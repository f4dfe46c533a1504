"""Data parallelism over ranks on `torch.distributed`, one rank per card
(counterpart of neo360_tpu/parallel/sharding.py and of the JAX CLI's
`_make_mesh_if_multichip` / `_round_to_devices`, neo360_tpu/cli.py:487-510).

The JAX package runs one process over a 1-D {"data": n} mesh: one global
batch is drawn on the host, its ray axis is sharded over the devices (an
array whose axis does not divide by n is replicated), and XLA inserts the
gradient psum ahead of the optimizer's clip. Here each rank is a process:

- `Group` says who this rank is (rank, world size, local rank and size,
  node and node count) and where it computes. `init` / `init_from_env`
  join a process group (NCCL for CUDA devices, gloo for the CPU) and make
  the group `current()`; `launch` starts one process per rank and returns
  each rank's result.
- `rows` / `shard_batch` / `shard_staged_batch` / `shard_stage_batch`
  keep a rank's contiguous block of the ray axis, with the JAX placement
  rule: an array whose axis does not divide by the rank count stays whole.
- `Group.draws` stands in a `core/sampling.py:RowDraws` for a
  `torch.Generator`: every rank draws the uniforms of the global batch
  from the same generator state and keeps its rows, so the n-rank step
  computes the one-rank step on the same global batch.
- `all_reduce_mean_` averages gradients in one flat bucket per dtype;
  `all_reduce_mean` and `all_gather_rows(..., differentiable=True)` are
  the autograd-aware collectives of losses that need the whole batch
  (MipNeRF-360's sqrt of the batch MSE, the finetune's LPIPS patch).

A JAX process is a host; its counterpart here is a node (torchrun's
GROUP_RANK). The ranks of one node share the node's host batch, as the
devices of one JAX host do, and the global batch is the nodes' batches
one after the other.

Tensor parallelism (`tp_param_shardings`, `distribute_params`) shards
the wide Linear weights over a DeviceMesh axis "model" with DTensor, whose
sharding propagation plays the part of XLA's. No CLI path uses it, in
either package. On CUDA it needs NCCL, one rank per card: DTensor's
all-gather of CUDA tensors through gloo segfaults (torch 2.11), so
several ranks sharing one card run it on the CPU.

Under the gloo backend a collective on CUDA tensors is staged through
host copies; that is only for checking several ranks on one card. A CUDA
group that asks for nothing else runs NCCL, and a failing NCCL init
raises.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, \
    Union

import torch
import torch.distributed as dist
from torch import nn

from neo360_tpu_torch.core.sampling import RowDraws

# long enough for a rank to wait out rank 0's checkpoint write or a
# validation render; a hung collective fails after it
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Group:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"

    @property
    def node(self) -> int:
        return self.rank // self.local_world_size

    @property
    def nodes(self) -> int:
        return self.world_size // self.local_world_size

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def host_rows(self, n: int) -> bool:
        """Whether a host batch of `n` rays splits over this node's ranks
        (else every rank of the node keeps it whole)."""
        return n % self.local_world_size == 0

    def draws(self, generator, split: bool):
        """`generator` as the rows of the global batch's draws: this
        rank's block when its node's batch is `split` over the ranks, else
        its node's block (the plain generator on one node)."""
        index, count = ((self.rank, self.world_size) if split
                        else (self.node, self.nodes))
        return generator if count == 1 else RowDraws(generator, index, count)


_CURRENT: Optional[Group] = None


def current() -> Optional[Group]:
    """The group this process joined (`init`), or None outside one."""
    return _CURRENT


def is_primary_process() -> bool:
    """True on rank 0 and in any process outside a group."""
    return _CURRENT is None or _CURRENT.primary


def init(rank: int, world_size: int, device, backend: Optional[str] = None,
         init_method: str = "env://", local_rank: Optional[int] = None,
         local_world_size: Optional[int] = None) -> Group:
    """Join the process group as `rank` of `world_size` computing on
    `device` and make it `current()`. The backend is NCCL for a CUDA
    device and gloo for the CPU; `backend="gloo"` on a CUDA device is for
    several ranks sharing one card. Local rank and size default to one
    node holding every rank."""
    global _CURRENT
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank if local_rank is None
                                  else local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT, **kw)
    _CURRENT = Group(rank=rank, world_size=world_size,
                     local_rank=rank if local_rank is None else local_rank,
                     local_world_size=(world_size if local_world_size is None
                                       else local_world_size),
                     device=device, backend=backend)
    return _CURRENT


def torchrun_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device_type: str = "cuda") -> Group:
    """Join the group torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE; MASTER_ADDR / MASTER_PORT through env://), the rank
    on cuda:LOCAL_RANK or the CPU."""
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    device = (torch.device("cuda", local_rank) if device_type == "cuda"
              else torch.device("cpu"))
    return init(rank, world, device, local_rank=local_rank,
                local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)))


def destroy() -> None:
    global _CURRENT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT = None


def _entry(rank, world_size, device, backend, init_method, local_world_size,
           threads, result_dir, fn, args):
    torch.set_num_threads(threads)
    status = os.path.join(result_dir, f"rank{rank}")
    try:
        init(rank, world_size, device, backend, init_method,
             local_rank=rank % local_world_size,
             local_world_size=local_world_size)
        out = fn(*args)
        torch.save(out, status + ".pt")
    except BaseException:
        with open(status + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        destroy()


def launch(fn: Callable, world_size: int, *args, device="cuda",
           backend: Optional[str] = None, init_method: Optional[str] = None,
           local_world_size: Optional[int] = None) -> List:
    """Run fn(*args) in `world_size` new processes, one rank each, and
    return each rank's result (rank order; results pass through
    `torch.save`, so keep them on the host). `device`: "cuda" puts rank r
    on cuda:(local rank), "cpu" puts every rank on the CPU, an indexed
    CUDA device puts every rank on that card (then pass backend="gloo").
    `init_method` defaults to a file store in a fresh temporary directory;
    `local_world_size` (default: all ranks on one node) groups ranks into
    nodes. A rank that fails ends the others and raises here with its
    traceback."""
    import torch.multiprocessing as mp
    local_world_size = local_world_size or world_size
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = init_method or f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_entry, args=(
            r, world_size, str(device), backend, init_method,
            local_world_size, torch.get_num_threads(), tmp, fn, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            while any(p.exitcode is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}")
            if os.path.exists(path + ".err"):
                with open(path + ".err") as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and not errors:
                errors.append(f"rank {r} exited with code {p.exitcode}")
        if errors:
            raise RuntimeError("a data-parallel rank failed\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def round_to_devices(cfg, field: str, n: int):
    """Round a batch-size field of `cfg` up to a multiple of `n` so ray
    batches split evenly (neo360_tpu/cli.py:500-510: 500 rays on 8 cards
    would leave 4 over)."""
    value = getattr(cfg, field)
    if value % n:
        rounded = -(-value // n) * n
        print(f"{field} {value} -> {rounded} (multiple of {n} devices)")
        cfg = cfg.replace(**{field: rounded})
    return cfg


def rows(x, axis: int, index: int, count: int):
    """Block `index` of `count` of `x` (a tensor or array) along `axis`,
    or `x` whole when it has no such axis or the axis does not divide by
    `count` (the JAX placement's replication)."""
    if x.ndim <= axis or x.shape[axis] % count:
        return x
    per = x.shape[axis] // count
    return x[(slice(None),) * axis + (slice(index * per,
                                            (index + 1) * per),)]


def _local(batch: Dict, axis: int, group: Group) -> Dict:
    return {k: rows(v, axis, group.local_rank, group.local_world_size)
            for k, v in batch.items()}


def shard_batch(batch: Dict, group: Group) -> Dict:
    """This rank's block of every array's leading axis over its node's
    ranks (`shard_batch`, neo360_tpu/parallel/sharding.py:49)."""
    return _local(batch, 0, group)


def shard_staged_batch(batches: Dict, group: Group) -> Dict:
    """Staged (K, B, ...) batches by their per-step axis 1
    (`shard_staged_batch`, neo360_tpu/parallel/sharding.py:67)."""
    return _local(batches, 1, group)


def shard_stage_batch(rbs: Dict, group: Group, ray_axis: int) -> Dict:
    """Scene-stage ray batches by their ray axis: 2 for (n_stages, K, B,
    ...), 3 for scene-mixed (n_stages, K, S, B/S, ...)
    (`shard_stage_batch`, neo360_tpu/parallel/sharding.py:85)."""
    return _local(rbs, ray_axis, group)


def _staged(group: Group, t: torch.Tensor) -> bool:
    return group.backend == "gloo" and t.is_cuda


def _all_reduce_sum_(t: torch.Tensor, group: Group) -> None:
    if _staged(group, t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Average `tensors` over the ranks, in place: one flat bucket and one
    collective per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _all_reduce_sum_(flat, group)
        flat.div_(group.world_size)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def _gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    src = x.detach().contiguous()
    if _staged(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group.world_size)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss read the whole gathered batch: sum their
        # cotangents, keep this rank's rows
        grad = grad.contiguous().clone()
        _all_reduce_sum_(grad, ctx.group)
        r, n = ctx.group.rank, ctx.n
        return grad[r * n:(r + 1) * n], None


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        _all_reduce_sum_(out, group)
        return out / group.world_size

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce_sum_(grad, ctx.group)
        return grad / ctx.group.world_size, None


def all_gather_rows(x: torch.Tensor, group: Group,
                    differentiable: bool = False) -> torch.Tensor:
    """Every rank's `x` concatenated along the leading axis in rank order
    (the whole batch from its row blocks). `differentiable`: the backward
    sums every rank's cotangent of the gathered batch and returns this
    rank's rows, so the ranks' mean gradient is the gradient of a loss of
    the whole batch."""
    if differentiable:
        return _AllGatherRows.apply(x, group)
    return _gather(x, group)


def all_reduce_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of `x` over the ranks, differentiably (the backward sums
    the ranks' cotangents and divides by the rank count)."""
    return _AllReduceMean.apply(x, group)


def barrier(group: Group) -> None:
    if group.backend == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


def sync_buffers_across_nodes(module: torch.nn.Module, group: Group) -> None:
    """Average `module`'s floating-point buffers (BatchNorm running
    statistics) over the ranks when they span several nodes: the nodes
    encode their own scenes, and the mean of their updates is what the
    scene-mixed stage does with the scenes of one node. On one node every
    rank encoded the same views, so there is nothing to do."""
    if group.nodes > 1:
        all_reduce_mean_([b for b in module.buffers()
                          if b.is_floating_point()], group)


def tp_param_shardings(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                       mesh, axis: str = "model", min_tp_width: int = 512
                       ) -> Dict[str, tuple]:
    """Parameter name -> DTensor placements (one per dimension of the
    DeviceMesh `mesh`) for `params` (a module's named parameters, or a
    name -> tensor mapping), the rule of
    neo360_tpu/parallel/sharding.py:tp_param_shardings: a weight whose
    output width is at least `min_tp_width` and divides by the size of
    mesh axis `axis` is sharded on its output dimension, and so is a 1-D
    bias of such a width; everything else is replicated. A Flax kernel
    is (in, out) and shards on its last axis; a torch Linear weight is
    (out, in), so here a 2-D or 1-D tensor shards on dimension 0."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    dim = mesh.mesh_dim_names.index(axis)
    size = mesh.size(dim)

    def spec(x: torch.Tensor):
        wide = (x.dim() in (1, 2) and x.shape[0] >= min_tp_width
                and x.shape[0] % size == 0)
        return tuple(Shard(0) if i == dim and wide else Replicate()
                     for i in range(mesh.ndim))

    return {name: spec(x) for name, x in params.items()}


def distribute_params(module: nn.Module, mesh,
                      shardings: Mapping[str, tuple]) -> nn.Module:
    """Make every parameter of `module` a DTensor on `mesh` with its
    placements from `shardings` (`tp_param_shardings`), in place, from the
    values this rank holds (each rank must hold the same values). Each
    submodule that owns parameters then takes plain tensors and returns
    plain tensors: its inputs enter as replicated DTensors, DTensor
    propagates the placements through its forward (a sharded weight gives
    an output sharded on its last dimension), and its output leaves whole
    (`full_tensor`, an all-gather of the shards). A submodule that owns
    parameters may not hold another that does (raises). Returns
    `module`."""
    from torch.distributed.tensor import DTensor, Replicate, \
        distribute_tensor

    replicate = [Replicate()] * mesh.ndim

    def enter(_, inputs):
        return tuple(DTensor.from_local(x, mesh, replicate)
                     if isinstance(x, torch.Tensor) else x for x in inputs)

    def leave(_, inputs, output):
        return output.full_tensor() if isinstance(output, DTensor) \
            else output

    for prefix, sub in module.named_modules():
        own = list(sub.named_parameters(recurse=False))
        if not own:
            continue
        if any(True for child in sub.children()
               for _ in child.parameters()):
            raise ValueError(f"distribute_params: {prefix or 'the module'} "
                             f"and one of its submodules both own "
                             f"parameters")
        for name, p in own:
            full = f"{prefix}.{name}" if prefix else name
            sub.register_parameter(name, nn.Parameter(
                distribute_tensor(p.detach(), mesh, shardings[full]),
                requires_grad=p.requires_grad))
        sub.register_forward_pre_hook(enter)
        sub.register_forward_hook(leave)
    return module
