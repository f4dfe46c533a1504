"""Training loop building blocks: the per-step trainer (port of
neo360_tpu/train/loop.py:29-80, 127-166), the ray-buffer trainer of the
vanilla NeRF (83-124), the scene-mixed, encode-once
stage trainer (169-308) and tiled full-image rendering (make_image_renderer,
311-366).

The per-step trainer differentiates one loss with respect to every
parameter, steps one optimizer (one global clip), and commits the
BatchNorm running statistics its forward recorded, once per step (Flax
semantics: momentum 0.9, biased batch variance; nn/layers.py:BatchNorm).
`make_staged_trainer` runs it over the K stacked batches of one call in a
Python loop and returns the last step's metrics; K = 1 takes no other
path.

The stage trainer runs the encoder once per stage of K steps. Each step
differentiates the loss with respect to the ray-branch parameters and to
detached copies of the encoder's corner tables, steps the ray optimizer,
and adds the table cotangents to an accumulator of `cot_dtype`. With the
default float32 accumulators the tables' backward (kernel A') adds into
them itself, at the rows the step read, and autograd returns None for the
tables; with another dtype each step's dense table gradient is cast and
added. After the K steps the mean cotangent, cast to the tables' dtype, is
pulled back through the encoder graph with one `torch.autograd.grad` and
the encoder optimizer steps once: exact gradient accumulation, since the
pullback is linear in the cotangent and the encoder's parameters do not
change within the stage. The two partitions have their own Adam states
and step counts (encoder: one per stage).

Data parallelism (`group`, a `parallel.sharding.Group`; None on one
device): each rank runs the step on its rows of the global batch and the
gradients are averaged over the ranks before the optimizer steps, so its
clip sees the global gradient, as optax's clip sees XLA's psum in the
JAX package. The stage trainer averages the ray partition's gradients
every step and the encoder's gradient once per stage, after each rank's
pullback: the pullback is linear, and averaging its result (rather than
the f32 table cotangents) gives every rank the same bits although each
rank's scatter-adds (kernel A') round in their own order. Metrics are
averaged too (psnr from the averaged mse). The image renderer gives each
rank a contiguous block of tiles and gathers the tiles.

Spans (core/spans.py, imported through train/profiling.py, the module
the benchmark reads the recorder from): a per-step trainer's step is the
item `train.step`, a rendered view the item `render.view`. A step takes
`train.loss` (forward and loss), `train.backward` (the gradients) and
`train.update` (the gradient all-reduce, the optimizer, the running
statistics); a view takes `render.tile` for each tile, one in
`MARKED_TILES` with device markers, and `render.assemble` for the padding
and for the output (on CUDA the other tiles replay one CUDA graph, whose
spans are credited: `make_image_renderer`). The stage trainer opens no
item: no benchmark cell runs it yet.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from neo360_tpu_torch.core.sampling import RowDraws
from neo360_tpu_torch.ops import kernels
from neo360_tpu_torch.parallel import sharding
from neo360_tpu_torch.train.profiling import credit, graphs, item, noting, \
    span

# one tile in MARKED_TILES of a rendered view takes device markers: a
# marker costs the host about a launch (core/spans.py)
MARKED_TILES = 16


@dataclass
class TrainState:
    """The per-step trainer's state: the model (parameters and BatchNorm
    buffers, updated in place), its trained parameters by name (those that
    require grad), the one optimizer over all of them, and the step
    count."""
    step: int
    model: nn.Module
    params: Dict[str, nn.Parameter]
    opt: object


def create_train_state(model: nn.Module,
                       make_optimizer: Callable[[List[torch.Tensor]], object]
                       ) -> TrainState:
    """`make_optimizer(params)` builds the optimizer of every parameter
    that requires grad (the CLI's build_optimizer); a frozen parameter
    (`requires_grad_(False)`) gets neither a gradient nor an update."""
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    return TrainState(step=0, model=model, params=params,
                      opt=make_optimizer(list(params.values())))


def _reduce(grads: List[torch.Tensor], metrics: Dict, group) -> Dict:
    """Average `grads` (in place) and `metrics` over the ranks of `group`
    in one collective per dtype; returns the averaged metrics, "psnr"
    taken from the averaged "mse" (the psnr of the global batch)."""
    from neo360_tpu_torch.ops.losses import mse2psnr
    vals = {k: v.detach().float().reshape(()).clone()
            for k, v in metrics.items()}
    sharding.all_reduce_mean_(list(grads) + list(vals.values()), group)
    if "psnr" in vals and "mse" in vals:
        vals["psnr"] = mse2psnr(vals["mse"])
    return vals


def make_train_step(loss_fn: Callable, with_model_state: bool = False,
                    with_step: bool = False, group=None):
    """train_step(state, batch, generator) -> metrics: loss_fn(batch,
    generator) -> (loss, metrics), the gradient of the loss with respect to
    every parameter (zero where it does not reach one), one optimizer step.
    `with_model_state`: the model has BatchNorm layers in training mode;
    the running statistics the step's forward recorded are committed after
    the step (`nn.layers.commit_running_stats`). `with_step`: loss_fn also
    takes the state's step count before the step, as a third argument
    (MipNeRF-360's anneal; neo360_tpu/train/loop.py's `with_step`).
    `group`: average the gradients and metrics over its ranks before the
    optimizer steps (and the running statistics across nodes)."""
    from neo360_tpu_torch.nn.layers import commit_running_stats

    def train_step(state: TrainState, batch, generator):
        with item("train.step"):
            extra = (state.step,) if with_step else ()
            with span("train.loss"):
                loss, metrics = loss_fn(batch, generator, *extra)
            params = list(state.params.values())
            with span("train.backward"):
                grads = _grads(torch.autograd.grad(loss, params,
                                                   allow_unused=True),
                               params)
            with span("train.update"):
                if group is not None:
                    metrics = _reduce(grads, metrics, group)
                state.opt.step(grads)
                if with_model_state:
                    commit_running_stats(state.model)
                    if group is not None:
                        sharding.sync_buffers_across_nodes(state.model,
                                                           group)
            state.step += 1
            return metrics

    return train_step


def make_staged_trainer(train_step: Callable):
    """run(state, batches, generator, const=None) -> the last step's
    metrics: `train_step` over the K stacked batches of `batches` (a dict of
    (K, ...) tensors), in order. `const`: a dict merged into every step's
    batch as it is, without the K axis (the optimize mode's cached pixel
    latents)."""

    def run(state, batches, generator, const=None):
        metrics = {}
        for i in range(next(iter(batches.values())).shape[0]):
            batch = {k: v[i] for k, v in batches.items()}
            metrics = train_step(state, dict(batch, **(const or {})),
                                 generator)
        return metrics

    return run


def make_buffer_trainer(train_step: Callable, batch_size: int,
                        steps_per_call: int, group=None):
    """run(state, buffers, generator, indices=None) -> the last step's
    metrics: `steps_per_call` steps of `train_step` over a device-resident
    ray buffer (neo360_tpu/train/loop.py:83-124). `buffers`: a dict of
    (N, ...) tensors on one device (rays_o, rays_d, viewdirs, target);
    each step's batch is `batch_size` rows drawn uniformly with
    replacement on that device from `generator`, which also feeds the
    step's randomized sampling. `indices` (steps_per_call, batch_size)
    gives the rows instead (the tests pass the JAX draws). With a `group`
    whose size divides batch_size, every rank draws the same global rows
    and keeps its block, and its sampling draws are its rows of the
    global batch's (`RowDraws`); otherwise every rank steps the
    whole batch, as the JAX mesh replicates it."""
    split = group is not None and batch_size % group.world_size == 0
    block = (group.rank, group.world_size) if split else (0, 1)

    def run(state, buffers, generator, indices=None):
        first = next(iter(buffers.values()))
        draws = generator if block[1] == 1 else RowDraws(generator, *block)
        metrics = {}
        for i in range(steps_per_call):
            if indices is None:
                idx = torch.randint(0, first.shape[0], (batch_size,),
                                    generator=generator,
                                    device=first.device)
            else:
                idx = torch.as_tensor(indices[i], device=first.device)
            idx = sharding.rows(idx, 0, *block)
            batch = {k: v.index_select(0, idx) for k, v in buffers.items()}
            metrics = train_step(state, batch, draws)
        return metrics

    return run


def partition_encoder_params(model: nn.Module
                             ) -> Tuple[Dict[str, nn.Parameter],
                                        Dict[str, nn.Parameter]]:
    """(encoder, ray-branch) parameters by name. Encoder = everything
    NeRFTP.encode touches: the GridEncoder (`encoder.*`) and the factored
    local projections (`local_proj_*`)."""
    is_enc = lambda name: name.startswith(("encoder.", "local_proj"))
    named = dict(model.named_parameters())
    enc = {k: v for k, v in named.items() if is_enc(k)}
    ray = {k: v for k, v in named.items() if not is_enc(k)}
    return enc, ray


@dataclass
class SceneStageState:
    """The model (parameters and BatchNorm buffers, updated in place), the
    two parameter partitions with their optimizers, and the ray-step
    count."""
    step: int
    model: nn.Module
    enc_params: Dict[str, nn.Parameter]
    ray_params: Dict[str, nn.Parameter]
    enc_opt: object
    ray_opt: object


def create_scene_stage_state(model: nn.Module,
                             make_optimizer: Callable[[List[torch.Tensor]],
                                                      object]
                             ) -> SceneStageState:
    """`make_optimizer(params)` builds one partition's optimizer (the CLI's
    build_optimizer); each partition gets its own."""
    enc, ray = partition_encoder_params(model)
    return SceneStageState(step=0, model=model, enc_params=enc,
                           ray_params=ray,
                           enc_opt=make_optimizer(list(enc.values())),
                           ray_opt=make_optimizer(list(ray.values())))


def _grads(grads, params) -> List[torch.Tensor]:
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def make_scene_stage_trainer(encode_fn: Callable, loss_fn: Callable,
                             multi_stage: bool = False,
                             cot_dtype=torch.float32, group=None):
    """The encode-once stage trainer.

    encode_fn(src) -> tuple of tables (differentiable in the encoder's
    parameters); loss_fn(tables, src, batch, generator, **kw) -> (loss,
    metrics). With `cot_dtype` float32, loss_fn is also given
    `grad_acc=[one zeroed f32 tensor per table]`, into which the tables'
    backward adds their gradients (returning None for them); a gradient it
    still returns for a table is added to that accumulator too.

    Returns run(state, src, ray_batches, generator) -> last step's metrics,
    ray_batches a dict of (K, ...) tensors. With `multi_stage=True`, every
    tensor of `src` and `ray_batches` carries a leading stage axis (as
    `stack_batches` builds them) and one call runs the stages in order.
    `cot_dtype` is the table-cotangent accumulator's dtype. `group`:
    average the ray gradients and metrics over its ranks every step and
    the encoder's gradient once per stage (module docstring)."""

    def stage(state: SceneStageState, src, ray_batches, generator):
        tables = encode_fn(src)
        if group is not None:
            sharding.sync_buffers_across_nodes(state.model, group)
        detached = [t.detach().requires_grad_() for t in tables]
        kw = {}
        cot = [None] * len(tables)   # allocated by the first cotangent
        if cot_dtype == torch.float32:
            cot = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for t in tables]
            kw = {"grad_acc": cot}
        ray_list = list(state.ray_params.values())
        k_steps = next(iter(ray_batches.values())).shape[0]
        metrics = {}
        for i in range(k_steps):
            batch = {k: v[i] for k, v in ray_batches.items()}
            loss, metrics = loss_fn(detached, src, batch, generator, **kw)
            grads = torch.autograd.grad(loss, ray_list + detached,
                                        allow_unused=True)
            g_ray = _grads(grads[:len(ray_list)], ray_list)
            if group is not None:
                metrics = _reduce(g_ray, metrics, group)
            state.ray_opt.step(g_ray)
            for j, g in enumerate(grads[len(ray_list):]):
                if g is None:
                    continue
                if cot[j] is None:
                    cot[j] = g.to(cot_dtype, copy=True)
                else:
                    cot[j].add_(g.to(cot_dtype))
            state.step += 1
        enc_list = list(state.enc_params.values())
        pairs = [(t, (c / k_steps).to(t.dtype)) for t, c in zip(tables, cot)
                 if c is not None]
        g_enc = _grads(torch.autograd.grad([t for t, _ in pairs],
                                           enc_list, [c for _, c in pairs],
                                           allow_unused=True), enc_list)
        if group is not None:
            sharding.all_reduce_mean_(g_enc, group)
        state.enc_opt.step(g_enc)
        return metrics

    if not multi_stage:
        return stage

    def run_stages(state, srcs, ray_batches, generator):
        metrics = {}
        for i in range(next(iter(srcs.values())).shape[0]):
            metrics = stage(state, {k: v[i] for k, v in srcs.items()},
                            {k: v[i] for k, v in ray_batches.items()},
                            generator)
        return metrics

    return run_stages


def stack_batches(samples: Sequence[Dict], keys=None) -> Dict[str,
                                                               np.ndarray]:
    """Stack a list of sample dicts into one dict of (K, ...) arrays."""
    keys = keys or list(samples[0].keys())
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}


def _graphs_on(device: torch.device) -> bool:
    """Whether a view's unmarked tiles on `device` run from a CUDA graph."""
    return device.type == "cuda"


def _warm(fn: Callable[[], Dict], device: torch.device):
    """fn() once on a new side stream that waits for the current one, as
    `torch.cuda.graph` asks of the work it captures; the current stream
    then waits for it. Returns (fn's outputs, the side stream)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    for v in out.values():
        v.record_stream(main)
    return out, side


def _capture(fn: Callable[[], Dict], side):
    """fn() captured into a new CUDA graph on the side stream, in a memory
    pool of its own. Returns (the graph, fn's outputs: the graph's static
    outputs, which each replay overwrites)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):   # the stream again if capture raises
        with torch.cuda.graph(graph, stream=side):
            out = fn()
    return graph, out


def _graph_key(pack, rays: Dict[str, torch.Tensor], chunk: int):
    """What a tile's graph is captured from, as far as the renderer can
    observe it: the device, `chunk`, each ray key with its dtype and
    trailing shape, and every leaf of `pack` (a tensor by its address,
    shape, strides and dtype; None, a number or a string by its value; any
    other object by its identity). Returns (the key, the pack's tensors
    and objects: a graph's entry holds them, so that no address it reads
    is freed and reused while it lives)."""
    held = []

    def leaf(x):
        if isinstance(x, torch.Tensor):
            held.append(x)
            return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
                    x.device)
        if isinstance(x, dict):
            return (dict,) + tuple((k, leaf(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return (type(x),) + tuple(leaf(v) for v in x)
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        held.append(x)
        return (type(x), id(x))

    first = next(iter(rays.values()))
    rays_key = tuple((k, v.dtype, tuple(v.shape[1:]))
                     for k, v in rays.items())
    return (first.device, chunk, rays_key, leaf(pack)), held


class _TileGraph:
    """One renderer's newest CUDA graph of a tile, with what it was
    captured from (make_image_renderer's docstring)."""

    def __init__(self, render_chunk_fn: Callable, chunk: int):
        self.fn, self.chunk = render_chunk_fn, chunk
        self.key, self.warned = None, False
        self._forget()

    def _forget(self) -> None:
        self.graph = self.static_in = self.static_out = None
        self.held = []          # the pack's tensors while the graph lives
        self.noted: List = []   # the spans a tile opens (spans.noting)
        self.launched: Dict[str, int] = {}  # a tile's launches by entry
        self.failed = False     # capture raised: tiles of the key eager

    def view(self, pack, padded: Dict[str, torch.Tensor],
             tiles: range) -> Dict[str, torch.Tensor]:
        """The tiles of `padded` starting at `tiles`, one after the other
        in one output per key: one in MARKED_TILES eager with device
        markers, the others replayed from the key's graph (captured from
        the first of them)."""
        key, held = _graph_key(pack, padded, self.chunk)
        if key != self.key:
            if self.graph is not None:
                self.graph.reset()
            self._forget()
            self.key, self.held = key, held
        out = None
        for j, i in enumerate(tiles):
            marked = j % MARKED_TILES == 0
            rays = {k: v[i:i + self.chunk] for k, v in padded.items()}
            with span("render.tile", marked):
                res, how = self._tile(pack, rays, marked)
                if out is None:
                    out = {k: v.new_empty((len(tiles) * self.chunk,)
                                          + v.shape[1:])
                           for k, v in res.items()}
                for k, v in res.items():
                    out[k][j * self.chunk:(j + 1) * self.chunk].copy_(v)
            graphs[how] += 1
        return out

    def _tile(self, pack, rays, marked: bool):
        """One tile's outputs and how it ran."""
        if marked or self.failed:
            return self.fn(pack, rays), "eager"
        if self.graph is None:
            return self._capture(pack, rays)
        for k, v in rays.items():
            self.static_in[k].copy_(v)
        self.graph.replay()
        credit(self.noted)
        for name, n in self.launched.items():
            kernels.launches[name] += n
        return self.static_out, "replayed"

    def _capture(self, pack, rays):
        """Run the tile on a side stream (its outputs are the tile's),
        then capture it from static inputs. The capture's spans are noted
        and its launches taken back out of `kernels.launches`: it runs
        nothing on the device, and each replay credits both."""
        self.static_in = {k: v.clone() for k, v in rays.items()}
        first, side = _warm(lambda: self.fn(pack, self.static_in),
                            next(iter(rays.values())).device)

        def captured():
            before = dict(kernels.launches)
            try:
                with noting() as noted:
                    return self.fn(pack, self.static_in)
            finally:
                self.noted = noted
                self.launched = {k: n - before[k] for k, n in
                                 kernels.launches.items() if n != before[k]}
                kernels.launches.update(before)

        try:
            self.graph, self.static_out = _capture(captured, side)
        except RuntimeError as e:
            self.graph = self.static_out = None
            self.failed = True
            if not self.warned:
                self.warned = True
                warnings.warn(f"a render tile could not be captured into a "
                              f"CUDA graph ({e}); its scene's tiles run "
                              f"eagerly", RuntimeWarning)
            return first, "eager"
        return first, "captured"


def make_image_renderer(render_chunk_fn: Callable, chunk: int = 4096,
                        group=None):
    """render_chunk_fn(pack, rays_chunk) -> dict of (chunk, ...) outputs.

    Returns render(pack, rays) that pads the (N, D) ray arrays to a multiple
    of `chunk` by repeating the last ray (padded rays stay finite through
    the normalization and sphere intersection), renders the tiles in order
    and strips the padding. With a `group` the padding goes to a multiple
    of chunk x ranks, rank r renders the r-th contiguous block of tiles
    and every rank returns the whole image, gathered
    (neo360_tpu/train/loop.py:311-366).

    On CUDA, a view of two tiles or more replays its tiles from a CUDA
    graph of `render_chunk_fn`, so the card no longer waits for the host's
    launches. One tile in MARKED_TILES runs eagerly with its device
    markers (the first builds the call's constants); the first other tile
    runs once on a side stream and is then captured from static inputs,
    one per ray key; every other tile copies its rays into them, replays
    the graph and copies its static outputs into the view's. The graph is
    keyed by what the renderer observes (`_graph_key`: the device, chunk,
    the ray keys' dtypes and trailing shapes, and the pack's tensors by
    address); another key captures anew, and only the newest graph is
    kept, holding the pack's tensors while it lives. So `render_chunk_fn`
    must read only its arguments and tensors that live as long as the
    renderer (weights updated in place are read where they are), and run
    the same work for every tile of one key, as every caller's does. A
    capture that raises (a path that waits for the stream) warns once,
    and the key's tiles run eagerly. A replayed tile's spans and kernel
    launches are credited as if it had run (`spans.credit`,
    `kernels.launches`), and each tile is counted by how it ran
    (`spans.graphs`). On the CPU, and for a single tile, the tiles run one
    after the other and their outputs are concatenated."""
    world = 1 if group is None else group.world_size
    tile_graph = _TileGraph(render_chunk_fn, chunk)

    @torch.inference_mode()
    def render(pack, rays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with item("render.view"):
            n = next(iter(rays.values())).shape[0]
            n_padded = -(-n // (chunk * world)) * chunk * world
            with span("render.assemble"):
                padded = {k: torch.cat([v, v[-1:].expand((n_padded - n,)
                                                         + v.shape[1:])])
                          for k, v in rays.items()}
            per = n_padded // world
            lo = 0 if group is None else group.rank * per
            tiles = range(lo, lo + per, chunk)
            out = None
            if len(tiles) > 1 and _graphs_on(
                    next(iter(padded.values())).device):
                out = tile_graph.view(pack, padded, tiles)
            else:
                outs = []
                for j, i in enumerate(tiles):
                    with span("render.tile", j % MARKED_TILES == 0):
                        outs.append(render_chunk_fn(
                            pack, {k: v[i:i + chunk]
                                   for k, v in padded.items()}))
            with span("render.assemble"):
                if out is None:
                    out = {k: torch.cat([o[k] for o in outs])
                           for k in outs[0]}
                if group is not None:
                    out = {k: sharding.all_gather_rows(v, group)
                           for k, v in out.items()}
                return {k: v[:n] for k, v in out.items()}

    return render
