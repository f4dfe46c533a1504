"""The port's data parallelism (neo360_tpu_torch/parallel/sharding.py and
the trainers' reductions) against the JAX package's mesh, on the CPU.

Multi-rank tests start two gloo processes through the port's own launcher
(`sharding.launch`), which rendezvous through a file store under the
test's tmp_path. The children import this module to find their rank
function, so it imports nothing of JAX at its top: the tests that run the
JAX side import it inside.

Tolerances:
- placement and rounding: exact.
- the DP step of a linear least-squares loss against one device: 1e-6
  (tests/test_parallel.py's test_dp_training_matches_single_device).
- a tiny scene-mixed neo360_fast stage (K=2, S=2, 16 rays a step,
  deterministic sampling, float32), two port ranks against JAX's stage
  trainer on a 2-device mesh (`shard_stage_batch`) with the parameters
  held, so that both sides differentiate at one point: the ray gradients
  summed over the steps and the encoder's pulled-back gradient to 1e-4
  relative and 2e-3 absolute of the largest entry, leaves under 5% of it
  skipped (tests/test_torch_train.py's joint-gradient tolerance: one
  float32 step of this loss moves the other framework's gradient by up to
  9.3e-4 of it, and an SGD step between the two would amplify that), and
  the BatchNorm running statistics to 1e-5 relative and 1e-6 absolute (a
  batch variance of the ResNet's third stage lands 2.3e-6 relative apart:
  float32 convolutions summed in two frameworks' orders). The ResNet34
  backbone's leaves are left out of the JAX comparison: at 40x30 inputs
  its deep BatchNorm batches hold a few values a channel and its gradient
  is ill-conditioned. On this stage the one-device JAX trainer and the
  one-rank port already differ there by up to 1.7e-2 of the largest
  entry, while JAX's mesh moves JAX's own result by 2e-5 and a 2e-7
  change of the rays moves the port's by 3e-3; the two port ranks are
  held to the one-rank port on those leaves too.
- the same stage with SGD at lr 1e-2, two port ranks against one port
  rank: 1e-6 absolute on every parameter and buffer after it, and on the
  held stage's gradients; the two ranks' BatchNorm buffers and gradients
  bit-equal.
"""

import functools
import os

import numpy as np
import pytest
import torch

from neo360_tpu_torch.parallel import sharding

torch.set_num_threads(1)

TINY = dict(grid_size=(8, 8, 4), encoder_width=64, lift_dim=32,
            num_prop_samples=8, num_fine_samples=6)
WH = (40, 30)
LR = 1e-2


def _launch(tmp_path, fn, *args, **kw):
    return sharding.launch(fn, 2, *args, device="cpu",
                           init_method=f"file://{tmp_path}/store", **kw)


@pytest.mark.parametrize("value,n", [(500, 8), (504, 8), (500, 2),
                                     (2048, 3), (16, 2), (1, 4)])
def test_round_to_devices_matches_jax(value, n, capsys):
    """The same rounding and the same printed line as the JAX CLI's
    `_round_to_devices`."""
    from neo360_tpu import cli as jcli
    from neo360_tpu.config import preset as jpreset
    from neo360_tpu_torch.config import preset
    ref = jcli._round_to_devices(jpreset("neo360_fast",
                                         ray_batch_size=value),
                                 "ray_batch_size", n)
    ref_out = capsys.readouterr().out
    ours = sharding.round_to_devices(preset("neo360_fast",
                                            ray_batch_size=value),
                                     "ray_batch_size", n)
    assert ours.ray_batch_size == ref.ray_batch_size
    assert ours.ray_batch_size % n == 0
    assert capsys.readouterr().out == ref_out


def _batches(rng):
    """Float32 arrays of the three batch layouts, with axes that divide by
    8 and axes that do not."""
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {
        "batch": (0, {"rays": f(16, 3), "src": f(3, 8, 8, 3),
                      "scalar": np.float32(2.0)}),
        "staged": (1, {"rays": f(2, 24, 3), "src": f(2, 3, 4, 4, 3),
                       "idx": np.arange(2, dtype=np.int32)}),
        "stage_mixed": (3, {"rays": f(1, 2, 2, 16, 3),
                            "odd": f(1, 2, 2, 252, 3)}),
        "stage_single": (2, {"rays": f(1, 2, 8, 3), "short": f(1, 2)}),
    }


@pytest.mark.parametrize("layout", ["batch", "staged", "stage_mixed",
                                    "stage_single"])
def test_row_sharding_matches_jax_placement(layout):
    """On the 8-device virtual mesh, rank r's block of a divisible array
    is the JAX placement's shard on device r; an array whose axis does not
    divide by 8 (or that has no such axis) is whole on every rank, as
    JAX replicates it."""
    import jax

    from neo360_tpu.parallel import sharding as jsh
    axis, batch = _batches(np.random.default_rng(0))[layout]
    mesh = jsh.make_mesh()
    if layout == "batch":
        placed = jsh.shard_batch(batch, mesh)
    elif layout == "staged":
        placed = jsh.shard_staged_batch(batch, mesh)
    else:
        placed = jsh.shard_stage_batch(batch, mesh, axis)
    devices = list(mesh.devices.flat)
    for r in range(8):
        group = sharding.Group(rank=r, world_size=8, local_rank=r,
                               local_world_size=8)
        ours = {"batch": sharding.shard_batch,
                "staged": sharding.shard_staged_batch}.get(
            layout, functools.partial(sharding.shard_stage_batch,
                                      ray_axis=axis))(batch, group)
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards
                         if s.device == devices[r])
            np.testing.assert_array_equal(ours[k], np.asarray(shard.data),
                                          err_msg=f"{k} rank {r}")
            whole = v.sharding.is_fully_replicated
            assert whole == (np.shape(ours[k]) == np.shape(batch[k])), k
    assert any(not v.sharding.is_fully_replicated for v in placed.values())
    assert jax.device_count() == 8


def test_row_draws_are_the_rows_of_the_global_draw():
    """RowDraws(g, r, n).rand((B, ...)) is block r of a (B * n, ...) draw
    from the same generator state, and the generator advances as the
    global draw does."""
    from neo360_tpu_torch.core.sampling import _uniform
    like = torch.zeros(())
    ref = torch.Generator().manual_seed(3)
    full = torch.rand((12, 5), generator=ref)
    after = torch.rand(4, generator=ref)
    for r in range(3):
        g = torch.Generator().manual_seed(3)
        part = _uniform((4, 5), like, None, sharding.RowDraws(g, r, 3))
        assert torch.equal(part, full[4 * r:4 * (r + 1)])
        assert torch.equal(torch.rand(4, generator=g), after)


def test_multihost_scene_sharding(multi_scene_root):
    """tests/test_parallel.py's per-host scene sharding on the port's
    loader: the train split is partitioned round-robin over processes, val
    keeps the full list, an empty shard raises; outside a group the loader
    keeps every scene."""
    from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE

    full = NeRDS360AE(multi_scene_root, "train", (16, 12)).scene_ids
    assert len(full) == 3
    shards = [NeRDS360AE(multi_scene_root, "train", (16, 12),
                         process_index=i, process_count=2).scene_ids
              for i in range(2)]
    assert sorted(shards[0] + shards[1]) == full
    assert set(shards[0]).isdisjoint(shards[1])
    val = NeRDS360AE(multi_scene_root, "val", (16, 12),
                     process_index=1, process_count=2).scene_ids
    assert val == full
    with pytest.raises(ValueError):
        NeRDS360AE(multi_scene_root, "train", (16, 12),
                   process_index=3, process_count=4)


def test_rank0_io_guards(tmp_path):
    """tests/test_parallel.py's rank-0 guards on the port's logger and
    checkpoint manager: a non-primary logger creates no file and its
    log_image returns None; in a single process a non-primary checkpoint
    manager saves nothing; the primary default writes."""
    from neo360_tpu_torch.train.checkpoints import CheckpointManager
    from neo360_tpu_torch.train.logging import MetricsLogger

    assert sharding.is_primary_process()     # single-process test run
    lg = MetricsLogger(str(tmp_path / "lg"), primary=False)
    lg.log(1, {"mse": 0.5})
    assert lg.log_image(1, "grid", np.zeros((4, 4, 3))) is None
    lg.close()
    assert not os.path.exists(str(tmp_path / "lg"))

    mgr = CheckpointManager(str(tmp_path / "ck"), primary=False)
    mgr.save(1, {"w": torch.zeros(3)}, {"val_psnr": 1.0})
    assert mgr.latest_step() is None and not os.path.exists(
        str(tmp_path / "ck"))

    lg2 = MetricsLogger(str(tmp_path / "lg2"))
    lg2.log(1, {"mse": 0.5})
    lg2.close()
    assert os.path.exists(str(tmp_path / "lg2" / "metrics.jsonl"))


class SGD:
    """p -= lr * g."""

    def __init__(self, params, lr=LR):
        self.params, self.lr = list(params), lr

    @torch.no_grad()
    def step(self, grads):
        torch._foreach_add_(self.params, [g.float() for g in grads],
                            alpha=-self.lr)


def _linear_step(x, y, w):
    """One DP step of mean((x @ w - y)^2) with SGD(0.1) on this rank's
    rows; returns the new w and the step's (averaged) metrics."""
    from neo360_tpu_torch.train import loop
    group = sharding.current()
    model = torch.nn.Linear(4, 2, bias=False)
    with torch.no_grad():
        model.weight.copy_(w.T)

    def loss_fn(batch, generator):
        loss = torch.mean((model(batch["x"]) - batch["y"]) ** 2)
        return loss, {"loss": loss.detach()}

    state = loop.create_train_state(model, functools.partial(SGD, lr=0.1))
    batch = {"x": x, "y": y}
    if group is not None:
        batch = sharding.shard_batch(batch, group)
    metrics = loop.make_train_step(loss_fn, group=group)(state, batch, None)
    return model.weight.detach().T.clone(), float(metrics["loss"])


def test_dp_training_matches_single_device(tmp_path):
    """tests/test_parallel.py's DP step: two ranks, each on its 8 rows of
    a 16-row batch, give the single-device update of the whole batch
    (1e-6), the same on both ranks, and the global loss."""
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=(4, 2)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(16, 4)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(16, 2)), dtype=torch.float32)
    ref_w, ref_loss = _linear_step(x, y, w)
    (w0, l0), (w1, l1) = _launch(tmp_path, _linear_step, x, y, w)
    torch.testing.assert_close(w0, ref_w, rtol=0, atol=1e-6)
    assert torch.equal(w0, w1)
    assert abs(l0 - ref_loss) < 1e-6 and l0 == l1


def _collectives(x):
    """sqrt(mean of the rows' squares) over the whole batch, from this
    rank's rows through the differentiable mean and gather; the
    gradients, averaged over the ranks as a trainer does, and the gathered
    rows."""
    group = sharding.current()
    x = sharding.rows(x, 0, group.rank, group.world_size).clone()
    x.requires_grad_()
    mse = sharding.all_reduce_mean(torch.mean(x ** 2), group)
    full = sharding.all_gather_rows(x, group, differentiable=True)
    loss = torch.sqrt(mse) + torch.sum(full[::3] ** 3)
    (g,) = torch.autograd.grad(loss, x)
    g = torch.cat([g, torch.zeros(x.shape)]) if group.rank == 0 else \
        torch.cat([torch.zeros(x.shape), g])
    sharding.all_reduce_mean_([g], group)
    return g, full.detach()


def test_whole_batch_collectives_give_the_whole_batch_gradient(tmp_path):
    """The differentiable mean (MipNeRF-360's sqrt of the batch MSE) and
    gather (the finetune's LPIPS patch): the ranks' mean gradient is the
    gradient of the same loss of the whole batch on one device (1e-6)."""
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(6, 3)),
                        dtype=torch.float32)
    xr = x.clone().requires_grad_()
    loss = torch.sqrt(torch.mean(xr ** 2)) + torch.sum(xr[::3] ** 3)
    (ref,) = torch.autograd.grad(loss, xr)
    (g0, f0), (g1, _) = _launch(tmp_path, _collectives, x)
    assert torch.equal(f0, x)
    # each rank's gradient is zero off its rows; their mean is the whole
    # batch's gradient
    torch.testing.assert_close(g0, ref, rtol=0, atol=1e-6)
    assert torch.equal(g0, g1)


def _node_buffers(value):
    """Two one-rank nodes: each sets a BatchNorm's running statistics to
    its own values, then syncs them across nodes."""
    from neo360_tpu_torch.nn.layers import BatchNorm
    group = sharding.current()
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.running_mean.fill_(value * (group.rank + 1))
        bn.running_var.fill_(group.rank)
    sharding.sync_buffers_across_nodes(bn, group)
    return group.node, group.nodes, bn.running_mean.clone(), \
        bn.running_var.clone()


def test_buffers_average_across_nodes(tmp_path):
    """Ranks on different nodes (encoding different scenes) average their
    running statistics after a commit; on one node there is nothing to
    average (every rank encoded the same views)."""
    (n0, c0, m0, v0), (n1, c1, m1, v1) = _launch(
        tmp_path, _node_buffers, 2.0, local_world_size=1)
    assert (n0, n1, c0, c1) == (0, 1, 2, 2)
    assert torch.equal(m0, torch.full((3,), 3.0)) and torch.equal(m0, m1)
    assert torch.equal(v0, torch.full((3,), 0.5)) and torch.equal(v0, v1)
    (tmp_path / "one").mkdir()
    (_, c, m, _), _ = _launch(tmp_path / "one", _node_buffers, 2.0)
    assert c == 1 and torch.equal(m, torch.full((3,), 2.0))


class SumGrads:
    """Changes nothing and sums the gradients it is given."""

    def __init__(self, params):
        self.sums = [torch.zeros_like(p) for p in params]

    def step(self, grads):
        torch._foreach_add_(self.sums, [g.float() for g in grads])


def _port_stage(state_dict, stage):
    """Two port stages (K=2, S=2, deterministic sampling) on this rank's
    rays from the given weights: with SGD (its parameters and buffers
    after the stage), and with parameters held (`SumGrads`: the ray
    gradients summed over the steps, and the encoder's)."""
    from neo360_tpu_torch import cli, weights
    from neo360_tpu_torch.config import preset
    from neo360_tpu_torch.models import neo360
    from neo360_tpu_torch.train import loop
    group = sharding.current()
    out = []
    for make_opt in (SGD, SumGrads):
        port = cli.build_model(preset("neo360_fast", bf16=False, **TINY),
                               "cpu")
        weights.load_into(port, state_dict)
        port.train()
        encode_fn, loss_fn = neo360.make_scene_stage_fns(
            port, mixed=True, randomized=False)
        src = {k: torch.as_tensor(stage[k]) for k in neo360.SRC_KEYS}
        rays = {k: torch.as_tensor(stage[k])
                for k in neo360.RAY_KEYS + ("target",)}
        if group is not None:
            rays = sharding.shard_stage_batch(rays, group, ray_axis=2)
        state = loop.create_scene_stage_state(port, make_opt)
        loop.make_scene_stage_trainer(encode_fn, loss_fn, group=group)(
            state, src, rays, None)
        out.append({k: v.detach().clone()
                    for k, v in port.state_dict().items()})
    grads = dict(zip(state.ray_params, state.ray_opt.sums))
    grads.update(zip(state.enc_params, state.enc_opt.sums))
    return out[0], out[1], grads


def _sum_grads():
    """An optax transformation that changes nothing and sums the
    gradients in its state (SumGrads)."""
    import jax
    import jax.numpy as jnp
    import optax
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        zeros, lambda g, s, p=None: (zeros(g), jax.tree_util.tree_map(
            jnp.add, s, g)))


class _Deterministic:
    """The JAX model with randomized=False in every ray-branch apply (the
    JAX stage samples at random, which the port cannot reproduce)."""

    def __init__(self, model):
        self.model, self.use_proposal = model, model.use_proposal

    def apply(self, variables, *args, **kw):
        if "method" not in kw:
            args = (args[0], False) + args[2:]
        return self.model.apply(variables, *args, **kw)


def test_stage_on_two_ranks_matches_jax_mesh_and_one_rank(multi_scene_root,
                                                          tmp_path):
    """A tiny scene-mixed neo360_fast stage: JAX's stage trainer on a
    2-device mesh against the port's on two ranks, with parameters held
    (the stage's summed ray gradients, its encoder gradient and its
    BatchNorm update); the port's two ranks against its one rank after an
    SGD stage (module docstring for the tolerances)."""
    import flax
    import jax
    import jax.numpy as jnp

    from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
    from neo360_tpu.models import neo360 as jneo
    from neo360_tpu.parallel import sharding as jsh
    from neo360_tpu.train import loop as jloop
    from neo360_tpu_torch import weights

    model = jneo.NeRFTP(num_src_views=3, use_proposal=True,
                        remat_encoder=False, **TINY)
    stage = JNeRDS360AE(multi_scene_root, "train", WH, 3, 16
                        ).sample_train_stage(np.random.default_rng(0), 2, 2)
    rays = {k: jnp.asarray(stage[k][0, 0][:4])
            for k in ("rays_o", "rays_d", "viewdirs")}
    rays.update({k: jnp.asarray(stage[k][0]) for k in jneo.SRC_KEYS})
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    flat = flax.traverse_util.flatten_dict(variables, sep="/")
    state_dict = weights.from_flax_flat(flat)

    mesh = jsh.make_mesh(devices=jax.devices()[:2])
    encode_fn, loss_fn = jneo.make_scene_stage_fns(_Deterministic(model),
                                                   mixed=True)
    jstate = jsh.replicate_tree(jloop.create_scene_stage_state(
        variables["params"], _sum_grads(), _sum_grads(),
        variables["batch_stats"]), mesh)
    src = jsh.replicate_tree({k: jnp.asarray(stage[k])
                              for k in jneo.SRC_KEYS}, mesh)
    rbs = jsh.shard_stage_batch({k: stage[k] for k in
                                 ("rays_o", "rays_d", "viewdirs", "target")},
                                mesh, ray_axis=2)
    assert not rbs["rays_o"].sharding.is_fully_replicated
    run = jloop.make_scene_stage_trainer(encode_fn, loss_fn, _sum_grads(),
                                         _sum_grads())
    jstate, _ = run(jstate, src, rbs, jax.random.PRNGKey(2))
    ref = weights.from_flax_flat(flax.traverse_util.flatten_dict(
        {"params": {**jstate.enc_opt_state, **jstate.ray_opt_state},
         "batch_stats": jstate.model_state}, sep="/"))

    one, _, one_grads = _port_stage(state_dict, stage)
    (r0, held0, grads0), (r1, _, grads1) = _launch(tmp_path, _port_stage,
                                                   state_dict, stage)
    for k, v in one.items():
        torch.testing.assert_close(r0[k], v, rtol=0, atol=1e-6, msg=k)
    for k, v in one_grads.items():
        torch.testing.assert_close(grads0[k], v, rtol=0, atol=1e-6, msg=k)
        assert torch.equal(grads0[k], grads1[k]), k
    bn = [k for k in r0 if k.endswith(("running_mean", "running_var"))]
    assert len(bn) > 40 and all(torch.equal(r0[k], r1[k]) for k in bn)

    for k in bn:
        np.testing.assert_allclose(held0[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    ours = {k: v.numpy() for k, v in grads0.items()
            if ".spatial_encoder.backbone." not in k}
    ref = {k: ref[k].numpy() for k in ours}
    scale = max(float(np.abs(v).max()) for v in ref.values())
    compared = 0
    for k in ours:
        if max(np.abs(ref[k]).max(), np.abs(ours[k]).max()) < 5e-2 * scale:
            continue
        np.testing.assert_allclose(ours[k] / scale, ref[k] / scale,
                                   rtol=1e-4, atol=2e-3, err_msg=k)
        compared += 1
    assert compared >= 25, compared
