"""The port's training slice against the JAX package, at a tiny size
(grid (8, 8, 4), encoder width 64, lift 32, 8 proposal and 6 fine samples,
float32), on the same converted weights and the same fixture scenes.

Tolerances:
- BatchNorm running statistics after a scene-mixed encode vs flax
  `mutable=["batch_stats"]` (mean over scenes): 1e-6.
- One joint gradient of the deterministic training loss (img2mse +
  interlevel + distortion) vs `jax.grad`: 1e-4 relative and 2e-3
  absolute, both sides divided by the largest gradient entry. The loss is
  ill-conditioned in float32 at this size: changing the ray directions by
  2e-7 (one or two ulps) moves JAX's own gradient by 4.3e-4 of its largest
  entry (the 3-view BatchNorm batches of the ResNet and the 2^9-frequency
  positional encoding of background points amplify rounding), and the two
  frameworks differ by up to 9.3e-4. Leaves whose largest entry is under
  5% of it are skipped, as tests/test_scene_stage.py does: the conv biases
  ahead of train-mode BatchNorm and the softmax-invariant pillar-head
  biases have a zero true gradient, and what both frameworks give there
  is rounding noise.
- `cli.build_optimizer` vs the JAX CLI's optax chain, on a fixed gradient
  sequence that turns clipping on and off: 1e-6.
- The port's K=2 stage: the encoder gradient it accumulates equals the
  mean of the two steps' direct gradients: 1e-5 (the same float32
  operations, summed in another order).

The port-only tests (the stage accumulation, the CLI run) shrink the
tri-planes from 120x160 to 30x40 (`GridEncoder.plane_hw`): the planes'
full-size convolutions and corner tables dominate a CPU step and are not
what those tests check.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu import cli as jcli
from neo360_tpu.config import preset as jpreset
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.models import neo360 as jneo
from neo360_tpu.ops.losses import img2mse as jimg2mse
from neo360_tpu.train import loop as jloop
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.models import neo360
from neo360_tpu_torch.nn.layers import BatchNorm
from neo360_tpu_torch.nn.triplane import GridEncoder
from neo360_tpu_torch.train import loop

torch.set_num_threads(1)

TINY = dict(grid_size=(8, 8, 4), encoder_width=64, lift_dim=32,
            num_prop_samples=8, num_fine_samples=6)
WH = (40, 30)
SRC = neo360.SRC_KEYS
RAYS = neo360.RAY_KEYS
SMALL_PLANES = (30, 40)


def _flat(tree, prefix):
    return flax.traverse_util.flatten_dict({prefix: tree}, sep="/")


@pytest.fixture(scope="module")
def setup(multi_scene_root):
    """The JAX model and variables (random running statistics), the port
    model on the same weights, and a 2-scene train stage (K=2)."""
    model = jneo.NeRFTP(num_src_views=3, use_proposal=True,
                        remat_encoder=False, **TINY)
    ds = JNeRDS360AE(multi_scene_root, "train", WH, 3, 16)
    stage = ds.sample_train_stage(np.random.default_rng(0), 2, n_scenes=2)
    rays = {k: jnp.asarray(stage[k][0, 0][:4]) for k in RAYS}
    rays.update({k: jnp.asarray(stage[k][0]) for k in SRC})
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    rng = np.random.default_rng(1)
    bs = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": bs}
    port = cli.build_model(preset("neo360_fast", bf16=False, **TINY), "cpu")
    weights.load_into(port, weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/")))
    return model, variables, port, stage


def _bn_buffers(model):
    return {f"{name}.{b}": getattr(m, b).clone()
            for name, m in model.named_modules() if isinstance(m, BatchNorm)
            for b in ("running_mean", "running_var")}


def test_mixed_encode_bn_update_matches_flax(setup):
    """Scene-mixed encode with BatchNorm in training mode: each scene's
    3 views are one batch, and the new running statistics are the mean
    over the scenes of each scene's flax update (momentum 0.9, biased
    variance); the flat tables match too."""
    model, variables, port, stage = setup
    encode_fn, _ = jneo.make_scene_stage_fns(model, mixed=True)
    enc, _ = jloop.partition_encoder_params(variables["params"])
    src = {k: jnp.asarray(stage[k]) for k in SRC}
    (pt, lt), (_, new_bs) = jax.jit(encode_fn)(enc, variables["batch_stats"],
                                               src)
    ref = weights.from_flax_flat(_flat(new_bs, "batch_stats"))

    port_encode, _ = neo360.make_scene_stage_fns(port.train(), mixed=True)
    before = _bn_buffers(port)
    with torch.no_grad():
        tables = port_encode({k: torch.as_tensor(stage[k]) for k in SRC})
    port.eval()
    after = _bn_buffers(port)
    assert set(after) == set(ref) and len(ref) > 40
    for k, v in after.items():
        assert not torch.equal(v, before[k]), k
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert all(not m.pending for m in port.modules()
               if isinstance(m, BatchNorm))
    assert tables[0].shape == (6, 121, 161, 512)
    for a, b in zip(tables, tuple(pt) + (lt["f"],)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    weights.load_into(port, weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/")))


def _compare_leaves(ours, ref, rtol, atol, min_compared):
    """Per-leaf comparison relative to the largest gradient entry; leaves
    under 5% of it are skipped (see the module docstring)."""
    scale = max(float(np.abs(v).max()) for v in ref.values())
    compared = 0
    for k, r in ref.items():
        o = ours[k]
        if max(np.abs(r).max(), np.abs(o).max()) < 5e-2 * scale:
            continue
        np.testing.assert_allclose(o / scale, r / scale, rtol=rtol,
                                   atol=atol, err_msg=k)
        compared += 1
    assert compared >= min_compared, compared


def test_joint_gradient_matches_jax(setup):
    """d(loss)/d(every parameter) with BatchNorm in training mode and
    deterministic sampling, through the kernels' autograd Functions (their
    plain versions on the CPU)."""
    model, variables, port, stage = setup
    batch = {k: jnp.asarray(stage[k][0, 0]) for k in RAYS + ("target",)}
    src = {k: jnp.asarray(stage[k][0]) for k in SRC}

    def joint_loss(params):
        rays = dict({k: batch[k] for k in RAYS}, **src)
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             rays, False, False, train=True,
                             mutable=["batch_stats"])
        l1 = jimg2mse(out[1]["rgb"], batch["target"])
        return (l1 + jneo.neo360_interlevel_loss(out)
                + jneo.neo360_distortion_loss(out))

    g = jax.jit(jax.grad(joint_loss))(variables["params"])
    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(g, "params")).items()}

    port.train()
    tsrc = {k: torch.as_tensor(stage[k][0]) for k in SRC}
    trays = {k: torch.as_tensor(np.asarray(batch[k])) for k in RAYS}
    enc = port.encode(*(tsrc[k] for k in SRC), True)
    out = port(dict(trays, **tsrc), enc)
    loss, _ = neo360.neo360_loss(out, torch.as_tensor(
        np.asarray(batch["target"])))
    named = dict(port.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    for m in port.modules():
        if isinstance(m, BatchNorm):
            m.pending.clear()
    port.eval()
    ours = {k: gr.numpy() for k, gr in zip(named, grads)}
    assert set(ours) == set(ref)
    _compare_leaves(ours, ref, rtol=1e-4, atol=2e-3, min_compared=40)


def test_build_optimizer_matches_optax():
    """Adam on nerf_schedule with per-partition clipping to 0.05, from zero
    parameters (so the parameters are the sum of the updates), over
    gradients that alternate above and below the clip."""
    kw = dict(lr_delay_steps=3, run_max_steps=20)
    cfg = preset("neo360_fast", **kw)
    tx = jcli.build_optimizer(jpreset("neo360_fast", **kw))
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    seq = [[(rng.normal(size=s) * (0.1 if i % 2 else 0.004)).astype(
        np.float32) for s in shapes] for i in range(6)]
    jp = [jnp.zeros(s, jnp.float32) for s in shapes]
    state = tx.init(jp)
    tp = [torch.zeros(s) for s in shapes]
    opt = cli.build_optimizer(cfg, tp)
    norms = []
    for grads in seq:
        norms.append(float(np.sqrt(sum((g ** 2).sum() for g in grads))))
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        opt.step([torch.as_tensor(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6 * float(jnp.abs(b).max()))
    assert min(norms) < 0.05 < max(norms)
    assert opt.count == 6


class _Record:
    """An optimizer that changes nothing and keeps every gradient."""

    def __init__(self, params):
        self.grads = []

    def step(self, grads):
        self.grads.append([g.clone() for g in grads])


@pytest.mark.parametrize("n_scenes", [1, 2])
def test_stage_accumulates_the_mean_step_gradient(multi_scene_root,
                                                  monkeypatch, n_scenes):
    """K=2, single-scene and scene-mixed (S=2) stages: the encoder gradient
    the stage pulls back from its accumulated table cotangents equals the
    mean of the two steps' direct encoder gradients (same tables, same ray
    parameters, same draws)."""
    stage = NeRDS360AE(multi_scene_root, "train", WH, 3, 16
                       ).sample_train_stage(np.random.default_rng(0), 2,
                                            n_scenes)
    monkeypatch.setattr(GridEncoder, "plane_hw", SMALL_PLANES)
    port = cli.build_model(preset("neo360_fast", bf16=False, **TINY),
                           "cpu").train()
    encode_fn, loss_fn = neo360.make_scene_stage_fns(port,
                                                     mixed=n_scenes > 1)
    src = {k: torch.as_tensor(stage[k]) for k in SRC}
    rays = {k: torch.as_tensor(stage[k]) for k in RAYS + ("target",)}
    state = loop.create_scene_stage_state(port, _Record)
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    loop.make_scene_stage_trainer(encode_fn, loss_fn)(state, src, rays, gen)
    assert state.step == 2 and len(state.ray_opt.grads) == 2
    (stage_grad,) = state.enc_opt.grads

    gen.set_state(start)
    enc = list(state.enc_params.values())
    direct = []
    for i in range(2):
        loss, _ = loss_fn(encode_fn(src), src,
                          {k: v[i] for k, v in rays.items()}, gen)
        direct.append(torch.autograd.grad(loss, enc, allow_unused=True))
    port.eval()
    names = list(state.enc_params)
    mean = {k: ((a if a is not None else 0) + (b if b is not None else 0))
            / 2 for k, a, b in zip(names, *direct)}
    ref = {k: np.broadcast_to(np.asarray(v, np.float32), p.shape)
           for (k, v), p in zip(mean.items(), enc)}
    ours = {k: g.numpy() for k, g in zip(names, stage_grad)}
    _compare_leaves(ours, ref, rtol=1e-5, atol=1e-5, min_compared=40)


def test_stage_adds_table_gradients_into_f32_accumulators(multi_scene_root,
                                                          monkeypatch):
    """With float32 accumulators (the preset) the scene-mixed stage hands
    loss_fn one f32 accumulator per table, the tables' autograd gradient
    is None at every step, and after the stage the accumulators hold the
    sum of the steps' dense table cotangents (1e-5 relative + 1e-6 of the
    largest entry: the same f32 products, summed in another order)."""
    stage = NeRDS360AE(multi_scene_root, "train", WH, 3, 16
                       ).sample_train_stage(np.random.default_rng(0), 2, 2)
    monkeypatch.setattr(GridEncoder, "plane_hw", SMALL_PLANES)
    port = cli.build_model(preset("neo360_fast", bf16=False, **TINY),
                           "cpu").train()
    encode_fn, loss_fn = neo360.make_scene_stage_fns(port, mixed=True)
    src = {k: torch.as_tensor(stage[k]) for k in SRC}
    rays = {k: torch.as_tensor(stage[k]) for k in RAYS + ("target",)}
    seen, table_grads = [], []
    grad = torch.autograd.grad

    def recording_loss(tables, src, batch, generator, **kw):
        seen.append(kw["grad_acc"])
        return loss_fn(tables, src, batch, generator, **kw)

    def recording_grad(outputs, inputs, *args, **kwargs):
        out = grad(outputs, inputs, *args, **kwargs)
        if len(inputs) == len(state.ray_params) + 4:   # the trainer's step
            table_grads.append(out[-4:])
        return out

    state = loop.create_scene_stage_state(port, _Record)
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    monkeypatch.setattr(torch.autograd, "grad", recording_grad)
    loop.make_scene_stage_trainer(encode_fn, recording_loss)(state, src,
                                                             rays, gen)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    assert len(seen) == 2 and seen[0] is seen[1]
    accs = seen[0]
    assert [a.dtype for a in accs] == [torch.float32] * 4
    assert len(table_grads) == 2
    assert all(g is None for step in table_grads for g in step)

    gen.set_state(start)
    tables = [t.detach().requires_grad_() for t in encode_fn(src)]
    ref = [torch.zeros(t.shape) for t in tables]
    for i in range(2):
        loss, _ = loss_fn(tables, src, {k: v[i] for k, v in rays.items()},
                          gen)
        for r, g in zip(ref, torch.autograd.grad(loss, tables)):
            r += g
    port.eval()
    for a, r in zip(accs, ref):
        assert float(r.abs().max()) > 0
        torch.testing.assert_close(a, r, rtol=1e-5,
                                   atol=1e-6 * float(r.abs().max()))


def test_training_needs_the_device_it_names(tmp_path):
    """The default device is cuda: without one, both entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = preset("neo360_fast", root_dir=str(tmp_path), eval_mode="full_eval")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run_eval(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run_train(cfg.replace(eval_mode=None))


def test_cli_trains_resumes_and_evaluates(tmp_path, monkeypatch, capsys):
    """`cli.main` without --eval_mode trains two stages on a fixture root,
    checkpoints, resumes from that checkpoint for two more, and
    --eval_mode full_eval evaluates the newest checkpoint."""
    from neo360_tpu.data.fixtures import make_micro_scene
    root = tmp_path / "scenes"
    for s in range(2):
        make_micro_scene(str(root / f"scene_{s:03d}"), n_val=1, wh=WH,
                         seed=100 + s)
    parse = cli.parse_args
    monkeypatch.setattr(cli, "parse_args", lambda argv: parse(argv).replace(
        bf16=False, **TINY))
    monkeypatch.setattr(GridEncoder, "plane_hw", SMALL_PLANES)
    base = ["--exp_type", "neo360_fast", "--root_dir", str(root),
            "--img_wh", "40", "30", "--ckpt_dir", str(tmp_path / "ckpts"),
            "--device", "cpu", "--stage_k", "2", "--ray_batch_size", "16",
            "--save_every_steps", "4"]
    state = cli.main(base + ["--run_max_steps", "4"])
    assert (state.step, state.enc_opt.count, state.ray_opt.count) == (4, 2, 4)
    exp = tmp_path / "ckpts" / "exp"
    assert sorted(os.listdir(exp / "checkpoints")) == ["ckpt_00000004.pt",
                                                       "metrics.json"]
    state = cli.main(base + ["--run_max_steps", "8"])
    assert "resumed from checkpoint step 4" in capsys.readouterr().out
    assert (state.step, state.enc_opt.count, state.ray_opt.count) == (8, 4, 8)
    raw = torch.load(exp / "checkpoints" / "ckpt_00000008.pt",
                     weights_only=True)
    assert raw["step"] == 8 and raw["enc_opt"]["count"] == 4
    records = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["step"] for r in records if "val_psnr" in r] == [4, 8]
    assert all(np.isfinite(r.get("val_psnr", r.get("mse", np.nan)))
               for r in records)
    assert os.path.exists(exp / "val_grid_00000008.png")

    summary = cli.main(base + ["--eval_mode", "full_eval"])
    out = capsys.readouterr().out
    assert "ckpt_00000008.pt" in out and "WARNING" not in out
    with open(exp / "results.json") as f:
        assert json.load(f)["psnr"]["mean"] == pytest.approx(summary["psnr"])
    model = cli.build_model(cli.parse_args(base))
    assert cli.restore(cli.parse_args(base), model, str(exp)).endswith(
        "ckpt_00000008.pt")
    for k, v in model.state_dict().items():
        saved = {**raw["enc_params"], **raw["ray_params"],
                 **raw["batch_stats"]}
        assert torch.equal(v, saved[k]), k


def test_port_loader_draws_the_jax_train_stage(multi_scene_root):
    """sample_train_stage and sample_val of the port's loader give the JAX
    loader's arrays from the same numpy seed."""
    jds = JNeRDS360AE(multi_scene_root, "train", WH, 3, 16)
    ds = NeRDS360AE(multi_scene_root, "train", WH, 3, 16)
    for n_scenes in (1, 2):
        ref = jds.sample_train_stage(np.random.default_rng(3), 3, n_scenes)
        ours = ds.sample_train_stage(np.random.default_rng(3), 3, n_scenes)
        for k, v in ours.items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    ref = jds.sample_val(1)
    ours = ds.sample_val(1)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    ref = jds.sample_train(np.random.default_rng(4))
    ours = ds.sample_train(np.random.default_rng(4))
    for k, v in ours.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
