"""The port's optimize and LPIPS-finetune modes against the JAX package,
at a tiny size (neo360_fast: grid (8, 8, 4), lift 32, 8 proposal and 6
fine samples; neo360: grid (8, 8, 8), 8 coarse and 6 fine samples; both
with encoder width 64, float32, 40x30 fixture scenes, random BatchNorm
running statistics), on the same converted weights.

- The sampler's optimize and finetune draws: equal arrays (both sides
  draw from one numpy Generator, in the same order).
- One optimize step (cached pixel latents) and one finetune step (a
  16x16 patch, the LPIPS term on synthetic weights) of both presets, on
  the same uniforms: the loss within 1e-5 relative; the trained
  partition's gradients (every leaf but the SpatialEncoder's) within
  1e-4 relative and 2e-3 absolute of the largest entry, leaves under 5%
  of it skipped (the float32 conditioning of tests/test_torch_train.py);
  the clip scales by max_norm over the trained partition's norm (1e-5
  relative: the port's float32 norm against a float64 one); one Adam step
  of the pinned lr, fed the JAX gradient, within 1e-6 of the largest
  update of optax's multi_transform; after a real step of the port's
  per-step trainer the SpatialEncoder's tensors and every BatchNorm
  buffer equal their values before it, bit for bit, and the trained
  tensors move. Running statistics: the source stack's own, times
  U(0.8, 1.2), so that the encoder's ReLUs pass.
- The cached-latent step equals the uncached one, bit for bit (port).
"""

import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu import cli as jcli
from neo360_tpu.config import preset as jpreset
from neo360_tpu.core import sampling as jsamp
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.models.neo360 import NeRFTP as JNeRFTP
from neo360_tpu.nn.lpips import LPIPSModel as JLPIPSModel
from neo360_tpu.train import loop as jloop
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import sampling
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.nn.layers import BatchNorm
from neo360_tpu_torch.nn.lpips import LPIPSModel, random_torch_state
from neo360_tpu_torch.train import loop

torch.set_num_threads(1)

WH = (40, 30)
N_RAYS = 16
PATCH = 16
TINY = {"neo360_fast": dict(grid_size=(8, 8, 4), encoder_width=64,
                            lift_dim=32, num_prop_samples=8,
                            num_fine_samples=6),
        "neo360": dict(grid_size=(8, 8, 8), encoder_width=64,
                       num_coarse_samples=8, num_fine_samples=6)}
MODES = {"optimize": dict(is_optimize=True),
         "finetune": dict(finetune_lpips=True)}
SAMPLE_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c", "rays_o",
               "viewdirs", "rays_d", "target")


def _flat(tree, prefix):
    return flax.traverse_util.flatten_dict({prefix: tree}, sep="/")


@pytest.mark.parametrize("flags", [
    dict(optimize=True), dict(finetune_lpips=True),
    dict(optimize=True, finetune_lpips=True),
    dict(finetune_lpips=True, patch_size=PATCH)])
def test_sampler_draws_match_jax(multi_scene_root, flags):
    """sample_train in the optimize and finetune modes (and both), three
    draws from one seed, and optimize_source_stack of every scene, as
    the JAX sampler gives them; the optimize-mode stage sampler too."""
    ours = NeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS, **flags)
    ref = JNeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS, **flags)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(3):
        a, b = ours.sample_train(r1), ref.sample_train(r2)
        for k in SAMPLE_KEYS + ("scene_idx",):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n = PATCH ** 2 if "patch_size" in flags else (
        900 if flags.get("finetune_lpips") else N_RAYS)
    assert a["rays_o"].shape == (n, 3)
    for s in range(len(ref.scene_ids)):
        a, b = ours.optimize_source_stack(s), ref.optimize_source_stack(s)
        for k in SAMPLE_KEYS[:4]:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if flags.get("optimize"):
        a = ours.sample_train_stage(r1, 2, n_scenes=2)
        b = ref.sample_train_stage(r2, 2, n_scenes=2)
        for k in SAMPLE_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _shared_uniforms(monkeypatch):
    """Both frameworks' sampling uniforms from one list, drawn from a
    seeded Generator at the first request of each position (each side
    takes them in its own order: per level, fg then bg)."""
    rng = np.random.default_rng(3)
    draws, taken = [], {"jax": 0, "torch": 0}
    real = jax.random.uniform

    def take(side, shape):
        i = taken[side]
        taken[side] += 1
        if i == len(draws):
            draws.append(rng.uniform(size=tuple(shape)).astype(np.float32))
        assert draws[i].shape == tuple(shape), (draws[i].shape, shape)
        return draws[i]

    def jax_uniform(key, shape, dtype=jnp.float32, *args, **kw):
        if sys._getframe(1).f_globals["__name__"] != jsamp.__name__:
            return real(key, shape, dtype, *args, **kw)
        return jnp.asarray(take("jax", shape), dtype)

    def port_uniform(shape, like, u, generator):
        return torch.as_tensor(take("torch", shape)).to(like.device,
                                                        like.dtype)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(sampling, "_uniform", port_uniform)
    return taken


class _Record:
    """An optimizer that changes nothing and keeps the gradients."""

    def __init__(self, params):
        self.grads = []

    def step(self, grads):
        self.grads.append([g.clone() for g in grads])


def _setup(root, exp, mode, tmp_path):
    """The JAX config, variables (random running statistics), loss_fn and
    batch; the port's config, LPIPS model and batch."""
    tiny = TINY[exp]
    jmodel = JNeRFTP(num_src_views=3, use_proposal=exp == "neo360_fast",
                     remat_encoder=False, **tiny)
    flags = dict(optimize=mode == "optimize",
                 finetune_lpips=mode == "finetune", patch_size=PATCH)
    jds = JNeRDS360AE(root, "train", WH, 3, N_RAYS, **flags)
    batch = jds.sample_train(np.random.default_rng(0))
    rays = {k: jnp.asarray(batch[k][:4] if k in cli.RAY_KEYS else batch[k])
            for k in cli.RAY_KEYS + cli.SRC_KEYS}
    variables = jax.jit(lambda r: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, True, False))(rays)
    # running statistics near the source stack's own (the batch's, from
    # one training-mode update of the initial 0 / 1, scaled by U(0.8,
    # 1.2)), so that the encoder's ReLUs after its BatchNorms pass
    _, upd = jax.jit(lambda v, r: jmodel.apply(
        v, r, False, False, train=True, mutable=["batch_stats"]))(
            variables, rays)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda new, old: np.asarray((new - 0.9 * old) / 0.1, np.float32)
        * rng.uniform(0.8, 1.2, new.shape).astype(np.float32),
        upd["batch_stats"], variables["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    lpips_path = str(tmp_path / "lpips.pt")
    torch.save(random_torch_state(7), lpips_path)
    jcfg = jpreset(exp, img_wh=WH, **MODES[mode])
    jlp = JLPIPSModel(lpips_path) if mode == "finetune" else None
    jb = {k: jnp.asarray(batch[k]) for k in cli.STEP_KEYS + ("scene_idx",)}
    tb = {k: torch.as_tensor(batch[k]) for k in cli.STEP_KEYS}
    if mode == "optimize":
        state = jloop.TrainState(step=jnp.asarray(0),
                                 params=variables["params"], opt_state=None,
                                 model_state=variables["batch_stats"])
        jb.update(jcli._optimize_latents(jmodel, state, variables, jds))
        tb["scene_idx"] = torch.as_tensor(batch["scene_idx"])
    cfg = preset(exp, img_wh=WH, bf16=False, remat_encoder=False,
                 lpips_weights=lpips_path, **MODES[mode], **tiny)
    plp = LPIPSModel(lpips_path) if mode == "finetune" else None
    if plp is not None:
        assert plp.pretrained and jlp.pretrained
    loss_fn = jcli.make_loss_fn(jcfg, jmodel, variables, jlp)
    return (jcfg, variables, loss_fn, jb), (cfg, plp, tb)


def _port(cfg, variables):
    model = cli.build_model(cfg, "cpu")
    weights.load_into(model, weights.from_flax_flat(
        flax.traverse_util.flatten_dict(variables, sep="/")))
    return model.eval()


def _frozen(name):
    return "spatial_encoder" in name


@pytest.mark.parametrize("mode", ["optimize", "finetune"])
@pytest.mark.parametrize("exp", ["neo360_fast", "neo360"])
def test_frozen_step_matches_jax(multi_scene_root, monkeypatch, tmp_path,
                                 exp, mode):
    """One optimize or finetune step of the port's per-step trainer
    against the JAX CLI's make_loss_fn and build_optimizer (module
    docstring)."""
    (jcfg, variables, loss_fn, jb), (cfg, plp, tb) = _setup(
        multi_scene_root, exp, mode, tmp_path)
    taken = _shared_uniforms(monkeypatch)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jb,
        jax.random.PRNGKey(7))
    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(grads, "params")).items()}

    port = _port(cfg, variables)
    state, staged = cli._per_step_runner(cfg, port, plp)
    const = None
    if mode == "optimize":
        # the port's cache against the JAX one; the step then takes the
        # JAX latents, so that it is compared alone
        ours = cli._optimize_latents(port, NeRDS360AE(
            multi_scene_root, "train", WH, 3, N_RAYS, optimize=True), "cpu")
        ref_lat = np.asarray(jb["pixel_latents"])
        np.testing.assert_allclose(ours["pixel_latents"].numpy(), ref_lat,
                                   rtol=1e-4, atol=1e-4)
        const = {"pixel_latents": torch.as_tensor(ref_lat)}
    assert set(state.params) == {k for k in ref if not _frozen(k)}
    assert all(not p.requires_grad for k, p in port.named_parameters()
               if _frozen(k))

    # the loss and the trained partition's gradient
    record = loop.create_train_state(port, _Record)
    step = loop.make_train_step(cli.make_loss_fn(cfg, port,
                                                 lpips_model=plp),
                                with_model_state=True)
    taken["torch"] = 0
    metrics = step(record, dict(tb, **(const or {})), None)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    ours = {k: g.numpy() for k, g in zip(record.params,
                                         record.opt.grads[0])}
    scale = max(float(np.abs(ref[k]).max()) for k in ours)
    compared = 0
    for k, g in ours.items():
        if max(np.abs(g).max(), np.abs(ref[k]).max()) < 5e-2 * scale:
            continue
        np.testing.assert_allclose(g / scale, ref[k] / scale, rtol=1e-4,
                                   atol=2e-3, err_msg=k)
        compared += 1
    assert compared >= 30, compared

    # the clip norm covers the trained partition only: Adam at the pinned
    # lr fed the JAX gradient against optax's multi_transform
    trained = {k: torch.as_tensor(ref[k]) for k in state.params}
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in trained.values())))
    norm_all = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                 for v in ref.values())))
    assert norm > cfg.grad_max_norm
    if mode == "finetune":   # the frozen encoder's gradient is not zero
        assert norm_all > norm
    opt = cli.build_optimizer(cfg, [torch.zeros_like(v)
                                    for v in trained.values()])
    for a, b in zip(opt.clip(list(trained.values())), trained.values()):
        torch.testing.assert_close(a, b * (cfg.grad_max_norm / norm),
                                   rtol=1e-5, atol=0)
    tx = jcli.build_optimizer(jcfg, variables["params"])
    upd, _ = tx.update(grads, tx.init(variables["params"]),
                       variables["params"])
    ref_upd = {k: v.numpy() for k, v in
               weights.from_flax_flat(_flat(upd, "params")).items()}
    params = {k: torch.zeros_like(v) for k, v in trained.items()}
    opt = cli.build_optimizer(cfg, list(params.values()))
    assert opt.lr(0) == opt.lr(100) == 5e-6
    opt.step([trained[k] for k in params])
    top = max(float(np.abs(v).max()) for v in ref_upd.values())
    for k, v in ref_upd.items():
        if _frozen(k):
            assert not np.any(v), k
        else:
            np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                       atol=1e-6 * top, err_msg=k)

    # a real step: frozen tensors and BatchNorm buffers keep their bits
    before = {k: v.clone() for k, v in port.state_dict().items()}
    taken["torch"] = 0
    staged(state, {k: v[None] for k, v in tb.items()}, None, const)
    after = port.state_dict()
    bn = {f"{n}.{b}" for n, m in port.named_modules()
          if isinstance(m, BatchNorm) for b in ("running_mean",
                                                "running_var")}
    keep = [k for k in before if _frozen(k) or k in bn]
    assert len(keep) > 100 and bn <= set(keep)
    for k in keep:
        assert torch.equal(before[k], after[k]), k
    moved = sum(not torch.equal(before[k], after[k]) for k in state.params)
    assert moved > 0.8 * len(state.params), moved
    assert all(not m.pending for m in port.modules()
               if isinstance(m, BatchNorm))


@pytest.mark.parametrize("exp", ["neo360_fast", "neo360"])
def test_cached_latent_step_equals_uncached(multi_scene_root, exp):
    """An optimize-mode step from the cached pixel latents (the
    SpatialEncoder skipped) equals the same step encoding the source views
    itself: loss, gradients and BatchNorm buffers, bit for bit."""
    cfg = preset(exp, img_wh=WH, bf16=False, remat_encoder=False,
                 is_optimize=True, **TINY[exp])
    ds = NeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS, optimize=True)
    sample = ds.sample_train(np.random.default_rng(2))
    tb = {k: torch.as_tensor(sample[k])
          for k in cli.STEP_KEYS + ("scene_idx",)}
    runs = []
    for cached in (True, False):
        model = cli.build_model(cfg, "cpu").eval()
        cli.freeze_spatial_encoder(model)
        const = cli._optimize_latents(model, ds, "cpu") if cached else {}
        state = loop.create_train_state(model, _Record)
        step = loop.make_train_step(cli.make_loss_fn(cfg, model),
                                    with_model_state=True)
        metrics = step(state, dict(tb, **const),
                       torch.Generator().manual_seed(5))
        runs.append((metrics, state.opt.grads[0],
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (m1, g1, s1), (m2, g2, s2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert len(g1) == len(g2) > 0
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
