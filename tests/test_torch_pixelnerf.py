"""The port's PixelNeRF against the JAX package, on the CPU, on the same
weights (parameters and BatchNorm statistics converted through
weights.from_flax_flat) and the same fixture scenes at 40x30: the latent
sample (one zeros-mode `table_sample` over the NV views against
`index_latent`), the forward of both levels with BatchNorm on the source
stack's statistics and on the running ones, a whole rendered view, one
training step, and the bf16 build. 8 + 8 samples, 16 rays, the preset's
widths (ResNet34 SpatialEncoder, 4 x 128 MLP), float32 unless stated.

Tolerances:
- the latent sample: 1e-5 relative plus 1e-5 of the largest entry (the
  pixel coordinates, products of camera points and focal lengths, round
  an ulp apart in the two frameworks, which moves a sample of the random
  latent by an ulp of the coordinate times its neighbour difference).
- the forward: 1e-4 relative plus 1e-5 absolute per output, as
  tests/test_torch_neo360_ref.py holds NeO-360's (the ResNet's
  convolutions and the matmuls sum in another order; at random init the
  outputs are sums of weights below 1e-2, and 1e-5 relative fails by
  measurement: 5.9e-5 on an rgb of 7.5e-3, 1.3e-4 on a weight of 7e-3).
- a whole render: rgb 1e-4 absolute per pixel, PSNR 0.01 dB per view, as
  tests/test_torch_eval.py.
- one training step: the loss 1e-5 relative; its gradient 2e-3 of the
  largest entry (tests/test_torch_train.py:149), leaves whose largest
  entry is under 5% of it skipped; BatchNorm buffers 1e-5 relative plus
  1e-6; one Adam step on the JAX gradient 1e-6 of the largest update.
- bf16 (the JAX acceptance's setting): the port folds bf16 table rows in
  float32 and rounds once, JAX folds in bf16, so rgb is held to 2e-2
  absolute, a few bf16 ulps of a value in [0, 1].
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
from neo360_tpu.core import geometry as jgeom
from neo360_tpu.core import sampling as jsamp
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.models.pixelnerf import PixelNeRF as JPixelNeRF
from neo360_tpu.nn.resnet import index_latent
from neo360_tpu.train import metrics as jmetrics
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import sampling
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.nn.layers import BatchNorm
from neo360_tpu_torch.ops.interpolate import build_corner_table
from neo360_tpu_torch.train import loop

torch.set_num_threads(1)

WH = (40, 30)
SRC = ("src_imgs", "src_poses", "src_focal", "src_c")
RAYS = ("rays_o", "rays_d", "viewdirs")
N_C, N_F = 8, 8
N_RAYS = 16


def _close(ours, ref, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _flat(tree, prefix):
    return flax.traverse_util.flatten_dict({prefix: tree}, sep="/")


def _variables_sd(variables):
    return weights.from_flax_flat({
        **_flat(variables["params"], "params"),
        **_flat(variables["batch_stats"], "batch_stats")})


def _jax_model(dtype=jnp.float32):
    return JPixelNeRF(num_src_views=3, num_coarse_samples=N_C,
                      num_fine_samples=N_F, compute_dtype=dtype)


def _port(variables, **kw):
    model = cli.build_model(preset("pixelnerf", num_coarse_samples=N_C,
                                   num_fine_samples=N_F, **kw), "cpu")
    weights.load_into(model, _variables_sd(variables))
    return model


@pytest.fixture(scope="module")
def setup(multi_scene_root):
    """The JAX model, its variables (running statistics drawn around the
    init's) and a test sample."""
    sample = JNeRDS360AE(multi_scene_root, "test", WH, 3).sample_test(0, 0)
    model = _jax_model()
    rays = {k: jnp.asarray(sample[k][:4] if k in RAYS else sample[k])
            for k in RAYS + SRC}
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sampling": jax.random.PRNGKey(1)}, rays, False,
                           False, 0.02, 3.0)
    rng = np.random.default_rng(1)
    bs = flax.traverse_util.flatten_dict(variables["batch_stats"])
    bs = {k: jnp.asarray(rng.normal(0, 0.1, v.shape) if k[-1] == "mean"
                         else rng.uniform(0.5, 2.0, v.shape), jnp.float32)
          for k, v in bs.items()}
    variables = {"params": variables["params"],
                 "batch_stats": flax.traverse_util.unflatten_dict(bs)}
    return model, variables, sample


def test_latent_sample_matches_index_latent(setup):
    """The port's one zeros-mode gather over all views (`_latents`, uv of
    the samples projected with (f, -f)) against the JAX chain
    geometry.projection + index_latent, points in and far outside the
    views included."""
    _, variables, sample = setup
    rng = np.random.default_rng(2)
    latent = rng.normal(size=(3, 15, 20, 512)).astype(np.float32)
    cam = rng.normal(size=(3, 200, 3)).astype(np.float32) * [1, 1, 0.3]
    cam[..., 2] -= 1.0
    focal, c = sample["src_focal"], sample["src_c"]
    uv = jgeom.projection(jnp.asarray(cam), jnp.stack(
        [focal[0], -focal[0]])[None], jnp.asarray(c[:1]), 3)
    ref, _ = index_latent(jnp.asarray(latent), uv, WH, padding_mode="zeros")
    port = _port(variables)
    table = build_corner_table(torch.as_tensor(latent), "zeros")
    ours = port._latents((table, (15, 20)), torch.as_tensor(cam),
                         torch.as_tensor(focal), torch.as_tensor(c), WH)
    top = np.abs(np.asarray(ref)).max()
    assert top > 0
    _close(ours, ref, rtol=1e-5, atol=1e-5 * top)


@pytest.mark.parametrize("bn", ["batch", "running"])
def test_forward_matches_jax(setup, bn):
    """Both levels' rgb, acc, depth, weights and t-values of 16 rays,
    deterministic sampling, the source stack encoded with BatchNorm on
    its own statistics ("batch") or the running ones."""
    model, variables, sample = setup
    idx = np.random.default_rng(3).choice(40 * 30, N_RAYS, replace=False)
    rays = {k: jnp.asarray(sample[k][idx] if k in RAYS else sample[k])
            for k in RAYS + SRC}
    if bn == "batch":
        latent, _ = model.apply(variables, rays["src_imgs"], True,
                                method=JPixelNeRF.encode,
                                mutable=["batch_stats"])
    else:
        latent = model.apply(variables, rays["src_imgs"],
                             method=JPixelNeRF.encode)
    ref = model.apply(variables, rays, False, False, 0.02, 3.0,
                      latent=latent)
    port = _port(variables)
    trays = {k: torch.as_tensor(np.asarray(v)) for k, v in rays.items()}
    with torch.no_grad():
        enc = port.encode(trays["src_imgs"], bn == "batch")
        ours = port(trays, enc)
    for lo, lr in zip(ours, ref):
        for k in ("rgb", "acc", "depth", "weights", "t_vals"):
            _close(lo[k], lr[k], rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.parametrize("bn", ["batch", "running"])
def test_render_matches_jax(setup, multi_scene_root, bn):
    """A whole 40x30 test view through each CLI's make_render_fn (the
    source stack encoded once): rgb within 1e-4, PSNR within 0.01 dB."""
    model, variables, _ = setup
    sample = dict(NeRDS360AE(multi_scene_root, "test", WH, 3).sample_test(
        1, 0), scene_key=1)
    jcfg = jpreset("pixelnerf", img_wh=WH, chunk=300, eval_bn_mode=bn)
    ref = jcli.make_render_fn(jcfg, model, scene_cache=True)(variables,
                                                            sample)
    cfg = preset("pixelnerf", img_wh=WH, chunk=300, eval_bn_mode=bn,
                 num_coarse_samples=N_C, num_fine_samples=N_F)
    out = cli.make_render_fn(cfg, _port(variables), "cpu")(sample)
    _close(out["rgb"], ref["rgb"], rtol=0, atol=1e-4)
    target = jnp.asarray(sample["target"])
    p_ref = float(jmetrics.psnr(ref["rgb"], target))
    p_ours = float(jmetrics.psnr(jnp.asarray(out["rgb"].numpy()), target))
    assert abs(p_ours - p_ref) < 0.01, (p_ours, p_ref)


def _shared_uniforms(monkeypatch, draws):
    jq, tq = list(draws), list(draws)
    real = jax.random.uniform

    def jax_uniform(key, shape, dtype=jnp.float32, *args, **kw):
        if sys._getframe(1).f_globals["__name__"] != jsamp.__name__:
            return real(key, shape, dtype, *args, **kw)
        u = jq.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return jnp.asarray(u, dtype)

    def port_uniform(shape, like, u, generator):
        u = tq.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return torch.as_tensor(u).to(like.device, like.dtype)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(sampling, "_uniform", port_uniform)
    return jq, tq


class _Record:
    """An optimizer that changes nothing and keeps the gradients."""

    def __init__(self, params, store):
        self.store = store

    def step(self, grads):
        self.store.append([g.clone() for g in grads])


def test_train_step_matches_jax(setup, multi_scene_root, monkeypatch):
    """One PixelNeRF training step (BatchNorm in training mode, randomized
    sampling on shared uniforms): the two-level MSE and its gradient
    against jax.value_and_grad of the JAX CLI's make_loss_fn, the
    BatchNorm running statistics the port commits against the JAX step's
    new batch_stats, and the port's Adam on the JAX gradient against the
    JAX CLI's optimizer."""
    model, variables, _ = setup
    batch = JNeRDS360AE(multi_scene_root, "train", WH, 3, N_RAYS
                        ).sample_train(np.random.default_rng(0))
    rng = np.random.default_rng(4)
    draws = [rng.uniform(size=(N_RAYS, n)).astype(np.float32)
             for n in (N_C + 1, N_F)]
    jcfg = jpreset("pixelnerf", img_wh=WH)
    loss_fn = jcli.make_loss_fn(jcfg, model, variables)
    keys = RAYS + SRC + ("target",)
    jq, _ = _shared_uniforms(monkeypatch, draws)
    (loss, (metrics, new_bs)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"],
                               variables["batch_stats"],
                               {k: jnp.asarray(batch[k]) for k in keys},
                               jax.random.PRNGKey(7))
    assert not jq
    tx = jcli.build_optimizer(jcfg, variables["params"])
    upd, _ = tx.update(grads, tx.init(variables["params"]),
                       variables["params"])

    port = _port(variables).train()
    cfg = preset("pixelnerf", img_wh=WH, num_coarse_samples=N_C,
                 num_fine_samples=N_F)
    _, tq = _shared_uniforms(monkeypatch, draws)
    recorded = []
    state = loop.create_train_state(port, lambda p: _Record(p, recorded))
    out = loop.make_train_step(cli.make_loss_fn(cfg, port),
                               with_model_state=True)(
        state, {k: torch.as_tensor(batch[k]) for k in keys}, None)
    assert not tq and state.step == 1
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(out["mse"]), float(metrics["mse"]),
                               rtol=1e-5)

    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(grads, "params")).items()}
    ours = {k: g.numpy() for k, g in zip(state.params, recorded[0])}
    assert set(ours) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    compared = 0
    for k, r in ref.items():
        if max(np.abs(r).max(), np.abs(ours[k]).max()) < 5e-2 * scale:
            continue
        _close(ours[k] / scale, r / scale, rtol=1e-4, atol=2e-3, msg=k)
        compared += 1
    assert compared >= 20, compared

    bn_ref = weights.from_flax_flat(_flat(new_bs, "batch_stats"))
    after = {f"{name}.{b}": getattr(m, b) for name, m in
             port.named_modules() if isinstance(m, BatchNorm)
             for b in ("running_mean", "running_var")}
    assert set(after) == set(bn_ref) and len(bn_ref) > 40
    for k, v in after.items():
        _close(v, bn_ref[k], rtol=1e-5, atol=1e-6, msg=k)

    params = {k: torch.zeros_like(torch.as_tensor(v)) for k, v in
              ref.items()}
    opt = cli.build_optimizer(cfg, list(params.values()))
    opt.step([torch.as_tensor(ref[k]) for k in params])
    ref_upd = {k: v.numpy() for k, v in
               weights.from_flax_flat(_flat(upd, "params")).items()}
    top = max(float(np.abs(v).max()) for v in ref_upd.values())
    for k, p in params.items():
        _close(p, ref_upd[k], rtol=0, atol=1e-6 * top, msg=k)


def test_bf16_build_matches_jax_bf16(setup):
    """`bf16=True` builds a bf16 PixelNeRF (bf16 corner table, bf16
    matmuls) whose render of 16 rays agrees with the JAX bf16 model's."""
    _, variables, sample = setup
    idx = np.arange(0, 40 * 30, 75)
    rays = {k: sample[k][idx] if k in RAYS else sample[k]
            for k in RAYS + SRC}
    jmodel = _jax_model(jnp.bfloat16)
    jrays_ = {k: jnp.asarray(v) for k, v in rays.items()}
    latent, _ = jmodel.apply(variables, jrays_["src_imgs"], True,
                             method=JPixelNeRF.encode,
                             mutable=["batch_stats"])
    ref = jmodel.apply(variables, jrays_, False, False, 0.02, 3.0,
                       latent=latent)
    port = _port(variables, bf16=True)
    assert port.compute_dtype == torch.bfloat16
    trays = {k: torch.as_tensor(np.asarray(v)) for k, v in rays.items()}
    with torch.no_grad():
        enc = port.encode(trays["src_imgs"], True)
        assert enc[0].dtype == torch.bfloat16
        ours = port(trays, enc)
    for lo, lr in zip(ours, ref):
        assert torch.isfinite(lo["rgb"]).all()
        _close(lo["rgb"], lr["rgb"], rtol=0, atol=2e-2)


def test_jax_npz_loads_into_the_port(setup, tmp_path):
    """A JAX PixelNeRF exported with save_variables_npz (parameters and
    batch_stats) loads through cli.load_weights into the same model as
    the converted weights."""
    from neo360_tpu.utils.io import save_variables_npz
    _, variables, _ = setup
    npz = save_variables_npz(str(tmp_path / "pixelnerf.npz"), variables)
    model = cli.build_model(preset("pixelnerf", num_coarse_samples=N_C,
                                   num_fine_samples=N_F), "cpu")
    cli.load_weights(model, npz)
    ref = _port(variables).state_dict()
    assert set(model.state_dict()) == set(ref)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
