"""The port's vanilla NeRF slice against the JAX package, on the CPU: the
plain NeRF composite (kernel D's plain version and the Function around
it), the vanilla samplers, the rays, the NERDS360 loader, `NeRFMLP`,
`VanillaNeRF`, a whole rendered view, one training step and the ray-buffer
trainer, on the same weights (converted through weights.from_flax_flat)
and the same inputs (numpy, seeded).

Tolerances:
- composite, samplers, rays: 1e-6 absolute plus 1e-6 relative (the same
  float32 operations; sums and cumprods in another order); the sample
  points o + t d: 1e-6 of the largest coordinate (a one-ulp difference
  of t in inverse depth, times |d|).
- composite gradients vs jax.vjp: 1e-5 relative plus 1e-5 of the largest
  entry (the backward of a cumprod divides in torch, not in JAX).
- NeRFMLP / VanillaNeRF forward: 1e-5 relative plus 1e-6 absolute per
  output (float32 matmuls summed in another order); a whole render: 0.01
  dB PSNR per view, as tests/test_torch_eval.py.
- One training step: the loss 1e-5 relative; its gradient 2e-3 of the
  largest entry, as tests/test_torch_train.py:149 records; one Adam step
  on the JAX gradient 1e-6 of the largest update.
- The buffer trainer, 2 steps on the JAX trainer's own ray indices: the
  last step's MSE 1e-4 relative, each parameter within 2 x the summed
  Adam step sizes of the JAX trainer's (a gradient entry near zero may
  flip the sign of Adam's normalized first step).

Randomized sampling draws the same uniforms on both sides: while a step
runs, `jax.random.uniform` (called from neo360_tpu.core.sampling) and the
port's `sampling._uniform` take their numbers from one list of numpy
draws, in the order both make them.
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
from neo360_tpu.core import rays as jrays
from neo360_tpu.core import render as jrender
from neo360_tpu.core import sampling as jsamp
from neo360_tpu.data.nerds360 import NeRDS360 as JNeRDS360
from neo360_tpu.models.vanilla import VanillaNeRF as JVanillaNeRF
from neo360_tpu.nn.mlp import NeRFMLP as JNeRFMLP
from neo360_tpu.train import loop as jloop
from neo360_tpu.train import metrics as jmetrics
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import rays, sampling
from neo360_tpu_torch.core.render import composite_vanilla, \
    composite_vanilla_reference
from neo360_tpu_torch.data.nerds360 import NeRDS360
from neo360_tpu_torch.models.vanilla import VanillaNeRF
from neo360_tpu_torch.nn.mlp import NeRFMLP
from neo360_tpu_torch.train import loop

torch.set_num_threads(1)

WH = (40, 30)
RAYS = ("rays_o", "rays_d", "viewdirs")
N_C, N_F = 8, 8


def _close(ours, ref, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _flat(tree, prefix):
    return flax.traverse_util.flatten_dict({prefix: tree}, sep="/")


def _composite_inputs(rng, b=16, s=9, case="random"):
    t = np.sort(rng.uniform(0.2, 3.0, (b, s)), -1).astype(np.float32)
    sigma = rng.uniform(0, 10, (b, s, 1)).astype(np.float32)
    if case == "zero":
        sigma[:] = 0.0
    elif case == "large":
        sigma = (sigma * 1e6).astype(np.float32)
    rgb = rng.uniform(0, 1, (b, s, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return rgb, sigma, t, dirs


@pytest.mark.parametrize("case", ["random", "zero", "large"])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite_matches_jax(case, white_bkgd):
    """composite_vanilla_reference, and composite_vanilla on CPU tensors,
    against volumetric_rendering: comp_rgb, acc, weights, depth."""
    args = _composite_inputs(np.random.default_rng(0), case=case)
    ref = jrender.volumetric_rendering(*map(jnp.asarray, args), white_bkgd)
    targs = [torch.as_tensor(a) for a in args]
    for fn in (composite_vanilla_reference, composite_vanilla):
        for o, r, name in zip(fn(*targs, white_bkgd), ref,
                              ("rgb", "acc", "weights", "depth")):
            _close(o, r, msg=f"{fn.__name__} {name}")


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite_gradients_match_jax_vjp(white_bkgd):
    """The autograd Function's gradients (d rgb, d density) for cotangents
    of all four outputs against jax.vjp of volumetric_rendering."""
    rng = np.random.default_rng(1)
    args = _composite_inputs(rng)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((16, 3), (16,), (16, 9), (16,))]
    _, vjp = jax.vjp(lambda r, d: jrender.volumetric_rendering(
        r, d, jnp.asarray(args[2]), jnp.asarray(args[3]), white_bkgd),
        jnp.asarray(args[0]), jnp.asarray(args[1]))
    ref = vjp(tuple(map(jnp.asarray, cots)))
    rgb, density = (torch.as_tensor(a).requires_grad_() for a in args[:2])
    out = composite_vanilla(rgb, density, torch.as_tensor(args[2]),
                            torch.as_tensor(args[3]), white_bkgd)
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(out, cots))
    for o, r in zip(torch.autograd.grad(loss, [rgb, density]), ref):
        r = np.asarray(r)
        _close(o, r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("randomized", [False, True])
def test_samplers_match_jax(lindisp, randomized, monkeypatch):
    """sample_along_rays (65 = 64 + 1 t-values, near 0.2, far 3.0) and
    sample_pdf (the midpoints and weights[1:-1] of a coarse level, 16
    draws merged with the coarse t-values) against JAX's, deterministic
    and on shared uniforms."""
    rng = np.random.default_rng(2)
    o = rng.normal(size=(8, 3)).astype(np.float32)
    d = rng.normal(size=(8, 3)).astype(np.float32)
    u0 = rng.uniform(size=(8, 65)).astype(np.float32)
    u1 = rng.uniform(size=(8, 16)).astype(np.float32)
    w = rng.uniform(size=(8, 65)).astype(np.float32)
    _shared_uniforms(monkeypatch, [u0, u1])
    key = jax.random.PRNGKey(0) if randomized else None
    jt, jpts = jsamp.sample_along_rays(jnp.asarray(o), jnp.asarray(d), 64,
                                       0.2, 3.0, randomized, lindisp, key)
    tt, tpts = sampling.sample_along_rays(torch.as_tensor(o),
                                          torch.as_tensor(d), 64, 0.2, 3.0,
                                          randomized, lindisp)
    _close(tt, jt)
    _close(tpts, jpts, atol=1e-6 * np.abs(jpts).max())
    mids = 0.5 * (jt[..., 1:] + jt[..., :-1])
    jt2, jpts2 = jsamp.sample_pdf(mids, jnp.asarray(w[:, 1:-1]),
                                  jnp.asarray(o), jnp.asarray(d), jt, 16,
                                  randomized, key)
    tmids = 0.5 * (tt[..., 1:] + tt[..., :-1])
    tt2, tpts2 = sampling.sample_pdf(tmids, torch.as_tensor(w[:, 1:-1]),
                                     torch.as_tensor(o), torch.as_tensor(d),
                                     tt, 16, randomized)
    assert tt2.shape == (8, 81)
    _close(tt2, jt2)
    _close(tpts2, jpts2, atol=1e-6 * np.abs(jpts2).max())


def test_rays_match_jax():
    """get_ray_directions / get_rays / rays_for_camera against JAX's."""
    rng = np.random.default_rng(3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    ref = jrays.rays_for_camera(30, 40, 44.0, jnp.asarray(c2w[:3, :4]))
    ours = rays.rays_for_camera(30, 40, 44.0, torch.as_tensor(c2w))
    for k in RAYS:
        _close(ours[k], ref[k], msg=k)
    _close(rays.get_ray_directions(30, 40, 44.0),
           jrays.get_ray_directions(30, 40, 44.0))


def test_nerds360_matches_jax(micro_scene):
    """The loader's splits, focal, ray buffers, full-image rays with the
    instance mask and the rays of an arbitrary pose, pixel radii included,
    against JAX's."""
    for split in ("train", "val", "test"):
        j, t = JNeRDS360(micro_scene, split, WH), NeRDS360(micro_scene,
                                                           split, WH)
        assert t.num_images == j.num_images and t.focal == j.focal
        _close(t.c2w, j.c2w, rtol=0, atol=0)
        sample, jsample = t.image_rays(0), j.image_rays(0)
        assert sorted(sample) == sorted(jsample)
        for k in sample:
            _close(sample[k], jsample[k], msg=f"{split} {k}")
    buffers, jbuffers = (NeRDS360(micro_scene, "train", WH).ray_buffers(),
                         JNeRDS360(micro_scene, "train", WH).ray_buffers())
    assert buffers["target"].shape == (100 * 40 * 30, 3)
    for k in buffers:
        _close(buffers[k], jbuffers[k], msg=k)
    pose = np.asarray(j.c2w[1])
    for k, v in t.pose_rays(pose).items():
        _close(v, j.pose_rays(pose)[k], msg=k)


def _port_mlp(variables, **kw):
    pe, vd = 63, 27
    mlp = NeRFMLP(pe, vd, **kw)
    weights.load_into(mlp, weights.from_flax_flat(
        _flat(variables["params"], "params")))
    return mlp


def test_nerf_mlp_matches_jax():
    """NeRFMLP at 6 x 32 (the skip after layer 4 included) and 2 x 16
    (no skip) on carried weights."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 7, 63)).astype(np.float32)
    v = rng.normal(size=(4, 27)).astype(np.float32)
    for size in (dict(netdepth=6, netwidth=32, netwidth_condition=16),
                 dict(netdepth=2, netwidth=16, netwidth_condition=16)):
        jm = JNeRFMLP(**size)
        variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(v))
        ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(v))
        ours = _port_mlp(variables, **size)(torch.as_tensor(x),
                                            torch.as_tensor(v))
        for o, r in zip(ours, ref):
            _close(o.detach(), r, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def vanilla_pair(micro_scene):
    """The JAX VanillaNeRF (8 + 8 samples, the reference 8 x 256 MLP), its
    variables and the port's model on them."""
    model = JVanillaNeRF(num_coarse_samples=N_C, num_fine_samples=N_F)
    sample = JNeRDS360(micro_scene, "test", WH).image_rays(0)
    rays_ = {k: jnp.asarray(sample[k][:4]) for k in RAYS}
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sampling": jax.random.PRNGKey(1)}, rays_,
                           False, False, 0.2, 3.0)
    port = cli.build_model(preset("vanilla", num_coarse_samples=N_C,
                                  num_fine_samples=N_F), "cpu")
    weights.load_into(port, weights.from_flax_flat(
        _flat(variables["params"], "params")))
    return model, variables, port


def test_vanilla_forward_matches_jax(vanilla_pair, micro_scene):
    """Both levels' rgb, acc, depth, weights and t-values of 64 rays,
    deterministic sampling, white background off and on."""
    model, variables, port = vanilla_pair
    sample = JNeRDS360(micro_scene, "test", WH).image_rays(1)
    idx = np.random.default_rng(5).choice(40 * 30, 64, replace=False)
    for white in (False, True):
        ref = model.apply(variables, {k: jnp.asarray(sample[k][idx])
                                      for k in RAYS}, False, white, 0.2, 3.0)
        with torch.no_grad():
            ours = port({k: torch.as_tensor(sample[k][idx]) for k in RAYS},
                        white, 0.2, 3.0)
        for lo, lr in zip(ours, ref):
            for k in ("rgb", "acc", "depth", "weights", "t_vals"):
                _close(lo[k], lr[k], rtol=1e-5, atol=1e-6, msg=k)


def test_vanilla_render_matches_jax(vanilla_pair, micro_scene):
    """A whole 40x30 view through each CLI's make_render_fn: rgb within
    1e-4 per pixel and PSNR within 0.01 dB."""
    model, variables, port = vanilla_pair
    cfg = preset("vanilla", img_wh=WH, chunk=256)
    sample = NeRDS360(micro_scene, "test", WH).image_rays(0)
    ref = jcli.make_render_fn(jpreset("vanilla", img_wh=WH, chunk=256),
                              model)(variables, sample)
    out = cli.make_render_fn(cfg, port, "cpu")(sample)
    _close(out["rgb"], ref["rgb"], rtol=0, atol=1e-4)
    target = jnp.asarray(sample["target"])
    p_ref = float(jmetrics.psnr(ref["rgb"], target))
    p_ours = float(jmetrics.psnr(jnp.asarray(out["rgb"].numpy()), target))
    assert abs(p_ours - p_ref) < 0.01, (p_ours, p_ref)


def _shared_uniforms(monkeypatch, draws):
    """Both frameworks take their sampling uniforms from copies of
    `draws`, in order."""
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


def _draws(rng, n_rays, steps=1):
    return [rng.uniform(size=(n_rays, n)).astype(np.float32)
            for _ in range(steps) for n in (N_C + 1, N_F)]


class _Record:
    """An optimizer that changes nothing and keeps the gradients."""

    def __init__(self, params, store):
        self.store = store

    def step(self, grads):
        self.store.append([g.clone() for g in grads])


def test_train_step_matches_jax(vanilla_pair, micro_scene, monkeypatch):
    """One vanilla training step (randomized sampling on shared uniforms):
    the two-level MSE and its gradient against jax.value_and_grad of the
    JAX CLI's make_loss_fn, and the port's Adam on the JAX gradient
    against the JAX CLI's optimizer."""
    model, variables, port = vanilla_pair
    buffers = JNeRDS360(micro_scene, "train", WH).ray_buffers()
    idx = np.random.default_rng(6).choice(buffers["target"].shape[0], 32)
    batch = {k: np.asarray(v)[idx] for k, v in buffers.items()}
    draws = _draws(np.random.default_rng(7), 32)
    jcfg = jpreset("vanilla", img_wh=WH)
    loss_fn = jcli.make_loss_fn(jcfg, model, variables)
    jq, _ = _shared_uniforms(monkeypatch, draws)
    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    assert not jq
    tx = jcli.build_optimizer(jcfg, variables["params"])
    upd, _ = tx.update(grads, tx.init(variables["params"]),
                       variables["params"])

    cfg = preset("vanilla", img_wh=WH, num_coarse_samples=N_C,
                 num_fine_samples=N_F)
    _, tq = _shared_uniforms(monkeypatch, draws)
    recorded = []
    state = loop.create_train_state(port, lambda p: _Record(p, recorded))
    out = loop.make_train_step(cli.make_loss_fn(cfg, port))(
        state, {k: torch.as_tensor(v) for k, v in batch.items()}, None)
    assert not tq and state.step == 1
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(out["mse"]), float(metrics["mse"]),
                               rtol=1e-5)
    ref = {k: v.numpy() for k, v in
           weights.from_flax_flat(_flat(grads, "params")).items()}
    ours = {k: g.numpy() for k, g in zip(state.params, recorded[0])}
    assert set(ours) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for k, r in ref.items():
        _close(ours[k] / scale, r / scale, rtol=0, atol=2e-3, msg=k)

    params = {k: torch.zeros_like(torch.as_tensor(v)) for k, v in
              ref.items()}
    opt = cli.build_optimizer(cfg, list(params.values()))
    opt.step([torch.as_tensor(ref[k]) for k in params])
    ref_upd = {k: v.numpy() for k, v in
               weights.from_flax_flat(_flat(upd, "params")).items()}
    top = max(float(np.abs(v).max()) for v in ref_upd.values())
    for k, p in params.items():
        _close(p, ref_upd[k], rtol=0, atol=1e-6 * top, msg=k)


def test_buffer_trainer_matches_jax(vanilla_pair, micro_scene, monkeypatch):
    """make_buffer_trainer: 2 steps of 32 rays on the rows the JAX
    trainer draws from its key (given as `indices`), on shared uniforms,
    against the JAX make_buffer_trainer from the same weights."""
    model, variables, _ = vanilla_pair
    jcfg = jpreset("vanilla", img_wh=WH)
    jbuf = JNeRDS360(micro_scene, "train", WH).ray_buffers()
    n = jbuf["target"].shape[0]
    key = jax.random.PRNGKey(11)
    k, indices = key, []
    for _ in range(2):      # the JAX trainer's own draws, in its order
        k, k_idx, _ = jax.random.split(k, 3)
        indices.append(np.asarray(jax.random.randint(k_idx, (32,), 0, n)))
    draws = _draws(np.random.default_rng(8), 32, steps=2)

    opt = jcli.build_optimizer(jcfg, variables["params"])
    step_fn = jloop.make_train_step(
        jcli.make_loss_fn(jcfg, model, variables), opt)
    run = jloop.make_buffer_trainer(step_fn, 32, 2)
    jq, _ = _shared_uniforms(monkeypatch, draws)
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    jstate, jm = run(jloop.create_train_state(params, opt), jbuf, key)
    assert not jq

    cfg = preset("vanilla", img_wh=WH, num_coarse_samples=N_C,
                 num_fine_samples=N_F)
    port = cli.build_model(cfg, "cpu")
    weights.load_into(port, weights.from_flax_flat(
        _flat(variables["params"], "params")))
    _, tq = _shared_uniforms(monkeypatch, draws)
    state = loop.create_train_state(
        port, lambda p: cli.build_optimizer(cfg, p))
    buffers = NeRDS360(micro_scene, "train", WH).ray_buffers()
    runner = loop.make_buffer_trainer(
        loop.make_train_step(cli.make_loss_fn(cfg, port)), 32, 2)
    metrics = runner(state, buffers, None, np.stack(indices))
    assert not tq and state.step == 2
    np.testing.assert_allclose(float(metrics["mse"]), float(jm["mse"]),
                               rtol=1e-4)
    sched = cli.build_optimizer(cfg, []).lr
    bound = 2 * (sched(0) + sched(1))
    ref = weights.from_flax_flat(_flat(jstate.params, "params"))
    for name, p in port.state_dict().items():
        _close(p, ref[name], rtol=0, atol=bound, msg=name)


def test_jax_npz_loads_warm_starts_and_evaluates(vanilla_pair, micro_scene,
                                                 tmp_path, capsys):
    """A JAX VanillaNeRF exported with save_variables_npz: cli.load_weights
    gives the same model as the converted weights, run_eval evaluates it
    (PSNR of each view within 0.01 dB of the JAX CLI's render) and
    run_train warm-starts from it at step 0."""
    from neo360_tpu.utils.io import save_variables_npz
    model, variables, port = vanilla_pair
    npz = save_variables_npz(str(tmp_path / "vanilla.npz"),
                             {"params": variables["params"]})
    cfg = preset("vanilla", root_dir=micro_scene, img_wh=WH,
                 num_coarse_samples=N_C, num_fine_samples=N_F,
                 ckpt_dir=str(tmp_path), ckpt_path=npz, device="cpu",
                 chunk=600)
    loaded = cli.build_model(cfg, "cpu")
    cli.load_weights(loaded, npz)
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    summary = cli.run_eval(cfg.replace(eval_mode="full_eval"))
    jrender = jcli.make_render_fn(jpreset("vanilla", img_wh=WH), model)
    ds = NeRDS360(micro_scene, "test", WH)
    ref = [float(jmetrics.psnr(jrender(variables, s)["rgb"],
                               jnp.asarray(s["target"])))
           for s in (ds.image_rays(i) for i in range(ds.num_images))]
    assert abs(summary["psnr"] - np.mean(ref)) < 0.01
    state = cli.run_train(cfg.replace(run_max_steps=1, steps_per_call=1,
                                      batch_size=16, exp_name="warm"))
    assert "warm-started" in capsys.readouterr().out and state.step == 1
