"""The port's MipNeRF-360 against the JAX package, on the CPU at a tiny
size (NeRF MLP 8 x 32, proposal MLPs 2 x 32, 8 + 8 + 4 samples): the pixel
radii, the IPE, the contraction and its covariance transport, the
icosahedron basis, every function of core/mip.py, the composite (kernel
E's plain version and the Function around it, its gradients included),
the distortion loss, and the whole model: renderings and ray history per
level, the loss and every parameter's gradient, on the same weights
(a JAX npz through weights.from_flax_flat) and the same inputs (numpy,
seeded).

Tolerances:
- rays and radii, contraction, lifting, IPE, Gaussians, the composite and
  the distortion loss: 1e-6 relative plus 1e-6 absolute (or 1e-6 of the
  largest entry), the same float32 operations in another order; the
  basis is bit for bit.
- track_linearize's covariance: 1e-5 of the largest entry (a closed-form
  Jacobian against jax.jacfwd's chain rule).
- resampled edges: 1e-6 absolute. XLA turns jnp.linspace's division
  into a multiply by the reciprocal, so core/geometry.linspace can
  differ from the mip sampling grids by an ulp; the interpolant is
  continuous, so the edges move by as much.
- composite gradients against jax.vjp: 1e-5 relative plus 1e-5 of the
  largest entry, with the last density's exactly 0 under the opaque
  background and the tie acc == 1.0 (ray 0) given the 0.5 rule.
- the whole model's renderings: 2e-5 relative plus 2e-5 absolute; its
  densities 1e-4 relative (a 504-wide IPE through float32 matmuls summed
  in another order); the loss 1e-5 relative; each parameter's gradient
  within 2e-3 of its largest entry, as tests/test_torch_train.py.

Randomized sampling draws the same uniforms on both sides: while a run
lasts, `jax.random.uniform` (called from neo360_tpu.core.mip) and the
port's `sampling._uniform` take their numbers from one list of numpy
draws, in the order both make them.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu import cli as jcli
from neo360_tpu.config import preset as jpreset
from neo360_tpu.core import encoding as jenc
from neo360_tpu.core import mip as jmip
from neo360_tpu.core import rays as jrays
from neo360_tpu.core import render as jrender
from neo360_tpu.models.mipnerf360 import MipNeRF360 as JMipNeRF360
from neo360_tpu.ops import losses as jlosses
from neo360_tpu.utils.io import save_variables_npz
from neo360_tpu_torch import cli, weights
from neo360_tpu_torch.config import preset
from neo360_tpu_torch.core import encoding, mip, rays, sampling
from neo360_tpu_torch.core.render import composite_mip, \
    composite_mip_reference
from neo360_tpu_torch.models.mipnerf360 import MipNeRF360, resample_logits
from neo360_tpu_torch.ops import losses

torch.set_num_threads(1)

TINY = dict(num_prop_samples=8, num_nerf_samples=4, nerf_netwidth=32,
            prop_netdepth=2, prop_netwidth=32)
RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "radii")


def _close(ours, ref, rtol=1e-6, atol=1e-6, msg=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _shared_uniforms(monkeypatch, draws):
    """Both frameworks take their sampling jitter from copies of `draws`,
    in order."""
    jq, tq = list(draws), list(draws)
    real = jax.random.uniform

    def jax_uniform(key, shape, dtype=jnp.float32, *args, **kw):
        if sys._getframe(1).f_globals["__name__"] != jmip.__name__:
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


def test_pixel_radii_and_rays_match_jax():
    """rays_for_camera's four outputs (radii (H*W, 1) included) and
    pixel_radii of a direction image, against JAX's."""
    rng = np.random.default_rng(0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    ref = jrays.rays_for_camera(30, 40, 44.0, jnp.asarray(c2w[:3, :4]))
    ours = rays.rays_for_camera(30, 40, 44.0, torch.as_tensor(c2w))
    assert sorted(ours) == sorted(ref) and ours["radii"].shape == (1200, 1)
    for k in ref:
        _close(ours[k], ref[k], msg=k)
    d = rng.normal(size=(6, 5, 3)).astype(np.float32)
    _close(rays.pixel_radii(_t(d)), jrays.pixel_radii(jnp.asarray(d)))


def test_ipe_and_contraction_match_jax():
    """contract and track_linearize (closed-form Jacobian against
    jax.vmap(jax.jacfwd)) on points inside and outside the unit ball,
    lift_and_diagonalize on the basis, and the IPE at degrees 0-12 with
    variances large enough for exp to underflow."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 3)) * rng.uniform(0.05, 4, (64, 1))
         ).astype(np.float32)
    x[0] = 0.0
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) * 0.01).astype(np.float32)
    _close(encoding.contract(_t(x)), jenc.contract(jnp.asarray(x)))
    jm_, jc = jenc.track_linearize(jenc.contract, jnp.asarray(x),
                                   jnp.asarray(cov))
    tm_, tc = encoding.track_linearize(_t(x), _t(cov))
    _close(tm_, jm_)
    _close(tc, jc, rtol=0, atol=1e-5 * float(np.abs(jc).max()))
    basis = encoding.generate_basis()
    lm, lv = encoding.lift_and_diagonalize(tm_, tc, _t(basis))
    jlm, jlv = jenc.lift_and_diagonalize(jm_, jc, jnp.asarray(basis))
    _close(lm, jlm)
    _close(lv, jlv, rtol=0, atol=1e-5 * float(np.abs(jlv).max()))
    var = np.abs(rng.normal(size=(64, 21))).astype(np.float32) * 10.0 ** \
        rng.uniform(-8, 1, (64, 21)).astype(np.float32)
    mean = rng.normal(size=(64, 21)).astype(np.float32)
    ours = encoding.integrated_pos_enc(_t(mean), _t(var), 0, 12)
    ref = jenc.integrated_pos_enc(jnp.asarray(mean), jnp.asarray(var), 0, 12)
    assert ours.shape == (64, 504)
    _close(ours, ref, rtol=1e-5, atol=1e-5)
    assert float((ours == 0).float().mean()) > 0.1   # underflowed features


@pytest.mark.parametrize("shape,sub,sym", [("icosahedron", 2, True),
                                           ("icosahedron", 1, False),
                                           ("octahedron", 2, True)])
def test_generate_basis_is_bit_for_bit(shape, sub, sym):
    ours = encoding.generate_basis(shape, sub, sym)
    ref = jenc.generate_basis(shape, sub, sym)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    if (shape, sub, sym) == ("icosahedron", 2, True):
        assert ours.shape == (3, 21)


def _histogram(rng, b=12, n=10):
    """Sorted edges (B, N+1) in [0, 1] and weights summing to 1, with empty
    intervals; row 0 puts all its mass in the two edge intervals and row 1
    repeats edges."""
    t = np.sort(rng.uniform(0, 1, (b, n + 1)), -1).astype(np.float32)
    t[:, 0], t[:, -1] = 0.0, 1.0
    w = rng.uniform(0, 1, (b, n)).astype(np.float32)
    w[w < 0.3] = 0.0
    w[0] = 0.0
    w[0, 0] = w[0, -1] = 0.5
    t[1, 3:6] = t[1, 3]
    w = (w / np.maximum(w.sum(-1, keepdims=True), 1e-9)).astype(np.float32)
    return t, w


def test_dilation_and_cdf_match_jax():
    """max_dilate_weights (renormalized, at the model's dilations),
    weight_to_pdf / pdf_to_weight, integrate_weights and the s-space
    warps."""
    t, w = _histogram(np.random.default_rng(2))
    for dilation in (0.5 / 8 + 0.0025, 0.5 / 64 + 0.0025):
        jt, jw = jmip.max_dilate_weights(jnp.asarray(t), jnp.asarray(w),
                                         dilation, (0.0, 1.0), True)
        tt, tw = mip.max_dilate_weights(_t(t), _t(w), dilation, (0.0, 1.0),
                                        True)
        assert tt.shape == (12, 31)
        _close(tt, jt)
        _close(tw, jw)
    _close(mip.integrate_weights(_t(w)), jmip.integrate_weights(
        jnp.asarray(w)))
    t_to_s, s_to_t = mip.construct_ray_warps(0.2, 3.0)
    jt_to_s, js_to_t = jmip.construct_ray_warps(0.2, 3.0)
    _close(s_to_t(_t(t)), js_to_t(jnp.asarray(t)))
    _close(t_to_s(s_to_t(_t(t))), jt_to_s(js_to_t(jnp.asarray(t))))


def test_sorted_interp_matches_jax_at_ties():
    """The dense masked interpolation at points equal to knots, below the
    first and above the last, and over repeated knots (denom == 0)."""
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0, 1, (6, 9)), -1).astype(np.float32)
    xp[:, 2:5] = xp[:, 2:3]
    fp = np.sort(rng.uniform(0, 3, (6, 9)), -1).astype(np.float32)
    x = np.sort(np.concatenate([rng.uniform(-0.2, 1.2, (6, 8)), xp[:, :4]],
                               -1), -1).astype(np.float32)
    _close(mip.sorted_interp(_t(x), _t(xp), _t(fp)),
           jmip.sorted_interp(jnp.asarray(x), jnp.asarray(xp),
                              jnp.asarray(fp)), rtol=0, atol=0)


@pytest.mark.parametrize("randomized", [False, True])
def test_resampling_matches_jax_with_a_dead_row(randomized, monkeypatch):
    """A proposal level's resampling: max_dilate_weights, the edge slice,
    the annealed logits with the dead-row guard and sample_intervals
    (single jitter, domain [0, 1]), against the JAX model's lines on the
    same histogram. Row 0's sliced weights are set to 0 on both sides, as
    when a ray's whole mass sits in the two edge intervals the slice
    drops: every logit is -inf and the row resamples uniformly."""
    t, w = _histogram(np.random.default_rng(4))
    draws = [np.random.default_rng(5).uniform(size=(12, 1)).astype(
        np.float32)]
    _shared_uniforms(monkeypatch, draws)
    anneal = 10.0 * 0.3 / (9.0 * 0.3 + 1)
    jt, jw = jmip.max_dilate_weights(jnp.asarray(t), jnp.asarray(w),
                                     0.5 / 8 + 0.0025, (0.0, 1.0), True)
    jt, jw = jt[..., 1:-1], jw[..., 1:-1].at[0].set(0.0)
    jlog = jnp.where(jt[..., 1:] > jt[..., :-1], anneal * jnp.log(jw),
                     -jnp.inf)
    dead = jnp.all(jnp.isneginf(jlog), axis=-1, keepdims=True)
    assert bool(dead[0, 0]) and int(dead.sum()) == 1
    jlog = jnp.where(dead, 0.0, jlog)
    ref = jmip.sample_intervals(jt, jlog, 8, randomized,
                                jax.random.PRNGKey(0), single_jitter=True,
                                domain=(0.0, 1.0))
    tt, tw = mip.max_dilate_weights(_t(t), _t(w), 0.5 / 8 + 0.0025,
                                    (0.0, 1.0), True)
    tt, tw = tt[..., 1:-1], tw[..., 1:-1].clone()
    tw[0] = 0.0
    logits = resample_logits(tt, tw, anneal)
    assert torch.all(logits[0] == 0)
    _close(logits, jlog)
    ours = mip.sample_intervals(tt, logits, 8, randomized,
                                single_jitter=True, domain=(0.0, 1.0))
    assert ours.shape == (12, 9) and torch.isfinite(ours).all()
    _close(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("randomized,single_jitter,centred", [
    (False, False, False), (False, False, True), (True, False, False),
    (True, True, False)])
def test_sample_matches_jax(randomized, single_jitter, centred,
                            monkeypatch):
    """mip.sample (invert_cdf and integrate_weights under it) on a
    histogram with empty intervals: evenly spaced, centred, and jittered
    per sample or once per ray, on shared uniforms."""
    t, w = _histogram(np.random.default_rng(13))
    logits = np.where(w > 0, np.log(np.maximum(w, 1e-30)), -np.inf)
    d = 1 if single_jitter else 8
    _shared_uniforms(monkeypatch, [np.random.default_rng(14).uniform(
        size=(12, d)).astype(np.float32)])
    ref = jmip.sample(jnp.asarray(t), jnp.asarray(logits, jnp.float32), 8,
                      randomized, jax.random.PRNGKey(0), single_jitter,
                      centred)
    ours = mip.sample(_t(t), _t(logits.astype(np.float32)), 8, randomized,
                      single_jitter, centred)
    _close(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
@pytest.mark.parametrize("diag", [False, True])
def test_gaussians_match_jax(ray_shape, diag):
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(0.2, 3, (5, 9)), -1).astype(np.float32)
    o, d = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2))
    r = rng.uniform(1e-3, 1e-2, (5, 1)).astype(np.float32)
    ref = jmip.cast_rays_gaussian(*map(jnp.asarray, (t, o, d, r)),
                                  ray_shape, diag)
    ours = mip.cast_rays_gaussian(*map(_t, (t, o, d, r)), ray_shape, diag)
    for a, b in zip(ours, ref):
        _close(a, b, atol=1e-6 * float(np.abs(b).max()))


def _composite_inputs(rng, b=16, s=9):
    """density, tdist, dirs, rgb; ray 0's first density is 1e30, so its
    acc is exactly 1.0 (the tie of max(0, 1 - acc)); ray 1's densities are
    all 0."""
    density = rng.uniform(0, 10, (b, s)).astype(np.float32)
    density[0, 0] = 1e30
    density[1] = 0.0
    t = np.sort(rng.uniform(0.2, 3.0, (b, s + 1)), -1).astype(np.float32)
    return (density, t, rng.normal(size=(b, 3)).astype(np.float32),
            rng.uniform(0, 1, (b, s, 3)).astype(np.float32))


def _jax_composite(density, t, dirs, rgb, opaque, bg=1.0):
    w = jrender.compute_alpha_weights(density, t, dirs, opaque)[0]
    out = jrender.render_mip(rgb, w, t, bg, compute_depth=True)
    return w, out["rgb"], out["acc"], out["depth"]


@pytest.mark.parametrize("opaque", [True, False])
def test_composite_matches_jax(opaque):
    """composite_mip_reference, and composite_mip on CPU tensors, against
    compute_alpha_weights + render_mip: weights, rgb, acc, depth."""
    args = _composite_inputs(np.random.default_rng(7))
    ref = _jax_composite(*map(jnp.asarray, args), opaque)
    if opaque:
        assert float(ref[2][0]) == 1.0
    for fn in (composite_mip_reference, composite_mip):
        out = fn(*map(_t, args), 1.0, opaque)
        for o, r, name in zip(out, ref, ("weights", "rgb", "acc", "depth")):
            _close(o, r, msg=f"{fn.__name__} {name}")


def test_maximum_tie_gradient_is_half():
    """The premise of the plain version's torch.maximum: at acc == 1 its
    gradient is jnp.maximum's 0.5, where torch.clamp gives 1."""
    acc = torch.ones(1, requires_grad=True)
    grads = [torch.autograd.grad(f(1.0 - acc).sum(), acc)[0].item()
             for f in (lambda x: torch.maximum(torch.zeros_like(x), x),
                       lambda x: torch.clamp(x, min=0.0))]
    ref = jax.grad(lambda a: jnp.maximum(0.0, 1.0 - a).sum())(jnp.ones(1))
    assert grads == [-0.5, -1.0] and float(ref[0]) == -0.5


@pytest.mark.parametrize("opaque", [True, False])
def test_composite_gradients_match_jax_vjp(opaque):
    """The Function's gradients (d density, d rgb) for cotangents of all
    four outputs against jax.vjp, the tie ray included; the last density
    takes exactly 0 under the opaque background."""
    rng = np.random.default_rng(8)
    args = _composite_inputs(rng)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((16, 9), (16, 3), (16,), (16,))]
    _, vjp = jax.vjp(lambda d, c: _jax_composite(
        d, jnp.asarray(args[1]), jnp.asarray(args[2]), c, opaque),
        jnp.asarray(args[0]), jnp.asarray(args[3]))
    ref = [np.asarray(r) for r in vjp(tuple(map(jnp.asarray, cots)))]
    density, rgb = _t(args[0]).requires_grad_(), _t(args[3]).requires_grad_()
    out = composite_mip(density, _t(args[1]), _t(args[2]), rgb, 1.0, opaque)
    loss = sum((o * _t(c)).sum() for o, c in zip(out, cots))
    ours = torch.autograd.grad(loss, [density, rgb])
    for o, r in zip(ours, ref):
        _close(o, r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    if opaque:
        assert np.all(ref[0][:, -1] == 0) and torch.all(ours[0][:, -1] == 0)


def test_distortion_loss_matches_jax():
    """The O(S) distortion per ray against JAX's and against the O(S^2)
    formula."""
    t, w = _histogram(np.random.default_rng(9))
    ours = losses.distortion_loss(_t(t), _t(w))
    _close(ours, jlosses.distortion_loss(jnp.asarray(t), jnp.asarray(w)))
    _close(ours, losses.lossfun_distortion(_t(t), _t(w)), rtol=1e-5,
           atol=1e-6)


@pytest.fixture(scope="module")
def mip_pair(tmp_path_factory):
    """The JAX MipNeRF360 at the tiny size, its variables, a batch of 24
    rays with radii, and the port's model loaded from the variables' npz
    (neo360_tpu/utils/io.py:save_variables_npz)."""
    rng = np.random.default_rng(10)
    o = (rng.normal(size=(24, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(24, 3)).astype(np.float32)
    batch = {"rays_o": o, "rays_d": d,
             "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
             "radii": rng.uniform(1e-3, 1e-2, (24, 1)).astype(np.float32),
             "target": rng.uniform(0, 1, (24, 3)).astype(np.float32)}
    model = JMipNeRF360(**TINY)
    variables = jax.jit(lambda r: model.init(
        {"params": jax.random.PRNGKey(0),
         "sampling": jax.random.PRNGKey(1)}, r, 0.5, False, 0.2, 3.0))(
        {k: jnp.asarray(batch[k]) for k in RAY_KEYS})
    path = save_variables_npz(str(tmp_path_factory.mktemp("mip") / "v.npz"),
                              variables)
    port = MipNeRF360(**TINY)
    weights.load_into(port, weights.from_flax_flat(
        weights.load_variables_npz(path)))
    return model, variables, port, batch


def _draws(seed, b=24, levels=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(b, 1)).astype(np.float32)
            for _ in range(levels)]


@pytest.mark.parametrize("randomized,train_frac", [(False, 1.0),
                                                   (True, 0.3)])
def test_model_matches_jax(mip_pair, monkeypatch, randomized, train_frac):
    """Every level's renderings (rgb, acc, depth) and ray history (sdist,
    weights, density, rgb) of 24 rays, deterministic at train_frac 1 (the
    renderer's) and randomized on shared jitter at train_frac 0.3."""
    model, variables, port, batch = mip_pair
    _shared_uniforms(monkeypatch, _draws(11))
    rays_ = {k: jnp.asarray(batch[k]) for k in RAY_KEYS}
    rend, hist = jax.jit(lambda v: model.apply(
        v, rays_, train_frac, randomized, 0.2, 3.0,
        rngs={"sampling": jax.random.PRNGKey(2)}))(variables)
    with torch.no_grad():
        trend, thist = port({k: _t(batch[k]) for k in RAY_KEYS}, train_frac,
                            randomized, 0.2, 3.0)
    for level in range(3):
        for k in ("rgb", "acc", "depth"):
            _close(trend[level][k], rend[level][k], rtol=2e-5, atol=2e-5,
                   msg=f"level {level} {k}")
        for k in ("sdist", "weights", "rgb"):
            _close(thist[level][k], hist[level][k], rtol=2e-5, atol=2e-5,
                   msg=f"level {level} {k}")
        _close(thist[level]["density"], hist[level]["density"], rtol=1e-4,
               atol=1e-5, msg=f"level {level} density")


def test_loss_and_gradients_match_jax(mip_pair, monkeypatch):
    """One training step's loss, sqrt(mse + 1e-6) + interlevel + 0.01
    distortion at step 30,000 (train_frac 0.03), through each CLI's
    make_loss_fn on shared jitter, and the gradient of every parameter
    against jax.value_and_grad."""
    model, variables, port, batch = mip_pair
    draws = _draws(12)
    jq, tq = _shared_uniforms(monkeypatch, draws)
    loss_fn = jcli.make_loss_fn(jpreset("mipnerf360"), model, variables)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(3), jnp.int32(30000))
    assert not jq
    port_loss = cli.make_loss_fn(preset("mipnerf360"), port)
    ours, tmetrics = port_loss({k: _t(v) for k, v in batch.items()}, None,
                               30000)
    assert not tq
    _close(ours, loss, rtol=1e-5, atol=0)
    _close(tmetrics["mse"], metrics["mse"], rtol=1e-5, atol=0)
    names = [k for k, _ in port.named_parameters()]
    tgrads = torch.autograd.grad(ours, list(port.parameters()))
    ref = weights.from_flax_flat(
        {"params/" + "/".join(str(getattr(p, "key", p)) for p in path): v
         for path, v in jax.tree_util.tree_leaves_with_path(grads)})
    assert sorted(ref) == sorted(names)
    for name, g in zip(names, tgrads):
        r = ref[name].numpy()
        _close(g, r, rtol=0, atol=2e-3 * max(float(np.abs(r).max()), 1e-12),
               msg=name)
