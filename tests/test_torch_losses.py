"""Parity of the port's losses, randomized sampling and learning-rate
schedule with the JAX package, on the same numpy inputs.

Tolerances: 1e-6 relative (plus a 1e-7 absolute floor) for the losses and
the schedule — the same float32 operations, summed in another order;
1e-6 for the sampling, fed the uniforms that `jax.random.uniform` draws
from the same key (torch.Generator draws other numbers), relative and
absolute, the absolute part scaled by the bin range for inverse-CDF
samples: they are bin0 + t * (bin1 - bin0), and the two frameworks' f32
cumsums of the pdf differ in the last bit, which the (background, full
range) bracket carries over the whole range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu.core import sampling as jsamp
from neo360_tpu.core import spherical as jsph
from neo360_tpu.models import neo360 as jneo
from neo360_tpu.ops import losses as jl
from neo360_tpu.train.schedules import nerf_schedule as jnerf_schedule
from neo360_tpu_torch.core import sampling
from neo360_tpu_torch.models import neo360
from neo360_tpu_torch.ops import losses
from neo360_tpu_torch.train.schedules import nerf_schedule

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _hist(rng, b, s, descending=False):
    t = np.sort(rng.uniform(0, 2, size=(b, s)), -1).astype(np.float32)
    if descending:
        t = t[:, ::-1].copy()
    w = rng.uniform(0, 1, size=(b, s)).astype(np.float32)
    w /= w.sum(-1, keepdims=True) * 1.3
    return t, w


def test_mse_psnr_match_jax():
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(size=(50, 3)).astype(np.float32) for _ in range(2))
    mse = losses.img2mse(_t(x), _t(y))
    _close(mse, jl.img2mse(jnp.asarray(x), jnp.asarray(y)))
    _close(losses.mse2psnr(mse), jl.mse2psnr(jnp.asarray(mse.numpy())))


def test_interlevel_primitives_match_jax():
    rng = np.random.default_rng(1)
    t1 = np.sort(rng.uniform(0, 1, size=(8, 10)), -1).astype(np.float32)
    t0 = np.sort(rng.uniform(-0.1, 1.1, size=(8, 7)), -1).astype(np.float32)
    t0[0, 2] = t1[0, 4]                     # a query exactly on an edge
    y1 = rng.uniform(size=(8, 9)).astype(np.float32)
    for a, b in zip(losses._searchsorted(_t(t1), _t(t0)),
                    jl._searchsorted(jnp.asarray(t1), jnp.asarray(t0))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(losses.inner_outer(_t(t0), _t(t1), _t(y1)),
                    jl.inner_outer(jnp.asarray(t0), jnp.asarray(t1),
                                   jnp.asarray(y1))):
        _close(a, b)
    w0 = rng.uniform(size=(8, 6)).astype(np.float32)
    _close(losses.lossfun_outer(_t(t0), _t(w0), _t(t1), _t(y1)),
           jl.lossfun_outer(jnp.asarray(t0), jnp.asarray(w0),
                            jnp.asarray(t1), jnp.asarray(y1)))


def test_distortion_matches_jax_and_the_oracle():
    rng = np.random.default_rng(2)
    t, w = _hist(rng, 16, 13)
    w = w[:, :-1]
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    ours = losses.eff_distloss(_t(w), _t(mids), _t(t[:, 1:] - t[:, :-1]))
    _close(ours, jl.eff_distloss(jnp.asarray(w), jnp.asarray(mids),
                                 jnp.asarray(t[:, 1:] - t[:, :-1])))
    oracle = losses.lossfun_distortion(_t(t), _t(w))
    _close(oracle, jl.lossfun_distortion(jnp.asarray(t), jnp.asarray(w)))
    _close(ours, np.mean(oracle.numpy()), rtol=1e-5)


def _results(rng, b=12, s0=9, s1=7):
    """Fake per-level outputs with the shapes and orderings of the model's
    (ascending fg t, descending bg t)."""
    out = []
    far = rng.uniform(1.0, 2.0, size=(b, 1)).astype(np.float32)
    for s in (s0, s1):
        fg_t, fg_w = _hist(rng, b, s)
        fg_t *= 0.5
        bg_t, bg_w = _hist(rng, b, s, descending=True)
        bg_t /= 2.0
        level = {"fg_tvals": fg_t, "fg_weights": fg_w, "bg_tvals": bg_t,
                 "bg_weights": bg_w, "far": far}
        fg_sd = 0.5 * (fg_t[:, 1:] + fg_t[:, :-1])
        level["fg_sdist"] = np.concatenate(
            [fg_sd, fg_sd[:, -1:] + (fg_sd[:, -1:] - fg_sd[:, -2:-1])], -1)
        level["bg_sdist"] = np.concatenate(
            [0.5 * (bg_t[:, 1:] + bg_t[:, :-1]), bg_t[:, -1:]], -1)
        out.append(level)
    return out


@pytest.mark.parametrize("name", ["neo360_distortion_loss",
                                  "neo360_interlevel_loss"])
def test_neo360_losses_match_jax(name):
    res = _results(np.random.default_rng(3))
    ours = getattr(neo360, name)([{k: _t(v) for k, v in r.items()}
                                  for r in res])
    ref = getattr(jneo, name)([{k: jnp.asarray(v) for k, v in r.items()}
                               for r in res])
    assert float(ours) > 0
    _close(ours, ref)


def test_hist_edges_match_jax():
    res = _results(np.random.default_rng(4))[0]
    _close(neo360._hist_edges_fg(_t(res["fg_tvals"]), _t(res["far"])),
           jneo._hist_edges_fg(jnp.asarray(res["fg_tvals"]),
                               jnp.asarray(res["far"])))
    _close(neo360._hist_edges_bg(_t(res["bg_tvals"])),
           jneo._hist_edges_bg(jnp.asarray(res["bg_tvals"])))


def _rays(rng, b):
    o = (rng.normal(size=(b, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    far = np.maximum(np.asarray(jsph.intersect_sphere(jnp.asarray(o),
                                                      jnp.asarray(d))), 2e-4)
    return o, d, far


@pytest.mark.parametrize("in_sphere", [True, False])
def test_stratified_sampling_matches_jax(in_sphere):
    """Level 0 with stratified jitter: the uniforms `_stratify` draws from
    the key are handed to the port."""
    rng = np.random.default_rng(5)
    o, d, far = _rays(rng, 8)
    near = np.full((8, 1), 1e-4, np.float32)
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (8, 13), dtype=jnp.float32))
    ours = sampling.sample_along_rays_nerfpp(
        _t(o), _t(d), 12, _t(near), _t(far), in_sphere,
        far_uncontracted=3.0, randomized=True, u=_t(u))
    ref = jsamp.sample_along_rays_nerfpp(
        jnp.asarray(o), jnp.asarray(d), 12, jnp.asarray(near),
        jnp.asarray(far), True, False, in_sphere, far_uncontracted=3.0,
        key=key)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _close(a, b, atol=1e-6)


@pytest.mark.parametrize("descending", [False, True])
def test_random_inverse_cdf_matches_jax(descending):
    rng = np.random.default_rng(6)
    bins = np.sort(rng.uniform(0, 3, size=(6, 11)), -1).astype(np.float32)
    if descending:
        bins = bins[:, ::-1].copy()
    w = rng.uniform(0, 1, size=(6, 10)).astype(np.float32)
    w[0, 3:7] = 0.0
    w[1, :] = 0.0
    key = jax.random.PRNGKey(12)
    u = np.asarray(jax.random.uniform(key, (6, 9), dtype=jnp.float32))
    ours = sampling.sorted_piecewise_constant_pdf(_t(bins), _t(w), 9,
                                                  randomized=True, u=_t(u))
    ref = jsamp.sorted_piecewise_constant_pdf(
        jnp.asarray(bins), jnp.asarray(w), 9, True, key)
    _close(ours, ref, atol=1e-6 * 3.0)      # bins span [0, 3]


@pytest.mark.parametrize("in_sphere", [True, False])
def test_random_resampling_matches_jax_and_is_detached(in_sphere):
    rng = np.random.default_rng(7)
    o, d, far = _rays(rng, 8)
    t = np.sort(rng.uniform(0, 1, size=(8, 9)), -1).astype(np.float32)
    if not in_sphere:
        t = t[:, ::-1].copy()
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    w = rng.uniform(0, 1, size=(8, 7)).astype(np.float32) + 0.01
    key = jax.random.PRNGKey(13)
    u = np.asarray(jax.random.uniform(key, (8, 6), dtype=jnp.float32))
    tw = _t(w).requires_grad_()
    ours = sampling.sample_pdf_nerfpp(
        _t(mids), tw, _t(o), _t(d), _t(t), 5, in_sphere, far=_t(far),
        randomized=True, u=_t(u), merge=False)
    ref = jsamp.sample_pdf_nerfpp(
        jnp.asarray(mids), jnp.asarray(w), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t), 5, True, in_sphere, far=jnp.asarray(far), key=key,
        merge=False)
    assert not ours[0].requires_grad
    for a, b in zip(ours, ref):
        _close(a, b, atol=1e-6)


def test_uniforms_come_from_the_generator():
    t = torch.linspace(0, 1, 5).expand(3, 5)
    draw = lambda seed: sampling.stratify(
        t, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    with pytest.raises(ValueError):
        sampling.stratify(t, u=torch.zeros(3, 4))


def test_nerf_schedule_matches_jax():
    ours = nerf_schedule(5e-4, 5e-6, 1000, 250, 0.01)
    ref = jnerf_schedule(5e-4, 5e-6, 1000, 250, 0.01)
    steps = [0, 1, 7, 124, 250, 251, 600, 999, 1000, 5000]
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=RTOL)
    flat = nerf_schedule(1e-3, 1e-4, 100, 0)
    np.testing.assert_allclose(flat(50), float(jnerf_schedule(
        1e-3, 1e-4, 100, 0)(50)), rtol=RTOL)
