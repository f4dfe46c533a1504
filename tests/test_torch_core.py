"""Parity of the port's core math (neo360_tpu_torch.core, train.metrics)
with the JAX package on the same numpy inputs.

Tolerances: 1e-5 (relative, with an absolute floor) for float32 core math —
the two frameworks round transcendental functions and reductions in
different orders, a few float32 ulps apart.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu.core import encoding as jenc
from neo360_tpu.core import geometry as jgeo
from neo360_tpu.core import render as jrender
from neo360_tpu.core import sampling as jsamp
from neo360_tpu.core import spherical as jsph
from neo360_tpu.train import metrics as jmetrics
from neo360_tpu_torch.core import encoding, geometry, render, sampling, \
    spherical
from neo360_tpu_torch.train import metrics

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5   # float32 core math, see module docstring


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _poses(rng, n):
    """Random rigid cam2world poses (n, 4, 4)."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    p = np.tile(np.eye(4), (n, 1, 1))
    p[:, :3, :3] = q
    p[:, :3, 3] = rng.normal(size=(n, 3))
    return p.astype(np.float32)


def _rays(rng, b):
    o = (rng.normal(size=(b, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    return o, d


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1, 50, 3)).astype(np.float32)
    poses = _poses(rng, 3)
    _close(geometry.repeat_interleave(_t(pts[0]), 3),
           jgeo.repeat_interleave(jnp.asarray(pts[0]), 3))
    cam = geometry.world2camera(_t(pts), _t(poses), ns=3)
    jcam = jgeo.world2camera(jnp.asarray(pts), jnp.asarray(poses), ns=3)
    _close(cam, jcam)
    _close(geometry.world2camera_viewdirs(_t(pts), _t(poses), ns=3),
           jgeo.world2camera_viewdirs(jnp.asarray(pts), jnp.asarray(poses),
                                      ns=3))
    focal = np.array([[40.0, -40.0]], np.float32)
    c = np.array([[20.0, 15.0]], np.float32)
    _close(geometry.projection(cam, _t(focal), _t(c), 3),
           jgeo.projection(jcam, jnp.asarray(focal), jnp.asarray(c), 3),
           rtol=1e-4)
    side = [[-1.0, 1.0], [-1.0, 1.0], [0.0, 1.0]]
    _close(geometry.get_world_grid(side, [4, 5, 3]),
           jgeo.get_world_grid(side, [4, 5, 3]))


def test_spherical_matches_jax():
    rng = np.random.default_rng(1)
    o, d = _rays(rng, 16)
    _close(spherical.intersect_sphere(_t(o), _t(d)),
           jsph.intersect_sphere(jnp.asarray(o), jnp.asarray(d)))
    depth = np.sort(rng.uniform(0, 1, size=(16, 7)).astype(np.float32))
    _close(spherical.depth2pts_outside(_t(o), _t(d), _t(depth)),
           jsph.depth2pts_outside(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(depth)))


def test_pos_enc_matches_jax():
    x = np.random.default_rng(2).normal(size=(5, 6, 4)).astype(np.float32)
    _close(encoding.pos_enc(_t(x), 0, 10), jenc.pos_enc(jnp.asarray(x), 0, 10),
           rtol=1e-4, atol=1e-4)  # sin of 2^9 x: argument ~1e3, ulp ~6e-5
    _close(encoding.pos_enc(_t(x), 0, 4), jenc.pos_enc(jnp.asarray(x), 0, 4))


@pytest.mark.parametrize("in_sphere", [True, False])
def test_sample_along_rays_nerfpp_matches_jax(in_sphere):
    rng = np.random.default_rng(3)
    o, d = _rays(rng, 8)
    near = np.full((8, 1), 1e-4, np.float32)
    far = np.maximum(np.asarray(jsph.intersect_sphere(jnp.asarray(o),
                                                      jnp.asarray(d))), 2e-4)
    ours = sampling.sample_along_rays_nerfpp(
        _t(o), _t(d), 12, _t(near), _t(far), in_sphere,
        far_uncontracted=3.0)
    ref = jsamp.sample_along_rays_nerfpp(
        jnp.asarray(o), jnp.asarray(d), 12, jnp.asarray(near),
        jnp.asarray(far), False, False, in_sphere, far_uncontracted=3.0)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("descending", [False, True])
def test_sorted_piecewise_constant_pdf_matches_jax(descending):
    """Deterministic inverse-CDF sampling, with zero-weight plateaus (flat
    cdf runs) and all-zero rays (the eps padding), over ascending bins and
    over the descending bins the background branch passes."""
    rng = np.random.default_rng(4)
    b, n = 6, 10
    bins = np.sort(rng.uniform(0, 3, size=(b, n + 1)), -1).astype(np.float32)
    if descending:
        bins = bins[:, ::-1].copy()
    w = rng.uniform(0, 1, size=(b, n)).astype(np.float32)
    w[0, 3:7] = 0.0                      # plateau
    w[1, :] = 0.0                        # all-zero ray
    w[2, ::2] = 0.0                      # alternating plateaus
    for m in (7, 16):
        ours = sampling.sorted_piecewise_constant_pdf(_t(bins), _t(w), m)
        ref = jsamp.sorted_piecewise_constant_pdf(jnp.asarray(bins),
                                                  jnp.asarray(w), m, False)
        _close(ours, ref)


@pytest.mark.parametrize("in_sphere", [True, False])
def test_sample_pdf_nerfpp_matches_jax(in_sphere):
    rng = np.random.default_rng(5)
    o, d = _rays(rng, 8)
    far = np.maximum(np.asarray(jsph.intersect_sphere(jnp.asarray(o),
                                                      jnp.asarray(d))), 2e-4)
    t = np.sort(rng.uniform(0, 1, size=(8, 9)), -1).astype(np.float32)
    if not in_sphere:
        t = t[:, ::-1].copy()
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    w = rng.uniform(0, 1, size=(8, 7)).astype(np.float32) + 0.01
    ours = sampling.sample_pdf_nerfpp(
        _t(mids), _t(w), _t(o), _t(d), _t(t), 5, in_sphere, far=_t(far),
        merge=False)
    ref = jsamp.sample_pdf_nerfpp(
        jnp.asarray(mids), jnp.asarray(w), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t), 5, False, in_sphere, far=jnp.asarray(far),
        merge=False)
    for a, b in zip(ours, ref):
        _close(a, b)


def _composite_inputs(seed, b=16, s=9):
    rng = np.random.default_rng(seed)
    fg_t = np.sort(rng.uniform(0, 1, size=(b, s)), -1).astype(np.float32)
    bg_t = np.sort(rng.uniform(0, 1, size=(b, s)), -1)[:, ::-1].astype(
        np.float32).copy()
    return dict(
        fg_rgb=rng.uniform(size=(b, s, 3)).astype(np.float32),
        fg_sigma=rng.uniform(0, 5, size=(b, s, 1)).astype(np.float32),
        fg_t=fg_t,
        bg_rgb=rng.uniform(size=(b, s, 3)).astype(np.float32),
        bg_sigma=rng.uniform(0, 5, size=(b, s, 1)).astype(np.float32),
        bg_t=bg_t,
        dirs=rng.normal(size=(b, 3)).astype(np.float32),
        far=(fg_t[:, -1:] + rng.uniform(0.01, 0.5, size=(b, 1))).astype(
            np.float32))


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_rendering_nerfpp_matches_jax(white_bkgd):
    x = _composite_inputs(6)
    fg = render.volumetric_rendering_nerfpp(
        _t(x["fg_rgb"]), _t(x["fg_sigma"]), _t(x["fg_t"]), _t(x["dirs"]),
        white_bkgd, True, _t(x["far"]))
    jfg = jrender.volumetric_rendering_nerfpp(
        jnp.asarray(x["fg_rgb"]), jnp.asarray(x["fg_sigma"]),
        jnp.asarray(x["fg_t"]), jnp.asarray(x["dirs"]), white_bkgd, True,
        jnp.asarray(x["far"]))
    bg = render.volumetric_rendering_nerfpp(
        _t(x["bg_rgb"]), _t(x["bg_sigma"]), _t(x["bg_t"]), _t(x["dirs"]),
        white_bkgd, False)
    jbg = jrender.volumetric_rendering_nerfpp(
        jnp.asarray(x["bg_rgb"]), jnp.asarray(x["bg_sigma"]),
        jnp.asarray(x["bg_t"]), jnp.asarray(x["dirs"]), white_bkgd, False)
    for ours, ref in ((fg, jfg), (bg, jbg)):
        for a, b in zip(ours, ref):
            if b is None:
                assert a is None
            else:
                _close(a, b)


def test_composite_nerfpp_cpu_matches_jax_combination():
    """Kernel B's plain version (the CPU path of the wrapper) against the
    JAX renderer's two calls and the caller's fg + bg_lambda * bg."""
    x = _composite_inputs(7, s=11)
    before = render.composite_nerfpp.launches
    out = render.composite_nerfpp(*(_t(x[k]) for k in (
        "fg_rgb", "fg_sigma", "fg_t", "bg_rgb", "bg_sigma", "bg_t", "dirs",
        "far")))
    assert render.composite_nerfpp.launches == before   # no kernel on CPU
    j = {k: jnp.asarray(v) for k, v in x.items()}
    fg_c, fg_a, fg_w, lam, fg_d = jrender.volumetric_rendering_nerfpp(
        j["fg_rgb"], j["fg_sigma"], j["fg_t"], j["dirs"], False, True,
        j["far"])
    bg_c, bg_a, bg_w, _, bg_d = jrender.volumetric_rendering_nerfpp(
        j["bg_rgb"], j["bg_sigma"], j["bg_t"], j["dirs"], False, False)
    ref = {"rgb": fg_c + lam * bg_c, "fg_rgb": fg_c, "bg_rgb": bg_c,
           "fg_acc": fg_a, "bg_acc": bg_a, "fg_weights": fg_w,
           "bg_weights": bg_w, "bg_lambda": lam,
           "depth": fg_d + lam[..., 0] * bg_d, "fg_depth": fg_d}
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k])


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(size=(30, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(
        np.float32)
    _close(metrics.psnr(_t(a), _t(b)), jmetrics.psnr(jnp.asarray(a),
                                                     jnp.asarray(b)))
    _close(metrics.ssim(_t(a), _t(b)), jmetrics.ssim(jnp.asarray(a),
                                                     jnp.asarray(b)))


def test_port_imports_no_jax():
    """The port and its CLI load without jax, flax, optax or neo360_tpu
    (a subprocess: this test process has imported jax already)."""
    code = ("import sys, neo360_tpu_torch, neo360_tpu_torch.cli\n"
            "import neo360_tpu_torch.models.neo360, "
            "neo360_tpu_torch.models.mipnerf360, "
            "neo360_tpu_torch.data.fixtures, neo360_tpu_torch.train.eval\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'neo360_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
