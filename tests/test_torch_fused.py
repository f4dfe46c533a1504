"""The port's fused tri-plane and local gathers (ops.interpolate
.triplane_sample / local_sample) against the JAX package, and their
autograd Functions against the unfused calls they replace.

On CPU tensors both run their plain versions (the unfused chains over
`table_sample_reference`); the kernels themselves are held against those
versions on the card by tests/test_torch_kernels.py and chip_smoke.py.

Tolerances: against JAX 1e-5 absolute and relative (float32 folds whose
multiply-adds the two frameworks may order differently); bf16 tables are
compared with JAX sampling the same bf16 values held in float32 tables,
since the port folds in float32 and the JAX code in the table's type.
Gradients against the unfused calls: bit for bit (the same cotangent and
uv reach the same plain scatter).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu.models.neo360 import NeRFTP as JNeRFTP
from neo360_tpu.nn.triplane import index_grid_tables as jindex_grid_tables
from neo360_tpu_torch.core import geometry
from neo360_tpu_torch.data.fixtures import camera_ring
from neo360_tpu_torch.models.neo360 import NeRFTP
from neo360_tpu_torch.ops import interpolate

torch.set_num_threads(1)

TOL = 1e-5
NV, HW, C = 3, (7, 9), 8           # views, plane / latent hw, channels
IMAGE = (18, 14)                   # image (w, h) of the local projection


def _scene(seed, scenes=1, b=5, s=6):
    """World points fg, bg (b, s, 3) of which some lie behind the cameras,
    the source views' poses, focal and centre, and zeros-mode plane maps
    and a border-mode stacked fg/bg local map for `scenes` flat scenes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.6, 1.6, size=(2, b, s, 3)).astype(np.float32)
    poses = camera_ring(NV, 1.4, seed).astype(np.float32)
    focal = np.full(NV, 16.0, np.float32) + rng.uniform(0, 1, NV).astype(
        np.float32)
    c = (np.array([[9.0, 7.0]]) + rng.uniform(-1, 1, (NV, 2))).astype(
        np.float32)
    planes = [rng.normal(size=(NV * scenes,) + HW + (C,)).astype(np.float32)
              for _ in range(3)]
    local = rng.normal(size=(2 * NV * scenes,) + HW + (C,)).astype(
        np.float32)
    return pts[0], pts[1], poses, focal, c, planes, local


def _tables(maps, mode, dtype):
    """(JAX f32 tables holding the values of the port's `dtype` tables,
    the port's tables)."""
    ours = [interpolate.build_corner_table(torch.from_numpy(m), mode,
                                           dtype=dtype) for m in maps]
    return [jnp.asarray(t.float().numpy()) for t in ours], ours


def _behind(cam):
    return bool((cam[..., 2] > 0).any()) and bool((cam[..., 2] < 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scene", [0, 1])
def test_triplane_sample_matches_jax_index_grid_tables(dtype, scene):
    """world2camera + triplane_sample against JAX index_grid_tables on the
    same [fg | bg] world points, scene 1 of two flat scenes at view offset
    3."""
    fg, bg, poses, _, _, planes, _ = _scene(10 + scene, scenes=2)
    jt, tt = _tables(planes, "zeros", dtype)
    pts = np.concatenate([fg, bg], 0)
    ref = jindex_grid_tables(jnp.asarray(pts), jt, HW, jnp.asarray(poses),
                             NV, view_offset=NV * scene,
                             total_views=2 * NV)
    cam = geometry.world2camera(torch.from_numpy(pts).reshape(1, -1, 3),
                                torch.from_numpy(poses), ns=NV)
    assert _behind(cam)
    before = interpolate.triplane_sample.launches
    ours = interpolate.triplane_sample(tt, cam, HW, NV * scene)
    assert interpolate.triplane_sample.launches == before   # no kernel
    assert ours.dtype == torch.float32 and ours.shape == (NV, pts.size // 3,
                                                          C)
    assert float(ours.abs().max()) > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scene", [0, 1])
def test_local_sample_matches_jax_local_feats_pair(dtype, scene):
    """NeRFTP._local_feats_pair (world2camera of [fg | bg] once, then
    local_sample) against the JAX NeRFTP._local_feats_pair on the same
    points, scene 1 of two flat scenes at view offset 6."""
    fg, bg, poses, focal, c, _, local = _scene(20 + scene, scenes=2)
    (jt,), (tt,) = _tables([local], "border", dtype)
    jfg, jbg, jcam = JNeRFTP(num_src_views=NV)._local_feats_pair(
        jnp.asarray(fg), jnp.asarray(bg), jnp.asarray(poses),
        jnp.asarray(focal), jnp.asarray(c), jt, HW, IMAGE,
        view_offset=2 * NV * scene, total_views=4 * NV)
    cam = geometry.world2camera(
        torch.from_numpy(np.concatenate([fg, bg], 0)).reshape(1, -1, 3),
        torch.from_numpy(poses), ns=NV)
    assert _behind(cam)
    model = SimpleNamespace(num_src_views=NV)
    before = interpolate.local_sample.launches
    ofg, obg = NeRFTP._local_feats_pair(
        model, cam, torch.from_numpy(focal), torch.from_numpy(c), tt, HW,
        IMAGE, view_offset=2 * NV * scene)
    assert interpolate.local_sample.launches == before   # no kernel
    m = fg.size // 3
    np.testing.assert_allclose(cam[:, :m].numpy(), np.asarray(jcam),
                               atol=TOL, rtol=TOL)
    for ours, ref in ((ofg, jfg), (obg, jbg)):
        assert ours.shape == (NV, m, C)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)


def _cam_and_tables(seed, scenes=2):
    fg, bg, poses, focal, c, planes, local = _scene(seed, scenes)
    cam = geometry.world2camera(
        torch.from_numpy(np.concatenate([fg, bg], 0)).reshape(1, -1, 3),
        torch.from_numpy(poses), ns=NV)
    plane_t = [interpolate.build_corner_table(torch.from_numpy(m), "zeros")
               for m in planes]
    local_t = interpolate.build_corner_table(torch.from_numpy(local),
                                             "border")
    return cam, torch.from_numpy(focal), torch.from_numpy(c), plane_t, \
        local_t


SCALE = (0.35, 0.41)


def _unfused(cam, focal, c, plane_t, local_t, accs=None, offset=(3, 6)):
    """The unfused chain the fused ops replace: three table_sample calls
    and their sum; the local uv prologue and one table_sample."""
    accs = accs or (None,) * 4
    xz, xy, yz = (interpolate.table_sample(t, uv, HW, "zeros",
                                           view_offset=offset[0],
                                           grad_acc=a)
                  for t, uv, a in zip(plane_t,
                                      interpolate.triplane_uvs(cam), accs))
    loc = interpolate.table_sample(
        local_t, interpolate.local_uv(cam, focal, c, SCALE), HW, "border",
        view_offset=offset[1], grad_acc=accs[3])
    return xz + xy + yz, loc


def _fused(cam, focal, c, plane_t, local_t, accs=None, offset=(3, 6)):
    accs = accs or (None,) * 4
    world = interpolate.triplane_sample(
        plane_t, cam, HW, offset[0],
        grad_acc=None if accs[0] is None else accs[:3])
    loc = interpolate.local_sample(local_t, cam, focal, c, SCALE, HW,
                                   offset[1], grad_acc=accs[3])
    return world, loc


def test_fused_functions_give_the_unfused_gradients_bit_for_bit():
    """CPU: the fused ops' outputs and dense table gradients equal the
    unfused calls' (three table_sample calls and their sum; the local
    prologue and one table_sample) bit for bit in float32."""
    cam, focal, c, plane_t, local_t = _cam_and_tables(30)
    g = torch.Generator().manual_seed(31)
    grads = {}
    for name, fn in (("fused", _fused), ("unfused", _unfused)):
        leaves = [t.clone().requires_grad_() for t in plane_t + [local_t]]
        world, loc = fn(cam, focal, c, leaves[:3], leaves[3])
        if name == "fused":
            cots = (torch.randn(world.shape, generator=g),
                    torch.randn(loc.shape, generator=g))
        grads[name] = (world, loc) + torch.autograd.grad(
            (world, loc), leaves, cots)
    for ours, ref in zip(grads["fused"], grads["unfused"]):
        assert torch.equal(ours, ref)
    assert all(float(t.detach().abs().max()) > 0 for t in grads["fused"])


def test_fused_functions_add_into_grad_acc_bit_for_bit():
    """CPU: given accumulators, the fused ops' backward adds into them
    what the unfused calls add (two calls, bit for bit) and returns None
    for the tables."""
    g = torch.Generator().manual_seed(41)
    accs = {}
    for name, fn in (("fused", _fused), ("unfused", _unfused)):
        cam, focal, c, plane_t, local_t = _cam_and_tables(40)
        leaves = [t.requires_grad_() for t in plane_t + [local_t]]
        acc = [torch.zeros(t.shape) for t in leaves]
        g.manual_seed(41)
        for offset in ((0, 0), (3, 6)):
            world, loc = fn(cam, focal, c, leaves[:3], leaves[3], acc,
                            offset)
            cots = (torch.randn(world.shape, generator=g),
                    torch.randn(loc.shape, generator=g))
            got = torch.autograd.grad((world, loc), leaves, cots,
                                      allow_unused=True)
            assert all(x is None for x in got)
        accs[name] = acc
    for ours, ref in zip(accs["fused"], accs["unfused"]):
        assert torch.equal(ours, ref)
        assert float(ours.abs().max()) > 0


def test_fused_functions_refuse_what_they_do_not_take():
    cam, focal, c, plane_t, local_t = _cam_and_tables(50)
    with pytest.raises(ValueError, match="cam takes no gradient"):
        interpolate.triplane_sample(plane_t, cam.requires_grad_(), HW)
    cam = cam.detach()
    with pytest.raises(ValueError, match="cam takes no gradient"):
        interpolate.local_sample(local_t, cam.requires_grad_(), focal, c,
                                 SCALE, HW)
    cam = cam.detach()
    bad = torch.zeros(plane_t[0].shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="grad_acc"):
        interpolate.triplane_sample(plane_t, cam, HW, grad_acc=(bad,) * 3)
    with pytest.raises(ValueError, match="grad_acc"):
        interpolate.local_sample(local_t, cam, focal, c, SCALE, HW,
                                 grad_acc=torch.zeros(3))
