"""The port's counterparts of the JAX package's helper functions that no
CLI path calls, against the JAX functions on the same numpy inputs:
grid_sample_2d (both routes: the plain four-corner version that serves
CPU tensors and that kernel G repeats on the card, and the corner-table
design of PixelNeRF's encode, one table and one `table_sample`, here
through its plain version) and the plain version of its image gradient
(kernel G'), in_bounds_mask, resize_bilinear_align_corners, homography_warp, volume_rendering_volsdf,
the core/rays.py helpers, charbonnier_loss, the pose jitter, the nearest
views, train_iterator, evaluate_images / save_eval_artifacts and the
writers under them, the visualization arrays, the semantic colours, the
blender export, and the profiling trace with a span in it.

Tolerances:
- grid_sample_2d and its gradient with respect to the image, and
  homography_warp: 1e-5 relative and absolute (the same float32 lerp
  weights; the table route folds the four corners in another order);
- resize_bilinear_align_corners: 1e-6 in float32 and in bfloat16 (two
  matrix products in the image's dtype on both sides);
- volume_rendering_volsdf, the ray helpers and charbonnier_loss: 1e-6;
- evaluate_images' summary: 1e-5 (PSNR / SSIM of the same images);
- everything numpy (poses, nearest ids, visual arrays, semantic colours,
  the blender json, written files): exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo360_tpu.core import geometry as jgeo
from neo360_tpu.core import rays as jrays
from neo360_tpu.core import render as jrender
from neo360_tpu.data import blender_export as jblender
from neo360_tpu.data import nerds360_ae as jae
from neo360_tpu.data import poses as jposes
from neo360_tpu.ops import interpolate as jinterp
from neo360_tpu.ops import losses as jlosses
from neo360_tpu.train import eval as jeval
from neo360_tpu.train import pipeline as jpipeline
from neo360_tpu.utils import io as jio
from neo360_tpu.utils import semantic_labels as jlabels
from neo360_tpu.utils import visualize as jvis
from neo360_tpu_torch.core import geometry, rays, render
from neo360_tpu_torch.data import blender_export, nerds360_ae, poses
from neo360_tpu_torch.ops import interpolate, losses
from neo360_tpu_torch.train import eval as teval
from neo360_tpu_torch.train import pipeline, profiling
from neo360_tpu_torch.utils import io, semantic_labels, visualize

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(ours, ref, tol):
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else ours
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# --- grid_sample_2d -------------------------------------------------------

def _tables_route(image, uv, padding_mode):
    """The corner-table design of PixelNeRF's encode (one
    `build_corner_table`, one `table_sample`) computing grid_sample_2d,
    here through its plain version. Float32 out."""
    table = interpolate.build_corner_table(image, padding_mode)
    return interpolate.table_sample(table, uv, tuple(image.shape[1:3]),
                                    padding_mode, torch.float32)


ROUTES = {"plain": interpolate.grid_sample_2d, "tables": _tables_route}


def _grid_case(seed, b=2, h=7, w=9, c=3, n=300, nan=True):
    """An image and uv spread over [-1.5, 1.5] with the corners, far
    points and (with `nan`) non-finite points among them."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(b, h, w, c)).astype(np.float32)
    uv = rng.uniform(-1.5, 1.5, size=(b, n, 2)).astype(np.float32)
    special = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0], [5, 0], [0, -5],
               [1e30, 0.5], [-1e30, -1e30], [1.0000001, 0.2]]
    if nan:
        special += [[np.inf, 0.0], [0.0, -np.inf], [np.nan, 0.3],
                    [0.1, np.nan]]
    uv[:, :len(special)] = np.asarray(special, np.float32)
    return image, uv


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [1, 3, 32, 512, 1100])
def test_grid_sample_2d_matches_jax(route, mode, c):
    """Both routes of the port against JAX's grid_sample_2d, C = 1, 3, 32,
    512 and 1100, with corners, far and non-finite points (NaN gives NaN
    in border mode and 0 in zeros mode on both sides)."""
    image, uv = _grid_case(c, c=c, n=120 if c > 100 else 300)
    ref = jinterp.grid_sample_2d(jnp.asarray(image), jnp.asarray(uv), mode)
    out = ROUTES[route](_t(image), _t(uv), mode)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_grid_sample_2d_bf16_image_matches_jax(route):
    """A bf16 image samples to float32, as JAX promotes it."""
    image, uv = _grid_case(5, c=8, nan=False)
    image = jnp.asarray(image, jnp.bfloat16)
    ref = jinterp.grid_sample_2d(image, jnp.asarray(uv), "zeros")
    out = ROUTES[route](_t(np.asarray(image.astype(jnp.float32))).to(
        torch.bfloat16), _t(uv), "zeros")
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    _close(out, ref, 1e-5)


def test_grid_sample_2d_bf16_image_border_non_finite_matches_jax():
    """A bf16 image in border mode with infinite and NaN points: the plain
    route gives JAX's float32 values, NaN where JAX has NaN."""
    image, uv = _grid_case(6, c=5)
    image = jnp.asarray(image, jnp.bfloat16)
    ref = np.asarray(jinterp.grid_sample_2d(image, jnp.asarray(uv),
                                            "border"))
    out = interpolate.grid_sample_2d(_t(np.asarray(image.astype(
        jnp.float32))).to(torch.bfloat16), _t(uv), "border")
    assert out.dtype == torch.float32 and np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_sample_2d_backward_reference_matches_jax(mode, dtype):
    """The plain version of kernel G' (the image gradient, index_add_ in
    f32, rounded once to the image's type) against jax.grad of the JAX
    function on a float32 image, with corners and far points; in zeros
    mode non-finite points add nothing on both sides."""
    image, uv = _grid_case(10, c=6, nan=mode == "zeros")
    cot = np.random.default_rng(11).normal(size=(2, 300, 6)).astype(
        np.float32)
    ref = jax.grad(lambda im: jnp.sum(jinterp.grid_sample_2d(
        im, jnp.asarray(uv), mode) * cot))(jnp.asarray(image))
    out = interpolate.grid_sample_2d_backward(_t(cot), _t(uv), image.shape,
                                              dtype, mode)
    assert out.dtype == dtype and out.shape == image.shape
    # bf16: one rounding of the float32 sum, at most 2^-8 relative
    _close(out.float(), np.asarray(ref, np.float32),
           1e-5 if dtype == torch.float32 else 2.0 ** -8)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample_2d_image_grad_matches_jax(route, mode):
    """d(sum(out * cot)) / d image against jax.grad, with corners and far
    points (the table route: kernel A''s plain version and the corner
    table's transpose)."""
    image, uv = _grid_case(7, c=5, nan=False)
    cot = np.random.default_rng(8).normal(size=(2, 300, 5)).astype(
        np.float32)
    ref = jax.grad(lambda im: jnp.sum(jinterp.grid_sample_2d(
        im, jnp.asarray(uv), mode) * cot))(jnp.asarray(image))
    im = _t(image).requires_grad_()
    (ROUTES[route](im, _t(uv), mode) * _t(cot)).sum().backward()
    _close(im.grad, ref, 1e-5)


def test_grid_sample_2d_uv_takes_no_gradient():
    image, uv = _grid_case(9, nan=False)
    with pytest.raises(ValueError, match="uv takes no gradient"):
        interpolate.grid_sample_2d(_t(image), _t(uv).requires_grad_())
    with pytest.raises(ValueError, match="padding_mode"):
        interpolate.grid_sample_2d(_t(image), _t(uv), "reflection")


def test_in_bounds_mask_matches_jax():
    _, uv = _grid_case(10)
    ref = np.asarray(jinterp.in_bounds_mask(jnp.asarray(uv)))
    np.testing.assert_array_equal(interpolate.in_bounds_mask(_t(uv)).numpy(),
                                  ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_hw", [((2, 5, 7, 3), (11, 13)),
                                          ((6, 9, 4), (3, 2)),
                                          ((1, 4, 4, 2), (1, 6)),
                                          ((3, 3, 2), (3, 3))])
def test_resize_bilinear_align_corners_matches_jax(dtype, shape, out_hw):
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jinterp.resize_bilinear_align_corners(jx, out_hw)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    out = interpolate.resize_bilinear_align_corners(tx, out_hw)
    assert out.dtype == tx.dtype and out.shape == ref.shape
    _close(out, ref.astype(jnp.float32), 1e-6)


# --- homography_warp ------------------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_homography_warp_matches_jax(route, monkeypatch):
    """A non-trivial projection (rotation, translation, points behind the
    source camera, and a column on z = 0 that samples 0), both routes."""
    monkeypatch.setattr(interpolate, "grid_sample_2d", ROUTES[route])
    rng = np.random.default_rng(12)
    feat = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    proj = np.zeros((2, 3, 4), np.float32)
    proj[:, :, :3] = np.eye(3) + rng.normal(size=(2, 3, 3)) * 0.05
    proj[:, :, 3] = rng.normal(size=(2, 3)) * 0.5
    proj[1, 2] = [1.0, 0.0, -2.0, 0.0]      # z = x - 2: column x = 2 on z = 0
    depths = rng.uniform(0.5, 3.0, size=(2, 4)).astype(np.float32)
    ref = jgeo.homography_warp(jnp.asarray(feat), jnp.asarray(proj),
                               jnp.asarray(depths))
    out = geometry.homography_warp(_t(feat), _t(proj), _t(depths))
    assert out.shape == ref.shape == (2, 4, 6, 8, 5)
    _close(out, ref, 1e-5)
    assert float(out[1, :, :, 2].abs().max()) == 0.0


def test_homography_warp_more_depths_than_channels_matches_jax():
    """3 channels at 9 depths: the points are depth-major (all pixels of
    depth 0, then of depth 1, ...), the layout kernel G's groups walk and
    G''s runs merge along a row."""
    rng = np.random.default_rng(13)
    feat = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    proj = np.zeros((2, 3, 4), np.float32)
    proj[:, :, :3] = np.eye(3) + rng.normal(size=(2, 3, 3)) * 0.03
    proj[:, :, 3] = rng.normal(size=(2, 3)) * 0.3
    depths = np.sort(rng.uniform(0.5, 3.0, size=(2, 9)), -1).astype(
        np.float32)
    ref = jgeo.homography_warp(jnp.asarray(feat), jnp.asarray(proj),
                               jnp.asarray(depths))
    out = geometry.homography_warp(_t(feat), _t(proj), _t(depths))
    assert out.shape == ref.shape == (2, 9, 5, 7, 3)
    _close(out, ref, 1e-5)


def test_homography_warp_identity():
    """The identity projection reproduces the source features at every
    depth (tests/test_geometry.py's identity case)."""
    feat = np.random.default_rng(0).standard_normal((1, 6, 8, 4)).astype(
        np.float32)
    out = geometry.homography_warp(_t(feat), torch.eye(3, 4)[None],
                                   torch.tensor([[1.0, 2.0]]))
    assert out.shape == (1, 2, 6, 8, 4)
    for d in range(2):
        _close(out[0, d], feat[0], 1e-5)


# --- render, rays, losses -------------------------------------------------

@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("density_rank", [2, 3])
def test_volume_rendering_volsdf_matches_jax(white_bkgd, density_rank):
    rng = np.random.default_rng(13)
    b, s = 16, 12
    rgb = rng.uniform(size=(b, s, 3)).astype(np.float32)
    density = rng.uniform(0, 5, size=(b, s) + (1,) * (density_rank - 2))
    density = density.astype(np.float32)
    t = np.sort(rng.uniform(0.1, 4.0, size=(b, s)), -1).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    ref = jrender.volume_rendering_volsdf(*map(jnp.asarray, (rgb, density,
                                                             t, dirs)),
                                          white_bkgd)
    out = render.volume_rendering_volsdf(*map(_t, (rgb, density, t, dirs)),
                                         white_bkgd)
    for o, r in zip(out, ref):
        _close(o, r, 1e-6)


def test_ray_helpers_match_jax():
    rng = np.random.default_rng(14)
    o = (rng.normal(size=(40, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d[0] = [0.0, 0.5, -1.0]        # an axis-parallel ray (d = 0 on x)
    for ours, ref in zip(rays.ndc_rays(24, 32, 30.0, 1.0, _t(o), _t(d)),
                         jrays.ndc_rays(24, 32, 30.0, 1.0, jnp.asarray(o),
                                        jnp.asarray(d))):
        _close(ours, ref, 1e-6)
    box = ([-0.5, -0.4, -0.3], [0.6, 0.5, 0.4])
    o_out = o * 5.0
    for ours, ref in zip(rays.ray_aabb_intersection(_t(o_out), _t(d), *box),
                         jrays.ray_aabb_intersection(jnp.asarray(o_out),
                                                     jnp.asarray(d), *box)):
        _close(ours, ref, 1e-6)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3, 3)))
    args = (q.astype(np.float32),
            rng.normal(size=(3, 3)).astype(np.float32) * 0.3,
            rng.uniform(0.2, 0.6, size=(3, 3)).astype(np.float32))
    for ours, ref in zip(rays.sample_rays_in_bbox(_t(o_out), _t(d),
                                                  *map(_t, args)),
                         jrays.sample_rays_in_bbox(
                             jnp.asarray(o_out), jnp.asarray(d),
                             *map(jnp.asarray, args))):
        _close(ours, ref, 1e-6)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = q[0]
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    for ours, ref in zip(rays.get_rays_mvs(6, 8, 7.0, _t(c2w)),
                         jrays.get_rays_mvs(6, 8, 7.0, jnp.asarray(c2w))):
        _close(ours, ref, 1e-6)
    np.testing.assert_array_equal(rays.convert_pose_pd_to_nerf(c2w),
                                  jrays.convert_pose_pd_to_nerf(c2w))
    np.testing.assert_array_equal(poses.convert_pose_pd_to_nerf(c2w),
                                  jrays.convert_pose_pd_to_nerf(c2w))
    np.testing.assert_array_equal(rays.opencv_to_opengl(c2w),
                                  jrays.opencv_to_opengl(c2w))


def test_get_rays_segmented_matches_jax():
    rng = np.random.default_rng(15)
    h, w = 6, 8
    masks = (rng.uniform(size=(h, w, 2)) > 0.5).astype(np.float32)
    o = rng.normal(size=(h * w, 3)).astype(np.float32)
    d = rng.normal(size=(h * w, 3)).astype(np.float32)
    ours = rays.get_rays_segmented(masks, [7, 3], o, d, w, h, 5,
                                   np.random.default_rng(1))
    ref = jrays.get_rays_segmented(masks, [7, 3], o, d, w, h, 5,
                                   np.random.default_rng(1))
    assert ours[2] == ref[2]
    np.testing.assert_array_equal(ours[3], ref[3])
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(a, b)


def test_charbonnier_loss_matches_jax():
    rng = np.random.default_rng(16)
    x, y = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    for eps in (1e-3, 0.1):
        _close(losses.charbonnier_loss(_t(x), _t(y), eps),
               jlosses.charbonnier_loss(jnp.asarray(x), jnp.asarray(y), eps),
               1e-6)


# --- host numpy -----------------------------------------------------------

def test_pose_jitter_matches_jax():
    """The same generator gives the same draws and poses."""
    np.testing.assert_array_equal(
        poses.get_rotation_matrix(10.0, np.random.default_rng(3)),
        jposes.get_rotation_matrix(10.0, np.random.default_rng(3)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.3, -0.1, 0.9]
    for dtype in (np.float32, np.float64):
        ours = poses.rot_from_origin(c2w.astype(dtype)[:3], 15.0,
                                     np.random.default_rng(4))
        ref = jposes.rot_from_origin(c2w.astype(dtype)[:3], 15.0,
                                     np.random.default_rng(4))
        assert ours.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("method", ["matrix", "vector", "dist"])
@pytest.mark.parametrize("tar_id", [-1, 2])
def test_get_nearest_pose_ids_matches_jax(method, tar_id):
    rng = np.random.default_rng(17)
    ref_poses = np.tile(np.eye(4), (9, 1, 1))
    q, _ = np.linalg.qr(rng.normal(size=(9, 3, 3)))
    ref_poses[:, :3, :3] = q
    ref_poses[:, :3, 3] = rng.normal(size=(9, 3))
    tar = ref_poses[2].copy()
    kw = dict(num_select=4, tar_id=tar_id, angular_dist_method=method,
              scene_center=(0.1, 0.0, -0.1))
    np.testing.assert_array_equal(
        nerds360_ae.get_nearest_pose_ids(tar, ref_poses, **kw),
        jae.get_nearest_pose_ids(tar, ref_poses, **kw))
    with pytest.raises(ValueError):
        nerds360_ae.get_nearest_pose_ids(tar, ref_poses,
                                         angular_dist_method="other")


def test_train_iterator_matches_jax():
    class Draws:
        def sample_train(self, rng):
            return rng.integers(0, 1000, size=4)

    ours, ref = pipeline.train_iterator(Draws(), 5), \
        jpipeline.train_iterator(Draws(), 5)
    for _ in range(3):
        np.testing.assert_array_equal(next(ours), next(ref))


def _views(n=3, h=16, w=20, seed=18):
    rng = np.random.default_rng(seed)
    samples, renders = [], []
    for i in range(n):
        target = rng.uniform(size=(h * w, 3)).astype(np.float32)
        sample = {"target": target}
        if i != 1:                 # view 1 has no instance mask
            mask = np.zeros((h * w, 1), np.float32)
            mask[45:130] = 1.0
            sample["instance_mask"] = mask
        samples.append(sample)
        renders.append({
            "rgb": np.clip(target + rng.normal(size=target.shape) * 0.05,
                           0, 1).astype(np.float32),
            "depth": rng.uniform(0.5, 2.0, size=(h * w,)).astype(
                np.float32)})
    return samples, renders


def test_evaluate_images_and_artifacts_match_jax(tmp_path):
    samples, renders = _views()
    img_wh = (20, 16)
    jres = jeval.evaluate_images(
        lambda s: renders[next(i for i, x in enumerate(samples)
                               if x is s)], samples, img_wh)
    it = iter(renders)
    res = teval.evaluate_images(
        lambda s: {k: _t(v) for k, v in next(it).items()}, samples, img_wh)
    ref, ours = jres.summary(), res.summary()
    assert sorted(ours) == sorted(ref) == ["psnr", "psnr_obj", "ssim"]
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5)
    assert len(res.psnr_obj) == len(jres.psnr_obj) == 2
    for name in ("rgbs", "depths", "targets"):
        for a, b in zip(getattr(res, name), getattr(jres, name)):
            np.testing.assert_array_equal(a, b)

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsum = jeval.save_eval_artifacts(jres, str(jdir), str(jdir / "r.json"),
                                     video=True)
    tsum = teval.save_eval_artifacts(res, str(tdir), str(tdir / "r.json"),
                                     video=True)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for k in jsum:
        np.testing.assert_allclose(tsum[k], jsum[k], rtol=1e-5)
    for name in sorted(os.listdir(jdir)):
        if name.endswith((".jpg", ".npz")):
            a, b = (jdir / name).read_bytes(), (tdir / name).read_bytes()
            if name.endswith(".jpg"):
                assert a == b, name
            else:
                with np.load(jdir / name) as x, np.load(tdir / name) as y:
                    np.testing.assert_array_equal(x["depth"], y["depth"])
    with open(jdir / "r.json") as f, open(tdir / "r.json") as g:
        jj, tj = json.load(f), json.load(g)
    assert sorted(jj) == sorted(tj)
    for k in jj:
        np.testing.assert_allclose(tj[k]["mean"], jj[k]["mean"], rtol=1e-5)


def test_writers_match_jax(tmp_path):
    _, renders = _views(2, seed=19)
    rgbs = [r["rgb"].reshape(16, 20, 3) for r in renders]
    depths = [r["depth"].reshape(16, 20) for r in renders]
    ours = io.store_image(str(tmp_path / "p"), rgbs, "img")
    ref = jio.store_image(str(tmp_path / "j"), rgbs, "img")
    ours += io.store_depth_raw(str(tmp_path / "p"), depths)
    ref += jio.store_depth_raw(str(tmp_path / "j"), depths)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        if a.endswith(".jpg"):
            assert open(a, "rb").read() == open(b, "rb").read()
        else:
            with np.load(a) as x, np.load(b) as y:
                np.testing.assert_array_equal(x["depth"], y["depth"])


def test_visual_arrays_match_jax():
    rng = np.random.default_rng(20)
    w, h = 8, 6
    img = lambda: rng.uniform(-0.2, 1.2, size=(h * w, 3)).astype(np.float32)
    target, rgb, nocs_gt, nocs = img(), img(), img(), img()
    acc = rng.uniform(size=(h * w,)).astype(np.float32)
    depth = rng.uniform(0.5, 2.0, size=(h, w)).astype(np.float32)
    cases = [
        ("visualize_val_rgb", ((w, h), target, rgb)),
        ("visualize_val_opacity", ((w, h), rgb, acc)),
        ("visualize_val_rgb_opacity_nocs", ((w, h), target, rgb, acc,
                                            nocs_gt, nocs)),
        ("depth_normals", (depth,)),
        ("visualize_val_rgb_opa_depth_normals", ((w, h), target, rgb, acc,
                                                 depth)),
        ("depth_to_points", (depth, np.eye(4), 10.0, 1.5)),
        ("camera_frustum_lines", (np.eye(4), 10.0, (w, h), 0.2)),
        ("look_at_pose", (np.array([1.0, 0.5, -2.0]), np.zeros(3))),
        ("sphere_wireframe", (1.5, 4, 6, 8)),
        ("ray_segments", (np.eye(4), 10.0, (w, h), 7, 0.1, 3.0, 2)),
    ]
    for name, args in cases:
        ours, ref = getattr(visualize, name)(*args), getattr(jvis, name)(
            *args)
        for a, b in zip(*((ours, ref) if isinstance(ref, tuple)
                          else ((ours,), (ref,)))):
            np.testing.assert_array_equal(a, b, err_msg=name)
    c2ws = [jvis.look_at_pose(np.array(p, float), np.zeros(3))
            for p in ([1, 0.2, 1], [-1, 0.3, 1], [0, 0.4, -1.5])]
    frustums = [jvis.camera_frustum_lines(c, 20.0, (16, 12)) for c in c2ws]
    for a, b in zip(visualize.merge_frustums(frustums),
                    jvis.merge_frustums(frustums)):
        np.testing.assert_array_equal(a, b)
    ours = visualize.pose_sphere_geometry(c2ws, 20.0, (16, 12), 2, 8)
    ref = jvis.pose_sphere_geometry(c2ws, 20.0, (16, 12), 2, 8)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for viewer in (lambda: visualize.show_poses_open3d(c2ws, 20.0, (16, 12)),
                   lambda: visualize.show_scene_open3d([depth])):
        with pytest.raises(ImportError, match="open3d"):
            viewer()


def test_semantic_labels_match_jax():
    assert semantic_labels.LABELS == [
        semantic_labels.Label(*(getattr(l, f) for f in (
            "name", "id", "cuboid_id", "is_thing", "color")))
        for l in jlabels.LABELS]
    assert (semantic_labels.CAR_ID, semantic_labels.ROAD_ID) == \
        (jlabels.CAR_ID, jlabels.ROAD_ID) == (5, 24)
    assert sorted(semantic_labels.NAME_TO_LABEL) == sorted(
        jlabels.NAME_TO_LABEL)
    seg = np.random.default_rng(21).integers(-2, 46, size=(9, 11))
    out = semantic_labels.colorize_semantic(seg)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, jlabels.colorize_semantic(seg))


@pytest.mark.parametrize("split", ["train", "val"])
def test_blender_export_matches_jax(micro_scene, tmp_path, split):
    """transforms_{split}.json of tests/test_utils.py's micro scene,
    written by both packages, byte for byte."""
    ours = blender_export.export_transforms(micro_scene, split,
                                            str(tmp_path / "p.json"))
    ref = jblender.export_transforms(micro_scene, split,
                                     str(tmp_path / "j.json"))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    with open(ours) as f:
        data = json.load(f)
    assert len(data["frames"]) == (103 if split == "train" else 5)
    assert blender_export.focal2fov(35.0, 40) == jblender.focal2fov(35.0, 40)
    if split == "train":     # the default path, as the JAX test writes it
        assert blender_export.export_transforms(micro_scene) == \
            os.path.join(micro_scene, "transforms_train.json")


# --- profiling ------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("helpers_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "helpers_span"]
    assert spans and spans[0].get("cat") == "user_annotation"
