"""The port's vis_only pieces and disk fixtures against the JAX package,
on the CPU: the spiral poses (`spiral_pose`, `trajectory_360`) and the
few-shot loader's `sample_pose` at 1e-12 (the same float64 numpy
arithmetic), `make_micro_scene` / `make_multi_scene_root` writing the
same bytes, the video and depth writers and the validation grids (equal
arrays: the same numpy and cv2 calls).
"""

import filecmp
import os

import numpy as np
import pytest

from neo360_tpu.data import fixtures as jfix
from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu.train import eval as jeval
from neo360_tpu.utils import io as jio
from neo360_tpu.utils import visualize as jvis
from neo360_tpu_torch.data import fixtures
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE
from neo360_tpu_torch.train import eval as teval
from neo360_tpu_torch.utils import io, visualize

WH = (16, 12)


def test_trajectory_matches_jax():
    rng = np.random.default_rng(0)
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    for p in (0.0, 0.3, 0.99):
        np.testing.assert_allclose(teval.spiral_pose(pose, p),
                                   jeval.spiral_pose(pose, p), rtol=0,
                                   atol=1e-12)
    ours, ref = teval.trajectory_360(pose, 7), jeval.trajectory_360(pose, 7)
    assert ours.shape == (7, 4, 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    assert not np.allclose(ours[0], ours[1])


def test_sample_pose_matches_jax(multi_scene_root):
    """A spiral pose's full-image sample: the test source stack and one
    ray per pixel, as the JAX loader's (radii included)."""
    ours = NeRDS360AE(multi_scene_root, "test", WH, 3)
    ref = JNeRDS360AE(multi_scene_root, "test", WH, 3)
    meta = ours.scene_meta(ours.scene_ids[0])
    pose = teval.trajectory_360(meta.c2w_test[0], 5)[3]
    a, b = ours.sample_pose(0, pose), ref.sample_pose(0, pose)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    test = ours.sample_test(0, 0)
    for k in ("src_imgs", "src_poses", "src_focal", "src_c"):
        np.testing.assert_array_equal(a[k], test[k])


@pytest.mark.parametrize("n_scenes", [1, 2])
def test_fixtures_write_the_jax_bytes(tmp_path, n_scenes):
    """make_multi_scene_root (and so make_micro_scene) writes every file
    the JAX package's writes, byte for byte."""
    kw = dict(wh=(24, 18), n_train=101, n_val=2)
    fixtures.make_multi_scene_root(str(tmp_path / "t"), n_scenes, **kw)
    jfix.make_multi_scene_root(str(tmp_path / "j"), n_scenes, **kw)
    files = []
    for root, _, names in os.walk(tmp_path / "j"):
        files += [os.path.join(root, n) for n in names]
    assert len(files) == n_scenes * (3 * (101 + 2) + 2)
    for path in files:
        other = path.replace(str(tmp_path / "j"), str(tmp_path / "t"), 1)
        assert filecmp.cmp(path, other, shallow=False), path


def test_store_video_and_depth_images(tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.uniform(size=(12, 16, 3)).astype(np.float32)
              for _ in range(3)]
    path = io.store_video(str(tmp_path), frames, name="v.mp4")
    assert os.path.getsize(path) > 0 and path.endswith((".mp4", ".gif"))
    depths = [rng.uniform(0, 3, size=(12, 16)) for _ in range(2)]
    ours = io.store_depth_img(str(tmp_path / "t"), depths)
    ref = jio.store_depth_img(str(tmp_path / "j"), depths)
    for a, b in zip(ours, ref):
        assert filecmp.cmp(a, b, shallow=False)
    np.testing.assert_array_equal(io.visualize_depth(depths[0]),
                                  jio.visualize_depth(depths[0]))
    np.testing.assert_array_equal(io.visualize_depth(depths[0], (0.2, 3.0)),
                                  jio.visualize_depth(depths[0], (0.2, 3.0)))


@pytest.mark.parametrize("keys", [
    ("rgb",), ("rgb", "depth"), ("rgb", "depth", "acc"),
    ("rgb", "fg_rgb", "bg_rgb", "depth"),
    ("rgb", "fg_rgb", "bg_rgb", "fg_acc", "bg_acc")])
def test_build_val_grid_matches_jax(keys):
    """The grid each model's validation outputs give (PixelNeRF: rgb and
    depth; vanilla: rgb, depth, acc; NeO-360: fg / bg with opacities)."""
    rng = np.random.default_rng(2)
    n = WH[0] * WH[1]
    shapes = {"rgb": (n, 3), "fg_rgb": (n, 3), "bg_rgb": (n, 3),
              "depth": (n,), "acc": (n,), "fg_acc": (n,), "bg_acc": (n,)}
    outputs = {k: rng.uniform(size=shapes[k]).astype(np.float32)
               for k in keys}
    target = rng.uniform(size=(WH[1], WH[0], 3)).astype(np.float32)
    np.testing.assert_array_equal(
        visualize.build_val_grid(WH, target, outputs),
        jvis.build_val_grid(WH, target, outputs))
