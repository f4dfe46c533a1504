"""In-memory synthetic scenes (numpy port of neo360_tpu/data/fixtures.py
`_camera_ring` / `_render`).

`MemoryScenes` serves the same scenes that `make_multi_scene_root` writes to
disk — a shaded sphere under a direction-gradient sky, cameras on a
jittered ring — with the test-split interface of `data.nerds360_ae.
NeRDS360AE` (`scene_ids`, `num_test_views`, `sample_test`), without image
files: pixels are rendered analytically and quantized to 8 bits as the
PNGs are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from neo360_tpu_torch.data.nerds360_ae import (default_src_views,
                                               full_image_rays, source_stack)

SPHERE_RADIUS_FRAC = 0.35  # of camera ring radius


def _look_at_nerf(position: np.ndarray, target: np.ndarray,
                  up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """OpenGL/NeRF c2w: x right, y up, camera looks down -z."""
    z = position - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, position
    return c2w


def camera_ring(n: int, radius: float, seed: int) -> np.ndarray:
    """n cameras on a jittered upper hemisphere looking at the origin."""
    rng = np.random.default_rng(seed)
    c2ws = []
    for i in range(n):
        az = 2 * np.pi * i / n + rng.uniform(-0.05, 0.05)
        el = np.deg2rad(rng.uniform(15.0, 55.0))
        p = radius * np.array([
            np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
        c2ws.append(_look_at_nerf(p, np.zeros(3)))
    return np.stack(c2ws)


def render(c2w: np.ndarray, w: int, h: int, focal: float,
           sphere_radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic render -> (rgb (h, w, 3) float in [0, 1] quantized to 8
    bits, sphere-hit mask (h, w) float)."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    dirs = np.stack(
        [(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    d_unit = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)

    b = np.sum(d_unit * rays_o, axis=-1)
    c = np.sum(rays_o * rays_o, axis=-1) - sphere_radius ** 2
    disc = b ** 2 - c
    t_hit = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t_hit > 0)

    p = rays_o + t_hit[..., None] * d_unit
    normal = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)
    sky = 0.55 + 0.4 * np.stack(
        [0.5 + 0.5 * d_unit[..., 0], 0.5 + 0.5 * d_unit[..., 1],
         0.5 + 0.5 * d_unit[..., 2]], -1) * np.array([0.4, 0.55, 0.9])
    rgb = np.where(hit[..., None], 0.5 + 0.5 * normal, sky)
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return rgb8.astype(np.float32) / 255.0, hit.astype(np.float32)


class MemoryScenes:
    """Scenes of `make_multi_scene_root(n_scenes=...)` held in memory
    (scene s uses camera seeds 100 + s and 101 + s), test split only."""

    def __init__(self, n_scenes: int = 1, img_wh: Tuple[int, int] = (320, 240),
                 num_src_views: int = 3, n_train: int = 103, n_val: int = 5,
                 radius: float = 8.0):
        self.img_wh = tuple(img_wh)
        self.num_src_views = num_src_views
        self.scene_ids = [f"scene_{s:03d}" for s in range(n_scenes)]
        w = self.img_wh[0]
        self.focal = 1.1 * w
        self.sphere_radius = radius * SPHERE_RADIUS_FRAC
        self._cams = []
        for s in range(n_scenes):
            train = camera_ring(n_train, radius, 100 + s)
            test = camera_ring(n_val, radius, 101 + s)
            # the loader's normalization: 1 / max |t| over the train split
            scale = 1.0 / np.max(np.abs(train[:, :3, 3]))
            self._cams.append((train, test, scale))

    def num_test_views(self, scene_idx: int) -> int:
        return len(self._cams[scene_idx][1])

    def _view(self, c2w: np.ndarray, scale: float):
        w, h = self.img_wh
        rgb, hit = render(c2w, w, h, self.focal, self.sphere_radius)
        norm = c2w.copy()
        norm[:3, 3] *= scale
        return rgb, hit, norm.astype(np.float32)

    def sample_test(self, scene_idx: int, dest_idx: int,
                    src_views: Optional[list] = None) -> Dict[str, np.ndarray]:
        train, test, scale = self._cams[scene_idx]
        w, h = self.img_wh
        src = src_views or default_src_views(self.num_src_views)
        views = [self._view(train[v], scale) for v in src]
        sample = source_stack([v[0] for v in views], [v[2] for v in views],
                              self.focal, np.array([w / 2.0, h / 2.0]))
        rgb, hit, c2w = self._view(test[dest_idx], scale)
        sample.update(full_image_rays(c2w, w, h, self.focal))
        sample["target"] = rgb.reshape(-1, 3)
        sample["instance_mask"] = hit.reshape(-1, 1)
        sample["img_wh"] = np.asarray([w, h])
        return sample
