"""In-memory synthetic scenes (numpy port of neo360_tpu/data/fixtures.py
`_camera_ring` / `_render`).

`MemoryScenes` serves the same scenes that `make_multi_scene_root` writes to
disk — a shaded sphere under a direction-gradient sky, cameras on a
jittered ring — through the interface of `data.nerds360_ae.NeRDS360AE`
(train, val and test sampling, `sample_train_stage` included), without
image files: pixels are rendered analytically on first use, quantized to 8
bits as the PNGs are, and cached.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE, SceneMeta

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


class MemoryScenes(NeRDS360AE):
    """Scenes of `make_multi_scene_root(n_scenes=...)` held in memory
    (scene s uses camera seeds 100 + s and 101 + s); `split` only names the
    split, every sampler works; `sampling` takes NeRDS360AE's optimize,
    finetune_lpips and patch_size."""

    def __init__(self, n_scenes: int = 1, img_wh: Tuple[int, int] = (320, 240),
                 num_src_views: int = 3, n_train: int = 103, n_val: int = 5,
                 radius: float = 8.0, split: str = "test",
                 ray_batch_size: int = 500, **sampling):
        self.n_scenes = n_scenes
        super().__init__("", split, img_wh, num_src_views, ray_batch_size,
                         **sampling)
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

    def _scene_ids(self):
        return [f"scene_{s:03d}" for s in range(self.n_scenes)]

    def scene_meta(self, name: str) -> SceneMeta:
        if name in self._meta_cache:
            return self._meta_cache[name]
        train, test, scale = self._cams[self.scene_ids.index(name)]

        def normalized(c2ws):
            out = c2ws.copy()
            out[:, :3, 3] *= scale
            return out.astype(np.float32)

        w, h = self.img_wh
        files = lambda n: [f"{i:05d}.png" for i in range(n)]
        meta = SceneMeta(
            name=name, c2w_train=normalized(train[:100]),
            c2w_val_tail=normalized(train[100:]), c2w_test=normalized(test),
            focal=self.focal, c=np.array([w / 2.0, h / 2.0], np.float32),
            img_files_train=files(len(train)), img_files_test=files(len(test)))
        self._meta_cache[name] = meta
        return meta

    def _render(self, name: str, split_dir: str, img_file: str):
        key = (name, split_dir, img_file)
        if key not in self._img_cache:
            train, test, _ = self._cams[self.scene_ids.index(name)]
            c2w = (train if split_dir == "train" else test)[
                int(img_file.split(".")[0])]
            w, h = self.img_wh
            self._img_cache[key] = render(c2w, w, h, self.focal,
                                          self.sphere_radius)
        return self._img_cache[key]

    def _load_rgb(self, name: str, split_dir: str, img_file: str):
        return self._render(name, split_dir, img_file)[0]

    def _load_car_mask(self, name: str, split_dir: str, img_file: str):
        return self._render(name, split_dir, img_file)[1]
