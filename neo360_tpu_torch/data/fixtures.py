"""Synthetic scenes (port of neo360_tpu/data/fixtures.py): on disk in the
NERDS360 layout, or in memory.

`make_micro_scene` and `make_multi_scene_root` write what the JAX
package's functions of the same names write, byte for byte (the same PNGs
through PIL and the same pose.json): rgb/, semantic_segmentation_2d/,
nocs_2d/ and pose/pose.json under train/ and val/, poses in
Parallel-Domain axes with a non-zero obj_location, so the disk loaders
(data/nerds360.py, data/nerds360_ae.py) read them unmodified.

`MemoryScenes` serves the same scenes that `make_multi_scene_root` writes to
disk — a shaded sphere under a direction-gradient sky, cameras on a
jittered ring — through the interface of `data.nerds360_ae.NeRDS360AE`
(train, val and test sampling, `sample_train_stage` included), without
image files: pixels are rendered analytically on first use, quantized to 8
bits as the PNGs are, and cached.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE, SceneMeta

SPHERE_RADIUS_FRAC = 0.35  # of camera ring radius
CAR_ID = 5
_PD_FLIP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.float64)
_PD_FLIP_INV = np.linalg.inv(_PD_FLIP)


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


def render_uint8(c2w: np.ndarray, w: int, h: int, focal: float,
                 sphere_radius: float):
    """Analytic render -> (rgb (h, w, 3), car segmentation (h, w), NOCS
    (h, w, 3)), uint8, as the fixture's PNGs hold them."""
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
    seg = np.where(hit, CAR_ID, 0).astype(np.uint8)
    nocs = np.where(hit[..., None], 0.5 + 0.5 * normal, 0.0)
    nocs8 = (np.clip(nocs, 0, 1) * 255).astype(np.uint8)
    return rgb8, seg, nocs8


def render(c2w: np.ndarray, w: int, h: int, focal: float,
           sphere_radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic render -> (rgb (h, w, 3) float in [0, 1] quantized to 8
    bits, sphere-hit mask (h, w) float)."""
    rgb8, seg, _ = render_uint8(c2w, w, h, focal, sphere_radius)
    return rgb8.astype(np.float32) / 255.0, (seg == CAR_ID).astype(
        np.float32)


def _write_split(split_dir: str, c2ws_nerf: np.ndarray, w: int, h: int,
                 focal: float, radius: float, obj_location: np.ndarray):
    from PIL import Image
    for sub in ("rgb", "pose", "semantic_segmentation_2d", "nocs_2d"):
        os.makedirs(os.path.join(split_dir, sub), exist_ok=True)
    transform = {}
    for idx, c2w in enumerate(c2ws_nerf):
        name = f"{idx:05d}"
        rgb8, seg, nocs8 = render_uint8(c2w, w, h, focal,
                                        radius * SPHERE_RADIUS_FRAC)
        for sub, arr in (("rgb", rgb8), ("semantic_segmentation_2d", seg),
                         ("nocs_2d", nocs8)):
            Image.fromarray(arr).save(os.path.join(split_dir, sub,
                                                   name + ".png"))
        # Parallel-Domain axes with obj_location added back: the loader
        # subtracts obj_location and flips to NeRF axes
        c2w_pd = c2w @ _PD_FLIP_INV
        c2w_pd[:3, 3] += obj_location
        transform[name] = c2w_pd.tolist()
    box = radius * SPHERE_RADIUS_FRAC
    pose = {
        "focal": focal,
        "img_size": [w, h],
        "obj_location": obj_location.tolist(),
        "transform": transform,
        "bbox_dimensions": {"obj_0": [[-box] * 3, [box] * 3]},
        "obj_rotations": {"obj_0": np.eye(3).tolist()},
        "obj_translations": {"obj_0": obj_location.tolist()},
    }
    with open(os.path.join(split_dir, "pose", "pose.json"), "w") as f:
        json.dump(pose, f)


def make_micro_scene(root: str, n_train: int = 103, n_val: int = 5,
                     wh: Tuple[int, int] = (40, 30), focal: float = None,
                     radius: float = 8.0, seed: int = 0) -> str:
    """Write one micro scene under `root` (train/: n_train cameras, the
    loaders' 100 train and the rest val; val/: n_val test cameras); returns
    `root`. focal defaults to 1.1 x width, so every ray meets the unit
    sphere after pose normalization, as the NeRF++ background needs."""
    w, h = wh
    if focal is None:
        focal = 1.1 * w
    obj_location = np.array([0.5, 0.3, 0.2])
    _write_split(os.path.join(root, "train"),
                 camera_ring(n_train, radius, seed), w, h, focal, radius,
                 obj_location)
    _write_split(os.path.join(root, "val"),
                 camera_ring(n_val, radius, seed + 1), w, h, focal, radius,
                 obj_location)
    return root


def make_multi_scene_root(root: str, n_scenes: int = 3, **kwargs) -> str:
    """`n_scenes` micro scenes scene_000, ... (camera seeds 100 + s) for
    the few-shot loader."""
    for s in range(n_scenes):
        make_micro_scene(os.path.join(root, f"scene_{s:03d}"),
                         seed=100 + s, **kwargs)
    return root


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
        train, test, scale = self._cams[int(name.rsplit("_", 1)[1])]

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
            train, test, _ = self._cams[int(name.rsplit("_", 1)[1])]
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
