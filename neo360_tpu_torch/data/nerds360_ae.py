"""NERDS360_AE few-shot scenes, test split (port of
neo360_tpu/data/nerds360_ae.py:57-240, 255-288, 417-489).

A test sample is one full image of a scene's val/ directory (poses at the
train split's scale) with the fixed source stack [0, 15, 38, 52, 70]
(3 views: [0, 38, 44]) from the train split; source images are normalized
to [-1, 1]. Outputs are numpy. PIL (and cv2, for the instance masks) are
imported only inside the image readers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from neo360_tpu_torch.data import poses as pose_io

CAR_SEMANTIC_ID = 5
SRC_VIEWS_3 = [0, 38, 44]
SRC_VIEWS_5_TEST = [0, 15, 38, 52, 70]


@dataclass
class SceneMeta:
    name: str
    c2w_train: np.ndarray          # (<=100, 4, 4) normalized
    c2w_test: np.ndarray           # val/ directory cameras (train scale)
    focal: float                   # scaled to img_wh
    c: np.ndarray                  # (2,) principal point at img_wh
    img_files_train: List[str]
    img_files_test: List[str]


def rays_at_pixels(c2w: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                   w: int, h: int, focal: float):
    """Rays through pixel corners (no +0.5) of one camera: rays_o,
    viewdirs, rays_d, each (N, 3) float32."""
    dirs = np.stack(
        [(xs - w / 2.0) / focal, -(ys - h / 2.0) / focal,
         -np.ones_like(xs, dtype=np.float64)], axis=-1)
    rays_d = dirs @ c2w[:3, :3].T
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return (rays_o.astype(np.float32), viewdirs.astype(np.float32),
            rays_d.astype(np.float32))


def default_src_views(num_src_views: int) -> List[int]:
    """The fixed test source list for `num_src_views` views."""
    if num_src_views == 3:
        return SRC_VIEWS_3
    if num_src_views > len(SRC_VIEWS_5_TEST):
        raise ValueError(f"num_src_views {num_src_views} > "
                         f"{len(SRC_VIEWS_5_TEST)} known source views")
    return SRC_VIEWS_5_TEST[:num_src_views]


def source_stack(images: List[np.ndarray], c2ws: List[np.ndarray],
                 focal: float, c: np.ndarray) -> Dict[str, np.ndarray]:
    """Source-view arrays from images in [0, 1] and their poses."""
    nv = len(images)
    return {
        "src_imgs": (np.stack(images) * 2.0 - 1.0).astype(np.float32),
        "src_poses": np.stack(c2ws).astype(np.float32),
        "src_focal": np.full((nv,), focal, np.float32),
        "src_c": np.tile(c, (nv, 1)).astype(np.float32),
    }


def full_image_rays(c2w: np.ndarray, w: int, h: int,
                    focal: float) -> Dict[str, np.ndarray]:
    """One ray per pixel, row-major."""
    ys_g, xs_g = np.mgrid[0:h, 0:w]
    o, v, d = rays_at_pixels(c2w, xs_g.reshape(-1).astype(np.float64),
                             ys_g.reshape(-1).astype(np.float64), w, h, focal)
    return {"rays_o": o, "viewdirs": v, "rays_d": d}


class NeRDS360AE:
    """Test-split sampler over a root of NERDS360 scene directories."""

    def __init__(self, root_dir: str, split: str = "test",
                 img_wh: Tuple[int, int] = (320, 240),
                 num_src_views: int = 3):
        if split != "test":
            raise ValueError(f"split {split!r}: only 'test' is ported")
        self.root_dir = root_dir
        self.img_wh = tuple(img_wh)
        self.num_src_views = num_src_views
        self.scene_ids = sorted(
            f.name for f in os.scandir(root_dir) if f.is_dir())
        if not self.scene_ids:
            raise ValueError(f"no scene directories under {root_dir!r}")
        self._meta_cache: Dict[str, SceneMeta] = {}

    def scene_meta(self, name: str) -> SceneMeta:
        if name in self._meta_cache:
            return self._meta_cache[name]
        scene_dir = os.path.join(self.root_dir, name)
        img_files_train = pose_io.sorted_image_files(scene_dir, "train")
        cams = pose_io.read_poses(os.path.join(scene_dir, "train", "pose"),
                                  img_files_train)
        w, h = self.img_wh
        img_files_test: List[str] = []
        c2w_test = np.zeros((0, 4, 4), np.float32)
        val_dir = os.path.join(scene_dir, "val")
        if os.path.isdir(os.path.join(val_dir, "rgb")):
            img_files_test = pose_io.sorted_image_files(scene_dir, "val")
            c2w_test = pose_io.read_poses_with_scale(
                os.path.join(val_dir, "pose"), img_files_test,
                cams.pose_scale_factor)
        meta = SceneMeta(
            name=name, c2w_train=cams.c2w_train, c2w_test=c2w_test,
            focal=float(cams.focal * w / cams.img_wh[0]),
            c=np.array([w / 2.0, h / 2.0], dtype=np.float32),
            img_files_train=cams.img_files_train,
            img_files_test=img_files_test)
        self._meta_cache[name] = meta
        return meta

    def _load_rgb(self, name: str, split_dir: str, img_file: str):
        from PIL import Image
        path = os.path.join(self.root_dir, name, split_dir, "rgb", img_file)
        img = Image.open(path).resize(self.img_wh, Image.LANCZOS)
        return (np.asarray(img, np.float32) / 255.0)[..., :3]

    def _load_car_mask(self, name: str, split_dir: str, img_file: str):
        path = os.path.join(self.root_dir, name, split_dir,
                            "semantic_segmentation_2d", img_file)
        if not os.path.exists(path):
            return None
        import cv2
        from PIL import Image
        seg = (np.array(Image.open(path)) == CAR_SEMANTIC_ID).astype(np.uint8)
        seg = cv2.resize(seg, self.img_wh, interpolation=cv2.INTER_NEAREST)
        return seg.astype(np.float32)

    def sample_test(self, scene_idx: int, dest_idx: int,
                    src_views: Optional[List[int]] = None):
        """Full-image sample of the scene's val/ view `dest_idx`: source
        stack, rays, target (H*W, 3) and, where the scene has segmentation,
        instance_mask (H*W, 1)."""
        meta = self.scene_meta(self.scene_ids[scene_idx])
        src = src_views or default_src_views(self.num_src_views)
        sample = source_stack(
            [self._load_rgb(meta.name, "train", meta.img_files_train[v])
             for v in src], [meta.c2w_train[v] for v in src], meta.focal,
            meta.c)
        w, h = self.img_wh
        sample.update(full_image_rays(meta.c2w_test[dest_idx], w, h,
                                      meta.focal))
        img_file = meta.img_files_test[dest_idx]
        sample["target"] = self._load_rgb(meta.name, "val",
                                          img_file).reshape(-1, 3)
        mask = self._load_car_mask(meta.name, "val", img_file)
        if mask is not None:
            sample["instance_mask"] = mask.reshape(-1, 1)
        sample["img_wh"] = np.asarray([w, h])
        return sample

    def num_test_views(self, scene_idx: int) -> int:
        return len(self.scene_meta(self.scene_ids[scene_idx]).c2w_test)
