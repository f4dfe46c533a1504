"""NERDS360 single-scene dataset of the vanilla NeRF (port of
neo360_tpu/data/nerds360.py).

The train split's rays and colours become flat buffers on the device once
(`ray_buffers`): the rays are generated there from the poses
(core/rays.py), the images are read and LANCZOS-resized on the host and
copied up once, so the buffer trainer (train/loop.py:make_buffer_trainer)
draws its batches on the device with no host work per step.

- near 0.2, far 3.0; focal scaled by img_wh[0] / the native width.
- train: cameras 0:100 of train/; val: train/ cameras 100:; test: the
  val/ directory's cameras at the train split's pose scale.
- `image_rays` adds the car instance mask (semantic id 5, nearest
  resize) where the scene has segmentation; `pose_rays` gives the rays of
  any pose (the vis_only flythrough).
PIL and cv2 are imported only by the image readers.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from neo360_tpu_torch.core import rays as ray_core
from neo360_tpu_torch.data import poses as pose_io

NEAR = 0.2
FAR = 3.0
CAR_SEMANTIC_ID = 5


def load_rgb(path: str, wh) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], LANCZOS-resized to `wh`."""
    from PIL import Image
    img = Image.open(path).resize(tuple(wh), Image.LANCZOS)
    return (np.asarray(img, dtype=np.float32) / 255.0)[..., :3]


def load_instance_mask(path: str, wh) -> np.ndarray:
    """(H, W) bool car mask, nearest-resized to `wh`."""
    import cv2
    from PIL import Image
    seg = (np.array(Image.open(path)) == CAR_SEMANTIC_ID).astype(np.uint8)
    return cv2.resize(seg, tuple(wh),
                      interpolation=cv2.INTER_NEAREST).astype(bool)


class NeRDS360:
    """One scene's rays: split "train" (ray buffers of cameras 0:100),
    "val" (full images of train/ cameras 100:) or "test" (full images of
    the val/ directory)."""

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(320, 240)):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        train_dir = os.path.join(root_dir, "train")
        files_train = pose_io.sorted_image_files(root_dir, "train")
        cams = pose_io.read_poses(os.path.join(train_dir, "pose"),
                                  files_train)
        self.pose_scale_factor = cams.pose_scale_factor
        w, h = self.img_wh
        self.focal = cams.focal * w / cams.img_wh[0]
        if split == "train":
            self.base_dir = train_dir
            self.img_files = files_train[:100][:len(cams.c2w_train)]
            self.c2w = cams.c2w_train
        elif split == "val":
            self.base_dir = train_dir
            self.img_files = files_train[100:]
            self.c2w = cams.c2w_val
        elif split == "test":
            self.base_dir = os.path.join(root_dir, "val")
            self.img_files = pose_io.sorted_image_files(root_dir, "val")
            self.c2w = pose_io.read_poses_with_scale(
                os.path.join(self.base_dir, "pose"), self.img_files,
                cams.pose_scale_factor)
        else:
            raise ValueError(f"unknown split {split!r}")
        self.num_images = len(self.c2w)

    def _rays(self, c2ws, device) -> Dict[str, torch.Tensor]:
        w, h = self.img_wh
        poses = torch.as_tensor(np.asarray(c2ws, np.float32), device=device)
        per_cam = [ray_core.rays_for_camera(h, w, self.focal, c2w)
                   for c2w in poses]
        return {k: torch.cat([r[k] for r in per_cam]) for k in per_cam[0]}

    def ray_buffers(self, device="cpu") -> Dict[str, torch.Tensor]:
        """Every ray and target colour of the split as flat tensors on
        `device`: rays_o, rays_d, viewdirs, target (N_imgs*H*W, 3) and the
        pixel radii (N_imgs*H*W, 1)."""
        out = self._rays(self.c2w, device)
        rgbs = np.stack([load_rgb(os.path.join(self.base_dir, "rgb", f),
                                  self.img_wh) for f in self.img_files])
        out["target"] = torch.as_tensor(rgbs.reshape(-1, 3), device=device)
        return out

    def pose_rays(self, c2w: np.ndarray) -> Dict[str, np.ndarray]:
        """The rays (H*W, 3) and radii (H*W, 1) of any pose (4x4 or 3x4),
        no target."""
        return {k: v.numpy() for k, v in
                self._rays(np.asarray(c2w, np.float32)[None], "cpu").items()}

    def image_rays(self, idx: int) -> Dict[str, np.ndarray]:
        """Rays and target (H*W, 3) and radii (H*W, 1) of image `idx`, and
        its instance_mask (H*W,) where the scene has segmentation."""
        out = {k: v.numpy() for k, v in
               self._rays(self.c2w[idx:idx + 1], "cpu").items()}
        name = self.img_files[idx]
        out["target"] = load_rgb(os.path.join(self.base_dir, "rgb", name),
                                 self.img_wh).reshape(-1, 3)
        seg = os.path.join(self.base_dir, "semantic_segmentation_2d", name)
        if os.path.exists(seg):
            out["instance_mask"] = load_instance_mask(
                seg, self.img_wh).reshape(-1)
        return out
