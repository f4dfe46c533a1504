"""NERDS360 `pose.json` parsing and normalization, and the random "near
pose" jitter (port of neo360_tpu/data/poses.py, host-side numpy).

Normalization: subtract obj_location, flip Parallel-Domain axes to NeRF
axes, and scale every translation by 1 / max |t| over the train cameras
(the same factor for val/test). The first 100 cameras are train.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from neo360_tpu_torch.core.rays import convert_pose_pd_to_nerf



@dataclass
class SceneCameras:
    c2w_train: np.ndarray          # (N_train, 4, 4)
    c2w_val: np.ndarray            # (N_val, 4, 4)
    focal: float                   # at native resolution
    img_wh: tuple                  # native (W, H)
    pose_scale_factor: float
    img_files_train: List[str] = field(default_factory=list)


def _load_raw(pose_dir: str):
    with open(os.path.join(pose_dir, "pose.json"), "r") as f:
        return json.load(f)


def _normalized(data, img_files: List[str]) -> np.ndarray:
    obj_location = np.array(data["obj_location"], dtype=np.float64)
    all_c2w = []
    for img_file in img_files:
        c2w = np.array(data["transform"][img_file.split(".")[0]],
                       dtype=np.float64)
        c2w[:3, 3] -= obj_location
        all_c2w.append(convert_pose_pd_to_nerf(c2w))
    return np.stack(all_c2w)


def read_poses(pose_dir: str, img_files: List[str]) -> SceneCameras:
    """Parse + normalize train-split poses; split 100 train / rest val."""
    data = _load_raw(pose_dir)
    all_c2w = _normalized(data, img_files)
    pose_scale_factor = 1.0 / np.max(np.abs(all_c2w[:, :3, 3]))
    all_c2w[:, :3, 3] *= pose_scale_factor
    return SceneCameras(
        c2w_train=all_c2w[:100].astype(np.float32),
        c2w_val=all_c2w[100:].astype(np.float32),
        focal=float(data["focal"]),
        img_wh=tuple(data["img_size"]),
        pose_scale_factor=float(pose_scale_factor),
        img_files_train=list(img_files),
    )


def read_poses_with_scale(pose_dir: str, img_files: List[str],
                          pose_scale_factor: float) -> np.ndarray:
    """Poses normalized by the train split's scale (val/test)."""
    all_c2w = _normalized(_load_raw(pose_dir), img_files)
    all_c2w[:, :3, 3] *= pose_scale_factor
    return all_c2w.astype(np.float32)


def sorted_image_files(scene_dir: str, split: str) -> List[str]:
    files = os.listdir(os.path.join(scene_dir, split, "rgb"))
    files.sort()
    return files


def get_rotation_matrix(rotation_deg: float,
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
    """Random small rotation R = Rx @ Ry @ Rz, each Euler angle drawn
    uniformly from +-rotation_deg by `rng` (three draws, as the JAX
    function makes them)."""
    rng = rng or np.random.default_rng()
    phi = rotation_deg * (np.pi / 180.0)
    x, y, z = rng.uniform(-phi, phi, size=3)
    rot_x = np.array([[1, 0, 0],
                      [0, np.cos(x), -np.sin(x)],
                      [0, np.sin(x), np.cos(x)]])
    rot_y = np.array([[np.cos(y), 0, -np.sin(y)],
                      [0, 1, 0],
                      [np.sin(y), 0, np.cos(y)]])
    rot_z = np.array([[np.cos(z), -np.sin(z), 0],
                      [np.sin(z), np.cos(z), 0],
                      [0, 0, 1]])
    return (rot_x @ rot_y @ rot_z).astype(np.float64)


def rot_from_origin(c2w: np.ndarray, rotation_deg: float = 10.0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """A (3|4, 4) pose rotated about the world origin by
    `get_rotation_matrix(rotation_deg, rng)` (the reference's near pose
    for its smoothing loss), in c2w's dtype."""
    rot_mat = get_rotation_matrix(rotation_deg, rng)
    out = np.array(c2w, dtype=np.float64, copy=True)
    out[:3, :3] = rot_mat @ c2w[:3, :3]
    out[:3, 3:4] = rot_mat @ c2w[:3, 3:4]
    return out.astype(c2w.dtype if hasattr(c2w, "dtype") else np.float32)
