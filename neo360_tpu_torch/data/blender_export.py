"""Export a NERDS360 scene to the NeRF-blender `transforms.json` format
(port of neo360_tpu/data/blender_export.py; the reference's
datasets/convert_to_nerf_blender.py:66-114).

Usage:
    python -m neo360_tpu_torch.data.blender_export --base_dir <scene_dir>
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np

from neo360_tpu_torch.data import poses as pose_io


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def export_transforms(base_dir: str, split: str = "train",
                      output_file: Optional[str] = None) -> str:
    """Write transforms_{split}.json under `base_dir` (or `output_file`):
    camera_angle_x and every camera's normalized c2w, train cameras then
    the rest. Returns the path written."""
    img_files = pose_io.sorted_image_files(base_dir, split)
    cams = pose_io.read_poses(os.path.join(base_dir, split, "pose"),
                              img_files)
    all_c2w = np.concatenate([cams.c2w_train, cams.c2w_val])
    transforms = {
        "camera_angle_x": focal2fov(cams.focal, cams.img_wh[0]),
        "frames": [
            {"file_path": os.path.join("./", split, "rgb", f.split(".")[0]),
             "transform_matrix": c2w.tolist()}
            for c2w, f in zip(all_c2w, img_files)
        ],
    }
    output_file = output_file or os.path.join(base_dir,
                                              f"transforms_{split}.json")
    with open(output_file, "w") as f:
        json.dump(transforms, f, indent=4)
    return output_file


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--split", default="train")
    args = p.parse_args()
    print("wrote", export_transforms(args.base_dir, args.split))
