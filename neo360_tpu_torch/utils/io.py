"""Host-side output helpers (port of neo360_tpu/utils/io.py:to8b,
store_image, store_depth_img, store_depth_raw, store_video, write_stats,
visualize_depth): numpy, with PIL and cv2 imported inside the writers."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0.0, 1.0)).astype(np.uint8)


def write_stats(path: str, **metric_groups) -> str:
    """results.json writer: scalars, strings, {name: value} dicts and lists
    of floats."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {}
    for name, values in metric_groups.items():
        if values is None:
            continue
        if isinstance(values, str):
            payload[name] = values
        elif isinstance(values, dict):
            payload[name] = {k: (float(v) if np.ndim(v) == 0 else
                                 [float(e) for e in np.ravel(v)])
                             for k, v in values.items()}
        elif np.ndim(values) == 0:
            payload[name] = float(values)
        else:
            payload[name] = [float(v) for v in np.ravel(values)]
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path


def store_image(dirpath: str, rgbs: Sequence[np.ndarray],
                name: str = "image") -> List[str]:
    """(H, W, 3) float images as JPEGs {name}000.jpg... under `dirpath`."""
    from PIL import Image
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for i, rgb in enumerate(rgbs):
        path = os.path.join(dirpath, f"{name}{i:03d}.jpg")
        Image.fromarray(to8b(rgb)).save(path)
        paths.append(path)
    return paths


def store_depth_raw(dirpath: str, depths: Sequence[np.ndarray],
                    name: str = "depth_raw") -> List[str]:
    """Depth maps as compressed npz files {name}000.npz... (key "depth")."""
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for i, depth in enumerate(depths):
        path = os.path.join(dirpath, f"{name}{i:03d}.npz")
        np.savez_compressed(path, depth=np.asarray(depth))
        paths.append(path)
    return paths


def depth_jet(depth: np.ndarray, scale: float) -> np.ndarray:
    """(H, W) depth / scale as a JET colormap, BGR uint8 (cv2's order)."""
    import cv2
    return cv2.applyColorMap(to8b(np.asarray(depth) / scale),
                             cv2.COLORMAP_JET)


def store_depth_img(dirpath: str, depths: Sequence[np.ndarray],
                    name: str = "depth_img") -> List[str]:
    """JET-colormapped depth JPEGs {name}000.jpg..., normalized by the
    largest depth over the whole set."""
    import cv2
    os.makedirs(dirpath, exist_ok=True)
    arrs = [np.asarray(d) for d in depths]
    global_max = max((float(np.nanmax(d)) for d in arrs), default=1.0) or 1.0
    paths = []
    for i, depth in enumerate(arrs):
        path = os.path.join(dirpath, f"{name}{i:03d}.jpg")
        cv2.imwrite(path, depth_jet(depth, global_max))
        paths.append(path)
    return paths


def store_video(dirpath: str, rgbs: Sequence[np.ndarray],
                name: str = "video.mp4", fps: int = 20) -> str:
    """(H, W, 3) float frames as an mp4 through OpenCV's codec, or, where
    no codec opens a writer, an animated GIF through PIL. Returns the
    path written."""
    import cv2
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, name)
    frames = [to8b(r) for r in rgbs]
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if writer.isOpened():
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        if os.path.getsize(path) > 0:
            return path
    from PIL import Image
    path = os.path.splitext(path)[0] + ".gif"
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def visualize_depth(depth: np.ndarray,
                    near_far: Optional[tuple] = None) -> np.ndarray:
    """One depth map as a JET colormap, RGB float in [0, 1], normalized to
    `near_far` or to its own range (the validation grids' depth tile)."""
    import cv2
    d = np.asarray(depth, np.float32)
    lo, hi = (near_far if near_far is not None
              else (np.nanmin(d), np.nanmax(d)))
    img = depth_jet((d - lo), max(hi - lo, 1e-8))
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
