"""Validation image grids (port of neo360_tpu/utils/visualize.py:
_to_hw3, tile_images, the visualize_val_* grids and build_val_grid):
GT, prediction, depth, fg / bg and opacity tiles side by side, built with
numpy (cv2 colours the depth tile)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from neo360_tpu_torch.utils.io import visualize_depth


def _to_hw3(x, h: int, w: int) -> np.ndarray:
    """(H,W,3), flat (H*W,3), (H,W) or flat (H*W,) -> (H, W, 3)."""
    x = np.asarray(x)
    if x.shape == (h, w):
        x = np.repeat(x[..., None], 3, axis=-1)
    elif x.ndim == 1:
        x = np.repeat(x.reshape(h, w, 1), 3, axis=-1)
    return x.reshape(h, w, 3)


def tile_images(images: Sequence[np.ndarray], pad: int = 2,
                pad_value: float = 1.0) -> np.ndarray:
    """Horizontal strip of equally sized (H, W, 3) images."""
    h = images[0].shape[0]
    spacer = np.full((h, pad, 3), pad_value, dtype=np.float32)
    row = []
    for i, img in enumerate(images):
        if i:
            row.append(spacer)
        row.append(np.asarray(img, np.float32))
    return np.concatenate(row, axis=1)


def visualize_val_fg_bg_opacity(img_wh, target, rgb, fg_rgb, bg_rgb,
                                fg_acc, bg_acc) -> np.ndarray:
    w, h = img_wh
    clip = lambda x: _to_hw3(np.clip(x, 0, 1), h, w)
    return tile_images([_to_hw3(target, h, w), clip(rgb), clip(fg_rgb),
                        clip(bg_rgb), clip(fg_acc), clip(bg_acc)])


def visualize_val_rgb_depth(img_wh, target, rgb, depth=None) -> np.ndarray:
    """GT | prediction [| depth]."""
    w, h = img_wh
    tiles = [_to_hw3(target, h, w), _to_hw3(np.clip(rgb, 0, 1), h, w)]
    if depth is not None:
        tiles.append(visualize_depth(np.asarray(depth).reshape(h, w)))
    return tile_images(tiles)


def visualize_val_fg_bg(img_wh, target, rgb, fg_rgb, bg_rgb, depth=None,
                        acc=None) -> np.ndarray:
    """GT | comp | fg | bg [| depth] [| opacity]."""
    w, h = img_wh
    clip = lambda x: _to_hw3(np.clip(x, 0, 1), h, w)
    tiles = [_to_hw3(target, h, w), clip(rgb), clip(fg_rgb), clip(bg_rgb)]
    if depth is not None:
        tiles.append(visualize_depth(np.asarray(depth).reshape(h, w)))
    if acc is not None:
        tiles.append(clip(acc))
    return tile_images(tiles)


def visualize_val_rgb_opa_depth(img_wh, target, rgb, acc,
                                depth) -> np.ndarray:
    """GT | prediction | opacity | depth."""
    w, h = img_wh
    return tile_images([
        _to_hw3(target, h, w), _to_hw3(np.clip(rgb, 0, 1), h, w),
        _to_hw3(np.clip(acc, 0, 1), h, w),
        visualize_depth(np.asarray(depth).reshape(h, w))])


def build_val_grid(img_wh, target, outputs: Dict) -> np.ndarray:
    """The richest grid that the rendered `outputs` (host arrays) support,
    as the JAX trainer picks it: fg / bg with both opacities (NeO-360),
    fg / bg, rgb + opacity + depth (vanilla), else rgb [+ depth]
    (PixelNeRF)."""
    has = lambda *ks: all(outputs.get(k) is not None for k in ks)
    if has("fg_rgb", "bg_rgb", "fg_acc", "bg_acc"):
        return visualize_val_fg_bg_opacity(
            img_wh, target, outputs["rgb"], outputs["fg_rgb"],
            outputs["bg_rgb"], outputs["fg_acc"], outputs["bg_acc"])
    if has("fg_rgb", "bg_rgb"):
        return visualize_val_fg_bg(img_wh, target, outputs["rgb"],
                                   outputs["fg_rgb"], outputs["bg_rgb"],
                                   outputs.get("depth"), outputs.get("acc"))
    if has("acc", "depth"):
        return visualize_val_rgb_opa_depth(img_wh, target, outputs["rgb"],
                                           outputs["acc"], outputs["depth"])
    return visualize_val_rgb_depth(img_wh, target, outputs["rgb"],
                                   outputs.get("depth"))
