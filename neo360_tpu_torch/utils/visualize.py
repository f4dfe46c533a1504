"""The few-shot validation grid (port of neo360_tpu/utils/visualize.py:
_to_hw3, tile_images, visualize_val_fg_bg_opacity): GT | comp | fg | bg |
fg opacity | bg opacity, as the JAX trainer logs it for neo360 models."""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
