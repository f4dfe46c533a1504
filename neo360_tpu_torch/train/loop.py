"""Tiled full-image rendering (port of
neo360_tpu/train/loop.py:make_image_renderer, 311-366)."""

from __future__ import annotations

from typing import Callable, Dict

import torch


def make_image_renderer(render_chunk_fn: Callable, chunk: int = 4096):
    """render_chunk_fn(pack, rays_chunk) -> dict of (chunk, ...) outputs.

    Returns render(pack, rays) that pads the (N, D) ray arrays to a multiple
    of `chunk` by repeating the last ray (padded rays stay finite through
    the normalization and sphere intersection), renders the tiles in order
    and strips the padding."""

    @torch.inference_mode()
    def render(pack, rays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        n = next(iter(rays.values())).shape[0]
        n_padded = -(-n // chunk) * chunk
        padded = {k: torch.cat([v, v[-1:].expand((n_padded - n,)
                                                 + v.shape[1:])])
                  for k, v in rays.items()}
        outs = [render_chunk_fn(pack, {k: v[i:i + chunk]
                                       for k, v in padded.items()})
                for i in range(0, n_padded, chunk)]
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    return render
