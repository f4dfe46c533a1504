"""Positional encoding (port of neo360_tpu/core/encoding.py:23)."""

from __future__ import annotations

import math

import torch


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """[x, sin(2^i x), cos(2^i x)] for i in [min_deg, max_deg); cos is
    sin(x + pi/2). Output dim = d * (1 + 2 * (max_deg - min_deg))."""
    if min_deg == max_deg:
        return x
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)
