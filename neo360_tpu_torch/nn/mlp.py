"""Multi-view average fusion (port of neo360_tpu/nn/mlp.py:70-80)."""

from __future__ import annotations

import torch


def combine_interleaved(x: torch.Tensor, num_views: int) -> torch.Tensor:
    """(NV * B, ..., D) with views as the leading factor -> (B, ..., D)
    mean over views."""
    if num_views == 1:
        return x
    return torch.mean(x.reshape((num_views, -1) + tuple(x.shape[1:])), dim=0)
