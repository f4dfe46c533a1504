"""The vanilla NeRF MLP and multi-view average fusion (port of
neo360_tpu/nn/mlp.py:29-80)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.nn.layers import Dense


class NeRFMLP(nn.Module):
    """Vanilla-NeRF MLP (neo360_tpu/nn/mlp.py:29-67): a netdepth x netwidth
    ReLU trunk with the input concatenated again after every `skip_layer`-th
    layer, a density head, a bottleneck into a netdepth_condition x
    netwidth_condition view-conditioned branch and an rgb head; xavier
    kernels, zero biases. Inputs are positionally encoded already."""

    def __init__(self, in_features: int, viewdir_features: int,
                 netdepth: int = 8, netwidth: int = 256,
                 netdepth_condition: int = 1, netwidth_condition: int = 128,
                 skip_layer: int = 4, num_rgb_channels: int = 3,
                 num_density_channels: int = 1, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.netdepth, self.netdepth_condition = netdepth, netdepth_condition
        self.skip_layer = skip_layer
        dense = lambda i, o: Dense(i, o, dtype=dtype, kernel_init="xavier",
                                   generator=generator)
        width_in = in_features
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", dense(width_in, netwidth))
            width_in = netwidth + (in_features if self._skip(idx) else 0)
        self.density = dense(width_in, num_density_channels)
        self.bottleneck = dense(width_in, netwidth)
        width_in = netwidth + viewdir_features
        for idx in range(netdepth_condition):
            self.add_module(f"views_{idx}", dense(width_in,
                                                  netwidth_condition))
            width_in = netwidth_condition
        self.rgb = dense(width_in, num_rgb_channels)

    def _skip(self, idx: int) -> bool:
        return idx % self.skip_layer == 0 and idx > 0

    def forward(self, samples_enc: torch.Tensor, viewdirs_enc: torch.Tensor):
        """samples_enc (B, S, Dp), viewdirs_enc (B, Dv) -> (raw_rgb
        (B, S, 3), raw_density (B, S, 1)), float32."""
        inputs = samples_enc
        x = samples_enc
        for idx in range(self.netdepth):
            x = F.relu(getattr(self, f"pts_{idx}")(x))
            if self._skip(idx):
                x = torch.cat([x, inputs.to(x.dtype)], dim=-1)
        raw_density = self.density(x)
        bottleneck = self.bottleneck(x)
        cond = viewdirs_enc[..., None, :].expand(
            bottleneck.shape[:-1] + (viewdirs_enc.shape[-1],))
        x = torch.cat([bottleneck, cond.to(bottleneck.dtype)], dim=-1)
        for idx in range(self.netdepth_condition):
            x = F.relu(getattr(self, f"views_{idx}")(x))
        return self.rgb(x).float(), raw_density.float()


def combine_interleaved(x: torch.Tensor, num_views: int) -> torch.Tensor:
    """(NV * B, ..., D) with views as the leading factor -> (B, ..., D)
    mean over views."""
    if num_views == 1:
        return x
    return torch.mean(x.reshape((num_views, -1) + tuple(x.shape[1:])), dim=0)
