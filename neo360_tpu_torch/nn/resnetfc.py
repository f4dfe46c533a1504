"""PixelNeRF's published MLP, `ResnetFC` (pixel-nerf src/model/resnetfc.py,
Yu et al. 2021, arXiv:2012.02190), in float32 `Dense` layers.

Rows are points seen from NV source views, views leading (row v * B + b is
point b in view v), so the view mean is `nn.mlp.combine_interleaved`. With
x the point's encoded input and z its pixel latent in that view:

    x = lin_in(x)
    for i in 0 .. n_blocks - 1:
        if i == combine_layer: x = mean over the NV views of x
        if i < combine_layer:  x = x + lin_z[i](z)
        x = x + fc_1(relu(fc_0(relu(x))))        (block i)
    out = lin_out(relu(x))

so the first `combine_layer` blocks run once per view and the rest once
per point. Kernels are He-normal, biases zero and every block's `fc_1`
zero, as published (each block starts as the identity).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.nn.layers import Dense
from neo360_tpu_torch.nn.mlp import combine_interleaved


class ResnetBlockFC(nn.Module):
    """x + fc_1(relu(fc_0(relu(x)))), width in = hidden = out."""

    def __init__(self, width: int, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_0 = Dense(width, width, dtype=dtype, kernel_init="kaiming",
                          generator=generator)
        self.fc_1 = Dense(width, width, dtype=dtype, kernel_init="kaiming",
                          generator=generator)
        with torch.no_grad():
            self.fc_1.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc_1(F.relu(self.fc_0(F.relu(x))))


class ResnetFC(nn.Module):
    def __init__(self, d_in: int, d_latent: int, d_out: int = 4,
                 n_blocks: int = 5, d_hidden: int = 512,
                 combine_layer: int = 3, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_blocks, self.combine_layer = n_blocks, combine_layer
        dense = lambda i, o: Dense(i, o, dtype=dtype, kernel_init="kaiming",
                                   generator=generator)
        self.lin_in = dense(d_in, d_hidden)
        self.lin_z = nn.ModuleList([dense(d_latent, d_hidden) for _ in
                                    range(min(combine_layer, n_blocks))])
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden, dtype,
                                                   generator)
                                     for _ in range(n_blocks)])
        self.lin_out = dense(d_hidden, d_out)

    def forward(self, x: torch.Tensor, z: torch.Tensor, num_views: int
                ) -> torch.Tensor:
        """x (NV * B, ..., d_in) encoded inputs and z (NV * B, ...,
        d_latent) latents, views leading -> (B, ..., d_out) float32, the
        views averaged before block `combine_layer`."""
        x = self.lin_in(x)
        for i, block in enumerate(self.blocks):
            if i == self.combine_layer:
                x = combine_interleaved(x, num_views)
            if i < len(self.lin_z):         # the blocks before the mean
                x = x + self.lin_z[i](z)
            x = block(x)
        return self.lin_out(F.relu(x)).float()
