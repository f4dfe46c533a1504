"""Vanilla NeRF, coarse + fine (port of neo360_tpu/models/vanilla.py).

Level 0 draws num_coarse_samples + 1 stratified points along the unit
`viewdirs`; level 1 resamples num_fine_samples points from level 0's
weights at the midpoints (the first and last weight dropped) and merges
them with level 0's t-values. Both levels composite with the plain NeRF
rule (`composite_vanilla`: kernel D on the card) over |rays_d|, the
unnormalized directions, as the JAX model does. rgb = sigmoid padded by
+-rgb_padding, sigma = softplus(raw + sigma_bias). Randomized (training)
sampling draws from a `torch.Generator`. `lindisp` spaces the coarse
samples in inverse depth; `noise_std` adds U[0, noise_std) to the raw
density of every level in randomized forwards (the JAX model's fields, 0
and False in every preset, never set by the CLI).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.core import encoding, sampling
from neo360_tpu_torch.core.render import composite_vanilla
from neo360_tpu_torch.nn.mlp import NeRFMLP


class VanillaNeRF(nn.Module):
    # the JAX model's fixed hyperparameters (neo360_tpu/models/vanilla.py)
    min_deg_point, max_deg_point, deg_view = 0, 10, 4
    rgb_padding, sigma_bias = 0.001, -1.0

    def __init__(self, num_coarse_samples: int = 64,
                 num_fine_samples: int = 128,
                 generator: Optional[torch.Generator] = None,
                 noise_std: float = 0.0, lindisp: bool = False):
        super().__init__()
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.noise_std, self.lindisp = noise_std, lindisp
        pe = 3 * (1 + 2 * (self.max_deg_point - self.min_deg_point))
        vd = 3 * (1 + 2 * self.deg_view)
        self.coarse_mlp = NeRFMLP(pe, vd, generator=generator)
        self.fine_mlp = NeRFMLP(pe, vd, generator=generator)

    def forward(self, rays: Dict[str, torch.Tensor], white_bkgd: bool,
                near: float, far: float, randomized: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_u: Optional[List[torch.Tensor]] = None
                ) -> List[Dict[str, torch.Tensor]]:
        """rays: rays_o, rays_d, viewdirs, each (B, 3). Returns one dict per
        level: rgb (B,3), acc (B,), depth (B,), weights (B,S), t_vals
        (B,S). With `noise_std` a randomized forward draws each level's
        density noise after its samples, or takes it from `noise_u`, one
        (B, S, 1) tensor of uniforms per level."""
        rays_o, viewdirs = rays["rays_o"], rays["viewdirs"]
        viewdirs_enc = encoding.pos_enc(viewdirs, 0, self.deg_view)
        noise_u = list(noise_u or [None, None])
        results = []
        t_vals = weights = None
        for level, mlp in enumerate((self.coarse_mlp, self.fine_mlp)):
            if level == 0:
                t_vals, samples = sampling.sample_along_rays(
                    rays_o, viewdirs, self.num_coarse_samples, near, far,
                    randomized, self.lindisp, generator=generator)
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                t_vals, samples = sampling.sample_pdf(
                    t_mids, weights[..., 1:-1], rays_o, viewdirs, t_vals,
                    self.num_fine_samples, randomized, generator=generator)
            samples_enc = encoding.pos_enc(samples, self.min_deg_point,
                                           self.max_deg_point)
            raw_rgb, raw_sigma = mlp(samples_enc, viewdirs_enc)
            if self.noise_std > 0 and randomized:
                raw_sigma = raw_sigma + sampling._uniform(
                    raw_sigma.shape, raw_sigma, noise_u[level],
                    generator) * self.noise_std
            rgb = torch.sigmoid(raw_rgb)
            rgb = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
            sigma = F.softplus(raw_sigma + self.sigma_bias)
            comp, acc, weights, depth = composite_vanilla(
                rgb, sigma, t_vals, rays["rays_d"], white_bkgd)
            results.append({"rgb": comp, "acc": acc, "depth": depth,
                            "weights": weights, "t_vals": t_vals})
        return results
