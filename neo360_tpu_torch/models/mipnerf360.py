"""MipNeRF-360 (port of neo360_tpu/models/mipnerf360.py).

Three levels: two proposal rounds of 64 samples through density-only
4 x 256 MLPs, then 32 NeRF samples through the 8 x 1024 MLP. Sampling is
in s-space (the 1/t warp of [near, far] onto [0, 1]) with weight dilation
and annealed resampling logits (core/mip.py); each interval is a
conical-frustum Gaussian pushed through the scene contraction with its
Jacobian (core/encoding.py:track_linearize) and encoded by the lifted IPE
over the 21-vector icosahedron basis, degrees 0-12 (504 features).

Every level composites with `composite_mip` (kernel E on the card, E' in
the backward): 3 launches of each a training step. Module and parameter
names follow the Flax tree (`prop_mlp_0`, `prop_mlp_1`, `nerf_mlp`, each
with `pts_i`, `density`, and on the NeRF level `bottleneck`, `views_0`,
`rgb`), so `weights.from_flax_flat` carries the JAX parameters over.

As in the JAX model: the resampling reads detached edges and weights; a
ray whose resampling logits are all -inf resamples uniformly; the lifted
variances are clamped at 0 before the IPE (a variance a rounding below 0,
scaled by 4^11, would overflow exp); the proposal levels render zero rgb.
Randomized sampling draws one jitter per ray and level
(core/sampling.py:_uniform, from a `torch.Generator`).

Spans (train/profiling.py), per level: `model.sample` (the dilation, the
resampling logits, `sample_intervals`, `s_to_t` and the cone Gaussians),
`model.ipe` (the contraction with its Jacobian, the lift onto the basis,
the clamp and the IPE), `model.mlp` (the trunk and the heads) and
`model.composite` (kernel E). Outside an item they record nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.core import encoding, mip
from neo360_tpu_torch.core.render import composite_mip
from neo360_tpu_torch.nn.layers import Dense
from neo360_tpu_torch.ops import losses
from neo360_tpu_torch.train.profiling import span

RAY_KEYS = ("rays_o", "rays_d", "viewdirs", "radii")


class MipNeRF360MLP(nn.Module):
    """The trunk of the proposal and NeRF MLPs (neo360_tpu/models/
    mipnerf360.py:27-120): contraction, lifted IPE, a netdepth x netwidth
    ReLU trunk with the IPE concatenated again after every skip_layer-th
    layer, a softplus density head, and unless `disable_rgb` a
    bottleneck into one view-conditioned layer and a sigmoid rgb head
    padded by rgb_padding. Kaiming-uniform kernels, zero biases."""

    # the JAX module's fixed fields (every preset keeps their defaults)
    min_deg_point, max_deg_point, deg_view = 0, 12, 4
    density_bias, rgb_padding = -1.0, 0.001
    skip_layer, bottleneck_width, netwidth_condition = 4, 256, 128

    def __init__(self, netdepth: int = 8, netwidth: int = 256,
                 disable_rgb: bool = False, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.netdepth = netdepth
        self.disable_rgb = disable_rgb
        basis = torch.as_tensor(encoding.generate_basis("icosahedron", 2))
        self.register_buffer("pos_basis", basis, persistent=False)
        n_in = 2 * basis.shape[1] * (self.max_deg_point - self.min_deg_point)
        dense = lambda i, o: Dense(i, o, dtype=dtype,
                                   kernel_init="kaiming_uniform",
                                   generator=generator)
        width = n_in
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", dense(width, netwidth))
            width = netwidth + (n_in if self._skip(idx) else 0)
        self.density = dense(width, 1)
        if disable_rgb:
            return
        self.bottleneck = dense(width, self.bottleneck_width)
        self.views_0 = dense(self.bottleneck_width
                             + 3 * (1 + 2 * self.deg_view),
                             self.netwidth_condition)
        self.rgb = dense(self.netwidth_condition, 3)

    def _skip(self, idx: int) -> bool:
        return idx % self.skip_layer == 0 and idx > 0

    def forward(self, means: torch.Tensor, covs: torch.Tensor,
                viewdirs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """means (B,S,3), covs (B,S,3,3), viewdirs (B,3) -> density (B,S)
        and rgb (B,S,3), float32."""
        with span("model.ipe"), torch.no_grad():
            means, covs = encoding.track_linearize(means, covs)
            lifted_means, lifted_vars = encoding.lift_and_diagonalize(
                means, covs, self.pos_basis)
            lifted_vars = torch.clamp(lifted_vars, min=0.0)
            x = encoding.integrated_pos_enc(lifted_means, lifted_vars,
                                            self.min_deg_point,
                                            self.max_deg_point)
        with span("model.mlp"):
            inputs = x
            for idx in range(self.netdepth):
                x = F.relu(getattr(self, f"pts_{idx}")(x))
                if self._skip(idx):
                    x = torch.cat([x, inputs.to(x.dtype)], dim=-1)
            raw_density = self.density(x)[..., 0].float()
            density = F.softplus(raw_density + self.density_bias)
            if self.disable_rgb:
                return {"density": density, "rgb": torch.zeros_like(means)}
            bottleneck = self.bottleneck(x)
            dir_enc = encoding.pos_enc(viewdirs, 0, self.deg_view)
            dir_enc = dir_enc[..., None, :].expand(
                bottleneck.shape[:-1] + (dir_enc.shape[-1],))
            x = torch.cat([bottleneck, dir_enc.to(bottleneck.dtype)], dim=-1)
            x = F.relu(self.views_0(x))
            rgb = torch.sigmoid(self.rgb(x).float())
            rgb = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
            return {"density": density, "rgb": rgb}


class MipNeRF360(nn.Module):
    """Proposal + NeRF sampling (neo360_tpu/models/mipnerf360.py:123-258),
    with the JAX model's defaults: 64 proposal and 32 NeRF samples, 3
    levels, background 1.0, anneal slope 10, single jitter, dilation
    0.5 / S + 0.0025, an opaque background, cone-shaped intervals."""

    num_levels = 3
    bg_intensity = 1.0
    anneal_slope = 10.0
    dilation_multiplier, dilation_bias = 0.5, 0.0025
    resample_padding = 0.0
    opaque_background = True

    def __init__(self, num_prop_samples: int = 64,
                 num_nerf_samples: int = 32, nerf_netwidth: int = 1024,
                 prop_netdepth: int = 4, prop_netwidth: int = 256,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_prop_samples = num_prop_samples
        self.num_nerf_samples = num_nerf_samples
        for i in range(self.num_levels - 1):
            self.add_module(f"prop_mlp_{i}", MipNeRF360MLP(
                netdepth=prop_netdepth, netwidth=prop_netwidth,
                disable_rgb=True, dtype=dtype, generator=generator))
        self.nerf_mlp = MipNeRF360MLP(netwidth=nerf_netwidth, dtype=dtype,
                                      generator=generator)

    def mlps(self) -> List[MipNeRF360MLP]:
        return [getattr(self, f"prop_mlp_{i}")
                for i in range(self.num_levels - 1)] + [self.nerf_mlp]

    def forward(self, rays: Dict[str, torch.Tensor], train_frac,
                randomized: bool, near: float, far: float,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[Dict[str, torch.Tensor]],
                           List[Dict[str, torch.Tensor]]]:
        """rays: rays_o, rays_d, viewdirs (B,3), radii (B,1).

        Returns (renderings per level: rgb (B,3), acc (B,), depth (B,);
        ray history per level: density (B,S), rgb (B,S,3), sdist (B,S+1),
        weights (B,S))."""
        bsz = rays["rays_o"].shape[0]
        dev, dt = rays["rays_o"].device, rays["rays_o"].dtype
        _, s_to_t = mip.construct_ray_warps(near, far)
        init_s_near, init_s_far = 0.0, 1.0
        domain = (init_s_near, init_s_far)
        sdist = torch.cat([torch.full((bsz, 1), init_s_near, dtype=dt,
                                      device=dev),
                           torch.full((bsz, 1), init_s_far, dtype=dt,
                                      device=dev)], dim=-1)
        weights = torch.ones((bsz, 1), dtype=dt, device=dev)
        prod_num_samples = 1
        anneal = (self.anneal_slope * train_frac) / (
            (self.anneal_slope - 1) * train_frac + 1)
        renderings, history = [], []
        for i_level, mlp in enumerate(self.mlps()):
            is_prop = i_level < self.num_levels - 1
            num_samples = (self.num_prop_samples if is_prop
                           else self.num_nerf_samples)
            dilation = (self.dilation_bias + self.dilation_multiplier
                        * (init_s_far - init_s_near) / prod_num_samples)
            prod_num_samples *= num_samples
            with span("model.sample"), torch.no_grad():
                sdist, weights = sdist.detach(), weights.detach()
                if i_level > 0:
                    sdist, weights = mip.max_dilate_weights(
                        sdist, weights, dilation, domain=domain,
                        renormalize=True)
                    sdist = sdist[..., 1:-1]
                    weights = weights[..., 1:-1]
                logits = resample_logits(sdist, weights, anneal,
                                         self.resample_padding)
                sdist = mip.sample_intervals(
                    sdist, logits, num_samples, randomized,
                    single_jitter=True, domain=domain, generator=generator)
                tdist = s_to_t(sdist)
                means, covs = mip.cast_rays_gaussian(
                    tdist, rays["rays_o"], rays["rays_d"], rays["radii"],
                    "cone", diag=False)
            out = mlp(means, covs, rays["viewdirs"])
            with span("model.composite"):
                weights, rgb, acc, depth = composite_mip(
                    out["density"], tdist, rays["rays_d"], out["rgb"],
                    self.bg_intensity, self.opaque_background)
            history.append(dict(out, sdist=sdist, weights=weights))
            renderings.append({"rgb": rgb, "acc": acc, "depth": depth})
        return renderings, history


def resample_logits(sdist: torch.Tensor, weights: torch.Tensor, anneal,
                    padding: float = 0.0) -> torch.Tensor:
    """The resampling logits of one level (neo360_tpu/models/
    mipnerf360.py:195-210): anneal * log(weights + padding) over the
    intervals of positive width, -inf over empty ones; a ray whose logits
    are all -inf (its whole mass in the edge intervals the dilation drops)
    gets zeros, i.e. resamples uniformly."""
    logits = torch.where(sdist[..., 1:] > sdist[..., :-1],
                         anneal * torch.log(weights + padding),
                         torch.full_like(weights, -float("inf")))
    all_dead = torch.all(torch.isneginf(logits), dim=-1, keepdim=True)
    return torch.where(all_dead, torch.zeros_like(logits), logits)


def interlevel_loss(history) -> torch.Tensor:
    """The proposal histograms must bound the (detached) NeRF histogram
    (neo360_tpu/models/mipnerf360.py:261-270)."""
    c = history[-1]["sdist"].detach()
    w = history[-1]["weights"].detach()
    total = 0.0
    for level in history[:-1]:
        total = total + torch.mean(losses.lossfun_outer(
            c, w, level["sdist"], level["weights"]))
    return total


def distortion_loss(history) -> torch.Tensor:
    """O(S) distortion of the NeRF level's s-space histogram
    (neo360_tpu/models/mipnerf360.py:273-278)."""
    return torch.mean(losses.distortion_loss(history[-1]["sdist"],
                                             history[-1]["weights"]))
