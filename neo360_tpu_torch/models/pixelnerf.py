"""PixelNeRF (port of neo360_tpu/models/pixelnerf.py).

The source views are ResNet34-encoded once (`encode`): the (NV, H/2, W/2,
512) pixel latent becomes one zeros-padded corner table
(`build_corner_table`) that every ray batch of the scene samples. Per
level, each sample is projected into every source view and the NV views'
latents are gathered in ONE `table_sample` call (kernel A on the card,
zeros padding; its backward, kernel A' under the dense contract, feeds the
encoder, which trains every step). A 4 x 128 MLP fuses the views by their
mean at `combine_layer`; levels composite with the plain NeRF rule
(`composite_vanilla`: kernel D), ReLU sigma and plain sigmoid rgb. Two
levels of 64 + 64 samples along `rays_d`, near 0.02, far 3.0 (the CLI's).
`lindisp` spaces the coarse samples in inverse depth and `noise_std` adds
U[0, noise_std) to the raw density of every level in randomized forwards
(the JAX model's fields, 0 and False in every preset).

The JAX package's recorded divergences from the reference are kept: fy is
negated in the projection, viewdirs broadcast per ray in (ray, sample)
order, and the in-bounds mask of the latent sample is dropped. With a
bf16 `compute_dtype` the corner table is bf16 and kernel A folds its rows
in float32 before one rounding to bf16 (JAX folds in bf16).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.core import encoding, geometry, sampling
from neo360_tpu_torch.core.render import composite_vanilla
from neo360_tpu_torch.nn.layers import Dense
from neo360_tpu_torch.nn.mlp import combine_interleaved
from neo360_tpu_torch.nn.resnet import SpatialEncoder, latent_scaling
from neo360_tpu_torch.ops.interpolate import build_corner_table, table_sample

NEAR, FAR = 0.02, 3.0


class PixelNeRFMLP(nn.Module):
    """4 x 128 trunk evaluated per view, bottleneck and mean view fusion
    at `combine_layer`, 2 x 128 view branch fused after its first layer
    (neo360_tpu/models/pixelnerf.py:37-87)."""

    def __init__(self, in_features: int, viewdir_features: int,
                 netdepth: int = 4, netwidth: int = 128,
                 netdepth_condition: int = 2, netwidth_condition: int = 128,
                 skip_layer: int = 4, combine_layer: int = 3,
                 latent_size: int = 512, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.netdepth, self.netdepth_condition = netdepth, netdepth_condition
        self.skip_layer, self.combine_layer = skip_layer, combine_layer
        dense = lambda i, o: Dense(i, o, dtype=dtype, kernel_init="xavier",
                                   generator=generator)
        inputs = in_features + latent_size
        width_in = inputs
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", dense(width_in, netwidth))
            width_in = netwidth + (inputs if self._skip(idx) else 0)
        self.bottleneck = dense(netwidth, netwidth)
        self.density = dense(width_in, 1)
        width_in = netwidth + viewdir_features
        for idx in range(netdepth_condition):
            self.add_module(f"views_{idx}", dense(width_in,
                                                  netwidth_condition))
            width_in = netwidth_condition
        self.rgb = dense(width_in, 3)

    def _skip(self, idx: int) -> bool:
        return (idx % self.skip_layer == 0 and idx > 0
                and idx != self.combine_layer)

    def forward(self, x, viewdirs_enc, latent, num_views: int):
        """x (NV*B, S, Dp) encoded camera-frame samples; viewdirs_enc
        (NV*B, Dv); latent (NV*B, S, L) -> (raw_rgb, raw_density) (B, S,
        3|1) float32 after view fusion."""
        x = torch.cat([x, latent.to(x.dtype)], dim=-1)
        inputs = x
        bottleneck = None
        for idx in range(self.netdepth):
            x = F.relu(getattr(self, f"pts_{idx}")(x))
            if idx == self.combine_layer:
                bottleneck = self.bottleneck(x)
                x = combine_interleaved(x, num_views)
            if self._skip(idx):
                x = torch.cat([x, inputs.to(x.dtype)], dim=-1)
        raw_density = self.density(x)

        cond = viewdirs_enc[..., None, :].expand(
            bottleneck.shape[:-1] + (viewdirs_enc.shape[-1],))
        h = torch.cat([bottleneck, cond.to(bottleneck.dtype)], dim=-1)
        for idx in range(self.netdepth_condition):
            h = getattr(self, f"views_{idx}")(h)
            if idx == 0:
                h = combine_interleaved(h, num_views)
            h = F.relu(h)
        return self.rgb(h).float(), raw_density.float()


class PixelNeRF(nn.Module):
    min_deg_point, max_deg_point, deg_view = 0, 10, 4

    def __init__(self, num_src_views: int = 3, num_coarse_samples: int = 64,
                 num_fine_samples: int = 64, compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 noise_std: float = 0.0, lindisp: bool = False):
        super().__init__()
        self.num_src_views = num_src_views
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.noise_std, self.lindisp = noise_std, lindisp
        self.compute_dtype = compute_dtype
        pe = 3 * (1 + 2 * (self.max_deg_point - self.min_deg_point))
        vd = 3 * (1 + 2 * self.deg_view)
        self.encoder = SpatialEncoder(dtype=compute_dtype,
                                      generator=generator)
        self.coarse_mlp = PixelNeRFMLP(pe, vd, dtype=compute_dtype,
                                       generator=generator)
        self.fine_mlp = PixelNeRFMLP(pe, vd, dtype=compute_dtype,
                                     generator=generator)

    def encode(self, src_imgs: torch.Tensor, batch_stats: bool
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """src_imgs (NV, H, W, 3) in [-1, 1] -> (the zeros-padded corner
        table (NV, H/2+1, W/2+1, 4*512) of the pixel latent in the compute
        dtype, the latent's (H/2, W/2)). `batch_stats`: BatchNorm on the
        source stack's own statistics, else on the running ones; in
        training mode (`model.train()`) BatchNorm always takes the batch's
        and records its running-statistics update."""
        latent = self.encoder(src_imgs, batch_stats)
        table = build_corner_table(latent, "zeros", dtype=self.compute_dtype)
        return table, tuple(latent.shape[1:3])

    def _latents(self, encoded, cam: torch.Tensor, focal: torch.Tensor,
                 c: torch.Tensor, image_size) -> torch.Tensor:
        """The NV views' latents (NV, M, 512) at the camera points cam
        (NV, M, 3), projected with (f, -f) and view 0's centre, in one
        zeros-mode gather (neo360_tpu/nn/resnet.py:index_latent)."""
        table, hw = encoded
        nv = self.num_src_views
        uv = geometry.projection(cam, torch.stack([focal[0], -focal[0]])[None],
                                 c[:1], nv)
        scale = latent_scaling(hw, cam.device) / torch.tensor(
            image_size, dtype=torch.float32, device=cam.device)
        return table_sample(table, uv * scale - 1.0, hw, "zeros",
                            self.compute_dtype)

    def forward(self, rays: Dict[str, torch.Tensor], encoded,
                white_bkgd: bool = False, randomized: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_u: Optional[List[torch.Tensor]] = None
                ) -> List[Dict[str, torch.Tensor]]:
        """rays: rays_o, rays_d, viewdirs (B, 3), src_imgs (NV, H, W, 3),
        src_poses (NV, 4, 4), src_focal (NV,), src_c (NV, 2); `encoded`:
        `encode(src_imgs, ...)`. Returns one dict per level: rgb, acc,
        depth, weights, t_vals. With `noise_std` a randomized forward
        draws each level's density noise after its samples, or takes it
        from `noise_u`, one (B, S, 1) tensor of uniforms per level."""
        nv = self.num_src_views
        h_img, w_img = rays["src_imgs"].shape[1:3]
        rays_o, rays_d = rays["rays_o"], rays["rays_d"]
        poses = rays["src_poses"]
        viewdirs_cam = geometry.world2camera_viewdirs(
            rays["viewdirs"][None], poses, ns=nv)             # (NV, B, 3)
        viewdirs_enc = encoding.pos_enc(viewdirs_cam, 0, self.deg_view)
        noise_u = list(noise_u or [None, None])
        results = []
        t_vals = weights = None
        for level, mlp in enumerate((self.coarse_mlp, self.fine_mlp)):
            if level == 0:
                t_vals, samples = sampling.sample_along_rays(
                    rays_o, rays_d, self.num_coarse_samples, NEAR, FAR,
                    randomized, self.lindisp, generator=generator)
            else:
                t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                t_vals, samples = sampling.sample_pdf(
                    t_mids, weights[..., 1:-1], rays_o, rays_d, t_vals,
                    self.num_fine_samples, randomized, generator=generator)
            b, s, _ = samples.shape
            cam = geometry.world2camera(samples.reshape(1, -1, 3), poses,
                                        ns=nv)                # (NV, B*S, 3)
            lat = self._latents(encoded, cam, rays["src_focal"],
                                rays["src_c"], (w_img, h_img))
            samples_enc = encoding.pos_enc(cam, self.min_deg_point,
                                           self.max_deg_point)
            # (NV, B*S, .) -> (NV*B, S, .), view-major
            raw_rgb, raw_sigma = mlp(samples_enc.reshape(nv * b, s, -1),
                                     viewdirs_enc.reshape(nv * b, -1),
                                     lat.reshape(nv * b, s, -1), nv)
            if self.noise_std > 0 and randomized:
                raw_sigma = raw_sigma + sampling._uniform(
                    raw_sigma.shape, raw_sigma, noise_u[level],
                    generator) * self.noise_std
            rgb = torch.sigmoid(raw_rgb)
            sigma = F.relu(raw_sigma)
            comp, acc, weights, depth = composite_vanilla(
                rgb, sigma, t_vals, rays_d, white_bkgd)
            results.append({"rgb": comp, "acc": acc, "depth": depth,
                            "weights": weights, "t_vals": t_vals})
        return results
