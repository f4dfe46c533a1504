"""NeO-360 with the proposal fast path (port of
neo360_tpu/models/neo360.py:47-502, `use_proposal=True`, eval path).

Level 0: unconditioned PropMLP densities on 64+1 fg and bg points.
Level 1: 60+1 points per branch resampled from the level-0 histograms
(no union with the level-0 edges), conditioned on the tri-plane world
latent and the pixel-aligned local latent of every source view, through
NeRFTPMLP with mean view fusion. Each level composites fg and bg with the
NeRF++ rule (kernel B).

`encode` runs once per source stack and returns corner tables; `forward`
renders a ray batch against them. Viewdirs broadcast in (ray, sample)
order, the JAX package's documented divergence from the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.core import encoding, geometry, sampling, spherical
from neo360_tpu_torch.core.render import composite_nerfpp
from neo360_tpu_torch.nn.layers import Dense
from neo360_tpu_torch.nn.mlp import combine_interleaved
from neo360_tpu_torch.nn.resnet import latent_scaling
from neo360_tpu_torch.nn.triplane import GridEncoder, index_grid_tables
from neo360_tpu_torch.ops.interpolate import build_corner_table, table_sample


class NeRFTPMLP(nn.Module):
    """Conditioned trunk with mid-network view fusion
    (neo360_tpu/models/neo360.py:47-100)."""

    def __init__(self, in_features: int, viewdir_features: int,
                 netdepth: int = 4, netwidth: int = 128,
                 netdepth_condition: int = 2, netwidth_condition: int = 64,
                 skip_layer: int = 2, combine_layer: int = 3,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.netdepth, self.netdepth_condition = netdepth, netdepth_condition
        self.skip_layer, self.combine_layer = skip_layer, combine_layer
        dense = lambda i, o: Dense(i, o, dtype=dtype, kernel_init="xavier",
                                   generator=generator)
        width_in = in_features
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", dense(width_in, netwidth))
            width_in = netwidth
            if self._skip(idx):
                width_in += in_features
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

    def forward(self, x, viewdirs_enc, world_latent, local_latent,
                num_views: int):
        """x (NV*B, S, Dp); viewdirs_enc (NV*B, Dv); latents (NV*B, S, .)
        -> (raw_rgb, raw_density) (B, S, 3|1) f32."""
        x = torch.cat([x, local_latent, world_latent], dim=-1)
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


class PropMLP(nn.Module):
    """Unconditioned density-only proposal MLP
    (neo360_tpu/models/neo360.py:103-126)."""

    def __init__(self, point_dim: int, netdepth: int = 4, netwidth: int = 128,
                 min_deg: int = 0, max_deg: int = 10, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.netdepth, self.min_deg, self.max_deg = netdepth, min_deg, max_deg
        dense = lambda i, o: Dense(i, o, dtype=dtype, kernel_init="xavier",
                                   generator=generator)
        width_in = point_dim * (1 + 2 * (max_deg - min_deg))
        for idx in range(netdepth):
            self.add_module(f"pts_{idx}", dense(width_in, netwidth))
            width_in = netwidth
        self.density = dense(width_in, 1)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """points (B, S, 3|4) -> raw density (B, S, 1) f32."""
        x = encoding.pos_enc(points, self.min_deg, self.max_deg)
        for idx in range(self.netdepth):
            x = F.relu(getattr(self, f"pts_{idx}")(x))
        return self.density(x).float()


class NeRFTP(nn.Module):
    """NeO-360 with `use_proposal=True` (the neo360_fast model)."""

    # the JAX model's fixed hyperparameters (neo360_tpu/models/neo360.py
    # NeRFTP fields and __call__ defaults)
    min_deg_point, max_deg_point, deg_view = 0, 10, 4
    far_uncontracted = 3.0
    rgb_padding = 0.001
    density_bias = -1.0
    resample_padding = 0.01
    local_proj_dim = 128

    def __init__(self, num_src_views: int = 3, num_prop_samples: int = 64,
                 num_fine_samples: int = 64,
                 grid_size: Tuple[int, int, int] = (64, 64, 64),
                 compute_dtype=torch.float32, lift_dim: Optional[int] = None,
                 encoder_width: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_src_views = num_src_views
        self.num_prop_samples = num_prop_samples
        self.num_fine_samples = num_fine_samples
        self.compute_dtype = compute_dtype
        g = generator

        self.encoder = GridEncoder(grid_size=grid_size, dtype=compute_dtype,
                                   lift_dim=lift_dim,
                                   latent_size=encoder_width, generator=g)
        self.fg_prop_mlp = PropMLP(3, dtype=compute_dtype, generator=g)
        self.bg_prop_mlp = PropMLP(4, dtype=compute_dtype, generator=g)
        pe = lambda d: d * (1 + 2 * (self.max_deg_point - self.min_deg_point))
        vd = 3 * (1 + 2 * self.deg_view)
        local_proj_dim = self.local_proj_dim
        cond = local_proj_dim + GridEncoder.plane_dim
        self.fg_fine_mlp = NeRFTPMLP(pe(3) + cond, vd, dtype=compute_dtype,
                                     generator=g)
        self.bg_fine_mlp = NeRFTPMLP(pe(4) + cond, vd, dtype=compute_dtype,
                                     generator=g)
        # project-then-gather: each fine MLP's first-layer local block is
        # applied to the pixel-latent map once per encode (neo360.py:216-230)
        self.local_proj_fg_f = Dense(512, local_proj_dim, use_bias=False,
                                     dtype=compute_dtype, generator=g)
        self.local_proj_bg_f = Dense(512, local_proj_dim, use_bias=False,
                                     dtype=compute_dtype, generator=g)

    def encode(self, src_imgs, src_poses, src_focal, src_c,
               batch_stats: bool):
        """-> (plane corner tables (xz, xy, yz), stacked fg/bg local corner
        table, (plane_hw, latent_hw)).

        `batch_stats`: BatchNorm with the source stack's own statistics
        (eval_bn_mode "batch") or the stored running ones ("running"). The
        fg branch's projected pixel latent fills view rows [:NV] of the local
        table and the bg branch's rows [NV:], so the fine level samples both
        with one gather."""
        planes, pixel_latent = self.encoder(src_imgs, src_poses, src_focal,
                                            src_c, batch_stats)
        dt = self.compute_dtype
        plane_tables = tuple(build_corner_table(p, "zeros", dtype=dt)
                             for p in planes)
        stacked = torch.cat([self.local_proj_fg_f(pixel_latent),
                             self.local_proj_bg_f(pixel_latent)], dim=0)
        local_table = build_corner_table(stacked, "border", dtype=dt)
        hw = (tuple(planes[0].shape[1:3]), tuple(pixel_latent.shape[1:3]))
        return plane_tables, local_table, hw

    def _local_feats_pair(self, fg_samples, bg_samples, poses, focal, c,
                          stacked_table, latent_hw, image_size):
        """Pixel-aligned projected latents for the fg and bg branches in one
        border-mode gather (neo360_tpu/models/neo360.py:276-305). Returns
        (fg latent, bg latent, fg camera points), latents (NV, B*S, D)."""
        nv = self.num_src_views
        fg_cam = geometry.world2camera(fg_samples.reshape(1, -1, 3), poses,
                                       ns=nv)
        bg_cam = geometry.world2camera(bg_samples.reshape(1, -1, 3), poses,
                                       ns=nv)
        focal2 = torch.stack([focal[0], -focal[0]])[None]
        uv_fg = geometry.projection(fg_cam, focal2, c[:1], nv)
        uv_bg = geometry.projection(bg_cam, focal2, c[:1], nv)
        scale = latent_scaling(latent_hw, fg_cam.device) / torch.tensor(
            image_size, dtype=torch.float32, device=fg_cam.device)
        uv = torch.cat([uv_fg, uv_bg], dim=0) * scale - 1.0
        latent = table_sample(stacked_table, uv, latent_hw,
                              padding_mode="border")
        return latent[:nv], latent[nv:], fg_cam

    def _predict(self, mlp, cam_pts, world_lat, local_lat, viewdirs_enc,
                 b: int, n_samples: int):
        nv = self.num_src_views
        x = encoding.pos_enc(cam_pts, self.min_deg_point, self.max_deg_point)
        raw_rgb, raw_sigma = mlp(
            x.reshape(nv * b, n_samples, -1),
            viewdirs_enc.reshape(nv * b, -1),
            world_lat.reshape(nv * b, n_samples, -1),
            local_lat.reshape(nv * b, n_samples, -1), nv)
        sigma = F.softplus(raw_sigma + self.density_bias)
        rgb = torch.sigmoid(raw_rgb)
        rgb = rgb * (1 + 2 * self.rgb_padding) - self.rgb_padding
        return rgb, sigma

    def forward(self, rays: Dict[str, torch.Tensor], encoded,
                white_bkgd: bool = False, out_depth: bool = False
                ) -> List[Dict[str, torch.Tensor]]:
        """Deterministic (eval) render of a ray batch.

        rays: rays_o/rays_d/viewdirs (B, 3), src_imgs (NV, H, W, 3),
        src_poses (NV, 4, 4), src_focal (NV,), src_c (NV, 2); `encoded`:
        the output of `encode`. Returns one dict per level with rgb,
        fg_rgb, bg_rgb, fg_acc, bg_acc, bg_lambda, fg/bg weights and
        t_vals, far, and with `out_depth` depth and fg_depth."""
        plane_tables, local_table, (plane_hw, latent_hw) = encoded
        nv = self.num_src_views
        h_img, w_img = rays["src_imgs"].shape[1:3]
        image_size = (w_img, h_img)
        poses = rays["src_poses"]
        rays_o, rays_d = rays["rays_o"], rays["rays_d"]

        near = torch.full_like(rays_o[..., :1], 1e-4)
        far = spherical.intersect_sphere(rays_o, rays_d)
        # rays missing the unit sphere would give far < near
        far = torch.clamp(far, min=2e-4)

        viewdirs_cam = geometry.world2camera_viewdirs(
            rays["viewdirs"][None], poses, ns=nv)           # (NV, B, 3)
        viewdirs_enc = encoding.pos_enc(viewdirs_cam, 0, self.deg_view)

        results: List[Dict[str, torch.Tensor]] = []
        for level in range(2):
            if level == 0:
                fg_t, fg_samples = sampling.sample_along_rays_nerfpp(
                    rays_o, rays_d, self.num_prop_samples, near, far,
                    in_sphere=True)
                bg_t, bg_samples, bg_linear = (
                    sampling.sample_along_rays_nerfpp(
                        rays_o, rays_d, self.num_prop_samples, near, far,
                        in_sphere=False,
                        far_uncontracted=self.far_uncontracted))
                fg_sigma = F.softplus(self.fg_prop_mlp(fg_samples)
                                      + self.density_bias)
                bg_sigma = F.softplus(self.bg_prop_mlp(bg_samples)
                                      + self.density_bias)
                fg_rgb = torch.zeros(fg_sigma.shape[:-1] + (3,),
                                     device=fg_sigma.device)
                bg_rgb = torch.zeros(bg_sigma.shape[:-1] + (3,),
                                     device=bg_sigma.device)
            else:
                pad = self.resample_padding
                prev = results[-1]
                fg_mids = 0.5 * (fg_t[..., 1:] + fg_t[..., :-1])
                fg_t, fg_samples = sampling.sample_pdf_nerfpp(
                    fg_mids, prev["fg_weights"][..., 1:-1] + pad, rays_o,
                    rays_d, self.num_fine_samples, in_sphere=True)
                bg_mids = 0.5 * (bg_t[..., 1:] + bg_t[..., :-1])
                bg_t, bg_samples, bg_linear = sampling.sample_pdf_nerfpp(
                    bg_mids, prev["bg_weights"][..., 1:-1] + pad, rays_o,
                    rays_d, self.num_fine_samples, in_sphere=False,
                    far=far, far_uncontracted=self.far_uncontracted)

                b, s = fg_samples.shape[:2]
                bg_pts = bg_linear[..., :3]
                # fg + bg in one tri-plane gather and one local gather
                world = index_grid_tables(
                    torch.cat([fg_samples, bg_pts], dim=0), plane_tables,
                    plane_hw, poses, nv)
                world_fg, world_bg = world[:, :b * s], world[:, b * s:]
                local_fg, local_bg, fg_cam = self._local_feats_pair(
                    fg_samples, bg_pts, poses, rays["src_focal"],
                    rays["src_c"], local_table, latent_hw, image_size)

                bg_cam = geometry.world2camera(
                    bg_samples[..., :3].reshape(1, -1, 3), poses, ns=nv)
                bg_depth_ch = bg_samples[..., 3].reshape(1, -1, 1).expand(
                    bg_cam.shape[:-1] + (1,))
                bg_cam4 = torch.cat([bg_cam, bg_depth_ch], dim=-1)

                fg_rgb, fg_sigma = self._predict(
                    self.fg_fine_mlp, fg_cam, world_fg, local_fg,
                    viewdirs_enc, b, s)
                bg_rgb, bg_sigma = self._predict(
                    self.bg_fine_mlp, bg_cam4, world_bg, local_bg,
                    viewdirs_enc, b, bg_samples.shape[1])

            out = composite_nerfpp(fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma,
                                   bg_t, rays_d, far, white_bkgd)
            out.update(fg_tvals=fg_t, bg_tvals=bg_t, far=far)
            if not out_depth:
                del out["depth"], out["fg_depth"]
            results.append(out)
        return results
