"""PixelNeRF (port of neo360_tpu/models/pixelnerf.py), and PixelNeRF as
published (Yu et al. 2021, arXiv:2012.02190; github.com/sxyu/pixel-nerf,
conf/default_mv.conf) as `network="resnet"`.

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

`network="resnet"` is the published multi-view network, pixel-nerf's
PixelNeRFNet with its renderer:
- input: each sample rotated into each source camera's axes (pixel-nerf's
  `normalize_z`: R^T x, without the camera's translation), encoded with
  `pos_enc_interleaved` (6 frequencies from 1.5, input first: 39), then
  the ray's unit direction rotated the same way, raw (3): 42 features;
- latent: the sample in the camera's frame, R^T (x - t), projected with
  (f, -f) and the scene's centre and sampled from the border-padded
  latent (one `table_sample`, kernel A, border mode);
- `ResnetFC` (nn/resnetfc.py), one for each level: 5 blocks of 512, the
  latent added into blocks 0-2, the views averaged before block 3;
  sigmoid rgb and ReLU density;
- samples along the unit direction `viewdirs` over [NEAR, FAR]: 64 in
  equal bins (`sampling.sample_bins`), then 16 drawn by bin from the
  coarse weights (`sample_bins_pdf`) and 16 around the coarse depth
  (`sample_near_depth`), the fine level on all 96 sorted;
- the composite of either level is kernel D (`composite_vanilla`), last
  interval 1e10.
Departures from pixel-nerf, each written where it acts: the depth samples
are drawn around the detached coarse depth (pixel-nerf lets the fine loss
reach the coarse network through their positions; kernel D' takes no
gradient in t); the composite scales each interval by |viewdirs|, which
is 1 to rounding; a deterministic forward (`randomized=False`, eval) puts
the coarse samples and the bin draws at their bins' midpoints and the
depth samples at the depth, where pixel-nerf always draws.

Either network takes one scene, src (NV, ...) and rays (R, ...), or SB
scenes, src (SB, NV, ...) and rays (SB, R, ...): one encoder call over the
SB * NV images and one corner table, laid out view-major (table view v *
SB + s is view v of scene s) so that one gather serves every (view,
scene) and the MLP's rows keep the views leading, as `combine_interleaved`
averages them; each scene's samples are projected into its own views with
its own view 0's focal length and centre. The outputs of a level have the
rays' leading shape.

Spans (core/spans.py): `model.encode`; per level `model.sample`,
`model.gather` (the samples into the cameras' frames and the latent
lookup), `model.mlp` (the encodings and the MLP) and `model.composite`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.core import encoding, geometry, sampling
from neo360_tpu_torch.core.constants import cached
from neo360_tpu_torch.core.render import composite_vanilla
from neo360_tpu_torch.core.spans import span
from neo360_tpu_torch.nn.layers import Dense
from neo360_tpu_torch.nn.mlp import combine_interleaved
from neo360_tpu_torch.nn.resnet import SpatialEncoder, latent_scaling
from neo360_tpu_torch.nn.resnetfc import ResnetFC
from neo360_tpu_torch.ops.interpolate import build_corner_table, table_sample

NEAR, FAR = 0.02, 3.0
NETWORKS = ("nerf", "resnet")
LATENT_SIZE = 512           # the SpatialEncoder's channels
# the published network (pixel-nerf conf/default_mv.conf): ResnetFC
# blocks and the block the views are averaged before; the input's
# encoding (frequencies, the first one); the deviation of the samples
# drawn around the coarse depth
RESNET_BLOCKS, RESNET_COMBINE_LAYER = 5, 3
PE_FREQS, PE_FREQ_FACTOR = 6, 1.5
DEPTH_STD = 0.01


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
                 noise_std: float = 0.0, lindisp: bool = False,
                 network: str = "nerf", d_hidden: int = 512,
                 num_fine_depth_samples: int = 16):
        """`network`: "nerf", the JAX package's 4 x 128 MLP (the
        arguments after `network` unused), or "resnet", the published
        `ResnetFC` of RESNET_BLOCKS x `d_hidden` averaging the views
        before block RESNET_COMBINE_LAYER; `num_fine_samples` of its fine
        level are then pixel-nerf's n_fine, of which
        `num_fine_depth_samples` are drawn around the coarse depth."""
        super().__init__()
        if network not in NETWORKS:
            raise ValueError(f"network {network!r}: one of {NETWORKS}")
        self.network = network
        self.num_src_views = num_src_views
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.noise_std, self.lindisp = noise_std, lindisp
        self.compute_dtype = compute_dtype
        self.encoder = SpatialEncoder(dtype=compute_dtype,
                                      generator=generator)
        if network == "resnet":
            if not 0 <= num_fine_depth_samples <= num_fine_samples:
                raise ValueError(f"{num_fine_depth_samples} depth samples "
                                 f"of {num_fine_samples} fine ones")
            self.num_fine_depth_samples = num_fine_depth_samples
            self.padding = "border"
            d_in = 3 * (1 + 2 * PE_FREQS) + 3
            mlp = lambda: ResnetFC(d_in, LATENT_SIZE, 4, RESNET_BLOCKS,
                                   d_hidden, RESNET_COMBINE_LAYER,
                                   compute_dtype, generator)
        else:
            self.padding = "zeros"
            pe = 3 * (1 + 2 * (self.max_deg_point - self.min_deg_point))
            vd = 3 * (1 + 2 * self.deg_view)
            mlp = lambda: PixelNeRFMLP(pe, vd, dtype=compute_dtype,
                                       generator=generator)
        self.coarse_mlp = mlp()
        self.fine_mlp = mlp()

    def encode(self, src_imgs: torch.Tensor, batch_stats: bool
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """src_imgs (NV, H, W, 3), or (SB, NV, H, W, 3) for SB scenes, in
        [-1, 1] -> (the corner table (NV*SB, H/2+1, W/2+1, 4*512) of the
        pixel latent in the compute dtype, view-major, zeros-padded for
        "nerf" and border-padded for "resnet"; the latent's (H/2, W/2)).
        One encoder call over every image. `batch_stats`: BatchNorm on the
        source stack's own statistics, else on the running ones; in
        training mode (`model.train()`) BatchNorm always takes the batch's
        and records its running-statistics update."""
        with span("model.encode"):
            if src_imgs.dim() == 5:
                src_imgs = src_imgs.transpose(0, 1).reshape(
                    (-1,) + src_imgs.shape[2:])
            latent = self.encoder(src_imgs, batch_stats)
            table = build_corner_table(latent, self.padding,
                                       dtype=self.compute_dtype)
        return table, tuple(latent.shape[1:3])

    def _latents(self, encoded, cam: torch.Tensor, focal: torch.Tensor,
                 c: torch.Tensor, image_size) -> torch.Tensor:
        """The latents (NV*SB, M, 512) at the camera points cam (NV*SB, M,
        3), view-major, each scene's projected with (f, -f) and the centre
        of its view 0 (focal (NV,) or (SB, NV), c (NV, 2) or (SB, NV, 2)),
        in one gather of the model's padding
        (neo360_tpu/nn/resnet.py:index_latent)."""
        table, hw = encoded
        f0 = focal.reshape(-1, focal.shape[-1])[:, 0]           # (SB,)
        c0 = c.reshape((-1,) + c.shape[-2:])[:, 0]              # (SB, 2)
        nv = cam.shape[0] // f0.shape[0]
        uv = geometry.projection(cam, torch.stack([f0, -f0], -1).repeat(
            nv, 1), c0.repeat(nv, 1), 1)
        image_size, dev = tuple(image_size), cam.device
        scale = cached("latent_uv.scale", (tuple(hw), image_size),
                       torch.float32, dev,
                       lambda: latent_scaling(hw, dev) / torch.tensor(
                           image_size, dtype=torch.float32, device=dev))
        return table_sample(table, uv * scale - 1.0, hw, self.padding,
                            self.compute_dtype)

    def forward(self, rays: Dict[str, torch.Tensor], encoded,
                white_bkgd: bool = False, randomized: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_u: Optional[List[torch.Tensor]] = None
                ) -> List[Dict[str, torch.Tensor]]:
        """rays: rays_o, rays_d, viewdirs (R, 3), src_imgs (NV, H, W, 3),
        src_poses (NV, 4, 4), src_focal (NV,), src_c (NV, 2); or SB
        scenes: rays (SB, R, 3) and src (SB, NV, ...); `encoded`:
        `encode(src_imgs, ...)`. Returns one dict per level: rgb, acc,
        depth, weights, t_vals, of the rays' leading shape. With
        `noise_std` a randomized "nerf" forward draws each level's density
        noise after its samples, or takes it from `noise_u`, one (R, S, 1)
        tensor of uniforms per level."""
        lead = rays["rays_o"].shape[:-1]
        poses = rays["src_poses"]
        sb = poses.shape[0] if poses.dim() == 4 else 1
        h_img, w_img = rays["src_imgs"].shape[-3:-1]
        views = dict(
            nv=self.num_src_views, sb=sb, image_size=(w_img, h_img),
            # view-major poses: row v * SB + s is view v of scene s
            poses=poses.reshape((sb,) + poses.shape[-3:]).transpose(
                0, 1).reshape(-1, 4, 4))
        flat = {k: rays[k].reshape(-1, 3)
                for k in ("rays_o", "rays_d", "viewdirs")}
        run = self._published if self.network == "resnet" else self._jax
        results = run(flat, rays, views, encoded, white_bkgd, randomized,
                      generator, noise_u)
        return [{k: v.reshape(lead + v.shape[1:]) for k, v in r.items()}
                for r in results]

    def _to_cameras(self, x: torch.Tensor, views) -> torch.Tensor:
        """Points or directions (SB*R, ..., 3) of the scenes' rays, tiled
        over the views: (NV*SB, R*..., 3) in view-major rows."""
        return x.reshape(views["sb"], -1, 3).repeat(views["nv"], 1, 1)

    def _jax(self, flat, rays, views, encoded, white_bkgd, randomized,
             generator, noise_u):
        nv, poses = self.num_src_views, views["poses"]
        rays_o, rays_d = flat["rays_o"], flat["rays_d"]
        viewdirs_cam = geometry.world2camera_viewdirs(
            self._to_cameras(flat["viewdirs"], views), poses)  # (NV*SB, R, 3)
        viewdirs_enc = encoding.pos_enc(viewdirs_cam, 0, self.deg_view)
        noise_u = list(noise_u or [None, None])
        results = []
        t_vals = weights = None
        for level, mlp in enumerate((self.coarse_mlp, self.fine_mlp)):
            with span("model.sample"):
                if level == 0:
                    t_vals, samples = sampling.sample_along_rays(
                        rays_o, rays_d, self.num_coarse_samples, NEAR, FAR,
                        randomized, self.lindisp, generator=generator)
                else:
                    t_mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
                    t_vals, samples = sampling.sample_pdf(
                        t_mids, weights[..., 1:-1], rays_o, rays_d, t_vals,
                        self.num_fine_samples, randomized,
                        generator=generator)
            b, s, _ = samples.shape
            with span("model.gather"):
                cam = geometry.world2camera(self._to_cameras(samples, views),
                                            poses)       # (NV*SB, R*S, 3)
                lat = self._latents(encoded, cam, rays["src_focal"],
                                    rays["src_c"], views["image_size"])
            with span("model.mlp"):
                samples_enc = encoding.pos_enc(cam, self.min_deg_point,
                                               self.max_deg_point)
                # (NV*SB, R*S, .) -> (NV*B, S, .), view-major
                raw_rgb, raw_sigma = mlp(samples_enc.reshape(nv * b, s, -1),
                                         viewdirs_enc.reshape(nv * b, -1),
                                         lat.reshape(nv * b, s, -1), nv)
                if self.noise_std > 0 and randomized:
                    raw_sigma = raw_sigma + sampling._uniform(
                        raw_sigma.shape, raw_sigma, noise_u[level],
                        generator) * self.noise_std
                rgb = torch.sigmoid(raw_rgb)
                sigma = F.relu(raw_sigma)
            with span("model.composite"):
                comp, acc, weights, depth = composite_vanilla(
                    rgb, sigma, t_vals, rays_d, white_bkgd)
            results.append({"rgb": comp, "acc": acc, "depth": depth,
                            "weights": weights, "t_vals": t_vals})
        return results

    def _published(self, flat, rays, views, encoded, white_bkgd,
                   randomized, generator, noise_u=None):
        nv, poses = self.num_src_views, views["poses"]
        rays_o, dirs = flat["rays_o"], flat["viewdirs"]
        b = rays_o.shape[0]
        # the ray's direction in each camera's axes, (NV*SB, R, 3)
        dirs_cam = geometry.world2camera_viewdirs(
            self._to_cameras(dirs, views), poses)
        n_bins = self.num_fine_samples - self.num_fine_depth_samples
        results = []
        for level, mlp in enumerate((self.coarse_mlp, self.fine_mlp)):
            with span("model.sample"):
                if level == 0:
                    t_vals = t_coarse = sampling.sample_bins(
                        b, self.num_coarse_samples, NEAR, FAR, randomized,
                        rays_o, generator)
                else:
                    prev = results[-1]
                    t_vals = torch.sort(torch.cat([
                        t_coarse,
                        sampling.sample_bins_pdf(prev["weights"], n_bins,
                                                 NEAR, FAR, randomized,
                                                 generator),
                        sampling.sample_near_depth(
                            prev["depth"], self.num_fine_depth_samples,
                            DEPTH_STD, NEAR, FAR, randomized,
                            generator)], -1), -1).values
                samples = sampling.cast_rays(t_vals, rays_o, dirs)
            s = samples.shape[1]
            with span("model.gather"):
                tiled = self._to_cameras(samples, views)
                rotated = geometry.world2camera_viewdirs(tiled, poses)
                cam = geometry.world2camera(tiled, poses)
                lat = self._latents(encoded, cam, rays["src_focal"],
                                    rays["src_c"], views["image_size"])
            with span("model.mlp"):
                x = encoding.pos_enc_interleaved(
                    rotated, PE_FREQS, PE_FREQ_FACTOR).reshape(nv * b, s, -1)
                d = dirs_cam.reshape(nv * b, 1, 3).expand(nv * b, s, 3)
                out = mlp(torch.cat([x, d], -1),
                          lat.reshape(nv * b, s, -1), nv)    # (B, S, 4)
                rgb = torch.sigmoid(out[..., :3])
                sigma = F.relu(out[..., 3:])
            with span("model.composite"):
                comp, acc, weights, depth = composite_vanilla(
                    rgb, sigma, t_vals, dirs, white_bkgd)
            results.append({"rgb": comp, "acc": acc, "depth": depth,
                            "weights": weights, "t_vals": t_vals})
        return results
