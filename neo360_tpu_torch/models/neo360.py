"""NeO-360 (port of neo360_tpu/models/neo360.py:47-656): the model, its
training losses and the scene-stage loss functions.

Two variants, as the JAX NeRFTP's `use_proposal`:
- `use_proposal=False` (the `neo360` reference preset): level 0 draws
  num_coarse_samples+1 stratified fg and bg points and conditions them
  like the fine level, through its own fg/bg coarse NeRFTPMLPs and its own
  local table ("c"); level 1 resamples num_fine_samples points from level
  0's histograms and merges them with level 0's edges (merge=True), so it
  evaluates num_coarse + num_fine + 1 points per branch against table "f".
- `use_proposal=True` (the `neo360_fast` model): level 0 is unconditioned
  PropMLP densities on num_prop_samples+1 fg and bg points; level 1 draws
  num_fine_samples+1 points from level 0's padded histograms without the
  union (merge=False).
A conditioned level reads the tri-plane world latent and the pixel-aligned
local latent of every source view and runs NeRFTPMLP with mean view
fusion. Each level composites fg and bg with the NeRF++ rule (kernel B).

`encode` runs once per source stack and returns corner tables; `forward`
renders a ray batch against them, deterministically or (training) with
stratified and random inverse-CDF samples drawn from a `torch.Generator`.
Viewdirs broadcast in (ray, sample) order, the JAX package's documented
divergence from the reference.

Spans (core/spans.py): `model.encode` is `encode`; `forward` takes
`model.rays` (the far bound and view directions), then per level
`model.sample` (the level's samples), `model.gather` (world2camera and
the tri-plane and local gathers), `model.mlp` (the MLPs with their inputs'
encodings and concatenations) and `model.composite`. None lies inside the
encoder's recompute; outside an item (the stage trainer) they record
nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.core import encoding, geometry, sampling, spherical
from neo360_tpu_torch.core.constants import cached
from neo360_tpu_torch.core.render import composite_nerfpp
from neo360_tpu_torch.core.spans import span
from neo360_tpu_torch.nn.layers import Dense
from neo360_tpu_torch.nn.mlp import combine_interleaved
from neo360_tpu_torch.nn.resnet import latent_scaling
from neo360_tpu_torch.nn.layers import commit_running_stats
from neo360_tpu_torch.nn.triplane import GridEncoder
from neo360_tpu_torch.ops import losses
from neo360_tpu_torch.ops.interpolate import build_corner_table, \
    local_sample, triplane_sample


class NeRFTPMLP(nn.Module):
    """Conditioned trunk with mid-network view fusion
    (neo360_tpu/models/neo360.py:47-100).

    The function is the JAX module's: inputs = [pos_enc | local | world];
    a ReLU trunk whose layer after each skip takes [h | inputs]; at
    `combine_layer` a bottleneck, then the mean over views of the trunk;
    the density head; views_0 on [bottleneck | viewdirs_enc], the mean
    over views, then the view branch and the rgb head. Every Dense whose
    input is a concatenation is applied block by block instead, each
    block where it costs least, so no skip or view-direction
    concatenation is built:
    - the input block of each Dense after a skip, [W_h | W_in], joins
      pts_0 in one GEMM over the inputs ([W0; W_in], [b0; b]); the Dense
      later adds h W_hᵀ into its block as the GEMM's accumulator;
    - the bottleneck runs on the view mean of the trunk (B·S rows, not
      NV·B·S): a Dense is affine, so the mean of its outputs is its
      output at the mean;
    - views_0 = [W_b | W_c] is split the same way: the view-direction
      block is mean_v(viewdirs_enc W_cᵀ) + b once per ray (B, Wc), added
      over the samples to bottleneck W_bᵀ, which replaces the mean after
      views_0 as the mean is linear.
    Only the order of the sums differs from the concatenating form.
    Parameters keep their names and shapes; the weights are sliced at
    every call, so one path serves inference and training."""

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

    def _next(self, idx: int) -> Dense:
        """The Dense that takes layer idx's output."""
        if idx + 1 < self.netdepth:
            return getattr(self, f"pts_{idx + 1}")
        return self.density

    def forward(self, x, viewdirs_enc, world_latent, local_latent,
                num_views: int):
        """x (NV*B, S, Dp); viewdirs_enc (NV*B, Dv); latents (NV*B, S, .)
        -> (raw_rgb, raw_density) (B, S, 3|1) f32. The blocks are applied
        as the class docstring says, on rows (NV*B*S, .)."""
        b, s = x.shape[0] // num_views, x.shape[1]
        dt = self.pts_0.dtype
        inputs = torch.cat([x, local_latent, world_latent], dim=-1)
        inputs = inputs.reshape(-1, inputs.shape[-1]).to(dt)
        d_in = inputs.shape[-1]
        heads = [self.pts_0] + [self._next(idx) for idx in
                                range(self.netdepth) if self._skip(idx)]
        w = torch.cat([heads[0].weight]
                      + [d.weight[:, -d_in:] for d in heads[1:]])
        bias = torch.cat([d.bias for d in heads])
        blocks = iter(F.linear(inputs, w.to(dt), bias.to(dt)).split(
            [d.weight.shape[0] for d in heads], dim=-1))

        x = F.relu(next(blocks))
        for idx in range(self.netdepth):
            if idx == self.combine_layer:
                x = combine_interleaved(x, num_views)
                bottleneck = self.bottleneck(x)
            dense = self._next(idx)
            if self._skip(idx):
                x = torch.addmm(next(blocks), x,
                                dense.weight[:, :-d_in].to(dt).t())
            else:
                x = dense(x)
            if idx + 1 < self.netdepth:
                x = F.relu(x)
        raw_density = x

        views_0 = self.views_0
        w_b, w_c = views_0.weight.split(
            [bottleneck.shape[-1], viewdirs_enc.shape[-1]], dim=1)
        cond = combine_interleaved(F.linear(
            viewdirs_enc.to(dt), w_c.to(dt), views_0.bias.to(dt)), num_views)
        h = F.linear(bottleneck, w_b.to(dt)).view(b, s, -1) + cond[:, None]
        h = F.relu(h)
        for idx in range(1, self.netdepth_condition):
            h = F.relu(getattr(self, f"views_{idx}")(h))
        return self.rgb(h).float(), raw_density.float().view(b, s, -1)


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
    """NeO-360's NeRFTP: `use_proposal=False` is the neo360 reference
    model, `use_proposal=True` the neo360_fast model (module docstring)."""

    # the JAX model's fixed hyperparameters (neo360_tpu/models/neo360.py
    # NeRFTP fields and __call__ defaults)
    min_deg_point, max_deg_point, deg_view = 0, 10, 4
    far_uncontracted = 3.0
    rgb_padding = 0.001
    density_bias = -1.0

    def __init__(self, num_src_views: int = 3, num_prop_samples: int = 64,
                 num_fine_samples: int = 256,
                 grid_size: Tuple[int, int, int] = (64, 64, 64),
                 compute_dtype=torch.float32, lift_dim: Optional[int] = None,
                 encoder_width: int = 512,
                 generator: Optional[torch.Generator] = None,
                 use_proposal: bool = False, num_coarse_samples: int = 128,
                 remat_encoder: bool = True, plane_dim: int = 128,
                 local_proj_dim: int = 128,
                 pillar_width: Optional[int] = None,
                 depth_fc_layers: int = 2, lindisp: bool = False,
                 density_noise: float = 0.0, num_levels: int = 2):
        """The JAX NeRFTP's fields, with its defaults: `plane_dim`,
        `pillar_width` and `depth_fc_layers` go to the GridEncoder;
        `local_proj_dim` is the width of the projected pixel latent; the
        conditioned MLPs take both latents. `lindisp` spaces the fg
        level-0 samples in inverse depth. `density_noise` adds U[0,
        density_noise) to every conditioned level's raw density in
        randomized (training) forwards. `num_levels` levels run: level 0,
        then levels that each resample the one before through the fine
        MLPs and the fine local table."""
        super().__init__()
        self.num_src_views = num_src_views
        self.num_prop_samples = num_prop_samples
        self.num_coarse_samples = num_coarse_samples
        self.num_fine_samples = num_fine_samples
        self.compute_dtype = compute_dtype
        self.use_proposal = use_proposal
        self.lindisp = lindisp
        self.density_noise = density_noise
        self.num_levels = num_levels
        # uniform mass added to the proposal histogram before resampling;
        # the conditioned coarse level resamples its own histogram as is
        self.resample_padding = 0.01 if use_proposal else 0.0
        g = generator

        self.encoder = GridEncoder(grid_size=grid_size, dtype=compute_dtype,
                                   lift_dim=lift_dim,
                                   latent_size=encoder_width, generator=g,
                                   remat=remat_encoder,
                                   pillar_width=pillar_width,
                                   depth_fc_layers=depth_fc_layers,
                                   plane_dim=plane_dim)
        pe = lambda d: d * (1 + 2 * (self.max_deg_point - self.min_deg_point))
        vd = 3 * (1 + 2 * self.deg_view)
        cond = local_proj_dim + plane_dim
        mlp = lambda d: NeRFTPMLP(pe(d) + cond, vd, dtype=compute_dtype,
                                  generator=g)
        if use_proposal:
            self.fg_prop_mlp = PropMLP(3, dtype=compute_dtype, generator=g)
            self.bg_prop_mlp = PropMLP(4, dtype=compute_dtype, generator=g)
        else:
            self.fg_coarse_mlp = mlp(3)
            self.bg_coarse_mlp = mlp(4)
        self.fg_fine_mlp = mlp(3)
        self.bg_fine_mlp = mlp(4)
        # project-then-gather: each conditioned MLP's first-layer local block
        # is applied to the pixel-latent map once per encode
        # (neo360.py:216-230); "c" feeds the coarse level, "f" the fine one
        self.local_names = ("f",) if use_proposal else ("c", "f")
        for name in self.local_names:
            for branch in ("fg", "bg"):
                self.add_module(f"local_proj_{branch}_{name}", Dense(
                    512, local_proj_dim, use_bias=False, dtype=compute_dtype,
                    generator=g))

    def encode_images(self, src_imgs, batch_stats: bool = False):
        """The SpatialEncoder's pixel latents (NV, H/2, W/2, 512) in the
        compute dtype (neo360_tpu/models/neo360.py:232-239): the part of
        `encode` that the optimize and finetune modes freeze, with
        BatchNorm on its running statistics unless `batch_stats`. For a
        fixed source stack it is a run constant, to be passed to `encode`
        as `pixel_latent`."""
        return self.encoder.spatial_encoder(src_imgs, batch_stats)

    def encode(self, src_imgs, src_poses, src_focal, src_c,
               batch_stats: bool, pixel_latent=None):
        """-> (plane corner tables (xz, xy, yz), local corner table(s),
        (plane_hw, latent_hw)).

        `batch_stats`: BatchNorm with the source stack's own statistics
        (eval_bn_mode "batch") or the stored running ones ("running"); in
        training mode (`model.train()`) BatchNorm always uses the batch's
        statistics and records its running-statistics update. A local
        table stacks the fg branch's projected pixel latent in view rows
        [:NV] and the bg branch's in rows [NV:], so a level samples both
        with one gather. With the proposal there is one local table (the
        fine level's); without it a tuple of two, (coarse "c", fine
        "f"). `pixel_latent`: `encode_images(src_imgs)` computed
        beforehand; the SpatialEncoder is then skipped
        (neo360_tpu/models/neo360.py:241-254)."""
        with span("model.encode"):
            planes, pixel_latent = self.encoder(src_imgs, src_poses,
                                                src_focal, src_c, batch_stats,
                                                pixel_latent)
            dt = self.compute_dtype
            plane_tables = tuple(build_corner_table(p, "zeros", dtype=dt)
                                 for p in planes)
            local = tuple(build_corner_table(torch.cat(
                [getattr(self, f"local_proj_fg_{name}")(pixel_latent),
                 getattr(self, f"local_proj_bg_{name}")(pixel_latent)],
                dim=0), "border", dtype=dt) for name in self.local_names)
            hw = (tuple(planes[0].shape[1:3]),
                  tuple(pixel_latent.shape[1:3]))
            return plane_tables, local[0] if self.use_proposal else local, hw

    def _local_feats_pair(self, cam, focal, c, stacked_table, latent_hw,
                          image_size, view_offset: int = 0, grad_acc=None):
        """Pixel-aligned projected latents for the fg and bg branches in one
        border-mode gather (neo360_tpu/models/neo360.py:276-305) from the
        camera points cam (NV, 2M, 3) of [fg | bg]: `local_sample`, one
        fused kernel on the card. Returns (fg latent, bg latent), each
        (NV, M, D). `view_offset`: the first view row of this scene in a
        flat multi-scene table; `grad_acc`: the table's f32 gradient
        accumulator (`table_sample`'s accumulate contract)."""
        nv = self.num_src_views
        image_size = tuple(image_size)
        scale = cached("local_sample.scale", (tuple(latent_hw), image_size),
                       torch.float32, None,
                       lambda: latent_scaling(latent_hw) / torch.tensor(
                           image_size, dtype=torch.float32)).tolist()
        latent = local_sample(stacked_table, cam, focal, c, scale, latent_hw,
                              view_offset=view_offset, grad_acc=grad_acc)
        return latent[:nv], latent[nv:]

    def _predict(self, mlp, cam_pts, world_lat, local_lat, viewdirs_enc,
                 b: int, n_samples: int, noise=None):
        """`noise`: None, or (u, generator) for the density noise: the
        uniforms `u` (B, S, 1), or drawn from `generator` when u is None
        (neo360_tpu/models/neo360.py:454-465)."""
        nv = self.num_src_views
        x = encoding.pos_enc(cam_pts, self.min_deg_point, self.max_deg_point)
        raw_rgb, raw_sigma = mlp(
            x.reshape(nv * b, n_samples, -1),
            viewdirs_enc.reshape(nv * b, -1),
            world_lat.reshape(nv * b, n_samples, -1),
            local_lat.reshape(nv * b, n_samples, -1), nv)
        if noise is not None:
            u = sampling._uniform(raw_sigma.shape, raw_sigma, *noise)
            raw_sigma = raw_sigma + u * self.density_noise
        sigma = F.softplus(raw_sigma + self.density_bias)
        rgb = torch.sigmoid(raw_rgb)
        rgb = rgb * (1 + 2 * self.rgb_padding) - self.rgb_padding
        return rgb, sigma

    def forward(self, rays: Dict[str, torch.Tensor], encoded,
                white_bkgd: bool = False, out_depth: bool = False,
                randomized: bool = False,
                generator: Optional[torch.Generator] = None,
                noise_u: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]
                = None) -> List[Dict[str, torch.Tensor]]:
        """Render a ray batch (neo360_tpu/models/neo360.py:307-502).

        rays: rays_o/rays_d/viewdirs (B, 3), src_imgs (NV, H, W, 3),
        src_poses (NV, 4, 4), src_focal (NV,), src_c (NV, 2); `encoded`:
        the output of `encode`, optionally with a 4th element
        (scene index, scene count) when the tables are flat multi-scene
        tables (the scene-mixed stage trainer): this scene's rows start at
        view index * NV of the plane tables and * 2NV of the local tables;
        None for a single scene. An optional 5th element, ((3 plane
        accumulators), local accumulator(s) shaped as `encoded[1]`), f32
        tensors of the tables' shapes, makes the backward add the tables'
        gradients into them instead of returning them (the stage trainer's
        accumulate path). `randomized`: stratified level-0 samples and
        random inverse-CDF resampling, drawn from `generator` in the JAX
        order (fg then bg, per level). With `density_noise` a randomized
        forward also draws each conditioned level's fg then bg density
        noise after that level's samples, or takes them from `noise_u`,
        one (fg, bg) pair of (B, S, 1) uniforms per conditioned level, in
        order. Returns one dict per level with rgb,
        fg_rgb, bg_rgb, fg_acc, bg_acc, bg_lambda, fg/bg weights, fg/bg
        sdist (distortion midpoints), fg/bg tvals and far, and with
        `out_depth` depth and fg_depth."""
        plane_tables, local_tables = encoded[0], encoded[1]
        nv = self.num_src_views
        plane_off = local_off = 0
        if len(encoded) > 3 and encoded[3] is not None:
            s_idx = int(encoded[3][0])
            plane_off, local_off = s_idx * nv, s_idx * 2 * nv
        plane_acc, local_acc = (encoded[4] if len(encoded) > 4
                                and encoded[4] is not None else (None, None))
        if self.use_proposal:   # one local table: the fine level's
            local_tables, local_acc = (local_tables,), (local_acc,)
        elif local_acc is None:
            local_acc = (None, None)
        plane_hw = (plane_tables[0].shape[1] - 1,
                    plane_tables[0].shape[2] - 1)
        latent_hw = (local_tables[0].shape[1] - 1,
                     local_tables[0].shape[2] - 1)
        h_img, w_img = rays["src_imgs"].shape[1:3]
        image_size = (w_img, h_img)
        poses = rays["src_poses"]
        rays_o, rays_d = rays["rays_o"], rays["rays_d"]
        rnd = dict(randomized=randomized, generator=generator)

        with span("model.rays"):
            near = torch.full_like(rays_o[..., :1], 1e-4)
            far = spherical.intersect_sphere(rays_o, rays_d)
            # rays missing the unit sphere would give far < near
            far = torch.clamp(far, min=2e-4)

            viewdirs_cam = geometry.world2camera_viewdirs(
                rays["viewdirs"][None], poses, ns=nv)       # (NV, B, 3)
            viewdirs_enc = encoding.pos_enc(viewdirs_cam, 0, self.deg_view)

        noisy = randomized and self.density_noise != 0.0
        noise_u = iter(noise_u or ())
        results: List[Dict[str, torch.Tensor]] = []
        for level in range(self.num_levels):
            with span("model.sample"):
                if level == 0:
                    n0 = (self.num_prop_samples if self.use_proposal
                          else self.num_coarse_samples)
                    fg_t, fg_samples = sampling.sample_along_rays_nerfpp(
                        rays_o, rays_d, n0, near, far, in_sphere=True,
                        lindisp=self.lindisp, **rnd)
                    bg_t, bg_samples, bg_linear = (
                        sampling.sample_along_rays_nerfpp(
                            rays_o, rays_d, n0, near, far, in_sphere=False,
                            far_uncontracted=self.far_uncontracted,
                            lindisp=self.lindisp, **rnd))
                else:
                    pad = self.resample_padding
                    merge = not self.use_proposal
                    prev = results[-1]
                    fg_mids = 0.5 * (fg_t[..., 1:] + fg_t[..., :-1])
                    fg_t, fg_samples = sampling.sample_pdf_nerfpp(
                        fg_mids, prev["fg_weights"][..., 1:-1].detach() + pad,
                        rays_o, rays_d, fg_t, self.num_fine_samples,
                        in_sphere=True, merge=merge, **rnd)
                    bg_mids = 0.5 * (bg_t[..., 1:] + bg_t[..., :-1])
                    bg_t, bg_samples, bg_linear = sampling.sample_pdf_nerfpp(
                        bg_mids, prev["bg_weights"][..., 1:-1].detach() + pad,
                        rays_o, rays_d, bg_t, self.num_fine_samples,
                        in_sphere=False, far=far,
                        far_uncontracted=self.far_uncontracted, merge=merge,
                        **rnd)

            if self.use_proposal and level == 0:
                with span("model.mlp"):
                    fg_sigma = F.softplus(self.fg_prop_mlp(fg_samples)
                                          + self.density_bias)
                    bg_sigma = F.softplus(self.bg_prop_mlp(bg_samples)
                                          + self.density_bias)
                    fg_rgb = torch.zeros(fg_sigma.shape[:-1] + (3,),
                                         device=fg_sigma.device)
                    bg_rgb = torch.zeros(bg_sigma.shape[:-1] + (3,),
                                         device=bg_sigma.device)
            else:
                with span("model.gather"):
                    which = "coarse" if level == 0 else "fine"
                    tab = 0 if self.use_proposal else min(level, 1)
                    b, s = fg_samples.shape[:2]
                    bg_pts = bg_linear[..., :3]
                    # fg + bg: one world2camera, one tri-plane gather and one
                    # local gather
                    cam = geometry.world2camera(
                        torch.cat([fg_samples, bg_pts], dim=0).reshape(
                            1, -1, 3), poses, ns=nv)       # (NV, 2*B*S, 3)
                    world = triplane_sample(plane_tables, cam, plane_hw,
                                            view_offset=plane_off,
                                            grad_acc=plane_acc)
                    world_fg, world_bg = world[:, :b * s], world[:, b * s:]
                    local_fg, local_bg = self._local_feats_pair(
                        cam, rays["src_focal"], rays["src_c"],
                        local_tables[tab], latent_hw, image_size,
                        view_offset=local_off, grad_acc=local_acc[tab])
                    fg_cam = cam[:, :b * s]

                    bg_cam = geometry.world2camera(
                        bg_samples[..., :3].reshape(1, -1, 3), poses, ns=nv)
                    bg_depth_ch = bg_samples[..., 3].reshape(1, -1, 1).expand(
                        bg_cam.shape[:-1] + (1,))
                    bg_cam4 = torch.cat([bg_cam, bg_depth_ch], dim=-1)
                with span("model.mlp"):
                    fg_u, bg_u = next(noise_u, (None, None))
                    fg_rgb, fg_sigma = self._predict(
                        getattr(self, f"fg_{which}_mlp"), fg_cam, world_fg,
                        local_fg, viewdirs_enc, b, s,
                        (fg_u, generator) if noisy else None)
                    bg_rgb, bg_sigma = self._predict(
                        getattr(self, f"bg_{which}_mlp"), bg_cam4, world_bg,
                        local_bg, viewdirs_enc, b, bg_samples.shape[1],
                        (bg_u, generator) if noisy else None)

            with span("model.composite"):
                out = composite_nerfpp(fg_rgb, fg_sigma, fg_t, bg_rgb,
                                       bg_sigma, bg_t, rays_d, far,
                                       white_bkgd)
                # distortion midpoints (neo360_tpu/models/neo360.py:482-489)
                fg_sdist = 0.5 * (fg_t[..., 1:] + fg_t[..., :-1])
                last = fg_sdist[..., -1:] + (fg_sdist[..., -1:]
                                             - fg_sdist[..., -2:-1])
                bg_sdist = 0.5 * (bg_t[..., 1:] + bg_t[..., :-1])
                out.update(fg_tvals=fg_t, bg_tvals=bg_t, far=far,
                           fg_sdist=torch.cat([fg_sdist, last], dim=-1),
                           bg_sdist=torch.cat([bg_sdist, bg_t[..., -1:]],
                                              dim=-1))
                if not out_depth:
                    del out["depth"], out["fg_depth"]
                results.append(out)
        return results


SRC_KEYS = ("src_imgs", "src_poses", "src_focal", "src_c")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs")


def neo360_distortion_loss(results, mult: float = 0.01) -> torch.Tensor:
    """Distortion on the fine level's fg and bg histograms with uniform 1/N
    interval (neo360_tpu/models/neo360.py:599-615). The bg midpoints
    descend, so bg is flipped to ascending first, as the JAX code does."""
    fine = results[-1]
    n = fine["fg_weights"].shape[-1]
    loss = mult * losses.eff_distloss(fine["fg_weights"], fine["fg_sdist"],
                                      1.0 / n)
    return loss + mult * losses.eff_distloss(
        torch.flip(fine["bg_weights"], [-1]),
        torch.flip(fine["bg_sdist"], [-1]), 1.0 / n)


def _hist_edges_fg(tvals: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """Point-convention t (B,S) -> ascending edges (B,S+1), the last
    interval closed by the sphere exit `far`."""
    return torch.cat([tvals, torch.maximum(far, tvals[..., -1:])], -1)


def _hist_edges_bg(tvals: torch.Tensor) -> torch.Tensor:
    """Descending s-space t (B,S) -> ascending edges (B,S+1) of the flipped
    weights; the first (formerly infinite) interval is clamped to a 1e-3
    bin below 0."""
    a = torch.flip(tvals, [-1])
    return torch.cat([a[..., :1] - 1e-3, a], -1)


def neo360_interlevel_loss(results, mult: float = 1.0) -> torch.Tensor:
    """The proposal level's fg / bg histograms must upper-bound the
    detached fine histograms (neo360_tpu/models/neo360.py:634-656)."""
    prop, fine = results[0], results[-1]
    fg_c = _hist_edges_fg(fine["fg_tvals"], fine["far"]).detach()
    fg_w = fine["fg_weights"].detach()
    loss = torch.mean(losses.lossfun_outer(
        fg_c, fg_w, _hist_edges_fg(prop["fg_tvals"], prop["far"]),
        prop["fg_weights"]))
    bg_c = _hist_edges_bg(fine["bg_tvals"]).detach()
    bg_w = torch.flip(fine["bg_weights"], [-1]).detach()
    loss = loss + torch.mean(losses.lossfun_outer(
        bg_c, bg_w, _hist_edges_bg(prop["bg_tvals"]),
        torch.flip(prop["bg_weights"], [-1])))
    return mult * loss


def neo360_loss(results, target: torch.Tensor):
    """(training loss, fine MSE): MSE on the fine level + interlevel bound
    + distortion, the `use_proposal` loss of the JAX trainer."""
    l1 = losses.img2mse(results[1]["rgb"], target)
    return (l1 + neo360_interlevel_loss(results)
            + neo360_distortion_loss(results)), l1


def neo360_coarse_fine_loss(results, target: torch.Tensor):
    """(training loss, fine MSE): MSE on the coarse and the fine level +
    distortion, the loss of the JAX trainer without the proposal
    (neo360_tpu/cli.py:291-293)."""
    l0 = losses.img2mse(results[0]["rgb"], target)
    l1 = losses.img2mse(results[1]["rgb"], target)
    return l0 + l1 + neo360_distortion_loss(results), l1


def training_loss(model: NeRFTP, results, target: torch.Tensor):
    """The JAX trainer's loss for `model`'s variant: `neo360_loss` with the
    proposal, `neo360_coarse_fine_loss` without (looked up when called)."""
    fn = neo360_loss if model.use_proposal else neo360_coarse_fine_loss
    return fn(results, target)


def make_scene_stage_fns(model: NeRFTP, white_bkgd: bool = False,
                         mixed: bool = False, randomized: bool = True
                         ) -> Tuple[Callable, Callable]:
    """(encode_fn, loss_fn) for train.loop.make_scene_stage_trainer (port of
    neo360_tpu/models/neo360.py:505-596).

    encode_fn(src) -> tables (the 3 plane tables, then the local table,
    or the coarse and fine local tables without the proposal):
    `NeRFTP.encode` with BatchNorm in training mode; the running statistics are committed once the stage's scenes are
    encoded. loss_fn(tables, src, batch, generator, grad_acc=None) ->
    (loss, {"mse"}): the ray branch against the tables, with randomized
    sampling (drawn from `generator`) unless `randomized` is False, and the
    model variant's `training_loss`.
    `grad_acc`: one f32 accumulator per table; the backward then adds the
    tables' gradients into them and returns None for the tables.

    `mixed=True` (the SCENE-MIXED stage): `src` tensors carry a leading
    scene axis S and every step's ray batch is (S, B/S, ...). The encoder
    runs once per scene (each scene's 3 views are one BatchNorm batch), the
    new running statistics are the mean over scenes of each scene's Flax
    update, and the tables are flattened along the view-row axis, scene s
    addressed from view s * NV (plane tables) and s * 2NV (local table).
    The loss is the mean over scenes."""

    def _local(tables):   # the local table(s) as encode returns them
        return tables[3] if model.use_proposal else tuple(tables[3:])

    def _encode_one(src):
        pt, lt, _ = model.encode(*(src[k] for k in SRC_KEYS), True)
        return tuple(pt) + ((lt,) if model.use_proposal else lt)

    def _loss_one(tables, src, batch, generator, scene=None, grad_acc=None):
        rays = {k: batch[k] for k in RAY_KEYS}
        rays.update({k: src[k] for k in SRC_KEYS})
        acc = None if grad_acc is None else (tuple(grad_acc[:3]),
                                             _local(grad_acc))
        enc = (tables[:3], _local(tables), None, scene, acc)
        out = model(rays, enc, white_bkgd, randomized=randomized,
                    generator=generator)
        return training_loss(model, out, batch["target"])

    if not mixed:
        def encode_fn(src):
            tables = _encode_one(src)
            commit_running_stats(model)
            return tables

        def loss_fn(tables, src, batch, generator, grad_acc=None):
            loss, l1 = _loss_one(tables, src, batch, generator,
                                 grad_acc=grad_acc)
            return loss, {"mse": l1.detach()}

        return encode_fn, loss_fn

    def encode_fn(src):
        n_scenes = src["src_imgs"].shape[0]
        per = [_encode_one({k: src[k][i] for k in SRC_KEYS})
               for i in range(n_scenes)]
        commit_running_stats(model)
        return tuple(torch.cat(t, dim=0) for t in zip(*per))

    def loss_fn(tables, src, batch, generator, grad_acc=None):
        n_scenes = batch["target"].shape[0]
        pairs = [_loss_one(tables, {k: src[k][i] for k in SRC_KEYS},
                           {k: v[i] for k, v in batch.items()}, generator,
                           scene=(i, n_scenes), grad_acc=grad_acc)
                 for i in range(n_scenes)]
        return (torch.stack([p[0] for p in pairs]).mean(),
                {"mse": torch.stack([p[1] for p in pairs]).mean().detach()})

    return encode_fn, loss_fn
