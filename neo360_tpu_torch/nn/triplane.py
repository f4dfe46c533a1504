"""Tri-planar world representation — NeO-360's GridEncoder (port of
neo360_tpu/nn/triplane.py:49-354).

Per source stack: SpatialEncoder pixel latent -> lift projection -> the
(X, Y, Z) world grid, projected into every view, samples it through a
corner table (kernel A, zeros mode) -> DepthPillarEncoder -> three
TriPillarAggregator logit maps -> softmax pillar collapse (kernel C) ->
three floorplans -> FloorplanConvNet -> three tri-planes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from neo360_tpu_torch.core import geometry
from neo360_tpu_torch.nn.layers import BatchNorm, Conv, Dense, init_bias, \
    init_weight
from neo360_tpu_torch.nn.resnet import SpatialEncoder, latent_scaling
from neo360_tpu_torch.ops.interpolate import build_corner_table, table_sample
from neo360_tpu_torch.ops.pillar import pillar_collapse


class DepthPillarEncoder(nn.Module):
    """[feat, cam-xyz, dir] -> latent: `hidden_layers` relu Dense layers
    (fc0, fc1, ...) and a final Dense ("depth")."""

    def __init__(self, in_features: int, features: int = 512,
                 dtype=torch.float32, hidden_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dense = lambda i, o: Dense(i, o, dtype=dtype, kernel_init="kaiming",
                                   bias_init="small", generator=generator)
        self.hidden = []
        for i in range(hidden_layers):
            self.add_module(f"fc{i}", dense(in_features if i == 0
                                            else features, features))
            self.hidden.append(f"fc{i}")
        self.depth = dense(features if hidden_layers else in_features,
                           features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.hidden:
            x = F.relu(getattr(self, name)(x))
        return self.depth(x)


class TriPillarAggregator(nn.Module):
    """The three per-axis pillar aggregators with one fused (C, 3F) hidden
    kernel (`hidden_lat`), per-axis coordinate columns `coord_w` (3, F) and
    biases `hidden_b` (3, F), and heads out_yz, out_xz, out_xy."""

    def __init__(self, features: int = 512, dtype=torch.float32,
                 hidden_features: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = hidden_features or features
        self.f, self.dtype = f, dtype
        self.hidden_lat = Dense(features, 3 * f, use_bias=False, dtype=dtype,
                                kernel_init="kaiming", generator=generator)
        self.coord_w = nn.Parameter(torch.empty(3, f))
        # flax's kaiming_normal on a (3, F) param: fan_in = 3
        init_weight(self.coord_w, "kaiming", 3, f, generator)
        self.hidden_b = nn.Parameter(torch.empty(3, f))
        init_bias(self.hidden_b, "small", generator)
        for name in ("yz", "xz", "xy"):
            self.add_module(f"out_{name}", Dense(
                f, 1, dtype=dtype, kernel_init="kaiming", bias_init="small",
                generator=generator))

    def forward(self, latent: torch.Tensor, coords: torch.Tensor):
        """latent (..., C); coords (..., 3) world (x, y, z) of each cell ->
        logit maps (..., 1) for the yz, xz, xy collapses."""
        f = self.f
        hid = self.hidden_lat(latent)
        cw = self.coord_w.to(hid.dtype)
        hb = self.hidden_b.to(hid.dtype)
        logits = []
        for k, name in enumerate(("yz", "xz", "xy")):
            h = F.relu(hid[..., k * f:(k + 1) * f]
                       + coords[..., k:k + 1].to(hid.dtype) * cw[k] + hb[k])
            logits.append(getattr(self, f"out_{name}")(h))
        return logits


class FloorplanConvNet(nn.Module):
    """C-channel floorplan (NHWC) -> plane_dim-channel plane at plane_hw."""

    def __init__(self, in_ch: int, plane_hw: Tuple[int, int] = (120, 160),
                 dtype=torch.float32, plane_dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.plane_hw = tuple(plane_hw)
        conv = lambda i, o, s: Conv(i, o, 3, s, 1, dtype=dtype,
                                    kernel_init="kaiming", bias_init="small",
                                    generator=generator)
        self.conv0 = conv(in_ch, 256, 2)
        self.conv1 = conv(256, 128, 2)
        self.conv2 = conv(128, 128, 1)
        self.conv3 = conv(128, 128, 1)
        self.conv4 = conv(128, plane_dim, 1)
        for i, c in enumerate((256, 128, 128, 128)):
            self.add_module(f"bn{i}", BatchNorm(c, dtype))

    def forward(self, x: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn0(self.conv0(x), batch_stats))
        x = F.relu(self.bn1(self.conv1(x), batch_stats))
        x = F.relu(self.bn2(self.conv2(x), batch_stats))
        x = F.interpolate(x, size=(x.shape[-2] * 2, x.shape[-1] * 2),
                          mode="bilinear", align_corners=True)
        x = F.relu(self.bn3(self.conv3(x), batch_stats))
        if tuple(x.shape[-2:]) != self.plane_hw:
            x = F.interpolate(x, size=self.plane_hw, mode="bilinear",
                              align_corners=True)
        return self.conv4(x).permute(0, 2, 3, 1)


class GridEncoder(nn.Module):
    """Source views -> three tri-planes and the pixel latent.

    The JAX GridEncoder's width fields (neo360_tpu/nn/triplane.py:
    178-189): `pillar_width` is TriPillarAggregator's hidden width (None:
    `latent_size`), `depth_fc_layers` DepthPillarEncoder's hidden layers,
    `plane_dim` the tri-planes' channels. The defaults are the
    reference's."""

    # world box [-1,1] x [-1,1] x [0,1]; planes (120, 160) x plane_dim
    side_lengths = (1.0, 1.0, 1.0)
    plane_hw = (120, 160)

    def __init__(self, grid_size: Sequence[int] = (64, 64, 64),
                 latent_size: int = 512, dtype=torch.float32,
                 lift_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, pillar_width: Optional[int] = None,
                 depth_fc_layers: int = 2, plane_dim: int = 128):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.latent_size = latent_size
        self.plane_dim = plane_dim
        self.remat = remat
        self.spatial_encoder = SpatialEncoder(dtype, generator)
        self.lift_proj = None
        if lift_dim is not None:
            self.lift_proj = Dense(512, lift_dim, use_bias=False, dtype=dtype,
                                   kernel_init="kaiming", generator=generator)
        self.depth_fc = DepthPillarEncoder((lift_dim or 512) + 6, latent_size,
                                           dtype, depth_fc_layers, generator)
        self.tri_pillar = TriPillarAggregator(latent_size, dtype,
                                              pillar_width, generator)
        for name in ("yz", "xz", "xy"):
            self.add_module(f"floorplan_{name}", FloorplanConvNet(
                latent_size, self.plane_hw, dtype, plane_dim, generator))

    def forward(self, images: torch.Tensor, poses: torch.Tensor,
                focal: torch.Tensor, c: torch.Tensor, batch_stats: bool,
                pixel_latent: Optional[torch.Tensor] = None):
        """images (NV, H, W, 3) in [-1, 1]; poses (NV, 4, 4); focal (NV,);
        c (NV, 2). Returns ((plane_xz, plane_xy, plane_yz) each
        (NV, Hp, Wp, plane_dim) f32, pixel latent (NV, H/2, W/2, 512) f32).

        `pixel_latent`: the SpatialEncoder's output for `images`, computed
        beforehand (neo360_tpu/nn/triplane.py:214-256); the SpatialEncoder
        is then skipped. The optimize and finetune modes freeze it with
        BatchNorm on its running statistics, so for a fixed source stack
        its output is a run constant (NeRFTP.encode_images).

        With `remat` and grad enabled, the grid part (`_grid`: lift,
        depth_fc, pillar logits) runs under `torch.utils.checkpoint`: its
        activations, several grid-sized tensors, are recomputed in the
        backward instead of kept (the JAX model's `remat_encoder`). The
        BatchNorms of the ResNet and the floorplan convs lie outside it, so
        each still records one running-statistics update per forward."""
        if pixel_latent is None:
            pixel_latent = self.spatial_encoder(images, batch_stats)
        args = (pixel_latent, poses, focal, c, tuple(images.shape[1:3]))
        if self.remat and torch.is_grad_enabled():
            latent, *logits = torch.utils.checkpoint.checkpoint(
                self._grid, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            latent, *logits = self._grid(*args)
        floor_yz, floor_xz, floor_xy = pillar_collapse(latent, *logits)

        plane_yz = self.floorplan_yz(floor_yz, batch_stats).float()
        plane_xz = self.floorplan_xz(floor_xz, batch_stats).float()
        plane_xy = self.floorplan_xy(floor_xy, batch_stats).float()
        return (plane_xz, plane_xy, plane_yz), pixel_latent.float()

    def _grid(self, pixel_latent, poses, focal, c, image_hw):
        """The world grid lifted from the pixel latent and encoded: latent
        (NV, X, Y, Z, latent_size) and the yz, xz and xy pillar logits
        (NV, X, Y, Z)."""
        nv = pixel_latent.shape[0]
        h, w = image_hw
        gx, gy, gz = self.grid_size
        sx, sy, sz = self.side_lengths
        dev = pixel_latent.device

        world_grid = geometry.get_world_grid(
            [[-sx, sx], [-sy, sy], [0.0, sz]], list(self.grid_size),
            device=dev)
        world_grids = geometry.repeat_interleave(world_grid, nv)  # (NV,G,3)
        camera_grids = geometry.world2camera(world_grids, poses)

        mask = (camera_grids[..., 2] < 1e-3).to(torch.float32)
        cam_dir = world_grids - poses[:, None, :3, 3]
        cam_dir = cam_dir / torch.linalg.norm(cam_dir + 1e-9, dim=-1,
                                              keepdim=True)
        cam_dir = cam_dir * mask[..., None]

        focal2 = torch.stack([focal[0], -focal[0]])[None]   # -fy
        uv = geometry.projection(camera_grids, focal2, c[:1], nv)
        lat_hw = tuple(pixel_latent.shape[1:3])
        scale = latent_scaling(lat_hw, dev) / torch.tensor(
            [w, h], dtype=torch.float32, device=dev)
        uv_norm = uv * scale - 1.0
        lift_map = (self.lift_proj(pixel_latent)
                    if self.lift_proj is not None else pixel_latent)
        latent = table_sample(build_corner_table(lift_map, "zeros"), uv_norm,
                              lat_hw, padding_mode="zeros",
                              out_dtype=lift_map.dtype)     # (NV, G, lift)

        # the JAX concat promotes to f32 and depth_fc casts back to the
        # compute dtype: casting the geometry straight to it is the same
        geo = torch.cat([camera_grids, cam_dir], dim=-1).to(latent.dtype)
        latent = self.depth_fc(torch.cat([latent, geo], dim=-1))
        latent = latent.reshape(nv, gx, gy, gz, self.latent_size)

        coords = world_grid.reshape(1, gx, gy, gz, 3).expand(
            latent.shape[:-1] + (3,))
        logits = self.tri_pillar(latent, coords)
        return (latent,) + tuple(lg[..., 0] for lg in logits)
