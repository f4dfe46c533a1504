"""Vanilla NeRF (Mildenhall et al. 2020, arXiv:2003.08934, section 5 and
Fig. 7; code github.com/bmild/nerf `run_nerf_helpers.py:init_nerf_model`,
`config_lego.txt`) in plain PyTorch: the yardstick that decides `correct`
for the `vanilla` configuration. It reads its weights from a flat dict
keyed as the measured program's `state_dict()` names them
(`coarse_mlp.pts_0.weight`, ..., `fine_mlp.rgb.bias`) and computes both
levels of a ray batch in float32, with TF32 off, from the configuration's
sizes:

- level 0: num_coarse_samples + 1 t-values evenly spaced over [near, far]
  along the unit view direction (no jitter at render);
- level 1: num_fine_samples t-values drawn by inverse CDF at evenly spaced
  u from level 0's weights at the midpoints of its t-values, the first and
  last weight left out (`reference/model.py:inverse_cdf`, the dense-mask
  form), merged with level 0's t-values and sorted;
- each point x encoded as [x, sin(2^i x), cos(2^i x)] for i in 0..9 (63
  features), the view direction for i in 0..3 (27);
- the MLP: netdepth ReLU layers of netwidth, the encoded point
  concatenated to the output of every layer i with i % skip_layer == 0
  and i > 0 (the fifth, for 8 layers and skip_layer 4); a density head
  and a netwidth bottleneck on the trunk's output; the bottleneck
  concatenated with the encoded direction into netdepth_condition ReLU
  layers of netwidth_condition; an rgb head;
- rgb = sigmoid padded by +-rgb_padding, sigma = softplus(raw +
  sigma_bias);
- the composite: deltas of the t-values, the last 1e10, each scaled by
  |rays_d| (the unnormalized direction), alpha = 1 - exp(-sigma delta),
  T the cumulative product of 1 - alpha + 1e-10 shifted by one, weights
  alpha T; rgb, depth and acc their sums.

Departures from the paper, each the measured program's (so both sides
agree), written where they act and listed in the configuration's
`departures`: the padded sigmoid and the softplus density with its bias
(the paper: a plain sigmoid and a ReLU); 64 + 1 coarse points; no density
noise at render (as the paper's test renders); the composite over the
unnormalized direction.

`fault` plants a fault in the reference put in the program's place
(control.py): "rgb" adds 0.05 to every rendered colour where it is
produced; "unmerged" evaluates the fine level at its drawn points alone,
not merged with level 0's. `kind` "tf32" computes every matmul on TF32
tensor cores (`reference/model.py:matmul_precision`). Nothing of the
measured program, of JAX or of the JAX package is imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.model import (Precision, cast, dense, inverse_cdf,
                                       linspace, matmul_precision, pos_enc)

Weights = Dict[str, torch.Tensor]
FAULTS = ("rgb", "unmerged")
LEVELS = ("coarse_mlp", "fine_mlp")
EPS_ALPHA = 1e-10


@dataclass
class Arch:
    """The sizes and constants the reference builds from (a configuration
    file's keys of the same names)."""
    netdepth: int = 8
    netwidth: int = 256
    skip_layer: int = 4
    netdepth_condition: int = 1
    netwidth_condition: int = 128
    min_deg_point: int = 0
    max_deg_point: int = 10
    deg_view: int = 4
    num_coarse_samples: int = 64
    num_fine_samples: int = 128
    near: float = 0.2
    far: float = 3.0
    rgb_padding: float = 0.001
    sigma_bias: float = -1.0
    white_bkgd: bool = False

    @classmethod
    def from_config(cls, cfg: Dict) -> "Arch":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__
                      if k in cfg})


def mlp(W: Weights, p: Precision, arch: Arch, name: str, x, vd_enc):
    """One level's MLP: x (B, S, 63) encoded points, vd_enc (B, 27) ->
    (raw rgb (B, S, 3), raw density (B, S, 1))."""
    inputs = x
    for i in range(arch.netdepth):
        x = F.relu(dense(W, p, f"{name}.pts_{i}", x))
        if i % arch.skip_layer == 0 and i > 0:
            x = torch.cat([x, inputs], -1)
    density = dense(W, p, f"{name}.density", x)
    h = dense(W, p, f"{name}.bottleneck", x)
    h = torch.cat([h, vd_enc[:, None, :].expand(h.shape[:-1]
                                                + vd_enc.shape[-1:])], -1)
    for i in range(arch.netdepth_condition):
        h = F.relu(dense(W, p, f"{name}.views_{i}", h))
    return dense(W, p, f"{name}.rgb", h), density


def composite(rgb, sigma, t, rays_d):
    """(rgb (B, 3), acc (B,), weights (B, S), depth (B,))."""
    dists = torch.cat([t[..., 1:] - t[..., :-1],
                       torch.full_like(t[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma[..., 0] * dists)
    trans = torch.cumprod(1.0 - alpha + EPS_ALPHA, -1)
    w = alpha * torch.cat([torch.ones_like(trans[..., :1]),
                           trans[..., :-1]], -1)
    return (w[..., None] * rgb).sum(-2), w.sum(-1), w, (w * t).sum(-1)


def render(W: Weights, p: Precision, arch: Arch, rays: Dict
           ) -> List[Dict[str, torch.Tensor]]:
    """Both levels of a ray batch (rays_o, rays_d, viewdirs, each (B, 3)):
    one dict a level, {"rgb", "acc", "weights", "depth", "t_vals"}."""
    o, d, vd = rays["rays_o"], rays["rays_d"], rays["viewdirs"]
    vd_enc = pos_enc(vd, 0, arch.deg_view)
    n0 = arch.num_coarse_samples + 1
    base = linspace(0.0, 1.0, n0, o.device).expand(o.shape[0], n0)
    t = arch.near * (1.0 - base) + arch.far * base
    out = []
    for level, name in enumerate(LEVELS):
        if level == 1:
            drawn = inverse_cdf(0.5 * (t[..., 1:] + t[..., :-1]),
                                out[0]["weights"][..., 1:-1],
                                arch.num_fine_samples, None)
            if p.fault != "unmerged":
                drawn = torch.cat([t, drawn], -1)
            t = torch.sort(drawn, -1).values
        x = pos_enc(cast(t, o, vd), arch.min_deg_point, arch.max_deg_point)
        raw_rgb, raw_sigma = mlp(W, p, arch, name, x, vd_enc)
        rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * arch.rgb_padding) \
            - arch.rgb_padding
        sigma = F.softplus(raw_sigma + arch.sigma_bias)
        comp, acc, w, depth = composite(rgb, sigma, t, d)
        if arch.white_bkgd:
            comp = comp + (1.0 - acc[..., None])
        if p.fault == "rgb":
            comp = comp + 0.05
        out.append({"rgb": comp, "acc": acc, "weights": w, "depth": depth,
                    "t_vals": t})
    return out


def render_blocks(W: Weights, arch: Arch, rays: Dict, block: int,
                  kind: str = "f32", fault=None) -> Dict[str, torch.Tensor]:
    """The fine level's rgb, depth and acc of every ray of `rays`, in
    blocks of `block` rays, in precision `kind`, with `fault` planted."""
    p = Precision(kind, fault)
    n = rays["rays_o"].shape[0]
    with torch.no_grad(), matmul_precision(p):
        outs = [render(W, p, arch, {k: v[i:i + block]
                                    for k, v in rays.items()})[-1]
                for i in range(0, n, block)]
    return {k: torch.cat([o[k] for o in outs]) for k in ("rgb", "depth",
                                                          "acc")}
