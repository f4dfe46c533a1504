"""Loss primitives (port of neo360_tpu/ops/losses.py:25-101): MSE / PSNR,
the MipNeRF-360 interlevel bound and the distortion loss.

`lossfun_distortion` is the O(S^2) formula, kept as the test oracle of the
O(S) prefix-sum `eff_distloss`. These stay plain PyTorch on the card, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import torch

EPS = 1.1920929e-07


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def _searchsorted(a: torch.Tensor, v: torch.Tensor):
    """Indices of the last a <= v and first a > v, in the dense
    formulation of the JAX code (masked max / min over the bins)."""
    i = torch.arange(a.shape[-1], device=a.device)
    v_ge_a = v[..., None, :] >= a[..., :, None]
    idx_lo = torch.amax(torch.where(v_ge_a, i[:, None], i[:1, None]), dim=-2)
    idx_hi = torch.amin(torch.where(~v_ge_a, i[:, None], i[-1:, None]),
                        dim=-2)
    return idx_lo, idx_hi


def inner_outer(t0: torch.Tensor, t1: torch.Tensor, y1: torch.Tensor):
    """Inner / outer measures on (t1, y1) of the t0 intervals."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]),
                     torch.cumsum(y1, dim=-1)], dim=-1)
    idx_lo, idx_hi = _searchsorted(t1, t0)
    cy1_lo = torch.gather(cy1, -1, idx_lo)
    cy1_hi = torch.gather(cy1, -1, idx_hi)
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                           cy1_lo[..., 1:] - cy1_hi[..., :-1],
                           torch.zeros_like(y0_outer))
    return y0_inner, y0_outer


def lossfun_outer(t: torch.Tensor, w: torch.Tensor, t_env: torch.Tensor,
                  w_env: torch.Tensor) -> torch.Tensor:
    """The proposal histogram (t_env, w_env) must upper-bound (t, w)."""
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + EPS)


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """O(S^2) distortion per ray (B,): t (B,S+1) sorted edges, w (B,S)."""
    ut = 0.5 * (t[..., 1:] + t[..., :-1])
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1),
                           dim=-1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return loss_inter + loss_intra


def eff_distloss(w: torch.Tensor, m: torch.Tensor, interval) -> torch.Tensor:
    """O(S) distortion, mean over rays: w (B,S) weights, m (B,S) sorted
    midpoints, interval a scalar or (B,S) lengths."""
    cum_w = torch.cumsum(w, dim=-1) - w
    cum_wm = torch.cumsum(w * m, dim=-1) - w * m
    loss_inter = 2.0 * torch.sum(w * (m * cum_w - cum_wm), dim=-1)
    loss_intra = torch.sum(w ** 2 * interval, dim=-1) / 3.0
    return torch.mean(loss_inter + loss_intra)
