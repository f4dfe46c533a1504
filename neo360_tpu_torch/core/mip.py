"""MipNeRF-360 sampling (port of neo360_tpu/core/mip.py): the s-space
warp, weight dilation, histogram resampling and conical-frustum Gaussians.

The masks of `max_dilate` and `sorted_interp` stay dense, (B, N, M)
elementwise max / min reductions as in the JAX package: the resampled
edges are then the JAX package's in every case, ties and empty bins
included (`torch.searchsorted` breaks ties differently). At the path's
sizes a mask is (2048, 191, 65) entries a level in training.

Randomized sampling draws one jitter per ray (single jitter) through
`core.sampling._uniform`: from an explicit `torch.Generator`, or the
numbers a test hands to both packages. Nothing here takes a gradient: the
model detaches every input of the resampling, as the JAX model stops
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from neo360_tpu_torch.core import sampling
from neo360_tpu_torch.core.geometry import linspace

EPS = 1.1920929e-07  # float32 machine epsilon, as in the JAX package


def construct_ray_warps(t_near, t_far):
    """(t_to_s, s_to_t) of the 1/t warp normalized to [0, 1]."""
    s_near, s_far = 1.0 / t_near, 1.0 / t_far

    def t_to_s(t):
        return (1.0 / t - s_near) / (s_far - s_near)

    def s_to_t(s):
        return 1.0 / (s * s_far + (1.0 - s) * s_near)

    return t_to_s, s_to_t


def weight_to_pdf(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return w / torch.clamp(t[..., 1:] - t[..., :-1], min=EPS)


def pdf_to_weight(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t: torch.Tensor, w: torch.Tensor, dilation,
               domain: Tuple[float, float]):
    """Dilate the step function (t, w) by `dilation`, the max over the
    intervals that cover each new edge: (t_dilate (..., 3N+1), w_dilate
    (..., 3N)) for N intervals."""
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    t_dilate = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
    t_dilate = torch.clamp(t_dilate, domain[0], domain[1])
    mask = ((t0[..., None, :] <= t_dilate[..., None])
            & (t1[..., None, :] > t_dilate[..., None]))
    w_dilate = torch.amax(torch.where(mask, w[..., None, :],
                                      torch.zeros((), dtype=w.dtype,
                                                  device=w.device)),
                          dim=-1)[..., :-1]
    return t_dilate, w_dilate


def max_dilate_weights(t, w, dilation, domain, renormalize: bool):
    p = weight_to_pdf(t, w)
    t_dilate, p_dilate = max_dilate(t, p, dilation, domain)
    w_dilate = pdf_to_weight(t_dilate, p_dilate)
    if renormalize:
        w_dilate = w_dilate / torch.clamp(
            torch.sum(w_dilate, dim=-1, keepdim=True), min=EPS)
    return t_dilate, w_dilate


def integrate_weights(w: torch.Tensor) -> torch.Tensor:
    """CDF over the bin edges, pinned to 0 and 1 at the ends."""
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1.0)
    shape = cw.shape[:-1] + (1,)
    return torch.cat([torch.zeros(shape, dtype=cw.dtype, device=cw.device),
                      cw, torch.ones(shape, dtype=cw.dtype,
                                     device=cw.device)], dim=-1)


def sorted_interp(x: torch.Tensor, xp: torch.Tensor,
                  fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of sorted (xp, fp) at sorted x, by
    dense masked max / min (the JAX package's formulation)."""
    mask = x[..., None, :] >= xp[..., :, None]
    fp0 = torch.amax(torch.where(mask, fp[..., None], fp[..., :1, None]),
                     dim=-2)
    fp1 = torch.amin(torch.where(mask, fp[..., -1:, None], fp[..., None]),
                     dim=-2)
    xp0 = torch.amax(torch.where(mask, xp[..., None], xp[..., :1, None]),
                     dim=-2)
    xp1 = torch.amin(torch.where(mask, xp[..., -1:, None], xp[..., None]),
                     dim=-2)
    denom = xp1 - xp0
    offset = torch.where(denom != 0.0,
                         (x - xp0) / torch.where(denom == 0,
                                                 torch.ones_like(denom),
                                                 denom),
                         torch.zeros_like(denom))
    offset = torch.clamp(torch.nan_to_num(offset, nan=0.0), 0.0, 1.0)
    return fp0 + offset * (fp1 - fp0)


def invert_cdf(u: torch.Tensor, t: torch.Tensor,
               w_logits: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(w_logits, dim=-1)
    return sorted_interp(u, integrate_weights(w), t)


def sample(t: torch.Tensor, w_logits: torch.Tensor, num_samples: int,
           randomized: bool, single_jitter: bool = False,
           deterministic_center: bool = False,
           u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """`num_samples` draws from the histogram (t, softmax(w_logits)) by
    stratified CDF inversion: evenly spaced (centred with
    `deterministic_center`), or jittered with `randomized` by uniforms of
    shape (..., 1) with `single_jitter`, else (..., num_samples)."""
    shape = t.shape[:-1] + (num_samples,)
    if not randomized:
        if deterministic_center:
            pad = 1.0 / (2 * num_samples)
            grid = linspace(pad, 1.0 - pad - EPS, num_samples, t.dtype,
                            t.device)
        else:
            grid = linspace(0.0, 1.0 - EPS, num_samples, t.dtype, t.device)
        grid = grid.expand(shape)
    else:
        u_max = EPS + (1.0 - EPS) / num_samples
        max_jitter = (1.0 - u_max) / (num_samples - 1) - EPS
        d = 1 if single_jitter else num_samples
        jitter = sampling._uniform(t.shape[:-1] + (d,), t, u, generator)
        grid = (linspace(0.0, 1.0 - u_max, num_samples, t.dtype, t.device)
                + jitter * max_jitter)
    return invert_cdf(grid.contiguous(), t, w_logits)


def sample_intervals(t: torch.Tensor, w_logits: torch.Tensor,
                     num_samples: int, randomized: bool,
                     single_jitter: bool = False,
                     domain: Tuple[float, float] = (-float("inf"),
                                                    float("inf")),
                     u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """num_samples + 1 interval edges centred on histogram draws, the
    outer two clipped to `domain`."""
    centers = sample(t, w_logits, num_samples, randomized, single_jitter,
                     deterministic_center=True, u=u, generator=generator)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    min_val, max_val = domain
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=min_val)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=max_val)
    return torch.cat([first, mid, last], dim=-1)


def lift_gaussian(d: torch.Tensor, t_mean: torch.Tensor,
                  t_var: torch.Tensor, r_var: torch.Tensor, diag: bool):
    """Per-interval (t_mean, t_var, r_var) lifted onto the ray direction
    d: means (..., S, 3) and covariances (..., S, 3[, 3])."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True),
                           min=1e-10)
    if diag:
        d_outer_diag = d ** 2
        null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(d, t0, t1, radius, diag: bool):
    """Mean and covariance of a conical frustum, in the stable form."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=EPS)
    t_mean = mu + (2 * mu * hw ** 2) / denom
    t_var = (hw ** 2) / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) \
        / denom ** 2
    r_var = (mu ** 2) / 4 + (5 / 12) * hw ** 2 - (4 / 15) * (hw ** 4) / denom
    r_var = r_var * radius ** 2
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(d, t0, t1, radius, diag: bool):
    t_mean = (t0 + t1) / 2
    r_var = radius ** 2 / 4
    t_var = (t1 - t0) ** 2 / 12
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays_gaussian(t_vals, origins, directions, radii,
                       ray_shape: str = "cone", diag: bool = True):
    """Per-interval Gaussians along each ray: means (B, S, 3) offset by
    the origins, covariances (B, S, 3, 3) (or (B, S, 3) with `diag`)."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    if ray_shape == "cone":
        fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        fn = cylinder_to_gaussian
    else:
        raise ValueError(f"ray_shape {ray_shape!r} not supported")
    means, covs = fn(directions, t0, t1, radii, diag)
    return means + origins[..., None, :], covs
