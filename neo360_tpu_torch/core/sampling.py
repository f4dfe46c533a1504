"""Ray sampling: the vanilla stratified and inverse-CDF samplers and the
NeRF++ fg/bg split (port of neo360_tpu/core/sampling.py:29-145, 150-235).

The inverse-CDF lookup uses `torch.searchsorted` instead of the JAX
package's dense (B, N+1, M) mask, with the same results: the mask
`u >= cdf` is a prefix of the bins (cdf never decreases), `count` its
length, and the masked max / min of the JAX code are the running max of
x[:count] and the running min of x[count:] (plus x[-1]). For ascending bins
those are x[count-1] and x[count]. Background bins DESCEND (inverse depth),
where the running forms give x[0] and x[-1] as the JAX code does, so the
running max / min are kept rather than plain indexing.

Randomized (training) sampling draws its uniforms from an explicit
`torch.Generator`, or takes them as `u` (the tests pass the numbers that
`jax.random.uniform` draws, so both packages see the same ones); a
data-parallel rank passes a `RowDraws`, which draws the global batch's
uniforms and keeps the rank's rows. The resampled t is detached, as
`jax.lax.stop_gradient` does in the JAX code.
"""

from __future__ import annotations

from typing import Optional

import torch

from neo360_tpu_torch.core.geometry import linspace
from neo360_tpu_torch.core.spherical import depth2pts_outside

_FLOAT_MIN_EPS = 2.0 ** -32


class RowDraws:
    """A generator whose draws are rows `index` of `count` of the draws of
    the global batch: `rand(shape)` draws (shape[0] * count, ...) from
    `generator` and keeps this block of the leading (ray) axis."""

    def __init__(self, generator: torch.Generator, index: int, count: int):
        self.generator, self.index, self.count = generator, index, count

    def rand(self, shape, dtype, device) -> torch.Tensor:
        n = shape[0]
        full = torch.rand((n * self.count,) + tuple(shape[1:]),
                          generator=self.generator, dtype=dtype,
                          device=device)
        return full[self.index * n:(self.index + 1) * n]


def _uniform(shape, like: torch.Tensor, u: Optional[torch.Tensor],
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """`u` if given (checked against `shape`), else U[0, 1) drawn from
    `generator` (a torch.Generator or a RowDraws) on `like`'s device."""
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected "
                             f"{tuple(shape)}")
        return u.to(like.device, like.dtype)
    if isinstance(generator, RowDraws):
        return generator.rand(tuple(shape), like.dtype, like.device)
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def stratify(t_vals: torch.Tensor, u: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Jitter bin edges uniformly within adjacent-midpoint intervals
    (neo360_tpu/core/sampling.py:_stratify)."""
    mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
    upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
    lower = torch.cat([t_vals[..., :1], mids], dim=-1)
    t_rand = _uniform(t_vals.shape, t_vals, u, generator)
    return lower + (upper - lower) * t_rand


def cast_rays(t_vals: torch.Tensor, origins: torch.Tensor,
              directions: torch.Tensor) -> torch.Tensor:
    """points[..., i, :] = o + t_i * d."""
    return origins[..., None, :] + t_vals[..., None] * directions[..., None, :]


def sorted_piecewise_constant_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    randomized: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of a piecewise-constant PDF: bins (B, N+1),
    weights (B, N) -> (B, num_samples), at evenly spaced u, or with
    `randomized` at uniform random u (`u` or drawn from `generator`)."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)

    shape = cdf.shape[:-1] + (num_samples,)
    if randomized:
        u = _uniform(shape, cdf, u, generator)
    else:
        u = linspace(0.0, 1.0 - _FLOAT_MIN_EPS, num_samples, cdf.dtype,
                     cdf.device).expand(shape)
    u = u.contiguous()

    # count = #{j : cdf[j] <= u} >= 1 since cdf[0] = 0 <= u
    count = torch.searchsorted(cdf.contiguous(), u, right=True)
    last = cdf.shape[-1] - 1
    i0 = count - 1
    i1 = torch.clamp(count, max=last)

    def masked_max(x):
        return torch.gather(torch.cummax(x, dim=-1).values, -1, i0)

    def masked_min(x):
        run_min = torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values,
                             [-1])
        return torch.gather(run_min, -1, i1)

    bin0, bin1 = masked_max(bins), masked_min(bins)
    cdf0, cdf1 = masked_max(cdf), masked_min(cdf)

    denom = cdf1 - cdf0
    t = torch.where(denom > 0,
                    (u - cdf0) / torch.where(denom == 0,
                                             torch.ones_like(denom), denom),
                    torch.zeros_like(denom))
    t = torch.clamp(torch.nan_to_num(t, nan=0.0), 0.0, 1.0)
    return bin0 + t * (bin1 - bin0)


def sample_along_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    num_samples: int,
    near,
    far,
    randomized: bool = False,
    lindisp: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Stratified samples over [near, far] (neo360_tpu/core/sampling.py:
    44-69): (t_vals (B, N+1), coords (B, N+1, 3)), evenly spaced in depth,
    or in inverse depth with `lindisp`; `randomized` jitters them
    (`stratify`)."""
    bsz = rays_o.shape[0]
    t_vals = linspace(0.0, 1.0, num_samples + 1, rays_o.dtype, rays_o.device)
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    t_vals = t_vals.expand(bsz, num_samples + 1)
    if randomized:
        t_vals = stratify(t_vals, u, generator)
    return t_vals, cast_rays(t_vals, rays_o, rays_d)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    num_samples: int,
    randomized: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Fine-level resampling (neo360_tpu/core/sampling.py:124-145):
    `num_samples` inverse-CDF draws from the histogram (bins, weights),
    detached, merged with `t_vals` and sorted -> (t_vals (B, N + M),
    coords (B, N + M, 3))."""
    t_samples = sorted_piecewise_constant_pdf(
        bins, weights, num_samples, randomized, u, generator).detach()
    t_vals = torch.sort(torch.cat([t_vals, t_samples], dim=-1),
                        dim=-1).values
    return t_vals, cast_rays(t_vals, origins, directions)


def sample_along_rays_nerfpp(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    num_samples: int,
    near,
    far,
    in_sphere: bool,
    far_uncontracted: float = 4.0,
    randomized: bool = False,
    lindisp: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """NeO-360 level-0 sampling (neo360_tpu/core/sampling.py:150-193);
    `randomized` jitters the edges (`stratify`) before the bg flip.

    in_sphere=True: (t_vals (B, N+1), coords (B, N+1, 3)) over [near, far],
    evenly spaced in depth, or in inverse depth with `lindisp`.
    in_sphere=False: inverse-sphere depths s in [0, 1], flipped to descend;
    returns (t_vals, coords4d (B, N+1, 4), coords_linear (B, N+1, 3)) where
    the linear points at t in [far, far_uncontracted] index the features.
    """
    bsz = rays_o.shape[0]
    t_vals = linspace(0.0, 1.0, num_samples + 1, rays_o.dtype, rays_o.device)
    if in_sphere and lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    elif in_sphere:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    t_vals = t_vals.expand(bsz, num_samples + 1)
    if randomized:
        t_vals = stratify(t_vals, u, generator)

    if in_sphere:
        return t_vals, cast_rays(t_vals, rays_o, rays_d)

    t_vals_linear = far * (1.0 - t_vals) + far_uncontracted * t_vals
    t_vals = torch.flip(t_vals, [-1])
    t_vals_linear = torch.flip(t_vals_linear, [-1])
    coords_linear = cast_rays(t_vals_linear, rays_o, rays_d)
    coords = depth2pts_outside(rays_o, rays_d, t_vals)
    return t_vals, coords, coords_linear


def sample_pdf_nerfpp(
    bins: torch.Tensor,
    weights: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    num_samples: int,
    in_sphere: bool,
    far=None,
    far_uncontracted: float = 3.0,
    randomized: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    merge: bool = True,
):
    """Fine-level NeRF++ resampling (neo360_tpu/core/sampling.py:196-235).

    merge=True: num_samples points are drawn, detached, concatenated after
    the level-0 `t_vals` and sorted together (for bg the level-0 t_vals
    descend and the union is flipped back to descend), num_samples + N + 1
    points per ray. merge=False (the proposal path): num_samples + 1 points
    are drawn, detached and sorted, and `t_vals` is not read."""
    t_samples = sorted_piecewise_constant_pdf(
        bins, weights, num_samples if merge else num_samples + 1,
        randomized, u, generator).detach()
    if merge:
        t_samples = torch.cat([t_vals, t_samples], dim=-1)
    t_vals = torch.sort(t_samples, dim=-1).values

    if in_sphere:
        return t_vals, cast_rays(t_vals, origins, directions)

    t_vals_linear = far * (1.0 - t_vals) + far_uncontracted * t_vals
    t_vals = torch.flip(t_vals, [-1])
    coords = depth2pts_outside(origins, directions, t_vals)
    t_vals_linear = torch.flip(t_vals_linear, [-1])
    coords_linear = cast_rays(t_vals_linear, origins, directions)
    return t_vals, coords, coords_linear
