"""MipNeRF-360 (Barron et al. 2022, arXiv:2111.12077; code
google-research/multinerf, `configs/360.gin`) in plain PyTorch: the
yardstick that decides `correct` for the `mipnerf360` configuration. It
reads its weights from a flat dict keyed as the measured program's
`state_dict()` names them (`prop_mlp_0.pts_0.weight`, ...,
`nerf_mlp.rgb.bias`) and computes every step in float32 from the paper's
equations, in the published code's order where rounding would otherwise
move a resampled edge:

- the 1/t warp of [near, far] onto s in [0, 1];
- the proposal histograms dilated by 0.5 / (samples so far) + 0.0025 and
  renormalized, then resampled by inverse-CDF with one jitter per ray,
  the logits annealed by slope 10 (`torch.searchsorted`, not the dense
  masks of the measured program);
- conical-frustum Gaussians (the stable mean and variances) lifted onto
  the ray;
- the contraction x -> (2 - 1/|x|) x/|x| outside the unit ball, each
  covariance pushed through its Jacobian, here taken by forward-mode
  autodiff (`torch.func.jacfwd`) rather than in closed form;
- the basis (the icosahedron's faces tesselated twice, projected to the
  sphere, duplicates and antipodes dropped in order of appearance),
  generated by its own code;
- the lifted IPE, exp(-var/2) sin(mean) at degrees 0-12 over the basis;
- the MLPs: 4 x 256 density-only proposals; 8 x 1024 with the input again
  after layer 4, a softplus density (bias -1), a 256-wide bottleneck, a
  128-wide view layer on the direction's encoding (degrees 0-4) and a
  padded sigmoid colour;
- the composite with an opaque last interval, exp(-cumsum) transmittance
  and the background at weight max(0, 1 - acc), as plain operations;
- the loss: the data term, the interlevel loss (the proposal histograms
  must bound the NeRF one, by searchsorted) and 0.01 x the distortion loss
  in its O(S^2) form.

Departures from the paper, each the measured program's (so both sides
agree; none changes the work): the data term is sqrt(MSE over the batch +
1e-6) rather than the mean of per-element Charbonnier terms; no gradient
clip (multinerf clips the global norm at 1e-3); the anneal runs over 1e6
steps and the learning-rate schedule over 100,000 (multinerf: both over
its 250,000 steps); far is 3.0, the NERDS360 scenes' bound (360.gin:
1e6); the lifted variances are clamped at 0 before the IPE; a ray whose
resampling logits are all -inf resamples uniformly.

`fault` plants a fault in the reference put in the program's place
(control.py): "jacobian" leaves the covariances as they are instead of
pushing them through the contraction's Jacobian; "half" leaves half of
every ray batch out of the loss. `kind` "tf32" computes every matmul on
TF32 tensor cores (`reference/model.py:matmul_precision`). Nothing of the
measured program, of JAX or of the JAX package is imported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

Weights = Dict[str, torch.Tensor]
EPS = float(np.finfo(np.float32).eps)
KEYS = ("rays_o", "rays_d", "viewdirs", "radii", "target")


@dataclass
class Arch:
    """The sizes and constants the reference builds from (a configuration
    file's keys of the same names)."""
    num_prop_samples: int = 64
    num_nerf_samples: int = 32
    prop_levels: int = 2
    prop_netdepth: int = 4
    prop_netwidth: int = 256
    nerf_netdepth: int = 8
    nerf_netwidth: int = 1024
    skip_layer: int = 4
    bottleneck_width: int = 256
    view_width: int = 128
    min_deg_point: int = 0
    max_deg_point: int = 12
    deg_view: int = 4
    basis_tesselation: int = 2
    near: float = 0.2
    far: float = 3.0
    dilation_multiplier: float = 0.5
    dilation_bias: float = 0.0025
    anneal_slope: float = 10.0
    anneal_steps: float = 1.0e6
    density_bias: float = -1.0
    rgb_padding: float = 0.001
    background: float = 1.0
    data_eps: float = 1.0e-6
    interlevel_mult: float = 1.0
    distortion_mult: float = 0.01
    lr_init: float = 2.0e-3
    lr_final: float = 2.0e-5
    lr_max_steps: int = 100000
    lr_delay_steps: int = 512
    lr_delay_mult: float = 0.01

    @classmethod
    def from_config(cls, cfg: Dict) -> "Arch":
        return cls(**{k: cfg[k] for k in cls.__dataclass_fields__
                      if k in cfg})


# ------------------------------------------------------------ the basis

ICOSAHEDRON_FACES = (
    (0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1), (8, 10, 1),
    (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3), (7, 10, 3), (7, 6, 10),
    (7, 11, 6), (11, 0, 6), (0, 1, 6), (6, 1, 10), (9, 0, 11), (9, 11, 2),
    (9, 2, 5), (7, 2, 11))


def icosahedron() -> np.ndarray:
    """The 12 unit vertices (0, +-1, +-phi) and their cyclic shifts, in the
    published order."""
    a = (1.0 + math.sqrt(5.0)) / 2.0
    v = [(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a), (0, a, 1),
         (0, a, -1), (0, -a, 1), (0, -a, -1), (a, 1, 0), (-a, 1, 0),
         (a, -1, 0), (-a, -1, 0)]
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def basis(tesselation: int = 2, eps: float = 1e-4) -> np.ndarray:
    """(3, V) float32: every face's points at barycentric weights (i, j,
    n - i - j) / n, in face order and (i, j) order, pushed onto the unit
    sphere; a point is kept where it first appears and dropped if its
    antipode was kept before it; columns as (z, y, x). V = 21 at n = 2."""
    n = tesselation
    verts = icosahedron()
    kept: List[np.ndarray] = []
    for face in ICOSAHEDRON_FACES:
        for i in range(n + 1):
            for j in range(n + 1 - i):
                p = np.array([i, j, n - i - j]) / n @ verts[list(face)]
                p = p / np.linalg.norm(p)
                if all(np.sum((p - q) ** 2) > eps for q in kept):
                    kept.append(p)
    half = [p for k, p in enumerate(kept)
            if all(np.sum((p + q) ** 2) >= eps for q in kept[:k])]
    return np.stack(half)[:, ::-1].T.astype(np.float32)


# ------------------------------------------------------------- sampling

def s_to_t(s, near: float, far: float):
    """The inverse of s = (1/t - 1/near) / (1/far - 1/near)."""
    return 1.0 / (s * (1.0 / far) + (1.0 - s) * (1.0 / near))


def linspace(start: float, stop: float, num: int, like: torch.Tensor):
    """start (1 - i/d) + stop (i/d), d = num - 1, the last value exact (as
    jnp.linspace rounds)."""
    i = torch.arange(num - 1, dtype=like.dtype, device=like.device)
    frac = i / (num - 1)
    out = start * (1 - frac) + stop * frac
    return torch.cat([out, torch.full((1,), stop, dtype=like.dtype,
                                      device=like.device)])


def dilate(t, w, dilation: float):
    """The histogram (t, w) dilated by `dilation` (each new edge's density
    is the largest density of the intervals within `dilation` of it) and
    renormalized: (edges (B, 3N+1), weights (B, 3N))."""
    pdf = w / torch.clamp(t[..., 1:] - t[..., :-1], min=EPS)
    lo, hi = t[..., :-1] - dilation, t[..., 1:] + dilation
    edges = torch.sort(torch.cat([t, lo, hi], -1), -1).values.clamp(0.0, 1.0)
    covers = (lo[..., None, :] <= edges[..., :, None]) & \
        (hi[..., None, :] > edges[..., :, None])
    pdf = torch.where(covers, pdf[..., None, :], 0.0).amax(-1)[..., :-1]
    w = pdf * (edges[..., 1:] - edges[..., :-1])
    return edges, w / torch.clamp(w.sum(-1, keepdim=True), min=EPS)


def resample(t, w, anneal: float, n: int, gen):
    """n + 1 interval edges around n stratified draws (one jitter per ray)
    from the histogram (t, softmax(anneal log w)) over its non-empty
    intervals; the outer edges clipped to [0, 1]."""
    logits = torch.where(t[..., 1:] > t[..., :-1], anneal * torch.log(w),
                         -math.inf)
    dead = torch.isneginf(logits).all(-1, keepdim=True)
    logits = torch.where(dead, 0.0, logits)
    p = torch.softmax(logits, -1)
    cdf = torch.cat([torch.zeros_like(p[..., :1]),
                     torch.clamp(torch.cumsum(p[..., :-1], -1), max=1.0),
                     torch.ones_like(p[..., :1])], -1)
    u_max = EPS + (1.0 - EPS) / n
    max_jitter = (1.0 - u_max) / (n - 1) - EPS
    jitter = torch.rand(t.shape[:-1] + (1,), generator=gen, dtype=t.dtype,
                        device=t.device)
    u = (linspace(0.0, 1.0 - u_max, n, t) + jitter * max_jitter).contiguous()
    # the CDF's segment holding each draw: its last edge at or below u
    k = torch.searchsorted(cdf.contiguous(), u, right=True) - 1
    k = k.clamp(0, cdf.shape[-1] - 2)
    c0, c1 = cdf.gather(-1, k), cdf.gather(-1, k + 1)
    t0, t1 = t.gather(-1, k), t.gather(-1, k + 1)
    gap = c1 - c0
    frac = torch.where(gap != 0, (u - c0) / torch.where(gap == 0, 1.0, gap),
                       0.0)
    centers = t0 + torch.clamp(torch.nan_to_num(frac), 0.0, 1.0) * (t1 - t0)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=0.0)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=1.0)
    return torch.cat([first, mid, last], -1)


def cone_gaussians(tdist, rays):
    """The conical frustum of each interval as a Gaussian: means (B, S, 3)
    and full covariances (B, S, 3, 3)."""
    d, radius = rays["rays_d"], rays["radii"]
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=EPS)
    t_mean = mu + (2 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) \
        / denom ** 2
    r_var = (mu ** 2 / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4 / denom) \
        * radius ** 2
    mean = d[..., None, :] * t_mean[..., None] + rays["rays_o"][..., None, :]
    along = d[..., :, None] * d[..., None, :]
    across = torch.eye(3, dtype=d.dtype, device=d.device) - along / \
        torch.clamp((d * d).sum(-1), min=1e-10)[..., None, None]
    cov = t_var[..., None, None] * along[..., None, :, :] + \
        r_var[..., None, None] * across[..., None, :, :]
    return mean, cov


def contract(x):
    """x inside the unit ball, (2 - 1/|x|) x/|x| outside it, written as
    (2 sqrt(s) - 1) / s x with s = |x|^2."""
    s = torch.clamp((x * x).sum(-1, keepdim=True), min=EPS)
    return torch.where(s <= 1.0, x, ((2 * torch.sqrt(s) - 1) / s) * x)


def contract_gaussians(mean, cov, fault=None):
    """Each Gaussian through the contraction: its mean contracted and its
    covariance J cov J^T, J the Jacobian at the mean (forward-mode
    autodiff). The "jacobian" fault keeps the covariance as it is."""
    if fault == "jacobian":
        return contract(mean), cov
    flat = mean.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacfwd(contract))(flat)
    jac = jac.reshape(mean.shape + (3,))
    return contract(mean), jac @ cov @ jac.transpose(-1, -2)


def lifted_ipe(mean, cov, basis_t, min_deg: int, max_deg: int):
    """The Gaussians' marginals along each basis vector, then per degree
    l: exp(-4^l var / 2) sin(2^l mean), the same with sin(x + pi/2); sines
    of every degree first, degree-major. Variances clamped at 0."""
    m = mean @ basis_t
    v = torch.einsum("iv,...ij,jv->...v", basis_t, cov, basis_t)
    v = torch.clamp(v, min=0.0)
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=m.dtype,
                                 device=m.device)
    m = (m[..., None, :] * scales[:, None]).flatten(-2)
    v = (v[..., None, :] * scales[:, None] ** 2).flatten(-2)
    damp = torch.exp(-0.5 * torch.cat([v, v], -1))
    return damp * torch.sin(torch.cat([m, m + 0.5 * math.pi], -1))


def dir_enc(x, deg: int):
    """[x, sin(2^l x), sin(2^l x + pi/2)] for l < deg, degree-major."""
    scales = 2.0 ** torch.arange(0, deg, dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).flatten(-2)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi],
                                             -1))], -1)


# -------------------------------------------------------------- the MLPs

def dense(W: Weights, name: str, x):
    return F.linear(x, W[name + ".weight"], W[name + ".bias"])


def mlp(W: Weights, prefix: str, x, viewdirs, depth: int, arch: Arch,
        colour: bool):
    """(density (B, S), rgb (B, S, 3) or None) of one level's MLP on its
    encoded samples x."""
    inputs = x
    for i in range(depth):
        x = F.relu(dense(W, f"{prefix}.pts_{i}", x))
        if i > 0 and i % arch.skip_layer == 0:
            x = torch.cat([x, inputs], -1)
    density = F.softplus(dense(W, f"{prefix}.density", x)[..., 0]
                         + arch.density_bias)
    if not colour:
        return density, None
    bottleneck = dense(W, f"{prefix}.bottleneck", x)
    d = dir_enc(viewdirs, arch.deg_view)
    d = d[..., None, :].expand(bottleneck.shape[:-1] + d.shape[-1:])
    x = F.relu(dense(W, f"{prefix}.views_0", torch.cat([bottleneck, d], -1)))
    rgb = torch.sigmoid(dense(W, f"{prefix}.rgb", x))
    return density, rgb * (1 + 2 * arch.rgb_padding) - arch.rgb_padding


def alpha_weights(density, tdist, dirs):
    """Each interval's weight, the last interval opaque."""
    delta = (tdist[..., 1:] - tdist[..., :-1]) * torch.linalg.norm(
        dirs[..., None, :], dim=-1)
    dd = density * delta
    dd = torch.cat([dd[..., :-1], torch.full_like(dd[..., -1:], math.inf)],
                   -1)
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], -1)], -1))
    return alpha * trans


def render(W: Weights, arch: Arch, rays: Dict[str, torch.Tensor],
           train_frac: float, gen, basis_t, fault=None):
    """(the NeRF level's colour (B, 3), each level's {"sdist", "weights",
    "density", "rgb"}): the two proposal levels, then the NeRF level,
    sampled with one jitter per ray and level drawn from `gen`."""
    o = rays["rays_o"]
    n_rays = o.shape[0]
    sdist = torch.tensor([0.0, 1.0], dtype=o.dtype,
                         device=o.device).expand(n_rays, 2)
    weights = torch.ones((n_rays, 1), dtype=o.dtype, device=o.device)
    slope = arch.anneal_slope
    anneal = slope * train_frac / ((slope - 1) * train_frac + 1)
    levels = [(f"prop_mlp_{i}", arch.num_prop_samples, arch.prop_netdepth,
               False) for i in range(arch.prop_levels)]
    levels.append(("nerf_mlp", arch.num_nerf_samples, arch.nerf_netdepth,
                   True))
    history, so_far = [], 1
    for i, (prefix, n, depth, colour) in enumerate(levels):
        with torch.no_grad():
            if i > 0:
                sdist, weights = dilate(
                    sdist, weights.detach(), arch.dilation_bias
                    + arch.dilation_multiplier / so_far)
                sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
            so_far *= n
            sdist = resample(sdist, weights, anneal, n, gen)
            tdist = s_to_t(sdist, arch.near, arch.far)
            mean, cov = cone_gaussians(tdist, rays)
            mean, cov = contract_gaussians(mean, cov, fault)
            x = lifted_ipe(mean, cov, basis_t, arch.min_deg_point,
                           arch.max_deg_point)
        density, rgb = mlp(W, prefix, x, rays["viewdirs"], depth, arch,
                           colour)
        weights = alpha_weights(density, tdist, rays["rays_d"])
        history.append({"sdist": sdist, "weights": weights,
                        "density": density, "rgb": rgb})
    acc = weights.sum(-1, keepdim=True)
    bg = torch.maximum(torch.zeros_like(acc), 1 - acc) * arch.background
    return (weights[..., None] * rgb).sum(-2) + bg, history


# ------------------------------------------------------------- the loss

def outer_bound(t, t_env, w_env):
    """The mass of the histogram (t_env, w_env) over the env intervals
    that touch each interval of t (the published searchsorted bounds)."""
    cum = torch.cat([torch.zeros_like(w_env[..., :1]),
                     torch.cumsum(w_env, -1)], -1)
    above = torch.searchsorted(t_env.contiguous(), t.contiguous(),
                               right=True)
    lo = (above - 1).clamp(min=0)
    hi = above.clamp(max=t_env.shape[-1] - 1)
    return cum.gather(-1, hi)[..., 1:] - cum.gather(-1, lo)[..., :-1]


def interlevel(history) -> torch.Tensor:
    t = history[-1]["sdist"].detach()
    w = history[-1]["weights"].detach()
    total = 0.0
    for level in history[:-1]:
        outer = outer_bound(t, level["sdist"], level["weights"])
        total = total + torch.mean(torch.clamp(w - outer, min=0) ** 2
                                   / (w + EPS))
    return total


def distortion(t, w) -> torch.Tensor:
    """The O(S^2) distortion of each ray's histogram, averaged."""
    mid = 0.5 * (t[..., 1:] + t[..., :-1])
    apart = (mid[..., :, None] - mid[..., None, :]).abs()
    inter = (w * (w[..., None, :] * apart).sum(-1)).sum(-1)
    intra = (w ** 2 * (t[..., 1:] - t[..., :-1])).sum(-1) / 3
    return torch.mean(inter + intra)


def loss(arch: Arch, rgb, history, target) -> torch.Tensor:
    mse = torch.mean((rgb - target) ** 2)
    return (torch.sqrt(mse + arch.data_eps)
            + arch.interlevel_mult * interlevel(history)
            + arch.distortion_mult * distortion(history[-1]["sdist"],
                                                history[-1]["weights"]))


# ------------------------------------------------------------ the trainer

class Trainer:
    """Per-step training on one scene: each item is one batch of rays; the
    loss at train_frac = (steps taken) / anneal_steps, its gradient with
    respect to every parameter, one Adam step (no clip) on the NeRF
    schedule."""

    def __init__(self, arch: Arch, weights: Weights, kind: str = "f32",
                 fault=None):
        self.arch, self.kind, self.fault = arch, kind, fault
        self.W = {k: v.detach().float().clone().requires_grad_()
                  for k, v in weights.items()}
        device = next(iter(self.W.values())).device
        self.basis = torch.as_tensor(basis(arch.basis_tesselation),
                                     device=device)
        self.count = 0
        sched = ref_train.nerf_schedule(arch.lr_init, arch.lr_final,
                                        arch.lr_max_steps,
                                        arch.lr_delay_steps,
                                        arch.lr_delay_mult)
        self.opt = ref_train.Adam(list(self.W.values()), math.inf, sched)

    def moments(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.W, self.opt.mu))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.W.items()}

    def loss(self, batch, gen) -> torch.Tensor:
        if self.fault == "half":            # half of the rays left out
            n = batch["rays_o"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        frac = min(max(self.count / self.arch.anneal_steps, 0.0), 1.0)
        rgb, history = render(self.W, self.arch, batch, frac, gen,
                              self.basis, self.fault)
        return loss(self.arch, rgb, history, batch["target"])

    def step(self, batch, gen) -> float:
        with ref_model.matmul_precision(ref_model.Precision(self.kind)):
            value = self.loss(batch, gen)
            grads = torch.autograd.grad(value, list(self.W.values()),
                                        allow_unused=True)
        self.opt.step([torch.zeros_like(p) if g is None else g
                       for g, p in zip(grads, self.W.values())])
        self.count += 1
        return float(value.detach())
