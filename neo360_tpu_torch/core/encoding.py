"""Positional and integrated positional encodings and the MipNeRF-360
scene contraction (port of neo360_tpu/core/encoding.py).

- `pos_enc`: [x, sin(2^i x), cos(2^i x)], cos as sin(x + pi/2).
- `pos_enc_interleaved`: PixelNeRF's encoding (pixel-nerf src/model/
  code.py): [x, sin(f_0 x), cos(f_0 x), sin(f_1 x), ...], f_i = factor
  2^i, sin and cos of each frequency side by side.
- `integrated_pos_enc`: E[sin] of per-axis Gaussians, exp(-var/2) sin(mean).
- `contract`: x inside the unit ball, (2 - 1/|x|) x/|x| outside it.
- `track_linearize`: pushes a Gaussian through `contract` with its
  Jacobian, written in closed form (the JAX package takes
  jax.vmap(jax.jacfwd)): J = I inside the ball, and for s = |x|^2 > 1,
  c(s) = (2 sqrt(s) - 1) / s, J = c I + 2 c'(s) x x^T with
  c'(s) = (1 - sqrt(s)) / s^2. The model detaches the result, so no
  gradient passes through it.
- `generate_basis`: the tesselated-icosahedron basis of the lifted IPE, host
  numpy (a copy of the JAX package's, bit for bit); `lift_and_diagonalize`
  projects Gaussians onto it.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from neo360_tpu_torch.core.constants import cached


def _scales(min_deg: int, max_deg: int, dtype, device) -> torch.Tensor:
    """2^i for i in [min_deg, max_deg), built once on `device`."""
    return cached("pos_enc.scales", (min_deg, max_deg), dtype, device,
                  lambda: torch.tensor([2.0 ** i for i in range(min_deg,
                                                                max_deg)],
                                       dtype=dtype, device=device))


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """[x, sin(2^i x), cos(2^i x)] for i in [min_deg, max_deg); cos is
    sin(x + pi/2). Output dim = d * (1 + 2 * (max_deg - min_deg))."""
    if min_deg == max_deg:
        return x
    scales = _scales(min_deg, max_deg, x.dtype, x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)


def pos_enc_interleaved(x: torch.Tensor, num_freqs: int,
                        freq_factor: float) -> torch.Tensor:
    """[x, sin(f_0 x), cos(f_0 x), ..., sin(f_{F-1} x), cos(f_{F-1} x)]
    with f_i = freq_factor * 2^i, each term over x's d channels; the
    argument is the phase (0 or pi/2) plus x times the frequency in one
    `addcmul`, as pixel-nerf's PositionalEncoding computes it. Output dim
    = d * (1 + 2 * num_freqs)."""
    def build(values):
        return lambda: torch.tensor(values, dtype=x.dtype,
                                    device=x.device)[:, None]

    key = (num_freqs, freq_factor)
    freqs = cached("pos_enc_interleaved.freqs", key, x.dtype, x.device,
                   build([freq_factor * 2.0 ** (i // 2)
                          for i in range(2 * num_freqs)]))
    phases = cached("pos_enc_interleaved.phases", key, x.dtype, x.device,
                    build([0.5 * math.pi * (i % 2)
                           for i in range(2 * num_freqs)]))
    embed = torch.sin(torch.addcmul(phases, x[..., None, :], freqs))
    return torch.cat([x, embed.flatten(-2)], dim=-1)


def expected_sin(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E[sin(x)] for x ~ N(mean, var) = exp(-var/2) sin(mean)."""
    return torch.exp(-0.5 * var) * torch.sin(mean)


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                       max_deg: int) -> torch.Tensor:
    """IPE of per-axis Gaussians (..., D) -> (..., 2 * D * (max_deg -
    min_deg)): the sines of every degree's scaled means, then the cosines
    (sin(x + pi/2)), degree-major within each half."""
    scales = _scales(min_deg, max_deg, mean.dtype, mean.device)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * math.pi], dim=-1),
        torch.cat([scaled_var] * 2, dim=-1))


def _mag_sq(x: torch.Tensor) -> torch.Tensor:
    eps = torch.finfo(x.dtype).eps
    return torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True), min=eps)


def contract(x: torch.Tensor) -> torch.Tensor:
    """The scene contraction onto the radius-2 ball, per point (..., 3)."""
    s = _mag_sq(x)
    return torch.where(s <= 1.0, x, ((2.0 * torch.sqrt(s) - 1.0) / s) * x)


def contract_jacobian(x: torch.Tensor) -> torch.Tensor:
    """d contract / dx, (..., 3, 3): I where |x|^2 <= 1, else
    c I + 2 c'(s) x x^T (module docstring)."""
    s = _mag_sq(x)
    root = torch.sqrt(s)
    c = (2.0 * root - 1.0) / s
    dc = (1.0 - root) / (s * s)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    outside = c[..., None] * eye + (2.0 * dc[..., None]) * (
        x[..., :, None] * x[..., None, :])
    return torch.where((s <= 1.0)[..., None], eye.expand_as(outside),
                       outside)


def track_linearize(mean: torch.Tensor, cov: torch.Tensor):
    """(contract(mean), J cov J^T) for Gaussians mean (..., 3), cov
    (..., 3, 3), J the contraction's Jacobian at the mean."""
    jac = contract_jacobian(mean)
    return contract(mean), jac @ cov @ jac.transpose(-1, -2)


def _compute_sq_dist(mat0: np.ndarray, mat1: np.ndarray = None
                     ) -> np.ndarray:
    """Squared Euclidean distance between all pairs of columns."""
    if mat1 is None:
        mat1 = mat0
    sq_norm0 = np.sum(mat0 ** 2, 0)
    sq_norm1 = np.sum(mat1 ** 2, 0)
    return np.maximum(0, sq_norm0[:, None] + sq_norm1[None, :]
                      - 2 * mat0.T @ mat1)


def _tesselate_geodesic(base_verts, base_faces, v: int, eps: float = 1e-4):
    """Barycentric tesselation of each face, projected to the sphere and
    deduplicated."""
    int_weights = np.array(
        [(i, j, v - (i + j)) for i in range(v + 1) for j in range(v + 1 - i)])
    tri_weights = int_weights / v
    verts = []
    for face in base_faces:
        new_verts = tri_weights @ base_verts[face, :]
        new_verts /= np.sqrt(np.sum(new_verts ** 2, 1, keepdims=True))
        verts.append(new_verts)
    verts = np.concatenate(verts, 0)
    sq_dist = _compute_sq_dist(verts.T)
    assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq_dist])
    return verts[np.unique(assignment), :]


def generate_basis(base_shape: str = "icosahedron",
                   angular_tesselation: int = 2,
                   remove_symmetries: bool = True,
                   eps: float = 1e-4) -> np.ndarray:
    """The tesselated-polyhedron vertex basis of the lifted IPE, (3, V)
    float32 (V = 21 for the icosahedron at tesselation 2), columns in zyx
    order."""
    if base_shape == "icosahedron":
        a = (np.sqrt(5.0) + 1.0) / 2.0
        verts = np.array(
            [(-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a),
             (0, a, 1), (0, a, -1), (0, -a, 1), (0, -a, -1),
             (a, 1, 0), (-a, 1, 0), (a, -1, 0), (-a, -1, 0)],
            dtype=np.float64) / np.sqrt(a + 2.0)
        faces = np.array(
            [(0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
             (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
             (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
             (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11)])
        verts = _tesselate_geodesic(verts, faces, angular_tesselation)
    elif base_shape == "octahedron":
        verts = np.array(
            [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0),
             (1, 0, 0)], dtype=np.float64)
        corners = np.array(list(itertools.product([-1, 1], repeat=3)))
        pairs = np.argwhere(_compute_sq_dist(corners.T, verts.T) == 2)
        faces = np.sort(np.reshape(pairs[:, 1], [3, -1]).T, 1)
        verts = _tesselate_geodesic(verts, faces, angular_tesselation)
    else:
        raise ValueError(f"base_shape {base_shape!r} not supported")
    if remove_symmetries:
        match = _compute_sq_dist(verts.T, -verts.T) < eps
        verts = verts[np.any(np.triu(match), 1), :]
    return verts[:, ::-1].T.astype(np.float32)


def lift_and_diagonalize(mean: torch.Tensor, cov: torch.Tensor,
                         basis: torch.Tensor):
    """Gaussians (..., 3), (..., 3, 3) projected onto the basis vectors
    (3, V): per-axis means and variances, each (..., V)."""
    fn_mean = mean @ basis
    fn_cov = torch.sum((cov @ basis) * basis[None], dim=-2)
    return fn_mean, fn_cov
