"""NeRF++ inverted-sphere parameterization (port of
neo360_tpu/core/spherical.py): sphere exit depth and the 4D lift of
background samples. The reference's assert on rays missing the unit sphere
is a clamp, as in the JAX package."""

from __future__ import annotations

import torch


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def intersect_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """(..., 3) origins and directions -> (..., 1) depth of the unit-sphere
    exit along the (unnormalized) direction."""
    d1 = -torch.sum(rays_d * rays_o, dim=-1, keepdim=True) / torch.sum(
        rays_d ** 2, dim=-1, keepdim=True)
    p = rays_o + d1 * rays_d
    rays_d_cos = 1.0 / _norm(rays_d)
    p_norm_sq = torch.sum(p * p, dim=-1, keepdim=True)
    d2 = torch.sqrt(torch.clamp(1.0 - p_norm_sq, min=0.0)) * rays_d_cos
    return d1 + d2


def depth2pts_outside(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      depth: torch.Tensor) -> torch.Tensor:
    """rays (B, 3), inverse-sphere depth (B, S) in [0, 1] -> (B, S, 4)
    points: the rotated unit direction on the sphere plus 1/r."""
    rays_o = rays_o[..., None, :].expand(depth.shape + (3,))
    rays_d = rays_d[..., None, :].expand(depth.shape + (3,))

    d1 = -torch.sum(rays_d * rays_o, dim=-1, keepdim=True) / torch.sum(
        rays_d ** 2, dim=-1, keepdim=True)
    p_mid = rays_o + d1 * rays_d
    p_mid_norm = _norm(p_mid)
    rays_d_cos = 1.0 / _norm(rays_d)

    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm * p_mid_norm, min=0.0)) \
        * rays_d_cos
    p_sphere = rays_o + (d1 + d2) * rays_d

    rot_axis = torch.cross(rays_o, p_sphere, dim=-1)
    # eps: rays through the origin have a zero cross product and a zero
    # rotation angle, so the guarded axis cancels instead of giving 0/0
    rot_axis = rot_axis / (_norm(rot_axis) + 1e-10)
    phi = torch.asin(torch.clamp(p_mid_norm, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth[..., None], -1.0, 1.0))
    rot_angle = phi - theta

    cos_a = torch.cos(rot_angle)
    sin_a = torch.sin(rot_angle)
    p_sphere_new = (
        p_sphere * cos_a
        + torch.cross(rot_axis, p_sphere, dim=-1) * sin_a
        + rot_axis * torch.sum(rot_axis * p_sphere, dim=-1, keepdim=True)
        * (1.0 - cos_a)
    )
    p_sphere_new = p_sphere_new / (_norm(p_sphere_new) + 1e-10)
    return torch.cat([p_sphere_new, depth[..., None]], dim=-1)
