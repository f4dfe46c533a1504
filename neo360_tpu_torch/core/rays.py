"""Camera rays of a pinhole camera and the MipNeRF pixel radii (port of
neo360_tpu/core/rays.py:25-97).

OpenGL convention: x right, y up, the camera looks down -z; no +0.5 pixel
centring (the reference's datasets/ray_utils.py). Computed with torch on
the device of the pose.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_INV_SQRT12_X2 = 2.0 / math.sqrt(12.0)


def get_ray_directions(h: int, w: int, focal: float, device=None
                       ) -> torch.Tensor:
    """Per-pixel ray directions in the camera frame, (H, W, 3) float32."""
    i = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    j = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    x = ((i - w / 2.0) / focal).expand(h, w)
    y = (-(j - h / 2.0) / focal).expand(h, w)
    z = -torch.ones((h, w), dtype=torch.float32, device=device)
    return torch.stack([x, y, z], dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """World rays of one camera: directions (..., 3) in the camera frame,
    c2w (3|4, 4) -> rays_o (camera centre), rays_d (unnormalized),
    viewdirs (unit), each (..., 3)."""
    rays_d = directions @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return {"rays_o": rays_o, "rays_d": rays_d, "viewdirs": viewdirs}


def pixel_radii(rays_d_image: torch.Tensor) -> torch.Tensor:
    """MipNeRF base radii of the pixel cones of an (H, W, 3) direction
    image: |d[y+1, x] - d[y, x]| * 2 / sqrt(12), the last row a copy of the
    one before it. Returns (H, W, 1)."""
    dx = torch.sqrt(torch.sum((rays_d_image[:-1] - rays_d_image[1:]) ** 2,
                              dim=-1))
    dx = torch.cat([dx, dx[-2:-1]], dim=0)
    return (dx * _INV_SQRT12_X2)[..., None]


def rays_for_camera(h: int, w: int, focal: float, c2w: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Every pixel's ray of one camera as flat tensors on c2w's device:
    rays_o, rays_d, viewdirs (H*W, 3) and radii (H*W, 1)."""
    r = get_rays(get_ray_directions(h, w, focal, c2w.device),
                 c2w.to(torch.float32))
    radii = pixel_radii(r["rays_d"])
    out = {k: v.reshape(-1, 3) for k, v in r.items()}
    out["radii"] = radii.reshape(-1, 1)
    return out
