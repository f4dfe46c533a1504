"""Camera rays of a pinhole camera, the MipNeRF pixel radii and the ray
helpers (port of neo360_tpu/core/rays.py).

OpenGL convention: x right, y up, the camera looks down -z; no +0.5 pixel
centring (the reference's datasets/ray_utils.py). Rays are computed with
torch on the device of the pose; pose flips and the segmentation-driven
ray picking are host numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
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


def convert_pose_pd_to_nerf(c2w: np.ndarray) -> np.ndarray:
    """Parallel-Domain -> NeRF camera axis flip: c2w right-multiplied by
    [[1,0,0,0],[0,0,-1,0],[0,1,0,0],[0,0,0,1]] (host numpy)."""
    flip = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], dtype=c2w.dtype)
    return c2w @ flip


def opencv_to_opengl(c2w: np.ndarray) -> np.ndarray:
    """Flip the y and z columns: OpenCV -> OpenGL camera (host numpy)."""
    return c2w @ np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=c2w.dtype))


def ndc_rays(h: int, w: int, focal, near, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Shift rays to the near plane and map them to NDC (the reference's
    ray_utils.py:205-246) -> (rays_o, rays_d), each (..., 3)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def ray_aabb_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor,
                          box_min, box_max):
    """Slab test of rays (..., 3) against an axis-aligned box: (hit, t_near,
    t_far), each (...). A ray that starts inside the box or behind it
    reports no hit, and a miss has t_near = t_far = 0."""
    box_min = torch.as_tensor(box_min, dtype=rays_o.dtype,
                              device=rays_o.device)
    box_max = torch.as_tensor(box_max, dtype=rays_o.dtype,
                              device=rays_o.device)
    d = torch.where(rays_d == 0.0, torch.full_like(rays_d, 1.0e-14), rays_d)
    inv_d = 1.0 / d
    t0 = (box_min - rays_o) * inv_d
    t1 = (box_max - rays_o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_near <= t_far) & (t_near >= 0.0) & (t_far >= 0.0)
    zero = torch.zeros_like(t_near)
    return hit, torch.where(hit, t_near, zero), torch.where(hit, t_far, zero)


def sample_rays_in_bbox(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        rotations: torch.Tensor, translations: torch.Tensor,
                        half_extents: torch.Tensor):
    """Per-ray near / far against K oriented boxes (rotations (K,3,3),
    translations (K,3), half_extents (K,3)) of rays (N,3): each ray in
    each box's frame through `ray_aabb_intersection`, then the nearest hit
    over the boxes. Returns near (N,1), far (N,1) and mask (N,1), the rays
    that hit a box; a ray that hits none has near = far = 0."""
    rot_t = rotations.transpose(-1, -2)                           # world->box
    o_box = (torch.einsum("kij,nj->kni", rot_t, rays_o)
             - torch.einsum("kij,kj->ki", rot_t, translations)[:, None, :])
    d_box = torch.einsum("kij,nj->kni", rot_t, rays_d)
    ext = half_extents[:, None, :]
    hit, near, far = ray_aabb_intersection(o_box, d_box, -ext, ext)
    inf = torch.full_like(near, float("inf"))
    near_min = torch.amin(torch.where(hit, near, inf), dim=0)
    far_min = torch.amin(torch.where(hit, far, inf), dim=0)
    any_hit = torch.any(hit, dim=0)
    zero = torch.zeros_like(near_min)
    return (torch.where(any_hit, near_min, zero)[:, None],
            torch.where(any_hit, far_min, zero)[:, None],
            any_hit[:, None])


def get_rays_segmented(seg_masks: np.ndarray, class_ids,
                       rays_o: np.ndarray, rays_d: np.ndarray,
                       w: int, h: int, n_rays: int,
                       rng: "np.random.Generator | None" = None):
    """Segmentation-conditioned ray picking (host numpy; the reference's
    ray_utils.py:276-326). seg_masks (H, W, K) per-class masks (> 0 =
    member) of `class_ids` (K,); rays_o / rays_d (H*W, 3). For each class
    (in sorted order) draws `n_rays` member pixels with replacement from
    `rng`, the same draws as the JAX function for the same generator.

    Returns (rays_o per class, rays_d per class, sorted class ids, fg mask):
    one (distinct members drawn, 3) array per class, and the flat mask of
    pixels in any class."""
    rng = rng or np.random.default_rng()
    seg = np.zeros((h, w), dtype=np.int64)
    class_ids = sorted(int(c) for c in class_ids)
    for i, cid in enumerate(class_ids):
        seg[seg_masks[:, :, i] > 0] = cid
    flat = seg.flatten()
    rays_o_cls, rays_d_cls = [], []
    for cid in class_ids:
        member = np.where(flat == cid)[0]
        picked = member[rng.integers(0, member.shape[0], size=n_rays)]
        mask = np.zeros(rays_o.shape[0], dtype=bool)
        mask[picked] = True
        rays_o_cls.append(rays_o[mask])
        rays_d_cls.append(rays_d[mask])
    return rays_o_cls, rays_d_cls, class_ids, flat > 0


def get_rays_mvs(h: int, w: int, focal, c2w: torch.Tensor):
    """MVS-convention rays: +z forward, principal point at the image centre
    (the reference's ray_utils.py:335-351). c2w (3|4, 4). Returns (rays_o,
    rays_d), each (H*W, 3) on c2w's device; rays_d is not normalized."""
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    dirs = torch.stack([(xs - w / 2) / focal, (ys - h / 2) / focal,
                        torch.ones_like(xs)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d
