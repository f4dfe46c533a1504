"""World <-> camera <-> image geometry (port of
neo360_tpu/core/geometry.py:23-122), and the MVS plane-sweep warp.

Points are batched as (B, N, 3) with (B, 4, 4) cam2world poses; views are
interleaved on the leading axis exactly as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch


def repeat_interleave(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """(B, ...) -> (B*repeats, ...) with each row repeated contiguously."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=0)


def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """`num` evenly spaced values rounded as jnp.linspace rounds them:
    start * (1 - i/d) + stop * (i/d) with d = num - 1, the end point exact.
    (torch.linspace rounds differently, which moves inverse-CDF samples
    that fall on a bin edge.)"""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    d = num - 1
    step = torch.arange(d, dtype=dtype, device=device) / d
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype,
                                      device=device)])


def get_world_grid(side_lengths: Sequence[Sequence[float]],
                   grid_size: Union[int, Sequence[int]],
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, Gx*Gy*Gz, 3) grid of world points, ij-indexed."""
    if isinstance(grid_size, int):
        grid_size = [grid_size] * 3
    elif len(grid_size) == 1:
        grid_size = [grid_size[0]] * 3
    axes = [linspace(side_lengths[i][0], side_lengths[i][1], grid_size[i],
                     dtype, device) for i in range(3)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(mesh, dim=-1).reshape(1, -1, 3)


def world2camera(w_xyz: torch.Tensor, cam2world: torch.Tensor,
                 ns: int | None = None) -> torch.Tensor:
    """World points -> camera frame: R^T x - R^T t. w_xyz (B, N, 3),
    cam2world (B', 4, 4); with `ns`, w_xyz rows are repeated ns times."""
    if ns is not None:
        w_xyz = repeat_interleave(w_xyz, ns)
    rot = cam2world[:, :3, :3].transpose(1, 2)
    trans = -torch.einsum("bij,bj->bi", rot, cam2world[:, :3, 3])
    cam_rot = torch.einsum("bij,bnj->bni", rot, w_xyz)
    return cam_rot + trans[:, None, :]


def world2camera_viewdirs(w_dirs: torch.Tensor, cam2world: torch.Tensor,
                          ns: int | None = None) -> torch.Tensor:
    """World directions -> camera frame (rotation only)."""
    if ns is not None:
        w_dirs = repeat_interleave(w_dirs, ns)
    rot = cam2world[:, :3, :3].transpose(1, 2)
    return torch.einsum("bij,bnj->bni", rot, w_dirs)


def projection(c_xyz: torch.Tensor, focal: torch.Tensor, c: torch.Tensor,
               nv: int | None = None) -> torch.Tensor:
    """Camera points -> pixel coordinates, uv = -xy/(z+1e-9)*f + c.

    c_xyz: (SB*NV, N, 3); focal, c: (SB, 2). A negative fy (passed by the
    caller) flips v into image-row direction.
    """
    if nv is None:
        nv = c_xyz.shape[0] // c.shape[0]
    uv = -c_xyz[..., :2] / (c_xyz[..., 2:] + 1e-9)
    f = repeat_interleave(focal[:, None, :], nv if focal.shape[0] > 1 else 1)
    cc = repeat_interleave(c[:, None, :], nv if c.shape[0] > 1 else 1)
    return uv * f + cc


def homography_uv(hw: tuple, proj_mat: torch.Tensor,
                  depth_values: torch.Tensor) -> torch.Tensor:
    """The normalized source-view uv (B, D*H*W, 2) of every reference
    pixel of an (H, W) map at every hypothesis depth: the pixel
    projected with `proj_mat` (B, 3, 4), src_proj @ ref_proj_inv, at each
    of `depth_values` (B, D), depths in order, then pixels row by row
    (align_corners=True: pixel 0 at -1, pixel W-1 at 1). A point projected
    onto z = 0 gets a non-finite uv."""
    h, w = hw
    b, d = depth_values.shape
    dev = proj_mat.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    ref = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, device=dev)])          # (3, HW)
    rot = proj_mat[:, :, :3]                                     # (B, 3, 3)
    t = proj_mat[:, :, 3:]                                       # (B, 3, 1)
    # (R @ x) + T/depth ~ homogeneous (R @ x * depth + T)
    src = (torch.einsum("bij,jn->bin", rot, ref)[:, None]
           + t[:, None] / depth_values[:, :, None, None])        # (B,D,3,HW)
    uv = src[:, :, :2] / src[:, :, 2:]
    scale = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], device=dev)
    uv = uv / scale[None, None, :, None] - 1.0                   # [-1, 1]
    return uv.permute(0, 1, 3, 2).reshape(b, d * h * w, 2)


def homography_warp(src_feat: torch.Tensor, proj_mat: torch.Tensor,
                    depth_values: torch.Tensor) -> torch.Tensor:
    """MVS plane-sweep warp (neo360_tpu/core/geometry.py:84-122): every
    reference pixel at every hypothesis depth projected into the source
    view (`homography_uv`) and bilinear-sampled there
    (`ops.interpolate.grid_sample_2d`, zeros padding, align_corners=True).
    A point projected onto z = 0 samples 0.

    src_feat (B, H, W, C) NHWC; proj_mat (B, 3, 4), src_proj @
    ref_proj_inv; depth_values (B, D). Returns (B, D, H, W, C) float32.
    The uv is computed on src_feat's device, and on the card the sample
    is one launch of kernel G (its gradient with respect to src_feat
    kernel G'); uv takes no gradient, so neither do proj_mat and
    depth_values."""
    from neo360_tpu_torch.ops.interpolate import grid_sample_2d
    b, h, w, _ = src_feat.shape
    uv = homography_uv((h, w), proj_mat, depth_values)
    warped = grid_sample_2d(src_feat, uv, padding_mode="zeros")
    return warped.reshape(b, depth_values.shape[1], h, w, -1)
