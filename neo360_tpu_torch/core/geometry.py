"""World <-> camera <-> image geometry (port of neo360_tpu/core/geometry.py:23-81).

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
