"""Corner-table bilinear sampling (port of neo360_tpu/ops/interpolate.py:
117-232).

`table_sample` is kernel A (csrc/table_sample.cu) on CUDA tensors and its
plain PyTorch version, `table_sample_reference`, on CPU tensors. Maps are
NHWC at these functions, as in the JAX package. The JAX package's
`resize_bilinear_align_corners` becomes F.interpolate(mode="bilinear",
align_corners=True) at its call sites.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neo360_tpu_torch.ops import kernels


def build_corner_table(image: torch.Tensor, padding_mode: str = "zeros",
                       dtype=None) -> torch.Tensor:
    """(B,H,W,C) -> (B,H+1,W+1,4C) table of 2x2 corner neighbourhoods.

    T[b, y0+1, x0+1] = concat(P[y0,x0], P[y0,x1], P[y1,x0], P[y1,x1]) over a
    one-pixel pad (zeros or edge per `padding_mode`), so `table_sample`
    needs one row gather per point."""
    b, h, w, c = image.shape
    nchw = image.permute(0, 3, 1, 2)
    if padding_mode == "zeros":
        pad = F.pad(nchw, (1, 1, 1, 1))
    elif padding_mode == "border":
        pad = F.pad(nchw, (1, 1, 1, 1), mode="replicate")
    else:
        raise ValueError(f"padding_mode {padding_mode!r} not supported")
    pad = pad.permute(0, 2, 3, 1)
    table = torch.cat([
        pad[:, 0:h + 1, 0:w + 1],      # corner (y0, x0)
        pad[:, 0:h + 1, 1:w + 2],      # corner (y0, x1)
        pad[:, 1:h + 2, 0:w + 1],      # corner (y1, x0)
        pad[:, 1:h + 2, 1:w + 2],      # corner (y1, x1)
    ], dim=-1)
    if dtype is not None:
        table = table.to(dtype)
    return table.contiguous()


def _check_mode(padding_mode: str) -> None:
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r} not supported")


def table_sample_reference(table: torch.Tensor, uv: torch.Tensor, hw: tuple,
                           padding_mode: str = "zeros",
                           out_dtype=torch.float32, view_offset: int = 0
                           ) -> torch.Tensor:
    """Plain PyTorch version of kernel A (interpolate.py:168-232).

    table (V, H+1, W+1, 4C); uv (B, N, 2) normalized; view b reads table
    view clip(b + view_offset, 0, V-1). The four corners are folded in f32
    and the result is cast once to `out_dtype` (the JAX code folds in the
    table's dtype: identical for f32 tables)."""
    _check_mode(padding_mode)
    b, n = uv.shape[:2]
    total_views = table.shape[0]
    c4 = table.shape[-1]
    c = c4 // 4
    h, w = hw
    uv = uv.float()
    ix = (uv[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (uv[..., 1] + 1.0) * 0.5 * (h - 1)
    if padding_mode == "border":
        ix = torch.clamp(ix, 0.0, w - 1.0)
        iy = torch.clamp(iy, 0.0, h - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    if padding_mode == "zeros":
        # beyond the one-pixel pad a clamped (live) row would be fetched:
        # zero all four weights there
        inside = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
        zero = torch.zeros_like(w00)
        w00, w01, w10, w11 = (torch.where(inside, wk, zero)
                              for wk in (w00, w01, w10, w11))
    # clamp in float before the cast: huge or non-finite uv stays defined
    xb = torch.nan_to_num(torch.clamp(x0 + 1, 0, w)).long()
    yb = torch.nan_to_num(torch.clamp(y0 + 1, 0, h)).long()
    views = torch.clamp(torch.arange(b, device=uv.device) + view_offset,
                        0, total_views - 1)
    idx = (views[:, None] * (h + 1) + yb) * (w + 1) + xb
    rows = table.reshape(-1, c4)[idx.reshape(-1)].float()
    wts = torch.stack([w00, w01, w10, w11], dim=-1).reshape(b * n, 1, 4)
    out = torch.bmm(wts, rows.reshape(b * n, 4, c))   # f32 corner fold
    return out.reshape(b, n, c).to(out_dtype)


def table_sample(table: torch.Tensor, uv: torch.Tensor, hw: tuple,
                 padding_mode: str = "zeros", out_dtype=torch.float32,
                 view_offset: int = 0) -> torch.Tensor:
    """Bilinear sample via one row gather from a `build_corner_table` table
    (semantics of neo360_tpu/ops/interpolate.py:table_sample, flat mode:
    total_views = table.shape[0]).

    CPU tensors run `table_sample_reference`; CUDA tensors launch kernel A
    (csrc/table_sample.cu) and add one to `table_sample.launches`."""
    if table.device.type == "cpu" and uv.device.type == "cpu":
        return table_sample_reference(table, uv, hw, padding_mode,
                                      out_dtype, view_offset)
    _check_mode(padding_mode)
    name = "table_sample"
    table, uv = table.contiguous(), uv.contiguous()
    kernels.require_cuda(name, table, uv)
    if uv.dtype != torch.float32 or uv.dim() != 3 or uv.shape[-1] != 2:
        raise ValueError(f"{name}: uv must be float32 (B, N, 2)")
    if (table.dtype not in kernels.DTYPE_CODES
            or out_dtype not in kernels.DTYPE_CODES):
        raise ValueError(f"{name}: table/out dtype must be float32 or "
                         f"bfloat16, got {table.dtype}/{out_dtype}")
    h, w = hw
    v, hp, wp, c4 = table.shape
    c = c4 // 4
    vec = 16 // table.element_size()
    if (hp, wp) != (h + 1, w + 1) or c4 % 4 or c % vec or c // vec > 256:
        raise ValueError(f"{name}: table {tuple(table.shape)} does not fit "
                         f"hw {hw}, or C={c} is not a multiple of {vec} "
                         f"up to {256 * vec}")
    b, n = uv.shape[:2]
    out = torch.empty((b, n, c), dtype=out_dtype, device=uv.device)
    kernels.launch("table_sample_fwd", uv.device, table.data_ptr(),
                   kernels.DTYPE_CODES[table.dtype], uv.data_ptr(),
                   out.data_ptr(), kernels.DTYPE_CODES[out_dtype], b, n, h,
                   w, c, int(padding_mode == "zeros"), int(view_offset), v)
    table_sample.launches += 1
    return out


table_sample.launches = 0

