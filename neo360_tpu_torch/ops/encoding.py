"""The positional encoding written in place: `pos_enc_into` puts
`core/encoding.py:pos_enc` of a conditioned level's points into columns of
the conditioned MLP's input rows, so no encoding of activation size is
built and then copied.

CUDA tensors launch csrc/pos_enc.cu (C entry `pos_enc_into`), whose values
are pos_enc's bit for bit (the same f32 operations, `sinf` without fast
math); CPU tensors run `pos_enc_into_reference`, pos_enc's own operations
on the same layout. Both zero the rows' columns after the encoding, so no
column of the rows is left undefined: a GEMM may read its operand past its
last column in pairs or vectors (the CPU's bfloat16 products do), and
must meet zeros there. The encoding takes no gradient: the write is not
recorded by autograd, and points that require one are refused.
"""

from __future__ import annotations

import math

import torch

from neo360_tpu_torch.core.encoding import _scales
from neo360_tpu_torch.ops import kernels


def width(dims: int, min_deg: int, max_deg: int) -> int:
    """Columns of the encoding of `dims` channels."""
    return dims * (1 + 2 * (max_deg - min_deg))


def pos_enc_into_reference(out: torch.Tensor, pts: torch.Tensor, col: int,
                           min_deg: int, max_deg: int,
                           extra: torch.Tensor = None) -> torch.Tensor:
    """Plain version of `pos_enc_into`: pos_enc's operations in its order
    (the product by 2^i, the add of pi/2, then sin over one contiguous
    float32 tensor of pos_enc's sin / cos half, so every value has
    pos_enc's bits), written into the columns and rounded once to out's
    type; zeros after them. Returns out."""
    nv, n = pts.shape[:2]
    dims = 3 + (extra is not None)
    deg = max_deg - min_deg
    end = col + width(dims, min_deg, max_deg)
    rows = out[:, col:end].view(nv, n, -1)
    with torch.no_grad():
        out[:, end:].zero_()
        x = torch.empty((nv, n, dims), dtype=torch.float32,
                        device=pts.device)
        x[..., :3] = pts
        if extra is not None:
            x[..., 3] = extra.reshape(n)
        rows[..., :dims] = x
        if deg:
            four = torch.empty((nv, n, 2 * dims * deg), dtype=torch.float32,
                               device=pts.device)
            sines = four[..., :dims * deg]
            torch.mul(x[..., None, :], _scales(min_deg, max_deg, x.dtype,
                                               x.device)[:, None],
                      out=sines.unflatten(-1, (deg, dims)))
            torch.add(sines, 0.5 * math.pi, out=four[..., dims * deg:])
            torch.sin(four, out=four)
            rows[..., dims:] = four
    return out


def pos_enc_into(out: torch.Tensor, pts: torch.Tensor, col: int,
                 min_deg: int, max_deg: int,
                 extra: torch.Tensor = None) -> torch.Tensor:
    """pos_enc(x, min_deg, max_deg) written at columns col .. col + width
    of `out`'s rows, and zeros from there to the rows' end; row v·N + n
    for point n of view v, where x is pts
    (NV, N, 3) float32, or, given `extra` (N values, float32, shared by
    every view), [pts | extra] (4 channels). `out`: a contiguous
    (NV·N, ld) float32 or bfloat16 buffer, its columns before col left as
    they are; pts may be a view whose points are contiguous per view (a half
    of the [fg | bg] camera points). Returns out.

    CPU tensors run `pos_enc_into_reference`; CUDA tensors launch
    csrc/pos_enc.cu through C entry `pos_enc_into`. pts and extra take no
    gradient (raises if either requires one)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (pts, extra)):
        raise ValueError("pos_enc_into: pts and extra take no gradient "
                         "(detach them)")
    nv, n = pts.shape[:2]
    dims = 3 + (extra is not None)
    if out.device.type == "cpu" and pts.device.type == "cpu":
        return pos_enc_into_reference(out, pts, col, min_deg, max_deg, extra)
    name = "pos_enc_into"
    if extra is not None:
        extra = extra.reshape(n)
    kernels.require_cuda(name, out)
    if not (pts.dtype == torch.float32 and pts.dim() == 3
            and pts.shape[-1] == 3 and pts.stride(2) == 1
            and pts.stride(1) == 3 and pts.stride(0) % 3 == 0
            and pts.device == out.device
            and (extra is None or (extra.dtype == torch.float32
                                   and extra.device == out.device))):
        raise ValueError(f"{name}: pts must be float32 (NV, N, 3) with "
                         f"contiguous points per view, extra float32 (N,), "
                         f"on out's device")
    if not (out.dim() == 2 and out.is_contiguous()
            and out.dtype in kernels.DTYPE_CODES
            and out.shape[0] == nv * n and 0 <= col
            and col + width(dims, min_deg, max_deg) <= out.shape[1]
            and min_deg <= max_deg):
        raise ValueError(f"{name}: out must be a contiguous float32 or "
                         f"bfloat16 (NV·N, ld) buffer with room for the "
                         f"encoding from col {col}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    kernels.launch(name, out.device, pts.data_ptr(), pts.stride(0) // 3,
                   None if extra is None else extra.data_ptr(),
                   0 if extra is None else extra.stride(0), out.data_ptr(),
                   kernels.DTYPE_CODES[out.dtype], out.shape[1], col, nv, n,
                   dims, min_deg, max_deg - min_deg)
    return out
