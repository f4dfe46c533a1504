"""Corner-table bilinear sampling (port of neo360_tpu/ops/interpolate.py:
117-232) and the model's two fused gathers over it.

`table_sample` is kernel A (csrc/table_sample.cu) on CUDA tensors and its
plain PyTorch version, `table_sample_reference`, on CPU tensors. With
autograd on it runs as a `torch.autograd.Function` whose backward, the
scatter-add into the table, is kernel A' (csrc/table_sample_bwd.cu) on CUDA
and its plain version on the CPU, under one of two contracts:
- dense (`table_sample_backward`): the table-shaped gradient, returned
  through autograd;
- accumulate (`table_sample(..., grad_acc=acc)`, `table_sample_accumulate`):
  the gradient is added into `acc`, an f32 tensor of the table's shape that
  the caller owns, and autograd gets None for the table.
uv takes no gradient.

`triplane_sample` (csrc/triplane_sample.cu) samples and sums the three
plane tables at camera points, and `local_sample` (csrc/local_sample.cu)
projects camera points into the stacked fg/bg local table and samples it;
both take the camera points themselves, so no uv tensor reaches device
memory, and both hand kernel A' the (cotangent, uv) pairs of the unfused
calls in their backward. Their plain versions
(`triplane_sample_reference`, `local_sample_reference`) are the unfused
chains over `table_sample_reference`. Given `out`, two callers' row
buffers (the fg and the bg branch's), both write the [fg | bg] halves of
their points into the buffers' columns from `col` instead of returning a
new tensor (`_dest`): the conditioned MLP's input is assembled in place.

`grid_sample_2d` (neo360_tpu/ops/interpolate.py:62) samples an image
rather than a table: on CUDA tensors it is kernel G (csrc/grid_sample.cu),
which reads the four corner pixels straight from the image, and its
gradient with respect to the image is kernel G' (csrc/grid_sample_bwd.cu);
on CPU tensors it is `grid_sample_2d_reference`, the JAX code's
four-corner formula. `resize_bilinear_align_corners` is two
interpolation-matrix products, as in the JAX package; the model's call
sites use F.interpolate(mode="bilinear", align_corners=True), the same
function.

Maps are NHWC at these functions, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neo360_tpu_torch.core import geometry
from neo360_tpu_torch.core.constants import cached
from neo360_tpu_torch.ops import kernels

# consecutive points a group of threads walks, reusing the corner rows of
# a run of points that fall in one cell (csrc/table_sample_common.cuh),
# one constant per entry point, adopted by measurement on the card
# (PERF.md). The path always runs these; only
# `scripts/torch_kernel_times.py --sweep` and the card tests of every run
# length pass another, as the wrappers' `run` argument
TABLE_SAMPLE_RUN = 4
TRIPLANE_SAMPLE_RUN = 8
LOCAL_SAMPLE_RUN = 4


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


def _corners(uv: torch.Tensor, hw: tuple, padding_mode: str,
             total_views: int, view_offset: int):
    """Row index (B*N,) into the flat (V*(H+1)*(W+1), 4C) table and the
    four f32 corner weights (B*N, 4) of every point. In zeros mode points
    beyond the one-pixel pad get zero weights (a clamped, live row would be
    fetched)."""
    b = uv.shape[0]
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
    wts = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                       fx * fy], dim=-1)
    if padding_mode == "zeros":
        inside = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
        wts = torch.where(inside[..., None], wts, torch.zeros_like(wts))
    # clamp in float before the cast: huge or non-finite uv stays defined
    xb = torch.nan_to_num(torch.clamp(x0 + 1, 0, w)).long()
    yb = torch.nan_to_num(torch.clamp(y0 + 1, 0, h)).long()
    views = torch.clamp(torch.arange(b, device=uv.device) + view_offset,
                        0, total_views - 1)
    idx = (views[:, None] * (h + 1) + yb) * (w + 1) + xb
    return idx.reshape(-1), wts.reshape(-1, 4)


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
    c4 = table.shape[-1]
    c = c4 // 4
    idx, wts = _corners(uv, hw, padding_mode, table.shape[0], view_offset)
    rows = table.reshape(-1, c4)[idx].float()
    out = torch.bmm(wts.reshape(b * n, 1, 4),
                    rows.reshape(b * n, 4, c))   # f32 corner fold
    return out.reshape(b, n, c).to(out_dtype)


def table_sample_backward_reference(grad: torch.Tensor, uv: torch.Tensor,
                                    table_shape, table_dtype, hw: tuple,
                                    padding_mode: str = "zeros",
                                    view_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel A': the gradient of
    `table_sample_reference` with respect to the table, for the output
    cotangent `grad` (B, N, C).

    Each point adds w_k * grad into corner block k of its row, summed in
    f32 and rounded once to `table_dtype` (autograd through a bf16 table
    would sum in bf16). Points with non-finite uv add nothing. For finite
    uv this equals autograd of the plain forward on an f32 copy of the
    table."""
    out = torch.zeros(table_shape, dtype=torch.float32, device=grad.device)
    table_sample_accumulate_reference(grad, uv, out, hw, padding_mode,
                                      view_offset)
    return out.to(table_dtype)


def table_sample_accumulate_reference(grad: torch.Tensor, uv: torch.Tensor,
                                      acc: torch.Tensor, hw: tuple,
                                      padding_mode: str = "zeros",
                                      view_offset: int = 0) -> None:
    """Plain PyTorch version of kernel A' under the accumulate contract:
    adds the table gradient of `table_sample_reference` for the output
    cotangent `grad` (B, N, C) into `acc`, a contiguous f32 tensor of the
    table's shape, in place. Each point adds w_k * grad in f32 into corner
    block k of its row; points with non-finite uv add nothing."""
    _check_mode(padding_mode)
    b, n, c = grad.shape
    idx, wts = _corners(uv, hw, padding_mode, acc.shape[0], view_offset)
    finite = torch.isfinite(uv.float()).all(-1).reshape(-1, 1)
    wts = torch.where(finite, wts, torch.zeros_like(wts))
    contrib = wts[:, :, None] * grad.reshape(b * n, 1, c).float()
    acc.view(-1, 4, c).index_add_(0, idx, contrib)


def _table_shape_ok(name: str, table_shape, hw, c_multiple: int) -> int:
    h, w = hw
    v, hp, wp, c4 = table_shape
    c = c4 // 4
    if (hp, wp) != (h + 1, w + 1) or c4 % 4 or c % c_multiple \
            or c // c_multiple > 256:
        raise ValueError(f"{name}: table {tuple(table_shape)} does not fit "
                         f"hw {hw}, or C={c} is not a multiple of "
                         f"{c_multiple} up to {256 * c_multiple}")
    if v * hp * wp >= 2 ** 31:
        raise ValueError(f"{name}: table {tuple(table_shape)} has 2^31 rows "
                         f"or more")
    return c


def _table_sample_forward(table, uv, hw, padding_mode, out_dtype,
                          view_offset, run=None):
    if table.device.type == "cpu" and uv.device.type == "cpu":
        return table_sample_reference(table, uv, hw, padding_mode,
                                      out_dtype, view_offset)
    _check_mode(padding_mode)
    name = "table_sample"
    table, uv = kernels.dense(table), uv.contiguous()
    kernels.require_cuda(name, table, uv)
    if uv.dtype != torch.float32 or uv.dim() != 3 or uv.shape[-1] != 2:
        raise ValueError(f"{name}: uv must be float32 (B, N, 2)")
    if (table.dtype not in kernels.DTYPE_CODES
            or out_dtype not in kernels.DTYPE_CODES):
        raise ValueError(f"{name}: table/out dtype must be float32 or "
                         f"bfloat16, got {table.dtype}/{out_dtype}")
    h, w = hw
    c = _table_shape_ok(name, table.shape, hw, 16 // table.element_size())
    b, n = uv.shape[:2]
    out = torch.empty((b, n, c), dtype=out_dtype, device=uv.device)
    kernels.launch("table_sample_fwd", uv.device, table.data_ptr(),
                   kernels.DTYPE_CODES[table.dtype], uv.data_ptr(),
                   out.data_ptr(), kernels.DTYPE_CODES[out_dtype], b, n, h,
                   w, c, int(padding_mode == "zeros"), int(view_offset),
                   table.shape[0], run or TABLE_SAMPLE_RUN)
    return out


def _backward_args(name, grad, uv, table_shape, grad_dtypes, hw):
    """grad and uv ready for kernel A' (contiguous, 16-byte aligned, on
    one CUDA device, of the shapes and types it takes) and (b, n, c)."""
    grad, uv = kernels.dense(grad), uv.contiguous()
    kernels.require_cuda(name, grad, uv)
    if uv.dtype != torch.float32 or uv.dim() != 3 or uv.shape[-1] != 2:
        raise ValueError(f"{name}: uv must be float32 (B, N, 2)")
    if any(d not in kernels.DTYPE_CODES for d in grad_dtypes):
        raise ValueError(f"{name}: grad/table dtype must be float32 or "
                         f"bfloat16, got {grad_dtypes}")
    c = _table_shape_ok(name, table_shape, hw, 4)
    b, n = uv.shape[:2]
    if tuple(grad.shape) != (b, n, c):
        raise ValueError(f"{name}: grad {tuple(grad.shape)}, expected "
                         f"{(b, n, c)}")
    return grad, uv, (b, n, c)


def table_sample_backward(grad: torch.Tensor, uv: torch.Tensor, table_shape,
                          table_dtype, hw: tuple, padding_mode: str = "zeros",
                          view_offset: int = 0) -> torch.Tensor:
    """Gradient of `table_sample` with respect to the table (the dense
    contract).

    CPU tensors run `table_sample_backward_reference`; CUDA tensors launch
    kernel A' (csrc/table_sample_bwd.cu) through C entry
    `table_sample_bwd`."""
    if grad.device.type == "cpu" and uv.device.type == "cpu":
        return table_sample_backward_reference(
            grad, uv, table_shape, table_dtype, hw, padding_mode,
            view_offset)
    _check_mode(padding_mode)
    name = "table_sample_backward"
    grad, uv, (b, n, c) = _backward_args(name, grad, uv, table_shape,
                                         (grad.dtype, table_dtype), hw)
    h, w = hw
    scratch = torch.empty(table_shape, dtype=torch.float32,
                          device=grad.device)
    dtable = scratch if table_dtype == torch.float32 else torch.empty(
        table_shape, dtype=table_dtype, device=grad.device)
    kernels.launch("table_sample_bwd", grad.device, grad.data_ptr(),
                   kernels.DTYPE_CODES[grad.dtype], uv.data_ptr(),
                   scratch.data_ptr(), dtable.data_ptr(),
                   kernels.DTYPE_CODES[table_dtype], b, n, h, w, c,
                   int(padding_mode == "zeros"), int(view_offset),
                   table_shape[0], scratch.numel())
    return dtable


def table_sample_accumulate(grad: torch.Tensor, uv: torch.Tensor,
                            acc: torch.Tensor, hw: tuple,
                            padding_mode: str = "zeros",
                            view_offset: int = 0) -> None:
    """Add the gradient of `table_sample` with respect to the table into
    `acc`, a contiguous f32 tensor of the table's shape (the accumulate
    contract), in place.

    CPU tensors run `table_sample_accumulate_reference`; CUDA tensors
    launch kernel A' (csrc/table_sample_bwd.cu, no scratch, memset or
    rounding) through C entry `table_sample_bwd_acc`."""
    if all(t.device.type == "cpu" for t in (grad, uv, acc)):
        return table_sample_accumulate_reference(grad, uv, acc, hw,
                                                 padding_mode, view_offset)
    _check_mode(padding_mode)
    name = "table_sample_accumulate"
    grad, uv, (b, n, c) = _backward_args(name, grad, uv, acc.shape,
                                         (grad.dtype,), hw)
    kernels.require_cuda(name, grad, acc)
    if acc.dtype != torch.float32 or acc.data_ptr() % 16:
        raise ValueError(f"{name}: acc must be float32 and 16-byte aligned")
    h, w = hw
    kernels.launch("table_sample_bwd_acc", grad.device, grad.data_ptr(),
                   kernels.DTYPE_CODES[grad.dtype], uv.data_ptr(),
                   acc.data_ptr(), b, n, h, w, c,
                   int(padding_mode == "zeros"), int(view_offset),
                   acc.shape[0])


class _TableSample(torch.autograd.Function):
    """table_sample with the table's gradient from `table_sample_backward`
    or, given `grad_acc`, added into it by `table_sample_accumulate` (the
    table then gets None); uv is saved, the table is not (the backward
    needs its shape only)."""

    @staticmethod
    def forward(ctx, table, uv, hw, padding_mode, out_dtype, view_offset,
                grad_acc, run):
        ctx.save_for_backward(uv)
        ctx.meta = (tuple(table.shape), table.dtype, hw, padding_mode,
                    view_offset)
        ctx.grad_acc = grad_acc
        return _table_sample_forward(table, uv, hw, padding_mode, out_dtype,
                                     view_offset, run)

    @staticmethod
    def backward(ctx, grad):
        (uv,) = ctx.saved_tensors
        dtable = None
        if ctx.needs_input_grad[0]:
            shape, dtype, hw, mode, offset = ctx.meta
            if ctx.grad_acc is None:
                dtable = table_sample_backward(grad, uv, shape, dtype, hw,
                                               mode, offset)
            else:
                table_sample_accumulate(grad, uv, ctx.grad_acc, hw, mode,
                                        offset)
        return dtable, None, None, None, None, None, None, None


def table_sample(table: torch.Tensor, uv: torch.Tensor, hw: tuple,
                 padding_mode: str = "zeros", out_dtype=torch.float32,
                 view_offset: int = 0, grad_acc: torch.Tensor = None,
                 run: int = None) -> torch.Tensor:
    """Bilinear sample via one row gather from a `build_corner_table` table
    (semantics of neo360_tpu/ops/interpolate.py:table_sample, flat mode:
    total_views = table.shape[0]).

    CPU tensors run `table_sample_reference`; CUDA tensors launch kernel A
    (csrc/table_sample.cu) through C entry `table_sample_fwd`. With
    grad enabled the call is a `_TableSample` autograd Function; uv must
    not require grad (raises). `grad_acc`: an f32 tensor of the table's
    shape; the backward then adds the table's gradient into it and returns
    None for the table (the accumulate contract). `run`: the kernel's run
    length, TABLE_SAMPLE_RUN unless given."""
    if not torch.is_grad_enabled():
        return _table_sample_forward(table, uv, hw, padding_mode, out_dtype,
                                     view_offset, run)
    if uv.requires_grad:
        raise ValueError("table_sample: uv takes no gradient (detach it)")
    _check_acc("table_sample", grad_acc, table)
    return _TableSample.apply(table, uv, tuple(hw), padding_mode, out_dtype,
                              int(view_offset), grad_acc, run)


# kernel A' against its plain version (ops.kernels.compare): bf16, one ulp
# (both round one f32 sum); f32, 1e-5 relative. Both allow 1e-5 * max|ref|:
# the atomic adds sum each row's contributions in another order than
# index_add_, which matters where they cancel.
BACKWARD_TOL = dict(rtol=1e-5, atol_frac=1e-5)


# the fused tri-plane and local gathers against their plain versions
# (ops.kernels.compare): 1e-5 relative plus 1e-5 * max|ref|. Each fold
# contracts its multiply-adds differently from the plain version's bmm,
# and the tri-plane sum of three folds can cancel.
FUSED_TOL = dict(rtol=1e-5, atol_frac=1e-5)


def _check_acc(name, grad_acc, table):
    if grad_acc is not None and (
            grad_acc.shape != table.shape or grad_acc.dtype != torch.float32
            or grad_acc.device != table.device
            or not grad_acc.is_contiguous()):
        raise ValueError(f"{name}: grad_acc must be a contiguous float32 "
                         f"tensor of the table's shape {tuple(table.shape)} "
                         f"on {table.device}")


def _table_grad(grad, uv, shape, dtype, hw, mode, offset, acc):
    """The table's gradient for one (cotangent, uv) pair: dense, or added
    into `acc` (then None)."""
    if acc is None:
        return table_sample_backward(grad, uv, shape, dtype, hw, mode,
                                     offset)
    table_sample_accumulate(grad, uv, acc, hw, mode, offset)
    return None


def _cam_ok(name, cam):
    if cam.dtype != torch.float32 or cam.dim() != 3 or cam.shape[-1] != 3:
        raise ValueError(f"{name}: cam must be float32 (NV, N, 3)")


def triplane_uvs(cam: torch.Tensor):
    """The uv of the three planes at camera points (NV, N, 3): (x, z),
    (x, y), (y, z), the camera coordinates used directly
    (neo360_tpu/nn/triplane.py:343-345). Slices: an index list would be
    copied to the device on every call, waiting for the stream."""
    return cam[..., 0::2], cam[..., :2], cam[..., 1:]


def triplane_sample_reference(tables, cam: torch.Tensor, hw: tuple,
                              view_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the fused tri-plane gather: the xz, xy and
    yz tables (zeros mode) sampled at `triplane_uvs(cam)` and summed in f32
    as (xz + xy) + yz (neo360_tpu/nn/triplane.py:328-352) -> (NV, N, C)."""
    xz, xy, yz = (table_sample_reference(t, uv, hw, "zeros", torch.float32,
                                         view_offset)
                  for t, uv in zip(tables, triplane_uvs(cam)))
    return xz + xy + yz


def _dest(name, out, col, shape, per, split, vec, device):
    """Where a fused gather's kernel writes (its output contract,
    csrc/table_sample_common.cuh:Dest). Without `out`: a new float32
    tensor of `shape`, returned. With `out`, two callers' 2-D row buffers
    of one type, each with its own row length: a view's first `split` of
    its `per` points go to out[0], the rest to out[1], each point's C
    values at columns col .. col + C; returns the pair. Returns (the
    result, the C entry's first, second, out_dtype, split, ld_first,
    ld_second, col). Raises unless the buffers take the kernel's stores
    (float32 or bfloat16, contiguous, on `device`, 16-byte aligned, row
    lengths and col multiples of `vec`) and hold a half's rows."""
    c = shape[-1]
    if out is None:
        whole = torch.empty(shape, dtype=torch.float32, device=device)
        return whole, (whole.data_ptr(), whole.data_ptr(), 0, per, c, c, 0)
    first, second = out
    rows = shape[:-1].numel() // 2
    if not (first.dtype == second.dtype
            and first.dtype in kernels.DTYPE_CODES
            and col >= 0 and col % vec == 0
            and all(t.dim() == 2 and t.device == device
                    and t.is_contiguous() and t.shape[0] == rows
                    and col + c <= t.shape[1] and t.shape[1] % vec == 0
                    and t.data_ptr() % 16 == 0 for t in out)):
        raise ValueError(f"{name}: out must be two contiguous float32 or "
                         f"bfloat16 (rows, ld) buffers of one type on "
                         f"{device}, of {rows} rows, 16-byte aligned, ld and "
                         f"col multiples of {vec}, with {c} columns from col "
                         f"{col}")
    return (first, second), (first.data_ptr(), second.data_ptr(),
                             kernels.DTYPE_CODES[first.dtype], split,
                             first.shape[1], second.shape[1], col)


def _write_halves(whole, out, col, dim):
    """The plain versions' side of the output contract: the two halves of
    `whole` along `dim` copied into the columns col .. col + C of out[0]
    and out[1] (rounded to their type, to nearest even). Returns out."""
    for dst, half in zip(out, whole.chunk(2, dim)):
        dst[:, col:col + half.shape[-1]].view(half.shape).copy_(half)
    return tuple(out)


def _joined(grads, col, shape, dim):
    """A fused gather's output cotangent, of `shape`, from its two
    destinations' (`_dest`): the columns col .. col + C of each, joined
    along `dim` in one copy (a missing cotangent reads zeros)."""
    half = list(shape)
    half[dim] //= 2
    like = next(g for g in grads if g is not None)
    return torch.cat([like.new_zeros(half) if g is None
                      else g[:, col:col + shape[-1]].reshape(half)
                      for g in grads], dim)


def _triplane_forward(tables, cam, hw, view_offset, run=None, out=None,
                      col=0):
    if all(t.device.type == "cpu" for t in (*tables, cam)):
        world = triplane_sample_reference(tables, cam, hw, view_offset)
        return world if out is None else _write_halves(world, out, col, 1)
    name = "triplane_sample"
    tables = [kernels.dense(t) for t in tables]
    cam = cam.contiguous()
    kernels.require_cuda(name, *tables, cam)
    _cam_ok(name, cam)
    shape, dtype = tables[0].shape, tables[0].dtype
    if any(t.shape != shape or t.dtype != dtype for t in tables) \
            or dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"{name}: the three tables must share one shape "
                         f"and a float32 or bfloat16 type")
    h, w = hw
    vec = 16 // tables[0].element_size()
    c = _table_shape_ok(name, shape, hw, vec)
    b, n = cam.shape[:2]
    if out is not None and n % 2:
        raise ValueError(f"{name}: out takes the [fg | bg] halves of cam "
                         f"(NV, 2M, 3), got {tuple(cam.shape)}")
    result, dest = _dest(name, out, col, torch.Size((b, n, c)), n,
                         n // 2, vec, cam.device)
    kernels.launch("triplane_sample_fwd", cam.device,
                   *(t.data_ptr() for t in tables), kernels.DTYPE_CODES[dtype],
                   cam.data_ptr(), *dest, b, n, h, w, c, int(view_offset),
                   shape[0], run or TRIPLANE_SAMPLE_RUN)
    return result


class _TriplaneSample(torch.autograd.Function):
    """triplane_sample; the backward rebuilds the three uv from the saved
    camera points and hands each table's (cotangent, uv) pair to
    `table_sample_backward`, or to `table_sample_accumulate` given
    accumulators (the table then gets None). Given destinations (`first`,
    `second`: the output contract), the forward writes into them and
    marks them modified; the backward reads its columns of their
    cotangents (`_joined`) and passes the cotangents on whole to whatever
    wrote the buffers before, which reads only its own columns."""

    @staticmethod
    def forward(ctx, t_xz, t_xy, t_yz, cam, hw, view_offset, grad_acc, run,
                col, first, second):
        tables = (t_xz, t_xy, t_yz)
        ctx.save_for_backward(cam)
        ctx.meta = ([(tuple(t.shape), t.dtype) for t in tables], hw,
                    view_offset, col)
        ctx.grad_acc = grad_acc or (None,) * 3
        out = None
        if first is not None:
            out = (first, second)
            ctx.mark_dirty(first, second)
        return _triplane_forward(tables, cam, hw, view_offset, run, out, col)

    @staticmethod
    def backward(ctx, *grads):
        (cam,) = ctx.saved_tensors
        metas, hw, offset, col = ctx.meta
        grad = grads[0]
        if len(grads) == 2:
            grad = _joined(grads, col, cam.shape[:2] + (metas[0][0][-1] // 4,),
                           1)
        tables = [_table_grad(grad, uv, shape, dtype, hw, "zeros", offset,
                              acc) if need else None
                  for uv, (shape, dtype), acc, need in zip(
                      triplane_uvs(cam), metas, ctx.grad_acc,
                      ctx.needs_input_grad[:3])]
        passed = grads if len(grads) == 2 else (None, None)
        return (*tables, None, None, None, None, None, None, *passed)


def triplane_sample(tables, cam: torch.Tensor, hw: tuple,
                    view_offset: int = 0, grad_acc=None, run: int = None,
                    out=None, col: int = 0):
    """The tri-plane world latent (NV, N, C) f32 of camera points cam
    (NV, N, 3): the three zeros-mode plane tables (xz, xy, yz) sampled at
    `triplane_uvs(cam)` and summed (semantics of
    neo360_tpu/nn/triplane.py:index_grid_tables after its world2camera).
    View b reads table view clip(b + view_offset, 0, V-1).

    CPU tensors run `triplane_sample_reference`; CUDA tensors launch the
    fused kernel (csrc/triplane_sample.cu) through C entry
    `triplane_sample_fwd`. With grad enabled the call is a
    `_TriplaneSample` autograd Function; cam must not require grad
    (raises). `grad_acc`: three f32 accumulators of the tables' shapes;
    the backward then adds the tables' gradients into them (kernel A''s
    accumulate contract) and returns None for the tables. `run`: the
    kernel's run length, TRIPLANE_SAMPLE_RUN unless given.

    `out`: two row buffers of NV·N/2 rows, float32 or bfloat16, of the fg
    and the bg branch (their rows may differ in length): cam is
    (NV, [fg | bg], 3), and the latent of view v's point n of each half is
    written at columns col .. col + C of row v·N/2 + n of that half's
    buffer, rounded to the buffers' type; the rows' lengths and col
    multiples of 16 bytes of the tables' type. Returns the two
    buffers (with the autograd history of the write) instead of the
    latent."""
    tables = tuple(tables)
    first, second = (None, None) if out is None else out
    if not torch.is_grad_enabled():
        return _triplane_forward(tables, cam, hw, view_offset, run, out, col)
    if cam.requires_grad:
        raise ValueError("triplane_sample: cam takes no gradient (detach "
                         "it)")
    if grad_acc is not None:
        for acc, t in zip(grad_acc, tables):
            _check_acc("triplane_sample", acc, t)
        grad_acc = tuple(grad_acc)
    return _TriplaneSample.apply(*tables, cam, tuple(hw), int(view_offset),
                                 grad_acc, run, int(col), first, second)


def local_uv(cam: torch.Tensor, focal: torch.Tensor, c: torch.Tensor,
             scale) -> torch.Tensor:
    """uv (2NV, M, 2) of the stacked fg/bg local table's rows: the camera
    points (NV, 2M, 3) of [fg | bg] projected with view 0's focal
    (f, -f) and centre, times `scale` (sx, sy), minus 1
    (neo360_tpu/models/neo360.py:293-299); row r holds branch r // NV,
    view r % NV."""
    nv, m = cam.shape[0], cam.shape[1] // 2
    focal2 = torch.stack([focal[0], -focal[0]])[None]
    uv = geometry.projection(cam, focal2, c[:1], nv)
    uv = torch.cat([uv[:, :m], uv[:, m:]], dim=0)
    scale = tuple(scale)
    return uv * cached("local_uv.scale", scale, torch.float32, cam.device,
                       lambda: torch.tensor(scale, dtype=torch.float32,
                                            device=cam.device)) - 1.0


def local_sample_reference(table: torch.Tensor, cam: torch.Tensor,
                           focal: torch.Tensor, c: torch.Tensor, scale,
                           hw: tuple, view_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the fused local gather: `local_uv` and a
    border-mode `table_sample_reference` -> (2NV, M, C) f32."""
    return table_sample_reference(table, local_uv(cam, focal, c, scale), hw,
                                  "border", torch.float32, view_offset)


def _local_forward(table, cam, focal, c, scale, hw, view_offset, run=None,
                   out=None, col=0):
    if all(t.device.type == "cpu" for t in (table, cam, focal, c)):
        local = local_sample_reference(table, cam, focal, c, scale, hw,
                                       view_offset)
        return local if out is None else _write_halves(local, out, col, 0)
    name = "local_sample"
    table, cam = kernels.dense(table), cam.contiguous()
    focal, c = focal.contiguous(), c.contiguous()
    kernels.require_cuda(name, table, cam, focal, c)
    _cam_ok(name, cam)
    if table.dtype not in kernels.DTYPE_CODES or focal.dtype != torch.float32 \
            or c.dtype != torch.float32 or cam.shape[1] % 2:
        raise ValueError(f"{name}: table float32 or bfloat16, focal and c "
                         f"float32, cam (NV, 2M, 3)")
    h, w = hw
    vec = 16 // table.element_size()
    cc = _table_shape_ok(name, table.shape, hw, vec)
    nv, m = cam.shape[0], cam.shape[1] // 2
    result, dest = _dest(name, out, col, torch.Size((2 * nv, m, cc)),
                         2 * nv * m, nv * m, vec, cam.device)
    kernels.launch("local_sample_fwd", cam.device, table.data_ptr(),
                   kernels.DTYPE_CODES[table.dtype], cam.data_ptr(),
                   focal.data_ptr(), c.data_ptr(), float(scale[0]),
                   float(scale[1]), *dest, nv, m, h, w, cc,
                   int(view_offset), table.shape[0], run or LOCAL_SAMPLE_RUN)
    return result


class _LocalSample(torch.autograd.Function):
    """local_sample; the backward rebuilds the uv from the saved camera
    points with `local_uv` and hands (cotangent, uv) to
    `table_sample_backward`, or to `table_sample_accumulate` given an
    accumulator (the table then gets None). Destinations (`first`,
    `second`) as `_TriplaneSample`'s."""

    @staticmethod
    def forward(ctx, table, cam, focal, c, scale, hw, view_offset,
                grad_acc, run, col, first, second):
        ctx.save_for_backward(cam, focal, c)
        ctx.meta = (tuple(table.shape), table.dtype, scale, hw, view_offset,
                    col)
        ctx.grad_acc = grad_acc
        out = None
        if first is not None:
            out = (first, second)
            ctx.mark_dirty(first, second)
        return _local_forward(table, cam, focal, c, scale, hw, view_offset,
                              run, out, col)

    @staticmethod
    def backward(ctx, *grads):
        cam, focal, c = ctx.saved_tensors
        shape, dtype, scale, hw, offset, col = ctx.meta
        grad = grads[0]
        if len(grads) == 2:
            grad = _joined(grads, col, (2 * cam.shape[0], cam.shape[1] // 2,
                                        shape[-1] // 4), 0)
        dtable = None
        if ctx.needs_input_grad[0]:
            dtable = _table_grad(grad, local_uv(cam, focal, c, scale), shape,
                                 dtype, hw, "border", offset, ctx.grad_acc)
        passed = grads if len(grads) == 2 else (None, None)
        return (dtable, None, None, None, None, None, None, None, None, None,
                *passed)


def local_sample(table: torch.Tensor, cam: torch.Tensor, focal: torch.Tensor,
                 c: torch.Tensor, scale, hw: tuple, view_offset: int = 0,
                 grad_acc: torch.Tensor = None, run: int = None, out=None,
                 col: int = 0):
    """Pixel-aligned local latents (2NV, M, C) f32 of the fg and bg points
    from the stacked fg/bg table (semantics of the uv prologue and gather
    of neo360_tpu/models/neo360.py:NeRFTP._local_feats_pair). cam
    (NV, 2M, 3): the camera points of [fg | bg]; focal (NV,), c (NV, 2):
    the source views' intrinsics (view 0's are used); scale: (sx, sy),
    latent_scaling / image size, as Python floats. Row r reads table view
    clip(r + view_offset, 0, V-1), border mode.

    CPU tensors run `local_sample_reference`; CUDA tensors launch the fused
    kernel (csrc/local_sample.cu) through C entry `local_sample_fwd`.
    With grad enabled the call is a `_LocalSample` autograd Function; cam
    must not require grad (raises). `grad_acc`: an f32 accumulator of the
    table's shape (kernel A''s accumulate contract). `run`: the kernel's run
    length, LOCAL_SAMPLE_RUN unless given.

    `out`: two row buffers of NV·M rows, float32 or bfloat16, of the fg and
    the bg branch (their rows may differ in length): the latent of output
    row (branch, view v) and point m is written at columns col .. col + C
    of row v·M + m of that branch's buffer, rounded to the buffers' type;
    the rows' lengths and col multiples of 16 bytes of the table's type.
    Returns the two buffers (with the autograd history of the write)
    instead of the latents."""
    scale = (float(scale[0]), float(scale[1]))
    first, second = (None, None) if out is None else out
    if not torch.is_grad_enabled():
        return _local_forward(table, cam, focal, c, scale, hw, view_offset,
                              run, out, col)
    if cam.requires_grad:
        raise ValueError("local_sample: cam takes no gradient (detach it)")
    _check_acc("local_sample", grad_acc, table)
    return _LocalSample.apply(table, cam, focal, c, scale, tuple(hw),
                              int(view_offset), grad_acc, run, int(col),
                              first, second)


# consecutive points a group of threads of kernel G' walks, merging the
# corner sums of points that share a cell before its atomics
# (csrc/grid_sample_bwd.cu), adopted by measurement on the card (PERF.md).
# The path always runs it; only `scripts/torch_kernel_times.py --sweep`
# and the card tests pass another, as `grid_sample_2d_backward`'s `run`
GRID_SAMPLE_BWD_RUN = 8


# grid_sample_2d's image gradient on the card against its plain version
# (ops.kernels.compare): 1e-5 relative plus 1e-5 * max|ref|. Kernel G''s
# atomic adds sum each pixel's contributions in another order than
# index_add_. (Kernel G's forward equals its plain version: no tolerance.)
GRID_SAMPLE_TOL = dict(rtol=1e-5, atol_frac=1e-5)

# a bf16 image's gradient from kernel G' against the plain float32
# gradient: one bf16 rounding of the f32 sum (at most 2^-8 relative) plus
# GRID_SAMPLE_TOL's allowance for the order of the sum
GRID_SAMPLE_BF16_GRAD_TOL = dict(rtol=2.0 ** -8, atol_frac=1e-5)


def grid_sample_2d_reference(image: torch.Tensor, uv: torch.Tensor,
                             padding_mode: str = "zeros") -> torch.Tensor:
    """Plain PyTorch version of `grid_sample_2d`: the four-corner formula
    of neo360_tpu/ops/interpolate.py:62-114 (in zeros mode each corner
    outside the image weighs 0). image (B, H, W, C), uv (B, N, 2) ->
    (B, N, C) in the promoted type of the image and the weights."""
    _check_mode(padding_mode)
    b, h, w, c = image.shape
    flat = image.reshape(b * h * w, c)
    n = uv.shape[1]
    p00, p01, p10, p11 = (flat[idx.reshape(-1)].reshape(b, n, c)
                          * wgt[..., None]
                          for idx, wgt in _grid_taps(uv, (b, h, w),
                                                     padding_mode))
    return ((p00 + p01) + p10) + p11


def _grid_taps(uv: torch.Tensor, bhw: tuple, padding_mode: str):
    """The four corners (x0, y0), (x1, y0), (x0, y1), (x1, y1) of every
    point, as (flat pixel index (B, N), weight (B, N)) pairs, in the JAX
    code's arithmetic; in zeros mode a corner outside the image weighs 0
    (its index is clamped inside)."""
    b, h, w = bhw
    ix = (uv[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (uv[..., 1] + 1.0) * 0.5 * (h - 1)
    if padding_mode == "border":   # torch.clamp keeps NaN, as jnp.clip
        ix = torch.clamp(ix, 0.0, w - 1)
        iy = torch.clamp(iy, 0.0, h - 1)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    base = (torch.arange(b, device=uv.device) * (h * w))[:, None]
    out = []
    for xi, yi, wgt in ((x0, y0, (x1 - ix) * (y1 - iy)),
                        (x1, y0, (ix - x0) * (y1 - iy)),
                        (x0, y1, (x1 - ix) * (iy - y0)),
                        (x1, y1, (ix - x0) * (iy - y0))):
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
        # clamp in float before the cast: huge or non-finite uv stays defined
        xc = torch.nan_to_num(torch.clamp(xi, 0, w - 1)).long()
        yc = torch.nan_to_num(torch.clamp(yi, 0, h - 1)).long()
        out.append((base + yc * w + xc, wgt))
    return out


def grid_sample_2d_backward_reference(grad: torch.Tensor, uv: torch.Tensor,
                                      image_shape, image_dtype,
                                      padding_mode: str = "zeros"
                                      ) -> torch.Tensor:
    """Plain PyTorch version of kernel G': the gradient of
    `grid_sample_2d_reference` with respect to the image, for the output
    cotangent `grad` (B, N, C): each point adds w_k * grad into its corner
    pixels (index_add_ in f32), rounded once to `image_dtype`. Points with
    non-finite uv add nothing; for finite uv this equals autograd of the
    plain forward on an f32 copy of the image."""
    _check_mode(padding_mode)
    b, h, w, c = image_shape
    uv = uv.float()
    finite = torch.isfinite(uv).all(-1)
    out = torch.zeros(b * h * w, c, dtype=torch.float32, device=grad.device)
    g = grad.float()
    for idx, wgt in _grid_taps(uv, (b, h, w), padding_mode):
        contrib = torch.where(finite[..., None], wgt[..., None] * g,
                              torch.zeros_like(g))
        out.index_add_(0, idx.reshape(-1), contrib.reshape(-1, c))
    return out.reshape(image_shape).to(image_dtype)


def _grid_args(name: str, image_shape, uv: torch.Tensor) -> None:
    """Raise unless uv is float32 (B, N, 2) for a (B, H, W, C) image of
    fewer than 2^31 pixels (attributes only)."""
    if uv.dtype != torch.float32 or uv.dim() != 3 or uv.shape[-1] != 2 \
            or len(image_shape) != 4 or uv.shape[0] != image_shape[0]:
        raise ValueError(f"{name}: uv must be float32 (B, N, 2) for an "
                         f"image (B, H, W, C), got {tuple(uv.shape)} "
                         f"{uv.dtype} and {tuple(image_shape)}")
    b, h, w, _ = image_shape
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{name}: {b * h * w} pixels, 2^31 or more")


def _grid_sample_forward(image: torch.Tensor, uv: torch.Tensor,
                         padding_mode: str) -> torch.Tensor:
    """Kernel G on CUDA tensors: one launch, whatever C."""
    name = "grid_sample_2d"
    _check_mode(padding_mode)
    image, uv = image.contiguous(), uv.contiguous()
    kernels.require_cuda(name, image, uv)
    code = kernels.DTYPE_CODES.get(image.dtype)
    if code is None:
        raise ValueError(f"{name}: image must be float32 or bfloat16, got "
                         f"{image.dtype}")
    _grid_args(name, image.shape, uv)
    b, h, w, c = image.shape
    n = uv.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=uv.device)
    kernels.launch("grid_sample_fwd", uv.device, image.data_ptr(), code,
                   uv.data_ptr(), out.data_ptr(), b, n, h, w, c,
                   int(padding_mode == "zeros"))
    return out


def grid_sample_2d_backward(grad: torch.Tensor, uv: torch.Tensor,
                            image_shape, image_dtype,
                            padding_mode: str = "zeros",
                            run: int = None) -> torch.Tensor:
    """Gradient of `grid_sample_2d` with respect to the image, for the
    output cotangent `grad` (B, N, C), in `image_dtype`.

    CPU tensors run `grid_sample_2d_backward_reference`; CUDA tensors
    launch kernel G' (csrc/grid_sample_bwd.cu: a memset, the scatter and,
    for a bf16 image, one rounding pass) through C entry
    `grid_sample_bwd`. `run`: the points a group of threads walks,
    GRID_SAMPLE_BWD_RUN unless given."""
    if grad.device.type == "cpu" and uv.device.type == "cpu":
        return grid_sample_2d_backward_reference(grad, uv, image_shape,
                                                 image_dtype, padding_mode)
    name = "grid_sample_2d_backward"
    _check_mode(padding_mode)
    grad, uv = grad.contiguous(), uv.contiguous()
    kernels.require_cuda(name, grad, uv)
    code = kernels.DTYPE_CODES.get(image_dtype)
    if code is None or grad.dtype != torch.float32:
        raise ValueError(f"{name}: image float32 or bfloat16 and a float32 "
                         f"cotangent, got {image_dtype} and {grad.dtype}")
    _grid_args(name, image_shape, uv)
    b, h, w, c = image_shape
    n = uv.shape[1]
    if tuple(grad.shape) != (b, n, c):
        raise ValueError(f"{name}: grad {tuple(grad.shape)}, expected "
                         f"{(b, n, c)}")
    scratch = torch.empty(image_shape, dtype=torch.float32,
                          device=grad.device)
    dimage = scratch if code == 0 else torch.empty(
        image_shape, dtype=image_dtype, device=grad.device)
    kernels.launch("grid_sample_bwd", grad.device, grad.data_ptr(),
                   uv.data_ptr(), scratch.data_ptr(), dimage.data_ptr(), code,
                   b, n, h, w, c, int(padding_mode == "zeros"),
                   run or GRID_SAMPLE_BWD_RUN)
    return dimage


class _GridSample(torch.autograd.Function):
    """grid_sample_2d on the card with the image's gradient from kernel G'
    (`grid_sample_2d_backward`); uv is saved, the image is not (the
    backward needs its shape and type only)."""

    @staticmethod
    def forward(ctx, image, uv, padding_mode):
        ctx.save_for_backward(uv)
        ctx.meta = (tuple(image.shape), image.dtype, padding_mode)
        return _grid_sample_forward(image, uv, padding_mode)

    @staticmethod
    def backward(ctx, grad):
        (uv,) = ctx.saved_tensors
        dimage = None
        if ctx.needs_input_grad[0]:
            shape, dtype, mode = ctx.meta
            dimage = grid_sample_2d_backward(grad, uv, shape, dtype, mode)
        return dimage, None, None


def grid_sample_2d(image: torch.Tensor, uv: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample NHWC images at normalized coords, align_corners=True
    (semantics of neo360_tpu/ops/interpolate.py:grid_sample_2d, and of
    F.grid_sample(mode="bilinear", align_corners=True) in zeros and border
    padding).

    image (B, H, W, C) float32 or bfloat16; uv (B, N, 2), x = u, y = v in
    [-1, 1], (-1, -1) the centre of pixel (0, 0). Returns (B, N, C)
    float32. Non-finite uv samples 0 in zeros mode.

    CPU tensors run `grid_sample_2d_reference`. CUDA tensors launch kernel
    G (csrc/grid_sample.cu) once, whatever C, through C entry
    `grid_sample_fwd`; with autograd on and an image that requires
    grad the call is a `_GridSample` Function whose backward is kernel G'
    (`grid_sample_2d_backward`). On the card uv must be float32, and a
    call the kernels cannot serve raises. G's values equal the plain
    version's for an image of finite values; in zeros mode a corner
    outside the image adds +0 on the card, where the plain version
    multiplies the clamped edge pixel by 0 (NaN if that pixel is inf or
    NaN). uv takes no gradient (raises if it requires one); the JAX
    function differentiates through uv, which no caller uses."""
    if torch.is_grad_enabled() and uv.requires_grad:
        raise ValueError("grid_sample_2d: uv takes no gradient (detach it)")
    if image.device.type == "cpu" and uv.device.type == "cpu":
        return grid_sample_2d_reference(image, uv, padding_mode)
    if torch.is_grad_enabled() and image.requires_grad:
        return _GridSample.apply(image, uv, padding_mode)
    return _grid_sample_forward(image, uv, padding_mode)


def in_bounds_mask(uv: torch.Tensor) -> torch.Tensor:
    """|uv| <= 1 per coordinate, (B, N, 2) bool."""
    return torch.abs(uv) <= 1.0


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bilinear interpolation matrix."""
    if n_in == 1:
        return np.ones((n_out, 1), dtype=np.float32)
    pos = np.zeros((1,)) if n_out == 1 else np.linspace(0.0, n_in - 1, n_out)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    m[rows, lo] += 1.0 - frac
    m[rows, hi] += frac
    return m


def resize_bilinear_align_corners(image: torch.Tensor,
                                  out_hw: tuple) -> torch.Tensor:
    """Resize (..., H, W, C) -> (..., H', W', C), align_corners=True, as
    two products with interpolation matrices in the image's dtype (so a
    bf16 map stays bf16), rows first."""
    h_out, w_out = out_hw
    h_in, w_in = image.shape[-3], image.shape[-2]
    if (h_in, w_in) == (h_out, w_out):
        return image
    mh, mw = (cached("resize_matrix", (n_out, n_in), image.dtype,
                     image.device, lambda n_out=n_out, n_in=n_in:
                     torch.as_tensor(_interp_matrix(n_out, n_in),
                                     device=image.device, dtype=image.dtype))
              for n_out, n_in in ((h_out, h_in), (w_out, w_in)))
    out = torch.einsum("oh,...hwc->...owc", mh, image)
    return torch.einsum("ow,...hwc->...hoc", mw, out)
