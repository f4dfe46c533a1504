"""NeRF++ volumetric compositing (port of neo360_tpu/core/render.py:55-96).

`composite_nerfpp` renders one level's fg and bg branches and combines
them (neo360_tpu/models/neo360.py:471-500). On CUDA tensors it is kernel B
(csrc/composite_nerfpp.cu); on CPU tensors it is `composite_nerfpp_reference`,
built on the plain `volumetric_rendering_nerfpp`. With autograd on it runs
as a `torch.autograd.Function` whose backward is kernel B'
(csrc/composite_nerfpp_bwd.cu) on CUDA and autograd of the plain version on
the CPU; t, dirs and far take no gradient.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from neo360_tpu_torch.ops import kernels

_EPS = 1e-10


def volumetric_rendering_nerfpp(
    rgb: torch.Tensor,
    density: torch.Tensor,
    t_vals: torch.Tensor,
    dirs: torch.Tensor,
    white_bkgd: bool,
    in_sphere: bool,
    t_far: Optional[torch.Tensor] = None,
):
    """NeRF++ fg/bg compositing with leftover-transmittance bg_lambda.

    rgb (B,S,3), density (B,S,1), t_vals (B,S), dirs (B,3), t_far (B,1).
    Foreground: the last interval is [t_last, t_far]; bg_lambda is the
    transmittance past the last sample. Background: t_vals descend, the last
    interval is 1e10 wide, bg_lambda is None.

    Returns comp_rgb (B,3), acc (B,), weights (B,S), bg_lambda (B,1)|None,
    depth (B,).
    """
    if in_sphere:
        dists = t_vals[..., 1:] - t_vals[..., :-1]
        dists = torch.cat([dists, t_far - t_vals[..., -1:]], dim=-1)
        dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    else:
        dists = t_vals[..., :-1] - t_vals[..., 1:]
        dists = torch.cat([dists, torch.full_like(t_vals[..., :1], 1e10)],
                          dim=-1)

    alpha = 1.0 - torch.exp(-density[..., 0] * dists)
    trans = torch.cumprod(1.0 - alpha + _EPS, dim=-1)
    bg_lambda = trans[..., -1:] if in_sphere else None
    accum_prod = torch.cat([torch.ones_like(trans[..., -1:]),
                            trans[..., :-1]], dim=-1)
    weights = alpha * accum_prod

    acc = torch.sum(weights, dim=-1)
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    depth = torch.sum(weights * t_vals, dim=-1)
    return comp_rgb, acc, weights, bg_lambda, depth


def composite_nerfpp_reference(fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma,
                               bg_t, dirs, far, white_bkgd: bool
                               ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of kernel B: both branches of one level and
    their NeRF++ combination."""
    fg_comp, fg_acc, fg_w, bg_lambda, fg_depth = volumetric_rendering_nerfpp(
        fg_rgb, fg_sigma, fg_t, dirs, white_bkgd, in_sphere=True, t_far=far)
    bg_comp, bg_acc, bg_w, _, bg_depth = volumetric_rendering_nerfpp(
        bg_rgb, bg_sigma, bg_t, dirs, white_bkgd, in_sphere=False)
    return {"rgb": fg_comp + bg_lambda * bg_comp, "fg_rgb": fg_comp,
            "bg_rgb": bg_comp, "fg_acc": fg_acc, "bg_acc": bg_acc,
            "fg_weights": fg_w, "bg_weights": bg_w, "bg_lambda": bg_lambda,
            "depth": fg_depth + bg_lambda[..., 0] * bg_depth,
            "fg_depth": fg_depth}


OUT_KEYS = ("rgb", "fg_rgb", "bg_rgb", "fg_acc", "bg_acc", "fg_weights",
            "bg_weights", "bg_lambda", "depth", "fg_depth")


def _checked(name, args):
    """The eight inputs, contiguous on one CUDA device with the shapes the
    kernels take; returns them and (B, S_fg, S_bg)."""
    args = tuple(a.contiguous() for a in args)
    kernels.require_cuda(name, *args)
    fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far = args
    b, s_fg = fg_t.shape
    s_bg = bg_t.shape[1]
    shapes = ((fg_rgb, (b, s_fg, 3)), (fg_sigma, (b, s_fg, 1)),
              (fg_t, (b, s_fg)), (bg_rgb, (b, s_bg, 3)),
              (bg_sigma, (b, s_bg, 1)), (bg_t, (b, s_bg)), (dirs, (b, 3)),
              (far, (b, 1)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return args, (b, s_fg, s_bg)


def _composite_forward(args, white_bkgd: bool) -> Dict[str, torch.Tensor]:
    if all(a.device.type == "cpu" for a in args):
        return composite_nerfpp_reference(*args, white_bkgd)
    args, (b, s_fg, s_bg) = _checked("composite_nerfpp", args)
    fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far = args
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=dirs.device)
    out = {"rgb": new(b, 3), "fg_rgb": new(b, 3), "bg_rgb": new(b, 3),
           "fg_acc": new(b), "bg_acc": new(b), "fg_weights": new(b, s_fg),
           "bg_weights": new(b, s_bg), "bg_lambda": new(b, 1),
           "depth": new(b), "fg_depth": new(b)}
    kernels.launch("composite_nerfpp_fwd", dirs.device, fg_rgb.data_ptr(),
                   fg_sigma.data_ptr(), fg_t.data_ptr(), s_fg,
                   bg_rgb.data_ptr(), bg_sigma.data_ptr(), bg_t.data_ptr(),
                   s_bg, dirs.data_ptr(), far.data_ptr(), b, int(white_bkgd),
                   *(out[k].data_ptr() for k in OUT_KEYS))
    composite_nerfpp.launches += 1
    return out


def composite_nerfpp_backward(args, grads, white_bkgd: bool = False):
    """Gradients (d fg_rgb, d fg_sigma, d bg_rgb, d bg_sigma) of
    `composite_nerfpp` at inputs `args` (its eight tensors) for the output
    cotangents `grads` (one per OUT_KEYS entry, None = zero).

    CPU tensors: autograd of `composite_nerfpp_reference`. CUDA tensors
    launch kernel B' (csrc/composite_nerfpp_bwd.cu) and add one to
    `composite_nerfpp_backward.launches`."""
    if all(a.device.type == "cpu" for a in args):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(i in (0, 1, 3, 4))
                      for i, a in enumerate(args)]
            out = composite_nerfpp_reference(*leaves, white_bkgd)
            pairs = [(out[k], g) for k, g in zip(OUT_KEYS, grads)
                     if g is not None]
            wrt = [leaves[i] for i in (0, 1, 3, 4)]
            d = torch.autograd.grad([o for o, _ in pairs], wrt,
                                    [g for _, g in pairs],
                                    allow_unused=True) if pairs else [None] * 4
            return tuple(torch.zeros_like(a) if g is None else g
                         for a, g in zip(wrt, d))
    name = "composite_nerfpp_backward"
    args, (b, s_fg, s_bg) = _checked(name, args)
    fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far = args
    ptrs = []
    for key, g in zip(OUT_KEYS, grads):
        if g is None:
            ptrs.append(None)
            continue
        g = g.contiguous()
        if g.dtype != torch.float32 or g.device != dirs.device:
            raise ValueError(f"{name}: cotangent of {key} must be float32 "
                             f"on {dirs.device}")
        ptrs.append(g)
    d = [torch.empty_like(a) for a in (fg_rgb, fg_sigma, bg_rgb, bg_sigma)]
    kernels.launch("composite_nerfpp_bwd", dirs.device, fg_rgb.data_ptr(),
                   fg_sigma.data_ptr(), fg_t.data_ptr(), s_fg,
                   bg_rgb.data_ptr(), bg_sigma.data_ptr(), bg_t.data_ptr(),
                   s_bg, dirs.data_ptr(), far.data_ptr(), b, int(white_bkgd),
                   *(None if g is None else g.data_ptr() for g in ptrs),
                   *(t.data_ptr() for t in d))
    composite_nerfpp_backward.launches += 1
    return tuple(d)


class _Composite(torch.autograd.Function):
    """composite_nerfpp with the gradient of `composite_nerfpp_backward`."""

    @staticmethod
    def forward(ctx, white_bkgd, *args):
        ctx.set_materialize_grads(False)
        ctx.white_bkgd = white_bkgd
        ctx.save_for_backward(*args)
        out = _composite_forward(args, white_bkgd)
        return tuple(out[k] for k in OUT_KEYS)

    @staticmethod
    def backward(ctx, *grads):
        d = composite_nerfpp_backward(ctx.saved_tensors, grads,
                                      ctx.white_bkgd)
        return (None, d[0], d[1], None, d[2], d[3], None, None, None)


def composite_nerfpp(fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs,
                     far, white_bkgd: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """One level's NeRF++ composite: {rgb, fg_rgb, bg_rgb (B,3); fg_acc,
    bg_acc, depth, fg_depth (B,); fg_weights (B,S_fg); bg_weights (B,S_bg);
    bg_lambda (B,1)}, all float32.

    CPU tensors run `composite_nerfpp_reference`; CUDA tensors launch
    kernel B and add one to `composite_nerfpp.launches`. With grad enabled
    the call is a `_Composite` autograd Function; t, dirs and far must not
    require grad (raises)."""
    args = (fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far)
    if not torch.is_grad_enabled():
        return _composite_forward(args, white_bkgd)
    for name, a in (("fg_t", fg_t), ("bg_t", bg_t), ("dirs", dirs),
                    ("far", far)):
        if a.requires_grad:
            raise ValueError(f"composite_nerfpp: {name} takes no gradient "
                             f"(detach it)")
    return dict(zip(OUT_KEYS, _Composite.apply(bool(white_bkgd), *args)))


composite_nerfpp.launches = 0
composite_nerfpp_backward.launches = 0

# kernel B' against autograd of the plain version (ops.kernels.compare):
# 1e-4 relative and 1e-5 * max|ref|. The plain backward of torch.cumprod
# divides by (1 - alpha + 1e-10) and sums in reverse cumsum order; the
# kernel's reverse scan does neither. A float32 emulation of the scan
# differs from float64 autograd by ~2e-6 relative at S=9.
BACKWARD_TOL = dict(rtol=1e-4, atol_frac=1e-5)
