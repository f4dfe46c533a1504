"""Volumetric compositing (port of neo360_tpu/core/render.py): the plain
NeRF rule, the NeRF++ fg/bg rule, the MipNeRF-360 rule, and the VolSDF
rule (`volume_rendering_volsdf`, plain PyTorch).

`composite_vanilla` is one level's plain NeRF composite
(neo360_tpu/core/render.py:volumetric_rendering), which the vanilla NeRF
and PixelNeRF models call. On CUDA tensors it is kernel D
(csrc/composite_vanilla.cu); on CPU tensors it is
`composite_vanilla_reference`. With autograd on it runs as a
`torch.autograd.Function` whose backward is kernel D'
(csrc/composite_vanilla_bwd.cu) on CUDA and autograd of the plain version
on the CPU; t and dirs take no gradient.

`composite_nerfpp` renders one level's fg and bg branches and combines
them (neo360_tpu/models/neo360.py:471-500). On CUDA tensors it is kernel B
(csrc/composite_nerfpp.cu); on CPU tensors it is `composite_nerfpp_reference`,
built on the plain `volumetric_rendering_nerfpp`. With autograd on it runs
as a `torch.autograd.Function` whose backward is kernel B'
(csrc/composite_nerfpp_bwd.cu) on CUDA and autograd of the plain version on
the CPU; t, dirs and far take no gradient.

`composite_mip` is one MipNeRF-360 level's composite
(neo360_tpu/core/render.py:compute_alpha_weights + render_mip), which
neo360_tpu_torch/models/mipnerf360.py calls once per level. On CUDA
tensors it is kernel E (csrc/composite_mip.cu), on CPU tensors
`composite_mip_reference`; its backward is kernel E'
(csrc/composite_mip_bwd.cu) on CUDA and autograd of the plain version on
the CPU; tdist and dirs take no gradient.
"""

from __future__ import annotations

from operator import itemgetter
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


def _nerfpp_shapes(args):
    """Kernels B / B''s input shapes and output shapes (in OUT_KEYS order)
    at inputs `args`; and (B, S_fg, S_bg)."""
    b, s_fg = args[2].shape
    s_bg = args[5].shape[1]
    return ((b, s_fg, 3), (b, s_fg, 1), (b, s_fg), (b, s_bg, 3),
            (b, s_bg, 1), (b, s_bg), (b, 3), (b, 1)), \
        ((b, 3), (b, 3), (b, 3), (b,), (b,), (b, s_fg), (b, s_bg), (b, 1),
         (b,), (b,)), (b, s_fg, s_bg)


def _composite_forward(args, white_bkgd: bool) -> Dict[str, torch.Tensor]:
    if all(a.device.type == "cpu" for a in args):
        return composite_nerfpp_reference(*args, white_bkgd)
    ins, outs, (b, s_fg, s_bg) = _nerfpp_shapes(args)
    fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far = \
        kernels.checked("composite_nerfpp", args, ins)
    out = {k: torch.empty(shape, dtype=torch.float32, device=dirs.device)
           for k, shape in zip(OUT_KEYS, outs)}
    kernels.launch("composite_nerfpp_fwd", dirs.device, fg_rgb.data_ptr(),
                   fg_sigma.data_ptr(), fg_t.data_ptr(), s_fg,
                   bg_rgb.data_ptr(), bg_sigma.data_ptr(), bg_t.data_ptr(),
                   s_bg, dirs.data_ptr(), far.data_ptr(), b, int(white_bkgd),
                   *(out[k].data_ptr() for k in OUT_KEYS))
    return out


def composite_nerfpp_backward(args, grads, white_bkgd: bool = False):
    """Gradients (d fg_rgb, d fg_sigma, d bg_rgb, d bg_sigma) of
    `composite_nerfpp` at inputs `args` (its eight tensors) for the output
    cotangents `grads` (one per OUT_KEYS entry, None = zero).

    CPU tensors: autograd of `composite_nerfpp_reference`. CUDA tensors
    launch kernel B' (csrc/composite_nerfpp_bwd.cu) through C entry
    `composite_nerfpp_bwd`."""
    if all(a.device.type == "cpu" for a in args):
        return kernels.plain_grads(
            lambda *a: itemgetter(*OUT_KEYS)(
                composite_nerfpp_reference(*a, white_bkgd)),
            args, (0, 1, 3, 4), grads)
    ins, outs, (b, s_fg, s_bg) = _nerfpp_shapes(args)
    checked = kernels.checked("composite_nerfpp_backward",
                              (*args, *grads), ins + outs)
    fg_rgb, fg_sigma, fg_t, bg_rgb, bg_sigma, bg_t, dirs, far = checked[:8]
    d = [torch.empty_like(a) for a in (fg_rgb, fg_sigma, bg_rgb, bg_sigma)]
    kernels.launch("composite_nerfpp_bwd", dirs.device, fg_rgb.data_ptr(),
                   fg_sigma.data_ptr(), fg_t.data_ptr(), s_fg,
                   bg_rgb.data_ptr(), bg_sigma.data_ptr(), bg_t.data_ptr(),
                   s_bg, dirs.data_ptr(), far.data_ptr(), b, int(white_bkgd),
                   *(None if g is None else g.data_ptr()
                     for g in checked[8:]),
                   *(t.data_ptr() for t in d))
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
    kernel B through C entry `composite_nerfpp_fwd`. With grad enabled
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


# kernel B' against autograd of the plain version (ops.kernels.compare):
# 1e-4 relative and 1e-5 * max|ref|. The plain backward of torch.cumprod
# divides by (1 - alpha + 1e-10) and sums in reverse cumsum order; the
# kernel's reverse scan does neither. A float32 emulation of the scan
# differs from float64 autograd by ~2e-6 relative at S=9.
BACKWARD_TOL = dict(rtol=1e-4, atol_frac=1e-5)


def volume_rendering_volsdf(rgb: torch.Tensor, density: torch.Tensor,
                            t_vals: torch.Tensor, dirs: torch.Tensor,
                            white_bkgd: bool):
    """VolSDF-style compositing in log space (neo360_tpu/core/render.py:99,
    the reference's vanilla_nerf/helper.py:488-518), plain PyTorch: free
    energy = density * dists, transmittance = exp(-cumsum), the last
    interval 1 wide (not 1e10). No model calls it; no kernel computes it.

    rgb (B,S,3), density (B,S) or (B,S,1), t_vals (B,S), dirs (B,3).
    Returns comp_rgb (B,3), acc (B,), weights (B,S), depth (B,)."""
    density = density[..., 0] if density.dim() == rgb.dim() else density
    dists = torch.cat([t_vals[..., 1:] - t_vals[..., :-1],
                       torch.ones_like(t_vals[..., :1])], dim=-1)
    dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    free_energy = dists * density
    shifted = torch.cat([torch.zeros_like(free_energy[..., :1]),
                         free_energy[..., :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    trans = torch.exp(-torch.cumsum(shifted, dim=-1))
    weights = alpha * trans
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * t_vals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, acc, weights, depth


# --- the plain NeRF composite (kernels D and D') -------------------------

VANILLA_OUT_KEYS = ("rgb", "acc", "weights", "depth")


def composite_vanilla_reference(rgb: torch.Tensor, density: torch.Tensor,
                                t_vals: torch.Tensor, dirs: torch.Tensor,
                                white_bkgd: bool):
    """Plain PyTorch version of kernel D, in the order of operations of
    neo360_tpu/core/render.py:volumetric_rendering.

    rgb (B,S,3), density (B,S,1), t_vals (B,S), dirs (B,3). The last
    interval is 1e10 wide; every interval is scaled by |dirs|. Returns
    comp_rgb (B,3), acc (B,), weights (B,S), depth (B,)."""
    dists = torch.cat([t_vals[..., 1:] - t_vals[..., :-1],
                       torch.full_like(t_vals[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    alpha = 1.0 - torch.exp(-density[..., 0] * dists)
    accum_prod = torch.cat([torch.ones_like(alpha[..., :1]),
                            torch.cumprod(1.0 - alpha[..., :-1] + _EPS,
                                          dim=-1)], dim=-1)
    weights = alpha * accum_prod

    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * t_vals, dim=-1)
    acc = torch.sum(weights, dim=-1)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, acc, weights, depth


def _vanilla_shapes(name, args):
    """Kernels D / D''s input shapes and output shapes (in VANILLA_OUT_KEYS
    order) at inputs `args`; and (B, S)."""
    t = args[2]
    if t.dim() != 2 or t.shape[1] < 1:
        raise ValueError(f"{name}: t_vals must be (B, S) with S >= 1, got "
                         f"{tuple(t.shape)}")
    b, s = t.shape
    return ((b, s, 3), (b, s, 1), (b, s), (b, 3)), \
        ((b, 3), (b,), (b, s), (b,)), (b, s)


def _vanilla_forward(args, white_bkgd: bool):
    if all(a.device.type == "cpu" for a in args):
        return composite_vanilla_reference(*args, white_bkgd)
    name = "composite_vanilla"
    ins, outs, (b, s) = _vanilla_shapes(name, args)
    rgb, density, t, dirs = kernels.checked(name, args, ins)
    out = tuple(torch.empty(shape, dtype=torch.float32, device=dirs.device)
                for shape in outs)
    kernels.launch("composite_vanilla_fwd", dirs.device, rgb.data_ptr(),
                   density.data_ptr(), t.data_ptr(), s, dirs.data_ptr(), b,
                   int(white_bkgd), *(o.data_ptr() for o in out))
    return out


def composite_vanilla_backward(args, grads, white_bkgd: bool = False):
    """Gradients (d rgb, d density) of `composite_vanilla` at inputs `args`
    (rgb, density, t_vals, dirs) for the output cotangents `grads` (one per
    VANILLA_OUT_KEYS entry, None = zero).

    CPU tensors: autograd of `composite_vanilla_reference`. CUDA tensors
    launch kernel D' (csrc/composite_vanilla_bwd.cu) through C entry
    `composite_vanilla_bwd`."""
    if all(a.device.type == "cpu" for a in args):
        return kernels.plain_grads(
            lambda *a: composite_vanilla_reference(*a, white_bkgd), args,
            (0, 1), grads)
    name = "composite_vanilla_backward"
    ins, outs, (b, s) = _vanilla_shapes(name, args)
    checked = kernels.checked(name, (*args, *grads), ins + outs)
    rgb, density, t, dirs = checked[:4]
    d = (torch.empty_like(rgb), torch.empty_like(density))
    kernels.launch("composite_vanilla_bwd", dirs.device, rgb.data_ptr(),
                   density.data_ptr(), t.data_ptr(), s, dirs.data_ptr(), b,
                   int(white_bkgd),
                   *(None if g is None else g.data_ptr()
                     for g in checked[4:]),
                   *(x.data_ptr() for x in d))
    return d


class _CompositeVanilla(torch.autograd.Function):
    """composite_vanilla with the gradient of
    `composite_vanilla_backward`."""

    @staticmethod
    def forward(ctx, white_bkgd, *args):
        ctx.set_materialize_grads(False)
        ctx.white_bkgd = white_bkgd
        ctx.save_for_backward(*args)
        return _vanilla_forward(args, white_bkgd)

    @staticmethod
    def backward(ctx, *grads):
        d = composite_vanilla_backward(ctx.saved_tensors, grads,
                                       ctx.white_bkgd)
        return None, d[0], d[1], None, None


def composite_vanilla(rgb, density, t_vals, dirs, white_bkgd: bool = False):
    """One level's plain NeRF composite: (comp_rgb (B,3), acc (B,),
    weights (B,S), depth (B,)), float32, as
    neo360_tpu/core/render.py:volumetric_rendering returns them.

    CPU tensors run `composite_vanilla_reference`; CUDA tensors launch
    kernel D through C entry `composite_vanilla_fwd`. With grad enabled
    the call is a `_CompositeVanilla` autograd Function; t_vals and dirs
    must not require grad (raises)."""
    args = (rgb, density, t_vals, dirs)
    if not torch.is_grad_enabled():
        return _vanilla_forward(args, white_bkgd)
    for name, a in (("t_vals", t_vals), ("dirs", dirs)):
        if a.requires_grad:
            raise ValueError(f"composite_vanilla: {name} takes no gradient "
                             f"(detach it)")
    return _CompositeVanilla.apply(bool(white_bkgd), *args)


# --- the MipNeRF-360 composite (kernels E and E') ------------------------

MIP_OUT_KEYS = ("weights", "rgb", "acc", "depth")


def composite_mip_reference(density: torch.Tensor, tdist: torch.Tensor,
                            dirs: torch.Tensor, rgb: torch.Tensor, bg: float,
                            opaque_background: bool = True):
    """Plain PyTorch version of kernel E: neo360_tpu/core/render.py:
    compute_alpha_weights then render_mip, in their order of operations.

    density (B,S), tdist (B,S+1), dirs (B,3), rgb (B,S,3), bg a scalar
    background colour. Each interval is scaled by |dirs|; with
    `opaque_background` the last one is infinitely wide (alpha 1, and its
    density takes no gradient). The background's weight is
    torch.maximum(0, 1 - acc), whose gradient at the tie acc == 1 is 0.5,
    as jnp.maximum's (torch.clamp would give 1). Returns weights (B,S),
    rgb (B,3), acc (B,), depth (B,) over the interval midpoints."""
    t_delta = tdist[..., 1:] - tdist[..., :-1]
    delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta
    if opaque_background:
        density_delta = torch.cat(
            [density_delta[..., :-1],
             torch.full_like(density_delta[..., -1:], float("inf"))], dim=-1)
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]),
         torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans

    acc = torch.sum(weights, dim=-1)
    bg_w = torch.maximum(torch.zeros_like(acc[..., None]),
                         1.0 - acc[..., None])
    comp = torch.sum(weights[..., None] * rgb, dim=-2) + bg_w * bg
    t_mids = 0.5 * (tdist[..., 1:] + tdist[..., :-1])
    depth = torch.sum(weights * t_mids, dim=-1)
    return weights, comp, acc, depth


def _mip_shapes(name, args):
    """Kernels E / E''s input shapes and output shapes (in MIP_OUT_KEYS
    order) at inputs `args`; and (B, S)."""
    density = args[0]
    if density.dim() != 2 or density.shape[1] < 1:
        raise ValueError(f"{name}: density must be (B, S) with S >= 1, got "
                         f"{tuple(density.shape)}")
    b, s = density.shape
    return ((b, s), (b, s + 1), (b, 3), (b, s, 3)), \
        ((b, s), (b, 3), (b,), (b,)), (b, s)


def _mip_forward(args, bg: float, opaque: bool):
    if all(a.device.type == "cpu" for a in args):
        return composite_mip_reference(*args, bg, opaque)
    name = "composite_mip"
    ins, outs, (b, s) = _mip_shapes(name, args)
    density, tdist, dirs, rgb = kernels.checked(name, args, ins)
    out = tuple(torch.empty(shape, dtype=torch.float32, device=dirs.device)
                for shape in outs)
    kernels.launch("composite_mip_fwd", dirs.device, density.data_ptr(),
                   tdist.data_ptr(), dirs.data_ptr(), rgb.data_ptr(), s, b,
                   float(bg), int(opaque), *(o.data_ptr() for o in out))
    return out


def composite_mip_backward(args, acc, grads, bg: float = 1.0,
                           opaque: bool = True):
    """Gradients (d density, d rgb) of `composite_mip` at inputs `args`
    (density, tdist, dirs, rgb) for the output cotangents `grads` (one per
    MIP_OUT_KEYS entry, None = zero). `acc` is the forward's acc: kernel
    E' takes the background weight's branch from it (0.5 at the tie).

    CPU tensors: autograd of `composite_mip_reference` (which takes the
    branch from its own acc; `acc` is not read). CUDA tensors launch
    kernel E' (csrc/composite_mip_bwd.cu) through C entry
    `composite_mip_bwd`."""
    if all(a.device.type == "cpu" for a in args):
        return kernels.plain_grads(
            lambda *a: composite_mip_reference(*a, bg, opaque), args,
            (0, 3), grads)
    name = "composite_mip_backward"
    ins, outs, (b, s) = _mip_shapes(name, args)
    checked = kernels.checked(name, (*args, acc, *grads),
                              ins + ((b,),) + outs)
    density, tdist, dirs, rgb, acc = checked[:5]
    d = (torch.empty_like(density), torch.empty_like(rgb))
    kernels.launch("composite_mip_bwd", dirs.device, density.data_ptr(),
                   tdist.data_ptr(), dirs.data_ptr(), rgb.data_ptr(), s, b,
                   float(bg), int(opaque), acc.data_ptr(),
                   *(None if g is None else g.data_ptr()
                     for g in checked[5:]),
                   *(x.data_ptr() for x in d))
    return d


class _CompositeMip(torch.autograd.Function):
    """composite_mip with the gradient of `composite_mip_backward`."""

    @staticmethod
    def forward(ctx, bg, opaque, *args):
        ctx.set_materialize_grads(False)
        ctx.bg, ctx.opaque = bg, opaque
        out = _mip_forward(args, bg, opaque)
        ctx.save_for_backward(*args, out[2])
        return out

    @staticmethod
    def backward(ctx, *grads):
        *args, acc = ctx.saved_tensors
        d = composite_mip_backward(args, acc, grads, ctx.bg, ctx.opaque)
        return None, None, d[0], None, None, d[1]


def composite_mip(density, tdist, dirs, rgb, bg: float = 1.0,
                  opaque_background: bool = True):
    """One MipNeRF-360 level's composite: (weights (B,S), rgb (B,3), acc
    (B,), depth (B,)), float32 (`composite_mip_reference`).

    CPU tensors run `composite_mip_reference`; CUDA tensors launch kernel
    E (csrc/composite_mip.cu) through C entry `composite_mip_fwd`.
    With grad enabled the call is a `_CompositeMip` autograd Function
    whose backward is kernel E' on CUDA; tdist and dirs must not require
    grad (raises)."""
    args = (density, tdist, dirs, rgb)
    if not torch.is_grad_enabled():
        return _mip_forward(args, bg, opaque_background)
    for name, a in (("tdist", tdist), ("dirs", dirs)):
        if a.requires_grad:
            raise ValueError(f"composite_mip: {name} takes no gradient "
                             f"(detach it)")
    return _CompositeMip.apply(float(bg), bool(opaque_background), *args)


# kernel E' against autograd of the plain version (ops.kernels.compare):
# 1e-4 relative and 1e-5 * max|ref|. The kernel sums the transmittance's
# exponent and the reverse sum R_i in warp-scan order (torch.cumsum runs
# in sequence), and d density = delta (g e T - R) cancels where the two
# terms meet.
MIP_BACKWARD_TOL = dict(rtol=1e-4, atol_frac=1e-5)
