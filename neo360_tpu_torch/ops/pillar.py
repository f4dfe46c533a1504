"""Softmax pillar collapse of the tri-planar encoder (kernel C,
csrc/pillar_collapse.cu), replacing the softmaxes and contractions of
neo360_tpu/nn/triplane.py:268-294. With autograd on it runs as a
`torch.autograd.Function` whose backward is kernel C'
(csrc/pillar_collapse_bwd.cu) on CUDA and autograd of the plain version on
the CPU."""

from __future__ import annotations

from typing import Tuple

import torch

from neo360_tpu_torch.ops import kernels


def pillar_collapse_reference(latent: torch.Tensor, logit_yz: torch.Tensor,
                              logit_xz: torch.Tensor, logit_xy: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel C. latent (NV,X,Y,Z,C); logits
    (NV,X,Y,Z). Softmax in f32, weights rounded to the latent's dtype, f32
    sums, outputs in the latent's dtype: floors (NV,Y,Z,C), (NV,X,Z,C),
    (NV,X,Y,C).

    The softmax is exp(l - max) / sum with the sum taken in axis order,
    as the kernel takes it, so both round the same float32 weights to
    bf16: a weight one float32 ulp apart could round to the neighbouring
    bf16 value and move an output by more than one bf16 ulp."""
    def weights(logit, axis):
        lg = logit.float()
        e = torch.exp(lg - lg.amax(axis, keepdim=True))
        total = torch.zeros_like(e.narrow(axis, 0, 1))
        for i in range(e.shape[axis]):
            total = total + e.narrow(axis, i, 1)
        return (e / total).to(latent.dtype).float()

    lat = latent.float()
    floor_yz = torch.einsum("nxyz,nxyzc->nyzc", weights(logit_yz, 1), lat)
    floor_xz = torch.einsum("nxyz,nxyzc->nxzc", weights(logit_xz, 2), lat)
    floor_xy = torch.einsum("nxyz,nxyzc->nxyc", weights(logit_xy, 3), lat)
    return tuple(f.to(latent.dtype) for f in (floor_yz, floor_xz, floor_xy))


def _pillar_forward(args):
    if all(a.device.type == "cpu" for a in args):
        return pillar_collapse_reference(*args)
    name = "pillar_collapse"
    args = tuple(a.contiguous() for a in args)
    kernels.require_cuda(name, *args)
    latent = args[0]
    nv, x, y, z, c = latent.shape
    for logit in args[1:]:
        if tuple(logit.shape) != (nv, x, y, z) or logit.dtype != latent.dtype:
            raise ValueError(f"{name}: logits must be {latent.dtype} "
                             f"{(nv, x, y, z)}, got {logit.dtype} "
                             f"{tuple(logit.shape)}")
    if latent.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"{name}: dtype must be float32 or bfloat16")
    # each thread of the one pass holds up to 64 y and 64 z values of a
    # channel vector (csrc/pillar_collapse.cu)
    if min(nv, x, y, z) < 1 or y > 64 or z > 64 or c < 4 or c % 4:
        raise ValueError(f"{name}: needs 1 <= Y <= 64, 1 <= Z <= 64 and C a "
                         f"positive multiple of 4, got latent "
                         f"{tuple(latent.shape)}")
    # the latent is read as 16- or 8-byte vectors; the scratch holds each
    # cell's three rounded softmax weights (and one word of padding)
    args = (kernels.dense(latent),) + args[1:]
    outs = tuple(torch.empty(shape, dtype=latent.dtype, device=latent.device)
                 for shape in ((nv, y, z, c), (nv, x, z, c), (nv, x, y, c)))
    scratch = torch.empty((nv * x * y * z, 4), dtype=latent.dtype,
                          device=latent.device)
    kernels.launch("pillar_collapse_fwd", latent.device,
                   *(a.data_ptr() for a in args),
                   *(o.data_ptr() for o in outs), scratch.data_ptr(),
                   kernels.DTYPE_CODES[latent.dtype], nv, x, y, z, c)
    pillar_collapse.launches += 1
    return outs


def pillar_collapse_backward(args, grads) -> Tuple[torch.Tensor, ...]:
    """Gradients (d latent, d logit_yz, d logit_xz, d logit_xy) of
    `pillar_collapse` at inputs `args` = (latent, logit_yz, logit_xz,
    logit_xy) for the floor cotangents `grads` (None = zero).

    CPU tensors: autograd of `pillar_collapse_reference`. CUDA tensors
    launch kernel C' (csrc/pillar_collapse_bwd.cu) and add one to
    `pillar_collapse_backward.launches`."""
    latent = args[0]
    nv, x, y, z, c = latent.shape
    shapes = ((nv, y, z, c), (nv, x, z, c), (nv, x, y, c))
    grads = tuple(torch.zeros(s, dtype=latent.dtype, device=latent.device)
                  if g is None else g for g, s in zip(grads, shapes))
    if all(a.device.type == "cpu" for a in args):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() for a in args]
            outs = pillar_collapse_reference(*leaves)
            return torch.autograd.grad(outs, leaves, grads)
    name = "pillar_collapse_backward"
    args = tuple(a.contiguous() for a in args)
    grads = tuple(g.contiguous() for g in grads)
    kernels.require_cuda(name, *args, *grads)
    for t in args[1:] + grads:
        if t.dtype != latent.dtype:
            raise ValueError(f"{name}: logits and cotangents must be "
                             f"{latent.dtype}")
    for g, shape in zip(grads, shapes):
        if tuple(g.shape) != shape:
            raise ValueError(f"{name}: cotangent {tuple(g.shape)}, expected "
                             f"{shape}")
    if latent.dtype not in kernels.DTYPE_CODES or c % 4 or max(x, y, z) > 256:
        raise ValueError(f"{name}: needs float32 or bfloat16, C % 4 == 0 "
                         f"and grid axes <= 256, got {latent.dtype} "
                         f"{tuple(latent.shape)}")
    # the latent, cotangents and d latent are read and written as 16-byte
    # vectors; the scratch holds the f32 softmax weights and the rounded
    # weight cotangents of the three floors
    args = (kernels.dense(latent),) + args[1:]
    grads = tuple(kernels.dense(g) for g in grads)
    d = tuple(torch.empty_like(a) for a in args)
    scratch = torch.empty((6, nv, x, y, z), dtype=torch.float32,
                          device=latent.device)
    kernels.launch("pillar_collapse_bwd", latent.device,
                   *(a.data_ptr() for a in args),
                   *(g.data_ptr() for g in grads),
                   *(t.data_ptr() for t in d), scratch.data_ptr(),
                   kernels.DTYPE_CODES[latent.dtype], nv, x, y, z, c)
    pillar_collapse_backward.launches += 1
    return d


class _PillarCollapse(torch.autograd.Function):
    """pillar_collapse with the gradient of `pillar_collapse_backward`."""

    @staticmethod
    def forward(ctx, *args):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*args)
        return _pillar_forward(args)

    @staticmethod
    def backward(ctx, *grads):
        return pillar_collapse_backward(ctx.saved_tensors, grads)


def pillar_collapse(latent: torch.Tensor, logit_yz: torch.Tensor,
                    logit_xz: torch.Tensor, logit_xy: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """(floor_yz, floor_xz, floor_xy): the softmax-weighted sums of the
    latent over X, Y and Z.

    CPU tensors run `pillar_collapse_reference`; CUDA tensors launch
    kernel C once for all three floors and add one to
    `pillar_collapse.launches`. With grad enabled the call is a
    `_PillarCollapse` autograd Function."""
    args = (latent, logit_yz, logit_xz, logit_xy)
    if not torch.is_grad_enabled():
        return _pillar_forward(args)
    return _PillarCollapse.apply(*args)


pillar_collapse.launches = 0
pillar_collapse_backward.launches = 0

# kernel C' against autograd of the plain version (ops.kernels.compare).
# d latent: the forward's tolerance (three products summed in f32, rounded
# once). d logit, f32: 1e-4 relative plus 1e-5 * max|ref|; bf16: one ulp
# plus 2^-7 * max|ref|: dw is a C-term f32 dot product summed in another order than
# the plain einsum's, and in bf16 it is rounded before the softmax
# gradient, so an order difference can move a rounded dw by one bf16 ulp
# (2^-8 relative), which the cancelling w * (dw - sum w dw) carries into d
# logit at up to w * ulp(dw).
BACKWARD_TOL = {"latent": dict(),
                "logit": {torch.float32: dict(rtol=1e-4, atol_frac=1e-5),
                          torch.bfloat16: dict(atol_frac=2.0 ** -7)}}
