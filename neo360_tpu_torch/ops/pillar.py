"""Softmax pillar collapse of the tri-planar encoder (kernel C,
csrc/pillar_collapse.cu), replacing the softmaxes and contractions of
neo360_tpu/nn/triplane.py:268-294."""

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


def pillar_collapse(latent: torch.Tensor, logit_yz: torch.Tensor,
                    logit_xz: torch.Tensor, logit_xy: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """(floor_yz, floor_xz, floor_xy): the softmax-weighted sums of the
    latent over X, Y and Z.

    CPU tensors run `pillar_collapse_reference`; CUDA tensors launch
    kernel C once for all three floors and add one to
    `pillar_collapse.launches`."""
    args = (latent, logit_yz, logit_xz, logit_xy)
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
    outs = tuple(torch.empty(shape, dtype=latent.dtype, device=latent.device)
                 for shape in ((nv, y, z, c), (nv, x, z, c), (nv, x, y, c)))
    kernels.launch("pillar_collapse_fwd", latent.device,
                   *(a.data_ptr() for a in args),
                   *(o.data_ptr() for o in outs),
                   kernels.DTYPE_CODES[latent.dtype], nv, x, y, z, c)
    pillar_collapse.launches += 1
    return outs


pillar_collapse.launches = 0
