"""Layers with Flax semantics: float32 parameters cast to the compute dtype
at every call (as flax.linen Dense/Conv with `dtype=`), initialisers of the
same distributions drawn from an explicit `torch.Generator`, and a
BatchNorm whose statistics mode is chosen per call.

Parameter names follow `weights.from_flax_flat`: Dense/Conv `weight`
(out, in[, kh, kw]) and `bias`; BatchNorm `weight`, `bias` and the buffers
`running_mean`, `running_var`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# jax.nn.initializers.truncated_normal draws from [-2, 2] and divides the
# standard deviation by this constant so the truncated law keeps it
_TRUNC_STD = 0.87962566103423978


def init_weight(w: torch.Tensor, kind: str, fan_in: int, fan_out: int,
                generator: Optional[torch.Generator]) -> None:
    """In place: "xavier" (uniform), "kaiming" (he_normal),
    "kaiming_uniform" (he_uniform) or "lecun" (lecun_normal), as
    flax.linen.initializers."""
    with torch.no_grad():
        if kind in ("xavier", "kaiming_uniform"):
            a = math.sqrt(6.0 / (fan_in + fan_out) if kind == "xavier"
                          else 6.0 / fan_in)
            w.uniform_(-a, a, generator=generator)
            return
        scale = {"kaiming": 2.0, "lecun": 1.0}[kind]
        std = math.sqrt(scale / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_bias(b: torch.Tensor, kind: str,
              generator: Optional[torch.Generator]) -> None:
    """In place: "zeros" or "small" (U(-1e-3, 1e-3), the triplane init)."""
    with torch.no_grad():
        if kind == "zeros":
            b.zero_()
        else:
            b.uniform_(-1e-3, 1e-3, generator=generator)


class Dense(nn.Module):
    """flax.linen.Dense on the last axis."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype=torch.float32,
                 kernel_init: str = "lecun", bias_init: str = "zeros",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        init_weight(self.weight, kernel_init, in_features, out_features,
                    generator)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_features))
            init_bias(self.bias, bias_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv(nn.Module):
    """flax.linen.Conv with symmetric explicit padding, on NCHW tensors."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 dtype=torch.float32, kernel_init: str = "lecun",
                 bias_init: str = "zeros",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        fan_in = in_ch * kernel * kernel
        init_weight(self.weight, kernel_init, fan_in, out_ch * kernel * kernel,
                    generator)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_ch))
            init_bias(self.bias, bias_init, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm (eps 1e-5, momentum 0.9) over the channel axis 1
    of NCHW.

    Three modes:
    - eval, `batch_stats=False`: the stored running statistics;
    - eval, `batch_stats=True`: the batch's own biased statistics,
      E[x^2] - E[x]^2 in f32 as Flax computes them, running statistics
      untouched (the few-shot eval "batch" mode);
    - training (`module.train()`): batch statistics whatever `batch_stats`
      says, as flax `train=True`, and the Flax update of this batch,
      `momentum * running + (1 - momentum) * batch` with the biased
      variance, is appended to `pending`. `commit_running_stats` writes the
      mean of the pending updates into the buffers, so several batches
      encoded with the same statistics (one per scene) update them as the
      JAX trainer's mean over scenes does. Output is in the compute dtype.
    """

    def __init__(self, features: int, dtype=torch.float32, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.dtype, self.eps, self.momentum = dtype, eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.pending = []

    def forward(self, x: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        x = x.float()
        if batch_stats or self.training:
            dims = (0, 2, 3)
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        else:
            mean, var = self.running_mean, self.running_var
        if self.training:
            m = self.momentum
            self.pending.append(
                (m * self.running_mean + (1 - m) * mean.detach(),
                 m * self.running_var + (1 - m) * var.detach()))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


def commit_running_stats(module: nn.Module) -> int:
    """Set every BatchNorm's running statistics under `module` to the mean
    of its pending training-mode updates and clear them. Returns the number
    of layers updated."""
    n = 0
    for bn in module.modules():
        if isinstance(bn, BatchNorm) and bn.pending:
            means, vars_ = zip(*bn.pending)
            with torch.no_grad():
                bn.running_mean.copy_(torch.stack(means).mean(0))
                bn.running_var.copy_(torch.stack(vars_).mean(0))
            bn.pending.clear()
            n += 1
    return n
