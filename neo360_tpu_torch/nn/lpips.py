"""LPIPS, the VGG16 perceptual distance, in plain torch (port of
neo360_tpu/nn/lpips.py): the stage-2 finetune's loss term and an eval
metric.

Inputs in [-1, 1] are normalized by the LPIPS shift and scale, run
through VGG16's convolutions (`F.conv2d`: no kernel of the JAX package
computes them either), tapped after relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3; each tap is divided by its channel norm, the squared
difference is weighted by max(lin_i, 0) per channel, summed over the
channels, averaged over the pixels, and summed over the taps.

Weights load from a torch state dict in the combined layout (torchvision
VGG16 `features.{idx}.weight/bias` plus lpips `lin{i}.model.1.weight`) or
from the `.npz` that scripts/convert_weights.py writes (Flax HWIO
kernels, converted by `weights.lpips_from_flax_flat`). Without weights the
model has random ones and `pretrained` is False: the distance then means
nothing, and callers skip it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.nn.layers import Conv

# LPIPS input scaling constants (the lpips package's scaling layer)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# VGG16: convolutions per block and their channels
VGG_CFG = (2, 2, 3, 3, 3)
CHANNELS = (64, 128, 256, 512, 512)


def vgg_layers() -> Iterator[Tuple[str, int, int, int]]:
    """(module name, torchvision `features` index, in, out channels) of
    each convolution."""
    idx, in_ch = 0, 3
    for b, (n_convs, ch) in enumerate(zip(VGG_CFG, CHANNELS)):
        for i in range(n_convs):
            yield f"conv{b}_{i}", idx, in_ch, ch
            in_ch = ch
            idx += 2          # conv + relu
        idx += 1              # max pool


class VGG16Features(nn.Module):
    """VGG16's convolutions; forward returns the 5 post-relu taps."""

    def __init__(self):
        super().__init__()
        for name, _, in_ch, ch in vgg_layers():
            self.add_module(name, Conv(in_ch, ch, 3, 1, 1))

    def forward(self, x: torch.Tensor):
        taps = []
        for b, n_convs in enumerate(VGG_CFG):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"conv{b}_{i}")(x))
            taps.append(x)
            if b < len(VGG_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


class LPIPSModel(nn.Module):
    """LPIPS distance of (B, H, W, 3) images in [0, 1]; `weights_path` a
    torch state dict or a converter npz. A path that does not exist leaves
    random weights and `pretrained` False, as the JAX model does."""

    def __init__(self, weights_path: Optional[str] = None):
        super().__init__()
        self.vgg = VGG16Features()
        for i, ch in enumerate(CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("shift", torch.tensor(SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE), persistent=False)
        self.requires_grad_(False)
        self.pretrained = False
        if weights_path is not None and os.path.exists(weights_path):
            self.load_state_dict(load_weights(weights_path))
            self.pretrained = True

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y (B, H, W, 3) in [0, 1] -> (B,) distances, float32."""
        fx, fy = (self.vgg(((2 * t.float() - 1 - self.shift) / self.scale)
                           .permute(0, 3, 1, 2)) for t in (x, y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt(torch.sum(a * a, 1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, 1, keepdim=True) + 1e-10)
            w = torch.clamp(getattr(self, f"lin{i}"), min=0.0)
            total = total + torch.mean(torch.sum(
                (a - b) ** 2 * w[:, None, None], 1), dim=(-2, -1))
        return total


def from_torch_layout(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The combined torch checkpoint (torchvision `features.{idx}` and
    lpips `lin{i}.model.1.weight`) -> LPIPSModel's parameters. Raises on
    a missing key."""
    out = {}
    for name, idx, _, _ in vgg_layers():
        for leaf in ("weight", "bias"):
            out[f"vgg.{name}.{leaf}"] = sd[f"features.{idx}.{leaf}"].float()
    for i in range(len(CHANNELS)):
        out[f"lin{i}"] = sd[f"lin{i}.model.1.weight"].float().reshape(-1)
    return out


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """LPIPSModel's parameters from a torch checkpoint or a converter
    npz."""
    from neo360_tpu_torch import weights
    if path.endswith(".npz"):
        return weights.lpips_from_flax_flat(weights.load_variables_npz(path))
    return from_torch_layout(torch.load(path, map_location="cpu",
                                        weights_only=True))


def random_torch_state(seed: int) -> Dict[str, torch.Tensor]:
    """Random weights in the combined torch layout, drawn from a seeded
    numpy Generator: He-normal convolution kernels, small biases and
    non-negative lin weights. For tests and smoke runs, which have no
    pretrained weights; the distance they give means nothing."""
    rng = np.random.default_rng(seed)
    sd = {}
    for _, idx, in_ch, ch in vgg_layers():
        std = np.sqrt(2.0 / (9 * in_ch))
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((ch, in_ch, 3, 3)) * std).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.standard_normal(ch) * 0.01).astype(np.float32))
    for i, ch in enumerate(CHANNELS):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(np.abs(
            rng.standard_normal((1, ch, 1, 1)) / ch).astype(np.float32))
    return sd
