"""ResNet-34 feature pyramid + pixel-aligned SpatialEncoder (port of
neo360_tpu/nn/resnet.py:36-112), in plain torch (no torchvision).

conv1 7x7/2 -> bn -> relu (latent[0], H/2); maxpool 3x3/2 -> layer1 (H/4);
layer2 (H/8); layer3 (H/16). All four levels are resized (align_corners)
to latent[0]'s size and concatenated in that order -> 512 channels.
Convolutions run NCHW; SpatialEncoder takes and returns NHWC.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from neo360_tpu_torch.nn.layers import BatchNorm, Conv


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = lambda i, o, k, s, p: Conv(i, o, k, s, p, use_bias=False,
                                          dtype=dtype, generator=generator)
        self.conv1 = conv(in_ch, features, 3, stride, 1)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = conv(features, features, 3, 1, 1)
        self.bn2 = BatchNorm(features, dtype)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_ch != features:
            self.downsample_conv = conv(in_ch, features, 1, stride, 0)
            self.downsample_bn = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), batch_stats))
        y = self.bn2(self.conv2(y), batch_stats)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), batch_stats)
        return F.relu(y + residual)


class ResNet34Features(nn.Module):
    """conv1..layer3 feature pyramid on NCHW input."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6),
                 stage_features: Sequence[int] = (64, 128, 256),
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, use_bias=False, dtype=dtype,
                          generator=generator)
        self.bn1 = BatchNorm(64, dtype)
        self.stages = []
        in_ch = 64
        for stage, (blocks, width) in enumerate(zip(stage_sizes,
                                                    stage_features)):
            names = []
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, BasicBlock(in_ch, width, stride, dtype,
                                                 generator))
                names.append(name)
                in_ch = width
            self.stages.append(names)

    def forward(self, x: torch.Tensor, batch_stats: bool) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x), batch_stats))
        feats = [x]
        # padding with -inf, as flax's max_pool
        x = F.max_pool2d(x, 3, 2, 1)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, batch_stats)
            feats.append(x)
        return feats


class SpatialEncoder(nn.Module):
    """Pixel-aligned 512-channel latent at half the input resolution."""

    def __init__(self, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet34Features(dtype=dtype, generator=generator)

    def forward(self, images: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> (B, H/2, W/2, 512)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        feats = self.backbone(x, batch_stats)
        size = feats[0].shape[-2:]
        up = [f if f.shape[-2:] == size else
              F.interpolate(f, size=size, mode="bilinear", align_corners=True)
              for f in feats]
        return torch.cat(up, dim=1).permute(0, 2, 3, 1)


def latent_scaling(latent_hw, device=None) -> torch.Tensor:
    """(w, h) scaling of pixel uv to normalized grid coordinates:
    s = 2 L / (L - 1)."""
    h, w = latent_hw
    s = torch.tensor([w, h], dtype=torch.float32, device=device)
    return s / (s - 1.0) * 2.0


def from_torchvision(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision resnet34 state dict -> `ResNet34Features` names
    (`layer1.0.conv1` -> `layer1_0.conv1`, `downsample.0` / `.1` ->
    `downsample_conv` / `downsample_bn`); layer4, fc and the BatchNorms'
    `num_batches_tracked` have no counterpart and are dropped. Flax
    BatchNorm's momentum 0.9 is torch's 0.1, so the running statistics
    carry over as they are."""
    out = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked") or not re.match(
                r"(conv1|bn1|layer[123])\.", key):
            continue
        key = re.sub(r"^(layer\d)\.(\d+)\.", r"\1_\2.", key)
        key = key.replace("downsample.0.", "downsample_conv.").replace(
            "downsample.1.", "downsample_bn.")
        out[key] = value.float()
    return out


def load_pretrained(path: str) -> Dict[str, torch.Tensor]:
    """Backbone weights for `ResNet34Features` (neo360_tpu/nn/resnet.py:
    136-201) from a torchvision resnet34 state dict or the `.npz` that
    scripts/convert_weights.py writes (Flax names and layouts, converted
    by `weights.from_flax_flat`), keyed by the backbone's own names.
    Raises when `path` does not exist."""
    from neo360_tpu_torch import weights
    if not os.path.exists(path):
        raise FileNotFoundError(f"resnet weights {path}: no such file")
    if path.endswith(".npz"):
        return weights.from_flax_flat(weights.load_variables_npz(path))
    return from_torchvision(torch.load(path, map_location="cpu",
                                       weights_only=True))
