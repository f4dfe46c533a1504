"""PSNR and SSIM (port of neo360_tpu/train/metrics.py).

SSIM: 11x11 Gaussian window (sigma 1.5), k1 0.01, k2 0.03, valid
filtering. The separable filter is a weighted sum of shifted slices in
float32, so no convolution library (and no TF32 rounding, which can flip
the sign of mu_xx - mu_x^2) is involved on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse) over all elements."""
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log(mse) / np.log(10.0)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _filter_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    n = x.shape[axis] - len(k) + 1
    out = float(k[0]) * x.narrow(axis, 0, n)
    for i in range(1, len(k)):
        out = out + float(k[i]) * x.narrow(axis, i, n)
    return out


def _filter2d_separable(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Valid separable filter of (H, W, C) with the 1-D kernel k."""
    return _filter_axis(_filter_axis(img, k, 0), k, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images in [0, max_val]."""
    pred, target = pred.float(), target.float()
    k = _gaussian_kernel(kernel_size, sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu_x = _filter2d_separable(pred, k)
    mu_y = _filter2d_separable(target, k)
    mu_xx = _filter2d_separable(pred * pred, k)
    mu_yy = _filter2d_separable(target * target, k)
    mu_xy = _filter2d_separable(pred * target, k)

    var_x = mu_xx - mu_x ** 2
    var_y = mu_yy - mu_y ** 2
    cov = mu_xy - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return torch.mean(num / den)
