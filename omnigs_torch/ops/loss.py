"""Training losses and image metrics.

Counterpart of `omnigs_tpu/ops/loss.py`: L1, two PSNR variants and SSIM
with an 11×11 σ = 1.5 Gaussian window over (C, H, W) float32 images
(float64 ones for a reference step), zero-padded at the border. The separable window runs as two banded matrix
products per image (B_v · img · B_h), like the JAX package, through
`torch.matmul`, which on the card is full float32 (the package switches
TF32 off; a cuDNN convolution would be TF32 by default).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean-over-pixels PSNR."""
    mse = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10(1.0 / mse)


def psnr_gaussian_splatting(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """3DGS-style PSNR: per-channel MSE, then the mean of the per-channel
    20·log10(1/√mse)."""
    mse = torch.mean((img1 - img2) ** 2, dim=(-2, -1))
    return torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(mse)))


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _band_matrix_np(n: int, window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(n, n) banded Gaussian B with B[i, j] = g(j − i): B @ x is the 1-D
    zero-padded SAME Gaussian conv along an axis of length n."""
    g = _gaussian_1d(window_size, sigma)
    h = window_size // 2
    B = np.zeros((n, n), np.float32)
    for d in range(-h, h + 1):
        idx = np.arange(max(0, -d), min(n, n - d))
        B[idx, idx + d] = g[d + h]
    return B


# device copies of the band matrices, one upload per (n, window, device,
# dtype); a float64 image gets the float32 window widened
_BANDS: Dict[Tuple[int, int, str, torch.dtype], torch.Tensor] = {}


def _band_matrix(n: int, window_size: int, device, dtype) -> torch.Tensor:
    key = (n, window_size, str(device), dtype)
    if key not in _BANDS:
        _BANDS[key] = torch.from_numpy(_band_matrix_np(n, window_size)).to(device, dtype)
    return _BANDS[key]


def _depthwise_conv(img: torch.Tensor, window_size: int) -> torch.Tensor:
    """(C, H, W) ⊛ Gaussian (k, k) with zero SAME padding, as B_v · img · B_h
    (the window is the outer product g·gᵀ, so the conv separates)."""
    _, H, W = img.shape
    Bv = _band_matrix(H, window_size, img.device, img.dtype)
    Bh = _band_matrix(W, window_size, img.device, img.dtype)
    return torch.matmul(torch.matmul(Bv, img), Bh)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    size_average: bool = True,
) -> torch.Tensor:
    """Differentiable SSIM of two (C, H, W) images (zero-padded border)."""
    mu1 = _depthwise_conv(img1, window_size)
    mu2 = _depthwise_conv(img2, window_size)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _depthwise_conv(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _depthwise_conv(img2 * img2, window_size) - mu2_sq
    sigma12 = _depthwise_conv(img1 * img2, window_size) - mu1_mu2
    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean() if size_average else ssim_map


def training_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    lambda_dssim: float = 0.2,
) -> torch.Tensor:
    """(1-λ)·L1 + λ·(1−SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt)
    )
