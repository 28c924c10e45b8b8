"""Photometric losses and image metrics.

Port of ``riggs_tpu/train/losses.py``: l1, l2, PSNR, the 11x11 Gaussian-window
SSIM with zero ('same') padding and its variance clamp, the 3DGS
photometric objective and the sparsity term ``kl_divergence``. SSIM's separable blur is two banded-matrix products,
as in the reference; the port keeps that form so that both compute the same
zero-padded convolution in the same order. The variance clamp uses
``torch.maximum``, which splits a tie's gradient as ``jnp.maximum`` does
(``torch.clamp`` would pass it whole), and the L1 term's absolute value
takes ``jnp.abs``'s gradient at 0; matmuls run in full f32 (TF32 off,
``riggs_tpu_torch.device``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from riggs_tpu_torch.device import constant


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient, +1 at 0 (``torch.abs`` gives 0 there:
    a rendered background pixel equal to the target's would lose its
    share)."""
    return torch.where(x >= 0, x, -x)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(abs_jax(x - y))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR with per-image MSE (the reference's view-flattened mean)."""
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.maximum(mse, constant(1e-12, mse))))


@lru_cache(maxsize=8)
def _band_matrix(n: int, window_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """(n, n) banded matrix of the 1D Gaussian with zero padding: row i holds
    g[j - i + r] for |j - i| <= r."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    r = window_size // 2
    T = np.zeros((n, n), np.float32)
    for o in range(-r, r + 1):
        if abs(o) >= n:
            continue
        T += np.diag(np.full(n - abs(o), g[o + r], np.float32), k=o)
    # made and copied to the device once per shape: a copy per call would
    # block the host until the stream drains
    with torch.inference_mode(False):
        return torch.as_tensor(T, device=device)


def _depthwise_conv_same(img: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """img (B, H, W, C) -> zero-padded Gaussian blur, as two band products."""
    h, w = img.shape[1], img.shape[2]
    Th = _band_matrix(h, window_size, sigma, img.device)
    Tw = _band_matrix(w, window_size, sigma, img.device)
    out = torch.einsum("hH,bHwc->bhwc", Th, img)
    return torch.einsum("wW,bhWc->bhwc", Tw, out)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Windowed SSIM, averaged. (H, W, C) or (B, H, W, C) in [0, 1]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1 = _depthwise_conv_same(img1, window_size)
    mu2 = _depthwise_conv_same(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    zero = img1.new_zeros(())
    # E[x^2] - mu^2 cancels in f32 on HDR transients; the clamp at 0 is exact
    # in exact arithmetic and inert on in-range images
    s1 = torch.maximum(_depthwise_conv_same(img1 * img1, window_size) - mu1_sq, zero)
    s2 = torch.maximum(_depthwise_conv_same(img2 * img2, window_size) - mu2_sq, zero)
    s12 = _depthwise_conv_same(img1 * img2, window_size) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(ssim_map)


def photometric_loss(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """The 3DGS objective: (1 - l) * L1 + l * (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(img, gt) + lambda_dssim * (1.0 - ssim(img, gt))


def kl_divergence(rho: float, rho_hat_logits: torch.Tensor) -> torch.Tensor:
    """The sparsity KL term: the mean over columns of KL(rho || rho_hat),
    rho_hat the column means of sigmoid(logits), both logs guarded by 1e-5."""
    rho_hat = torch.mean(torch.sigmoid(rho_hat_logits), dim=0)
    rho = torch.full_like(rho_hat, rho)
    return torch.mean(rho * torch.log(rho / (rho_hat + 1e-5))
                      + (1.0 - rho) * torch.log((1.0 - rho) / (1.0 - rho_hat + 1e-5)))
