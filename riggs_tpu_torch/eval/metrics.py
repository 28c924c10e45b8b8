"""Image quality metrics: PSNR, SSIM, MS-SSIM.

Port of ``riggs_tpu/eval/metrics.py``: ``_avg_pool2``, ``_ssim_cs``,
``ms_ssim`` (the standard 5-scale MS-SSIM) and ``evaluate_image``, on the
port's ``psnr`` and ``ssim`` (``train/losses.py``). Images are (H, W, C) or
(B, H, W, C). The variance clamp is ``torch.maximum``, as in ``ssim``. LPIPS
(``LpipsModel``) is not ported yet.
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.device import constant
from riggs_tpu_torch.train.losses import _depthwise_conv_same, psnr, ssim

__all__ = ["psnr", "ssim", "ms_ssim", "evaluate_image"]

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2 (NHWC); an odd last row or column is dropped."""
    b, h, w, c = img.shape
    img = img[:, : h // 2 * 2, : w // 2 * 2]
    return img.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def _ssim_cs(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11):
    """(mean SSIM, mean contrast-structure term) of NHWC images."""
    mu1 = _depthwise_conv_same(img1, window_size)
    mu2 = _depthwise_conv_same(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    zero = img1.new_zeros(())
    s1 = torch.maximum(_depthwise_conv_same(img1 * img1, window_size) - mu1_sq, zero)
    s2 = torch.maximum(_depthwise_conv_same(img2 * img2, window_size) - mu2_sq, zero)
    s12 = _depthwise_conv_same(img1 * img2, window_size) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    ssim_map = ((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs
    return torch.mean(ssim_map), torch.mean(cs)


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Multi-scale SSIM over 5 dyadic scales: the contrast-structure terms
    of the first four, the SSIM of the last, each floored at 1e-6 and raised
    to its weight."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    vals = []
    n = len(_MSSSIM_WEIGHTS)
    for i in range(n):
        s, cs = _ssim_cs(img1, img2, window_size)
        vals.append(s if i == n - 1 else cs)
        if i < n - 1:
            img1, img2 = _avg_pool2(img1), _avg_pool2(img2)
    vals = torch.stack(vals)
    weights = constant(_MSSSIM_WEIGHTS, vals)
    return torch.prod(torch.maximum(vals, constant(1e-6, vals)) ** weights)


def evaluate_image(img: torch.Tensor, gt: torch.Tensor, lpips_model=None) -> dict:
    """The metric bundle of one image pair: psnr, ssim, ms_ssim (host
    floats, one read of the three)."""
    if lpips_model is not None:
        raise NotImplementedError("LPIPS is not ported yet (ROADMAP A7)")
    with torch.no_grad():
        vals = torch.stack([psnr(img, gt), ssim(img, gt), ms_ssim(img, gt)]).tolist()
    return dict(zip(("psnr", "ssim", "ms_ssim"), vals))
