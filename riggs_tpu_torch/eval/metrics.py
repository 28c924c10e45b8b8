"""Image quality metrics: PSNR, SSIM, MS-SSIM, LPIPS.

Port of ``riggs_tpu/eval/metrics.py``: ``_avg_pool2``, ``_ssim_cs``,
``ms_ssim`` (the standard 5-scale MS-SSIM), ``LpipsModel`` and
``evaluate_image``, on the port's ``psnr`` and ``ssim``
(``train/losses.py``). Images are (H, W, C) or (B, H, W, C). The variance
clamp is ``torch.maximum``, as in ``ssim``.

LPIPS computes what ``riggs_tpu`` computes: the AlexNet or VGG16 feature
stack (stock ``torch.nn.functional`` convolutions and pools, as the
reference's are stock XLA ops), unit-normalized along channels, squared
differences weighted by the learned 1x1 heads, a mean over (H, W) and a sum
over the five taps, then a mean over the batch. Its AlexNet pools 2x2 with
stride 2, where torchvision's (the published metric's backbone) pools 3x3
(ROADMAP C3). Weights come from torch files in the real on-disk layout
(``scripts/make_lpips_ckpt.py`` writes seeded ones); nothing is fetched.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F

from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.train.losses import _depthwise_conv_same, psnr, ssim

__all__ = ["psnr", "ssim", "ms_ssim", "LpipsModel", "evaluate_image"]

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


_IMAGENET_SHIFT = (-0.030, -0.088, -0.188)
_IMAGENET_SCALE = (0.458, 0.448, 0.450)

# (out_channels, kernel, stride, pad) per conv; "M" = 2x2 max pool, stride 2
_ALEX_CFG = [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_TAPS = [0, 1, 2, 3, 4]  # conv indices whose relu output feeds LPIPS
_VGG_CFG = [
    (64, 3, 1, 1), (64, 3, 1, 1), "M",
    (128, 3, 1, 1), (128, 3, 1, 1), "M",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
]
_VGG_TAPS = [1, 3, 6, 9, 12]


def _cfg(net: str):
    if net not in ("alex", "vgg"):
        raise ValueError(f"LPIPS net {net!r}: alex or vgg")
    return (_ALEX_CFG, _ALEX_TAPS) if net == "alex" else (_VGG_CFG, _VGG_TAPS)


@dataclasses.dataclass
class LpipsModel:
    """The perceptual metric: conv kernels and linear heads in torch's
    layouts, on one device."""

    net: str  # "alex" | "vgg"
    convs: list  # [{"w": (cout, cin, k, k), "b": (cout,)}]
    lins: list  # [(1, c, 1, 1)] per tap

    @classmethod
    def random_init(cls, generator: torch.Generator, net: str = "alex",
                    device: str | torch.device | None = None) -> "LpipsModel":
        """Untrained weights drawn from ``generator`` (on ``device``), for
        shape tests: JAX's PRNG draws cannot be repeated, so parity with the
        reference goes through ``from_torch_state_dicts``."""
        dev = resolve_device(device)
        cfg, taps = _cfg(net)
        convs, channels, cin = [], [], 3
        for item in cfg:
            if item == "M":
                continue
            cout, k, _, _ = item
            w = torch.randn((cout, cin, k, k), generator=generator, device=dev) / np.sqrt(k * k * cin)
            convs.append({"w": w, "b": torch.zeros(cout, device=dev)})
            channels.append(cout)
            cin = cout
        lins = [torch.randn((1, channels[t], 1, 1), generator=generator, device=dev).abs() * 0.01 for t in taps]
        return cls(net=net, convs=convs, lins=lins)

    @classmethod
    def from_torch_state_dicts(cls, sd: dict, lsd: dict, net: str = "alex",
                               device: str | torch.device | None = None) -> "LpipsModel":
        """From a torchvision backbone state dict and the lpips package's
        linear heads, matched by layer name, not dict order: backbone convs
        ``[features.]<i>.weight`` (4-D) ordered by ``i``, heads
        ``lin<i>[.model.<j>].weight`` ordered by ``i``."""
        dev = resolve_device(device)
        cfg, taps = _cfg(net)
        to = lambda v: torch.as_tensor(v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v),
                                       dtype=torch.float32).to(dev)
        n_convs = sum(1 for c in cfg if c != "M")
        conv_items = sorted((int(m.group(1)), k) for k, v in sd.items()
                            if (m := re.match(r"^(?:features\.)?(\d+)\.weight$", k)) and v.ndim == 4)
        if len(conv_items) < n_convs:
            raise ValueError(f"backbone state dict has {len(conv_items)} conv layers, need {n_convs}")
        convs = [{"w": to(sd[k]), "b": to(sd[k[: -len("weight")] + "bias"])} for _, k in conv_items[:n_convs]]
        lin_items = sorted((int(m.group(1)), k) for k, v in lsd.items()
                           if (m := re.match(r"^lin(\d+)\b", k)) and v.ndim == 4)
        lins = [to(lsd[k]) for _, k in lin_items]
        if len(lins) != len(taps):
            raise ValueError(f"expected {len(taps)} linear heads, got {len(lins)}")
        return cls(net=net, convs=convs, lins=lins)

    @classmethod
    def from_torch_file(cls, backbone_path: str, lpips_path: str, net: str = "alex",
                        device: str | torch.device | None = None) -> "LpipsModel":
        """From a torchvision backbone file and an lpips linear-head file."""
        sd = torch.load(backbone_path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        lsd = torch.load(lpips_path, map_location="cpu")
        return cls.from_torch_state_dicts(sd, lsd, net=net, device=device)

    def _features(self, img: torch.Tensor) -> list[torch.Tensor]:
        """(B, H, W, 3) in [0, 1] -> the tapped relu maps, NCHW."""
        x = img.permute(0, 3, 1, 2)
        shift = constant(_IMAGENET_SHIFT, x).view(1, 3, 1, 1)
        scale = constant(_IMAGENET_SCALE, x).view(1, 3, 1, 1)
        x = (2.0 * x - 1.0 - shift) / scale
        cfg, taps = _cfg(self.net)
        feats, ci = [], 0
        for item in cfg:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            _, _, s, p = item
            x = torch.relu(F.conv2d(x, self.convs[ci]["w"], self.convs[ci]["b"], stride=s, padding=p))
            if ci in taps:
                feats.append(x)
            ci += 1
        return feats

    @torch.no_grad()
    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """The LPIPS distance (a 0-d tensor on the model's device) of (H, W,
        3) or (B, H, W, 3) images in [0, 1]."""
        if img1.dim() == 3:
            img1, img2 = img1[None], img2[None]
        total = 0.0
        for a, b, lin in zip(self._features(img1), self._features(img2), self.lins):
            eps = constant(1e-10, a)
            a = a / torch.maximum(torch.linalg.vector_norm(a, dim=1, keepdim=True), eps)
            b = b / torch.maximum(torch.linalg.vector_norm(b, dim=1, keepdim=True), eps)
            total = total + torch.mean(F.conv2d((a - b) ** 2, lin), dim=(1, 2, 3))
        return torch.mean(total)


def evaluate_image(img: torch.Tensor, gt: torch.Tensor, lpips_model: LpipsModel | None = None) -> dict:
    """The metric bundle of one image pair: psnr, ssim, ms_ssim and, with a
    model, ``lpips_<net>`` (host floats, one read of them all)."""
    keys = ["psnr", "ssim", "ms_ssim"]
    with torch.no_grad():
        vals = [psnr(img, gt), ssim(img, gt), ms_ssim(img, gt)]
        if lpips_model is not None:
            keys.append(f"lpips_{lpips_model.net}")
            vals.append(lpips_model(img, gt))
        return dict(zip(keys, torch.stack(vals).tolist()))
