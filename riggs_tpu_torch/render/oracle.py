"""Oracle rasterizer: exact, O(N * pixels), the tests' reference.

Port of ``riggs_tpu/render/oracle.py``: per-pixel front-to-back compositing
over all depth-sorted Gaussians as a cumulative product,

  P_i = prod_{j<=i} (1 - a_j);  w_i = a_i * P_{i-1} * [P_i >= 1e-4]
  color = sum_i w_i c_i;  alpha = sum_i w_i;  image = color + (1-alpha) bg
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.render.binning import _depth_rank_order
from riggs_tpu_torch.render.project import build_cov3d_packed, project_gaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def _pixel_alphas(pix, mean2d, conic, opacity):
    """pix: (P, 2) -> alphas (P, N)."""
    d = pix[:, None, :] - mean2d[None, :, :]
    dx, dy = d[..., 0], d[..., 1]
    power = -0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy) - conic[None, :, 1] * dx * dy
    alpha = opacity[None, :] * torch.exp(power)
    alpha = torch.where(power > 0.0, 0.0, alpha)
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    return torch.where(alpha < ALPHA_MIN, 0.0, alpha)


def composite(alphas, colors, depths):
    """Front-to-back composite along the last (depth-sorted) axis.
    alphas (P, N); colors (N, 3); depths (N,) -> rgb (P, 3), depth (P,), acc (P,)."""
    one_m = 1.0 - alphas
    P = torch.cumprod(one_m, dim=-1)
    T = P / one_m  # exclusive product; alpha <= 0.99 keeps one_m >= 0.01
    w = alphas * T * (P >= T_EPS)
    return w @ colors, w @ depths, torch.sum(w, dim=-1)


def rasterize_oracle(
    cam: Camera,
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    bg: torch.Tensor,
    alive: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    cov3d: torch.Tensor | None = None,
    pixel_chunk: int = 1024,
    mean2d_bias: torch.Tensor | None = None,
) -> dict:
    """Render one view; returns image (H, W, 3), depth, alpha, radii, proj."""
    if cov3d is None:
        cov3d = build_cov3d_packed(scales, rotations, scale_modifier)
    proj = project_gaussians(cam, means3d, cov3d, alive, mean2d_bias)
    order = _depth_rank_order(proj.depth, proj.mask)
    mean2d_s = proj.mean2d[order]
    conic_s = proj.conic[order]
    depth_s = proj.depth[order]
    op_s = torch.where(proj.mask, opacity, 0.0)[order]
    col_s = colors[order]

    H, W = cam.height, cam.width
    dev = means3d.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (H*W, 2)
    rgb, dep, acc = [], [], []
    for pc in torch.split(pix, pixel_chunk):
        r, d, a = composite(_pixel_alphas(pc, mean2d_s, conic_s, op_s), col_s, depth_s)
        rgb.append(r)
        dep.append(d)
        acc.append(a)
    rgb = torch.cat(rgb).reshape(H, W, 3)
    dep = torch.cat(dep).reshape(H, W)
    acc = torch.cat(acc).reshape(H, W)
    image = rgb + (1.0 - acc)[..., None] * bg
    return dict(image=image, depth=dep, alpha=acc, radii=proj.radius, proj=proj)
