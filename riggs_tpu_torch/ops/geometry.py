"""Point-to-segment distances for bone skinning.

Port of ``riggs_tpu/ops/geometry.py:point_segment_dist2``.
"""
from __future__ import annotations

import torch


def point_segment_dist2(a: torch.Tensor, b: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared distance from each point (N, D) to each segment [a_j, b_j]
    (a, b: (K, D)). Returns (N, K)."""
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-6)
    ap = points[:, None, :] - a[None, :, :]
    t = torch.sum(ap * ab[None], dim=-1) / denom
    t = torch.clamp(t, 0.0, 1.0)
    closest = a[None] + t[..., None] * ab[None]
    diff = closest - points[:, None, :]
    return torch.sum(diff * diff, dim=-1)
