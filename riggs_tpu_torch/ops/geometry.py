"""Point-to-segment distances, Procrustes rotation fits, a safe norm.

Port of ``riggs_tpu/ops/geometry.py``: ``point_segment_dist2`` (bone
skinning), ``fit_rotations`` (the ARAP losses) and ``safe_norm``.
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


def fit_rotations(cov: torch.Tensor) -> torch.Tensor:
    """Best-fit rotations (..., 3, 3) from correlation matrices: with cov =
    U S V^T, R = U diag(1, 1, det(U V^T)) V^T (det(R) = +1). R does not
    depend on the signs the SVD gives its singular vectors."""
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones_like(det)[..., None].expand(*det.shape, 2), det[..., None]], dim=-1)
    return torch.einsum("...ab,...b,...bc->...ac", u, d, vt)


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at the origin: sqrt(sum x^2 + eps)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)
