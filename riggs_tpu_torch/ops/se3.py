"""SO(3) and SE(3) exponential and logarithm maps.

Port of ``riggs_tpu/ops/se3.py``: ``skew``, ``exp_so3`` (Rodrigues),
``exp_se3`` (a twist to a 4x4 transform, the V matrix's coefficients at
their Taylor limits below |w| = 1e-6, so a pure translation maps to itself)
and ``log_so3``; the homogeneous helpers live in ``ops/geometry.py`` and
are re-exported here, as the reference does.

Every clip is a ``torch.maximum`` / ``torch.minimum`` pair: at a tie those
split the gradient in halves as ``jnp.clip`` does, where ``torch.clamp``
passes it whole (a rotation of angle 0 or pi meets the trace's clip).
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.device import constant
from riggs_tpu_torch.ops.geometry import from_homogeneous, to_homogeneous  # noqa: F401 (re-export)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        dim=-2,
    )


def _eye(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor, theta: torch.Tensor | None = None) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3). With
    ``theta`` given, ``w`` is taken as the unit axis."""
    if theta is None:
        theta = torch.linalg.norm(w, dim=-1)
        w = w / torch.maximum(theta[..., None], constant(1e-12, w))
    W = skew(w)
    th = theta[..., None, None]
    return _eye(W) + torch.sin(th) * W + (1.0 - torch.cos(th)) * (W @ W)


def exp_se3(S: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = (w, v) -> homogeneous transform (..., 4, 4)."""
    w, v = S[..., :3], S[..., 3:]
    theta = torch.linalg.norm(w, dim=-1)
    eps = constant(1e-12, theta)
    wn = w / torch.maximum(theta, eps)[..., None]
    W = skew(wn)
    th = theta[..., None, None]
    small = th < 1e-6
    eye = _eye(W)
    WW = W @ W
    R = eye + torch.sin(th) * W + (1.0 - torch.cos(th)) * WW
    a = torch.where(small, th / 2.0, (1.0 - torch.cos(th)) / torch.maximum(th, eps))
    b = torch.where(small, th * th / 6.0, (th - torch.sin(th)) / torch.maximum(th, eps))
    A = eye + a * W + b * WW
    t = torch.einsum("...ab,...b->...a", A, v)
    top = torch.cat([R, t[..., None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros(S.shape[:-1] + (1, 4), dtype=S.dtype, device=S.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    tr = torch.minimum(torch.maximum(tr, constant(-1.0, tr)), constant(1.0, tr))
    theta = torch.arccos(tr)
    s = torch.where(torch.abs(torch.sin(theta)) < 1e-7, 1.0, 2.0 * torch.sin(theta))
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    ) / s[..., None]
    return w * theta[..., None]
