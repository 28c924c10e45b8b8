"""EWA projection of 3D Gaussians to screen space.

Port of ``riggs_tpu/render/project.py``:

  cov3D = R S S^T R^T ; cov2D = J W cov3D W^T J^T + 0.3 I ; conic = cov2D^-1
  radius = ceil(3 * sqrt(max eigenvalue))

The operation order follows the reference term by term: ``ceil`` makes the
radius (and so the tile rects and counts) sensitive to one ulp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.device import constant
from riggs_tpu_torch.ops.quaternion import quat_normalize


class Projected(NamedTuple):
    """Screen-space Gaussians (all length N)."""

    mean2d: torch.Tensor  # (N, 2) pixel coords
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) upper-triangular inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # (N,) float screen radius (3 sigma)
    mask: torch.Tensor  # (N,) visible & valid


def build_cov3d_packed(scales: torch.Tensor, rotations: torch.Tensor, scale_modifier: float = 1.0) -> torch.Tensor:
    """Packed upper-triangle world covariance (N, 6): [c00, c01, c02, c11, c12, c22]."""
    q = quat_normalize(rotations)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = (scales[:, 0] * scale_modifier) ** 2
    s1 = (scales[:, 1] * scale_modifier) ** 2
    s2 = (scales[:, 2] * scale_modifier) ** 2
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([c00, c01, c02, c11, c12, c22], dim=-1)


def project_gaussians(
    cam: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    alive: torch.Tensor | None = None,
    mean2d_bias: torch.Tensor | None = None,
) -> Projected:
    """Project all Gaussians; cull those behind the near plane or off screen.

    ``mean2d_bias`` (zeros (N, 2) from the caller) is added to the pixel
    means before the on-screen test: its gradient is dL/d(mean2d), the input
    of the densification statistics."""
    w2c = cam.w2c.to(torch.float32)
    view = means3d @ w2c[:3, :3].T + w2c[:3, 3]
    tx, ty, tz = view[:, 0], view[:, 1], view[:, 2]
    fx, fy = cam.intrinsics[0], cam.intrinsics[1]
    cx, cy = cam.intrinsics[2], cam.intrinsics[3]

    in_front = tz > 0.2  # the CUDA rasterizer's near cull
    # torch.maximum, not clamp: a tie splits its gradient as jnp.maximum's does
    tz_safe = torch.maximum(tz, constant(1e-6, tz))

    # frustum clamp of the Jacobian evaluation point (1.3x fov guard band)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    txz = torch.maximum(torch.minimum(tx / tz_safe, limx), -limx) * tz_safe
    tyz = torch.maximum(torch.minimum(ty / tz_safe, limy), -limy) * tz_safe

    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2
    W = w2c[:3, :3]
    t00 = j00 * W[0, 0] + j02 * W[2, 0]
    t01 = j00 * W[0, 1] + j02 * W[2, 1]
    t02 = j00 * W[0, 2] + j02 * W[2, 2]
    t10 = j11 * W[1, 0] + j12 * W[2, 0]
    t11 = j11 * W[1, 1] + j12 * W[2, 1]
    t12 = j11 * W[1, 2] + j12 * W[2, 2]

    s00, s01, s02, s11, s12, s22 = (cov3d[:, i] for i in range(6))

    # cov2d = T Sigma T^T (+0.3 I dilation)
    u0 = t00 * s00 + t01 * s01 + t02 * s02
    u1 = t00 * s01 + t01 * s11 + t02 * s12
    u2 = t00 * s02 + t01 * s12 + t02 * s22
    v0 = t10 * s00 + t11 * s01 + t12 * s02
    v1 = t10 * s01 + t11 * s11 + t12 * s12
    v2 = t10 * s02 + t11 * s12 + t12 * s22
    a = u0 * t00 + u1 * t01 + u2 * t02 + 0.3
    b = u0 * t10 + u1 * t11 + u2 * t12
    c = v0 * t10 + v1 * t11 + v2 * t12 + 0.3
    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.maximum(det, constant(1e-12, det)), 0.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.maximum(mid * mid - det, constant(0.1, det)))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    mean2d = torch.stack([fx * tx * inv_z + cx - 0.5, fy * ty * inv_z + cy - 0.5], dim=-1)
    if mean2d_bias is not None:
        mean2d = mean2d + mean2d_bias

    on_screen = (
        (mean2d[:, 0] + radius > 0)
        & (mean2d[:, 0] - radius < cam.width)
        & (mean2d[:, 1] + radius > 0)
        & (mean2d[:, 1] - radius < cam.height)
    )
    mask = in_front & det_ok & on_screen
    if alive is not None:
        mask = mask & alive
    return Projected(
        mean2d=mean2d,
        depth=tz,
        conic=conic,
        radius=torch.where(mask, radius, 0.0),
        mask=mask,
    )
