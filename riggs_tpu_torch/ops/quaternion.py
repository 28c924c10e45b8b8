"""Quaternion and rotation math, batched over leading dimensions.

Port of ``riggs_tpu/ops/quaternion.py`` (the parts the serving path, the
dual-quaternion skinning and the key-pose animation use). Quaternions are (w, x, y, z); the quaternion
axis is the last one. A dual quaternion is a pair (q_r, q_d), each (..., 4).
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.device import constant

_EPS = 1e-12


def quat_normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Unit quaternion via q / sqrt(|q|^2 + eps^2) (zero quats stay finite)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps * eps)
    return q / norm


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -y, -z)."""
    return q * constant((1.0, -1.0, -1.0, -1.0), q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b. a, b: (..., 4) broadcastable."""
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    if normalize:
        q = quat_normalize(q)
    w, x, y, z = torch.unbind(q, dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branch-free Shepperd construction: all four candidates are built and the
    one with the largest squared magnitude is picked (first on ties)."""
    m00 = m[..., 0, 0]
    m11 = m[..., 1, 1]
    m22 = m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    def _div(a, b):
        return a / torch.clamp(b, min=_EPS)

    w_w = _safe_sqrt(qw2) * 0.5
    c_w = torch.stack(
        [
            _div(4.0 * w_w * w_w / 2.0, 2.0 * w_w),
            _div(m[..., 2, 1] - m[..., 1, 2], 4.0 * w_w),
            _div(m[..., 0, 2] - m[..., 2, 0], 4.0 * w_w),
            _div(m[..., 1, 0] - m[..., 0, 1], 4.0 * w_w),
        ],
        dim=-1,
    )
    x_x = _safe_sqrt(qx2) * 0.5
    c_x = torch.stack(
        [
            _div(m[..., 2, 1] - m[..., 1, 2], 4.0 * x_x),
            x_x,
            _div(m[..., 0, 1] + m[..., 1, 0], 4.0 * x_x),
            _div(m[..., 0, 2] + m[..., 2, 0], 4.0 * x_x),
        ],
        dim=-1,
    )
    y_y = _safe_sqrt(qy2) * 0.5
    c_y = torch.stack(
        [
            _div(m[..., 0, 2] - m[..., 2, 0], 4.0 * y_y),
            _div(m[..., 0, 1] + m[..., 1, 0], 4.0 * y_y),
            y_y,
            _div(m[..., 1, 2] + m[..., 2, 1], 4.0 * y_y),
        ],
        dim=-1,
    )
    z_z = _safe_sqrt(qz2) * 0.5
    c_z = torch.stack(
        [
            _div(m[..., 1, 0] - m[..., 0, 1], 4.0 * z_z),
            _div(m[..., 0, 2] + m[..., 2, 0], 4.0 * z_z),
            _div(m[..., 1, 2] + m[..., 2, 1], 4.0 * z_z),
            z_z,
        ],
        dim=-1,
    )
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([c_w, c_x, c_y, c_z], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions q0, q1
    (..., 4) at t in [0, 1]: a scalar, or one value per quaternion (a
    tensor of q0's leading shape, broadcast over the quaternion axis). The
    shorter arc (q1's sign flipped where the dot is negative); a plain lerp
    where sin(theta) < 1e-5."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    use_lerp = sin_theta < 1e-5
    denom = torch.clamp(sin_theta, min=1e-12)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / denom)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# dual quaternions
# ---------------------------------------------------------------------------


def qt_to_dq(q: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation quat, translation) -> dual quaternion (q_r, q_d)."""
    q = quat_normalize(q)
    t_quat = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return q, 0.5 * quat_multiply(t_quat, q)


def dq_to_qt(q_r: torch.Tensor, q_d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dual quaternion -> (rotation quat, translation)."""
    norm = torch.clamp(torch.linalg.vector_norm(q_r, dim=-1, keepdim=True), min=_EPS)
    q_r = q_r / norm
    q_d = q_d / norm
    t_quat = 2.0 * quat_multiply(q_d, quat_conjugate(q_r))
    return q_r, t_quat[..., 1:]


def dq_blend(q_r: torch.Tensor, q_d: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dual-quaternion linear blending: q_r, q_d (..., K, 4) per bone, w
    (..., K) weights; each bone's pair is first put in the hemisphere of the
    first bone's. Returns the normalized blend."""
    ref = q_r[..., :1, :]
    sign = torch.where(torch.sum(q_r * ref, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    q_r = q_r * sign
    q_d = q_d * sign
    b_r = torch.sum(w[..., None] * q_r, dim=-2)
    b_d = torch.sum(w[..., None] * q_d, dim=-2)
    norm = torch.clamp(torch.linalg.vector_norm(b_r, dim=-1, keepdim=True), min=_EPS)
    return b_r / norm, b_d / norm


def dq_apply(q_r: torch.Tensor, q_d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a unit dual quaternion's rigid transform to points x (..., 3)."""
    _, t = dq_to_qt(q_r, q_d)
    return quat_rotate(q_r, x) + t
