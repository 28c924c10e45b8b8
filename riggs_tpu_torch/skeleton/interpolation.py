"""Key-pose SLERP interpolation for animation playback.

Port of ``riggs_tpu/skeleton/interpolation.py``: each joint's local rotation
is interpolated spherically between consecutive key poses, the global
translation linearly.
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.ops.quaternion import quat_slerp


def slerp_batch(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q0, q1: (J, 4); t: (M,) -> (M, J, 4) interpolated unit quaternions."""
    return quat_slerp(q0[None], q1[None], t[:, None])


def interpolate_key_poses(
    rotations: torch.Tensor, translations: torch.Tensor, frames_per_segment: int = 20
) -> tuple[torch.Tensor, torch.Tensor]:
    """rotations: (P, J, 4) key poses; translations: (P, 3). Returns
    ((P - 1) * F, J, 4) rotations and ((P - 1) * F, 3) translations
    sweeping through the key poses, F frames a segment from its first key
    pose (included) towards the next (excluded)."""
    P = rotations.shape[0]
    if P < 2:
        raise ValueError("need at least two key poses")
    t = torch.linspace(0.0, 1.0, frames_per_segment + 1, dtype=rotations.dtype, device=rotations.device)[:-1]
    rots, trans = [], []
    for i in range(P - 1):
        rots.append(slerp_batch(rotations[i], rotations[i + 1], t))
        trans.append((1.0 - t[:, None]) * translations[i] + t[:, None] * translations[i + 1])
    return torch.cat(rots, dim=0), torch.cat(trans, dim=0)
