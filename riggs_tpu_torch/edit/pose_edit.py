"""Skeleton pose editing: rotate joints about the view axis, compose with the
PoseMLP output, retarget, and save, load and interpolate key poses.

Port of ``riggs_tpu/edit/pose_edit.py``: an edit is a per-joint delta
quaternion composed onto the current local rotation by quaternion
multiplication; saved poses are SLERP-interpolated into a playback sequence
(``skeleton/interpolation.py``). ``PoseLibrary``'s JSON file is the
reference's: float32 values written as their exact doubles, so a file
written by either package reads in the other to the same arrays.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.ops.quaternion import quat_multiply, quat_normalize
from riggs_tpu_torch.skeleton.interpolation import interpolate_key_poses


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def axis_angle_quat(axis, angle: float) -> np.ndarray:
    """The unit quaternion (4,) float32 of ``angle`` radians about ``axis``."""
    axis = np.asarray(axis, np.float32)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    half = angle / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis]).astype(np.float32)


def rotate_joint(local_rotation: torch.Tensor, joint_idx: int, view_axis, angle: float) -> torch.Tensor:
    """A copy of ``local_rotation`` (J, 4) with a rotation of ``angle`` about
    ``view_axis`` (the camera's forward axis) composed onto joint
    ``joint_idx``."""
    dq = torch.as_tensor(axis_angle_quat(view_axis, angle), device=local_rotation.device)
    out = local_rotation.clone()
    out[joint_idx] = quat_normalize(quat_multiply(dq, local_rotation[joint_idx]))
    return out


def compose_pose_edit(base_rotation: torch.Tensor, edit_rotation: torch.Tensor) -> torch.Tensor:
    """Per-joint edit quaternions applied onto a PoseMLP output."""
    return quat_normalize(quat_multiply(edit_rotation, base_rotation))


def retarget_pose(src_joints, dst_joints, local_rotation, global_trans) -> tuple[np.ndarray, np.ndarray]:
    """Drive one skeleton with a pose edited on another (host numpy): with
    equal joint counts the rotations transfer one to one, otherwise each
    destination joint takes the rotation of its nearest source joint at
    rest."""
    src_joints, dst_joints = _host(src_joints), _host(dst_joints)
    rot, trans = _host(local_rotation), _host(global_trans)
    if len(src_joints) == len(dst_joints):
        return rot.copy(), trans.copy()
    d = ((dst_joints[:, None] - src_joints[None]) ** 2).sum(-1)
    return rot[d.argmin(1)], trans.copy()


class PoseLibrary:
    """Named skeleton poses kept in a JSON file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.poses: dict[str, dict] = {}
        if self.path.exists():
            self.load()

    def add(self, name: str, local_rotation, global_trans):
        self.poses[name] = {
            "local_rotation": _host(local_rotation).tolist(),
            "global_trans": _host(global_trans).tolist(),
        }

    def get(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        p = self.poses[name]
        return np.asarray(p["local_rotation"], np.float32), np.asarray(p["global_trans"], np.float32)

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.poses))

    def load(self):
        self.poses = json.loads(self.path.read_text())

    def interpolate(self, names: list[str], frames_per_segment: int = 20,
                    device: str | torch.device | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """SLERP through the named poses: ((P - 1) F, J, 4) rotations and
        ((P - 1) F, 3) translations on ``device`` (the card unless given)."""
        dev = resolve_device(device)
        rots = torch.as_tensor(np.stack([self.get(n)[0] for n in names]), device=dev)
        trans = torch.as_tensor(np.stack([self.get(n)[1] for n in names]), device=dev)
        return interpolate_key_poses(rots, trans, frames_per_segment)
