"""Orbit camera for interactive viewers.

Port of ``riggs_tpu/camera/orbit.py``: mouse-drag orbit, pan and dolly on
host numpy state; ``to_camera`` makes the port's ``Camera`` on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera, make_camera


def _rotmat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


class OrbitCamera:
    def __init__(self, width: int = 800, height: int = 800, radius: float = 3.0, fovy: float = 0.9):
        self.width = width
        self.height = height
        self.radius = radius
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3)  # camera-to-world rotation

    @property
    def position(self) -> np.ndarray:
        return self.center - self.rot[:, 2] * self.radius

    def orbit(self, dx: float, dy: float, speed: float = 0.005):
        """Rotate about the up and right axes (screen-space drag)."""
        up = self.rot[:, 1]
        right = self.rot[:, 0]
        self.rot = _rotmat_from_axis_angle(up, -dx * speed) @ self.rot
        self.rot = _rotmat_from_axis_angle(right, -dy * speed) @ self.rot

    def pan(self, dx: float, dy: float, speed: float = 0.001):
        self.center += speed * self.radius * (-self.rot[:, 0] * dx + self.rot[:, 1] * dy)

    def scale(self, delta: float):
        self.radius *= 1.1 ** (-delta)

    def to_camera(self, fid: float = 0.0, device: str | torch.device | None = None) -> Camera:
        """The current view as a Camera on ``device`` (the card unless given),
        looking along +z towards the center."""
        R = self.rot
        T = -R.T @ self.position
        return make_camera(R, T, self.width, self.height, fovx=self.fovy, fovy=self.fovy, fid=fid, device=device)

    @property
    def view_axis(self) -> np.ndarray:
        """World-space forward axis (for view-axis pose editing)."""
        return self.rot[:, 2]
