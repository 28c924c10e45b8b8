"""2D overlays: projected skeletons and node trajectories drawn on renders.

Port of ``riggs_tpu/viz/overlay.py``: pure numpy drawing on the (row, col)
pixels of ``camera.project_nodes_2d``, which runs on the camera's device
(one read a call); the image may be a tensor or an array.
"""
from __future__ import annotations

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera, project_nodes_2d


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _project(cam: Camera, points) -> np.ndarray:
    """(row, col) pixels of world points (..., 3), on the host."""
    pts = torch.as_tensor(points, dtype=torch.float32, device=cam.device)
    return project_nodes_2d(cam, pts).cpu().numpy()


def _draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1):
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) * 2 + 2)
    rows = np.linspace(p0[0], p1[0], n)
    cols = np.linspace(p0[1], p1[1], n)
    for dr in range(-thickness + 1, thickness):
        for dc in range(-thickness + 1, thickness):
            r = np.clip(np.round(rows + dr).astype(int), 0, h - 1)
            c = np.clip(np.round(cols + dc).astype(int), 0, w - 1)
            img[r, c] = color


def _draw_dot(img: np.ndarray, p, color, radius: int = 2):
    h, w = img.shape[:2]
    r0 = int(round(p[0]))
    c0 = int(round(p[1]))
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            if dr * dr + dc * dc <= radius * radius:
                r, c = r0 + dr, c0 + dc
                if 0 <= r < h and 0 <= c < w:
                    img[r, c] = color
    return img


def overlay_skeleton(
    image: np.ndarray,
    cam: Camera,
    joints: np.ndarray,
    parents,
    bone_color=(0.1, 0.9, 0.1),
    joint_color=(0.9, 0.1, 0.1),
    root_color=(0.1, 0.3, 1.0),
) -> np.ndarray:
    """Composite the projected skeleton over an (H, W, 3) image copy."""
    img = _host(image).copy()
    proj = _project(cam, joints)  # (J, 2) = (row, col)
    parents = _host(parents)
    for j in range(1, len(parents)):
        if parents[j] >= 0:
            _draw_line(img, proj[parents[j]], proj[j], bone_color)
    for j in range(len(proj)):
        _draw_dot(img, proj[j], root_color if j == 0 else joint_color)
    return img


def overlay_trajectories(
    image: np.ndarray, cam: Camera, trajectories: np.ndarray, color=(1.0, 0.8, 0.1)
) -> np.ndarray:
    """Draw per-node trajectory polylines. trajectories: (M, T, 3)."""
    img = _host(image).copy()
    for proj in _project(cam, trajectories):
        for t in range(1, proj.shape[0]):
            _draw_line(img, proj[t - 1], proj[t], color)
    return img
