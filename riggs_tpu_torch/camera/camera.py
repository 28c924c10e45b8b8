"""Pinhole camera as a small tensor container.

Port of ``riggs_tpu/camera/camera.py``: the same (fx, fy, cx, cy) pinhole
math and the reference's viewport convention

    pix = f * (x_view / z_view) + c - 0.5,   c = (W/2, H/2) by default.

``depth2normal`` turns a depth map into view-space normals.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from riggs_tpu_torch.device import constant, resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclasses.dataclass(frozen=True)
class Camera:
    """w2c: (4, 4) world-to-camera (x_cam = w2c @ x_w); intrinsics: (4,) =
    (fx, fy, cx, cy) in pixels; fid: () normalized frame time in [0, 1]."""

    w2c: torch.Tensor
    intrinsics: torch.Tensor
    fid: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def fx(self):
        return self.intrinsics[..., 0]

    @property
    def fy(self):
        return self.intrinsics[..., 1]

    @property
    def cx(self):
        return self.intrinsics[..., 2]

    @property
    def cy(self):
        return self.intrinsics[..., 3]

    @property
    def tanfovx(self):
        return 0.5 * self.width / self.fx

    @property
    def tanfovy(self):
        return 0.5 * self.height / self.fy


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    width: int,
    height: int,
    fovx: float | None = None,
    fovy: float | None = None,
    K: np.ndarray | None = None,
    fid: float = 0.0,
    znear: float = 0.01,
    zfar: float = 100.0,
    device: str | torch.device | None = None,
) -> Camera:
    """Camera from the reference's (R, T) convention: R is camera-to-world
    (stored transposed in w2c), T the world-to-camera translation."""
    dev = resolve_device(device)
    w2c = np.zeros((4, 4), dtype=np.float32)
    w2c[:3, :3] = np.asarray(R, np.float32).T
    w2c[:3, 3] = np.asarray(T, np.float32)
    w2c[3, 3] = 1.0
    if K is not None:
        intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    else:
        if fovx is None or fovy is None:
            raise ValueError("make_camera needs K or both fovx and fovy")
        intr = np.array(
            [fov2focal(fovx, width), fov2focal(fovy, height), width / 2.0, height / 2.0],
            np.float32,
        )
    return Camera(
        w2c=torch.as_tensor(w2c, device=dev),
        intrinsics=torch.as_tensor(intr, device=dev),
        fid=torch.tensor(fid, dtype=torch.float32, device=dev),
        width=int(width),
        height=int(height),
        znear=float(znear),
        zfar=float(zfar),
    )


def world_to_view(w2c: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> view space under w2c (4, 4)."""
    return points @ w2c[:3, :3].T + w2c[:3, 3]


def project_points(cam: Camera, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """World points (N, 3) -> pixel coordinates (N, 2) (x, y) and view depth (N,)."""
    view = world_to_view(cam.w2c, points)
    z = view[..., 2]
    f = cam.intrinsics[:2]
    c = cam.intrinsics[2:]
    pix = view[..., :2] * f / torch.clamp(z, min=1e-6)[..., None] + c - 0.5
    return pix, z


def camera_center(cam: Camera) -> torch.Tensor:
    """World-space camera position: -R^T t of the w2c transform."""
    return -cam.w2c[:3, :3].T @ cam.w2c[:3, 3]


def depth2normal(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Per-pixel unit normals (H, W, 3) in view space from a view-space
    depth map (H, W): the cross product of the back-projected points'
    differences along x and y, central inside and one-sided at the edges
    (``torch.gradient``'s edge_order 1, as ``jnp.gradient``)."""
    H, W = depth.shape
    fx, fy, cx, cy = cam.intrinsics.unbind()
    xs = (torch.arange(W, dtype=torch.float32, device=depth.device) - cx + 0.5) / fx
    ys = (torch.arange(H, dtype=torch.float32, device=depth.device) - cy + 0.5) / fy
    pts = torch.stack([xs[None, :] * depth, ys[:, None] * depth, depth], dim=-1)
    (dx,) = torch.gradient(pts, dim=1)
    (dy,) = torch.gradient(pts, dim=0)
    n = torch.linalg.cross(dx, dy)
    return n / torch.maximum(torch.linalg.norm(n, dim=-1, keepdim=True), constant(1e-8, n))


def project_nodes_2d(cam: Camera, nodes: torch.Tensor) -> torch.Tensor:
    """World points -> (row, col) pixel coordinates for the thinned-skeleton
    chamfer: principal point at (cx, cy) with no half-pixel shift, and (y, x)
    order to match ``np.argwhere`` of the thinned mask."""
    view = world_to_view(cam.w2c, nodes)
    z = torch.maximum(view[..., 2], constant(1e-6, view))
    px = cam.intrinsics[0] * view[..., 0] / z + cam.intrinsics[2]
    py = cam.intrinsics[1] * view[..., 1] / z + cam.intrinsics[3]
    return torch.stack([py, px], dim=-1)
