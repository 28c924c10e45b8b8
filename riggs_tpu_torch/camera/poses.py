"""Synthetic camera trajectories: spherical orbits and Bezier interpolation.

A copy of ``riggs_tpu/camera/poses.py`` (numpy only; the port keeps its own
copy rather than import the JAX package): NeRF-convention c2w poses on a
sphere (``pose_spherical``, ``spherical_ring`` for the stage-1 spiral
sweep), de Casteljau Bezier curves and arc-length polyline resampling.
"""
from __future__ import annotations

import numpy as np


def _trans_t(t):
    m = np.eye(4)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4)
    m[1, 1] = np.cos(phi)
    m[1, 2] = -np.sin(phi)
    m[2, 1] = np.sin(phi)
    m[2, 2] = np.cos(phi)
    return m


def _rot_theta(th):
    m = np.eye(4)
    m[0, 0] = np.cos(th)
    m[0, 2] = -np.sin(th)
    m[2, 0] = np.sin(th)
    m[2, 2] = np.cos(th)
    return m


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """NeRF-convention c2w for a point on the sphere (degrees)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]) @ c2w
    return c2w


def spherical_ring(n: int = 40, phi: float = -30.0, radius: float = 4.0) -> list[np.ndarray]:
    """n c2w poses sweeping 360 degrees (render.py interpolate_all path)."""
    return [pose_spherical(th, phi, radius) for th in np.linspace(-180, 180, n, endpoint=False)]


def bezier_curve(control_points: np.ndarray, n: int = 100) -> np.ndarray:
    """Bezier curve through control points (utils/bezier.py:4-45 equivalent:
    de Casteljau evaluation). control_points: (K, D) -> (n, D)."""
    pts = np.asarray(control_points, np.float64)
    ts = np.linspace(0.0, 1.0, n)
    out = []
    for t in ts:
        p = pts.copy()
        while len(p) > 1:
            p = (1 - t) * p[:-1] + t * p[1:]
        out.append(p[0])
    return np.asarray(out, np.float32)


def piecewise_linear(points: np.ndarray, n: int = 100) -> np.ndarray:
    """Arc-length-uniform piecewise-linear resampling of a polyline."""
    pts = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    cum = np.concatenate([[0], np.cumsum(seg)])
    total = cum[-1]
    if total <= 0:
        return np.tile(pts[:1], (n, 1)).astype(np.float32)
    ts = np.linspace(0, total, n)
    out = np.empty((n, pts.shape[1]))
    for d in range(pts.shape[1]):
        out[:, d] = np.interp(ts, cum, pts[:, d])
    return out.astype(np.float32)
