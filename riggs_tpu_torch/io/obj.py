"""OBJ / point-cloud dumps for skeleton and skinning-weight inspection.

A copy of ``riggs_tpu/io/obj.py`` (numpy only; the port keeps its own copy
rather than import the JAX package): joints as vertices, bones as line
elements, and ASCII PLY point clouds with uchar colours. Both packages write
the same bytes for the same arrays.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def write_skeleton_obj(path: str | Path, joints: np.ndarray, parents) -> None:
    """Joints as v-lines, bones as l-lines (1-indexed)."""
    parents = np.asarray(parents)
    lines = [f"v {p[0]} {p[1]} {p[2]}" for p in np.asarray(joints)]
    for i in range(1, len(parents)):
        if parents[i] >= 0:
            lines.append(f"l {parents[i] + 1} {i + 1}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def read_skeleton_obj(path: str | Path):
    joints, edges = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            joints.append([float(x) for x in parts[1:4]])
        elif parts[0] == "l":
            edges.append((int(parts[1]) - 1, int(parts[2]) - 1))
    return np.asarray(joints, np.float32), edges


def jet_colormap(values: np.ndarray) -> np.ndarray:
    """values in [0,1] -> (N, 3) jet-style colors (for weight visualization)."""
    v = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], -1)


def write_colored_pointcloud_ply(path: str | Path, points: np.ndarray, colors: np.ndarray):
    """ASCII PLY with uchar colors (vis_blending_weight-style dumps)."""
    points = np.asarray(points)
    colors = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
    lines = [
        "ply",
        "format ascii 1.0",
        f"element vertex {len(points)}",
        "property float x",
        "property float y",
        "property float z",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        "end_header",
    ]
    for p, c in zip(points, colors):
        lines.append(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")
