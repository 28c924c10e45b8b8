"""Stage-1 evaluation and synthesis: the node-warp model's test set, time and spiral sweeps.

Port of ``riggs_tpu/eval/render_stage1.py``: ``render_deformed`` (the
canonical Gaussians warped by the node field at a time and rendered),
``render_test_set_stage1`` with the metric bundle per frame,
``interpolate_time_stage1`` (a fixed view) and ``interpolate_all_stage1``
(the camera orbits while time advances).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera, make_camera
from riggs_tpu_torch.camera.poses import spherical_ring
from riggs_tpu_torch.data.blender import _nerf_c2w_to_rt
from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.eval.metrics import evaluate_image
from riggs_tpu_torch.models import node_warp as NW
from riggs_tpu_torch.render.api import render


@torch.no_grad()
def render_deformed(gs, warp: NW.NodeWarp, cam: Camera, t, bg=None, active_sh=None, max_per_tile=1024) -> dict:
    """``render``'s result for the Gaussians warped to time ``t``, with the
    deformed nodes under ``d_nodes``."""
    bg = torch.zeros(3, device=gs.device) if bg is None else bg
    active_sh = gs.max_sh_degree if active_sh is None else active_sh
    d = NW.warp_forward(warp, gs.xyz, t, gs.feature, gs.motion_mask, local_frame=warp.net.local_frame)
    out = render(cam, gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                 d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=active_sh, max_per_tile=max_per_tile)
    out["d_nodes"] = d["d_nodes"]
    return out


def render_test_set_stage1(gs, warp, frames: list[Frame], bg=None, lpips_model=None, max_per_tile=1024):
    """(per-frame metrics, their means, the renders as host arrays), each
    frame through its own camera with the first frame's size."""
    rows, images = [], []
    for f in frames:
        cam = dataclasses.replace(frames[0].cam, w2c=f.cam.w2c, intrinsics=f.cam.intrinsics, fid=f.fid)
        img = render_deformed(gs, warp, cam, f.fid, bg=bg, max_per_tile=max_per_tile)["render"]
        rows.append(evaluate_image(img, f.image, lpips_model))
        images.append(img.cpu().numpy())
    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} if rows else {}
    return rows, means, images


def interpolate_time_stage1(gs, warp, cam: Camera, n_frames: int = 150, bg=None, max_per_tile=1024):
    """A uniform time sweep at a fixed view."""
    return [render_deformed(gs, warp, cam, float(t), bg=bg, max_per_tile=max_per_tile)["render"].cpu().numpy()
            for t in np.linspace(0.0, 1.0, n_frames)]


def interpolate_all_stage1(gs, warp, width: int = 800, height: int = 800, fov: float = 0.9, n_frames: int = 90,
                           radius: float = 4.0, bg=None, max_per_tile=1024):
    """The spiral sweep: frame i seen from the i-th of ``n_frames`` poses on
    a ring of ``radius`` at time i / n_frames."""
    images = []
    for i, c2w in enumerate(spherical_ring(n_frames, radius=radius)):
        R, T = _nerf_c2w_to_rt(c2w)
        cam = make_camera(R, T, width, height, fovx=fov, fovy=fov, fid=i / n_frames, device=gs.device)
        images.append(render_deformed(gs, warp, cam, i / n_frames, bg=bg, max_per_tile=max_per_tile)["render"]
                      .cpu().numpy())
    return images
