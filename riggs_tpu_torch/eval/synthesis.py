"""Stage-2 synthesis: render the rigged avatar at a time or an explicit pose.

Port of ``riggs_tpu/eval/synthesis.py``: ``render_rigged``,
``interpolate_time``, ``continuous_random_quats`` and
``generate_random_motion``. Skinning-weight visualization
(``with_skinning_vis``) and the test-set metrics come later.
"""
from __future__ import annotations

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.models import skeleton_warp as SW
from riggs_tpu_torch.models.gaussians import Gaussians
from riggs_tpu_torch.render.api import render


@torch.no_grad()
def render_rigged(
    gs: Gaussians,
    skel: SW.SkeletonWarp,
    cam: Camera,
    t: torch.Tensor | float | None = None,
    pose: dict | None = None,
    bg: torch.Tensor | None = None,
    active_sh: int | None = None,
    with_skinning_vis: bool = False,
    max_per_tile: int = 1024,
) -> dict:
    """Render the rigged model at time t OR at an explicit pose dict
    {local_rotation (J, 4), global_trans (3,)}. Besides the reference's
    render/depth/alpha/d, the result carries the overflow counters and the
    per-tile hit counts."""
    if with_skinning_vis:
        raise NotImplementedError("skinning-weight renders come with the evaluation port (ROADMAP A7)")
    bg = torch.zeros(3, device=gs.device) if bg is None else bg
    active_sh = gs.max_sh_degree if active_sh is None else active_sh
    if pose is None:
        pose = SW.pose_at(skel, t)
    d = SW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
    out = render(
        cam, gs, bg,
        d_xyz=d["d_xyz"],
        d_rotation=d["d_rotation"],
        d_scaling=torch.zeros_like(d["d_scaling"]),
        active_sh_degree=active_sh,
        max_per_tile=max_per_tile,
    )
    return {
        "render": out["render"],
        "depth": out["depth"],
        "alpha": out["alpha"],
        "d": d,
        "overflow_tiles": out["overflow_tiles"],
        "overflow_rect": out["overflow_rect"],
        "tile_counts": out["tile_counts"],
    }


def interpolate_time(gs, skel, cam, n_frames: int = 200, bg=None, max_per_tile: int = 1024) -> list[np.ndarray]:
    """Uniform time sweep at a fixed view."""
    return [
        render_rigged(gs, skel, cam, t=float(t), bg=bg, max_per_tile=max_per_tile)["render"].cpu().numpy()
        for t in np.linspace(0.0, 1.0, n_frames)
    ]


def continuous_random_quats(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 4) wxyz quats sweeping a random axis from -pi/6 to +pi/6."""
    axis = rng.random(3)
    axis /= np.linalg.norm(axis)
    angles = -np.pi / 6 + np.arange(n) * (np.pi / 3) / n
    half = angles / 2.0
    q = np.zeros((n, 4), np.float32)
    q[:, 0] = np.cos(half)
    q[:, 1:] = np.sin(half)[:, None] * axis[None, :]
    return q


def random_motion_poses(n_joints: int, seed: int = 0, pose_num: int = 60, change_ratio: float = 0.3,
                        min_joint: int = 5) -> list[dict]:
    """The pose sweep of ``generate_random_motion``: continuous random
    rotations on a random ~30% subset of joints (numpy, identity elsewhere)."""
    rng = np.random.default_rng(seed)
    J = n_joints
    lo = min(min_joint, max(J - 1, 1))
    n_change = max(1, int(change_ratio * J))
    candidates = np.arange(lo, J)
    if len(candidates) == 0:
        candidates = np.arange(1, J)
    chosen = rng.choice(candidates, size=min(n_change, len(candidates)), replace=False)
    sweeps = {int(j): continuous_random_quats(rng, pose_num) for j in chosen}
    ident = np.tile(np.array([1.0, 0, 0, 0], np.float32), (J, 1))
    poses = []
    for i in range(pose_num):
        rot = ident.copy()
        for j, qs in sweeps.items():
            rot[j] = qs[i]
        poses.append({"local_rotation": rot, "global_trans": np.zeros(3, np.float32)})
    return poses


def generate_random_motion(
    gs, skel, cam, seed: int = 0, pose_num: int = 60, change_ratio: float = 0.3,
    min_joint: int = 5, bg=None, max_per_tile: int = 1024,
) -> tuple[list[np.ndarray], list[dict]]:
    """Novel-pose synthesis: render each pose of ``random_motion_poses``."""
    poses = random_motion_poses(skel.net.n_joints, seed, pose_num, change_ratio, min_joint)
    dev = gs.device
    images = []
    for p in poses:
        pose = {k: torch.as_tensor(v, device=dev) for k, v in p.items()}
        images.append(render_rigged(gs, skel, cam, pose=pose, bg=bg, max_per_tile=max_per_tile)["render"].cpu().numpy())
    return images, poses
