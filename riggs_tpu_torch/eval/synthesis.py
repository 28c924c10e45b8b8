"""Stage-2 evaluation and synthesis: the test-set report, time sweeps, random motion.

Port of ``riggs_tpu/eval/synthesis.py``: ``skinning_colors`` and
``dump_skinning_weights_ply`` (skinning-weight visualization),
``render_rigged`` (with ``with_skinning_vis``, a second render in the
skinning colours), ``render_test_set`` and ``format_numerical_res`` (the
``numerical_res.txt`` table), ``interpolate_time``,
``continuous_random_quats`` and ``generate_random_motion``.

``render_test_set`` renders plain windows at ``max_per_tile`` and neither
escalates nor reports truncation, as the reference's does; its callers read
``render_rigged``'s overflow counters where they need them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.eval.metrics import evaluate_image
from riggs_tpu_torch.io.obj import jet_colormap, write_colored_pointcloud_ply
from riggs_tpu_torch.models import skeleton_warp as SW
from riggs_tpu_torch.models.gaussians import Gaussians
from riggs_tpu_torch.render.api import render


@functools.lru_cache(maxsize=None)
def _joint_colors(n_joints: int, device: torch.device) -> torch.Tensor:
    """The (J, 3) jet colours of the joints, made once per (J, device)."""
    with torch.inference_mode(False):
        return torch.as_tensor(jet_colormap(np.linspace(0.0, 1.0, n_joints)), device=device)


def skinning_colors(nn_idx: torch.Tensor, nn_weight: torch.Tensor, n_joints: int) -> torch.Tensor:
    """Per-Gaussian colours: the joints' jet colours blended by skinning weight."""
    colors = _joint_colors(n_joints, nn_weight.device)
    return torch.sum(colors[nn_idx.to(torch.int64)] * nn_weight[..., None], dim=1)


@torch.no_grad()
def dump_skinning_weights_ply(path, gs: Gaussians, skel: SW.SkeletonWarp, t: torch.Tensor | float = 0.0):
    """The alive Gaussians posed at ``t`` as an ASCII point cloud in their
    skinning colours."""
    pose = SW.pose_at(skel, t)
    d = SW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
    colors = skinning_colors(d["nn_idx"], d["nn_weight"], skel.net.n_joints)
    alive = gs.alive.cpu().numpy()
    write_colored_pointcloud_ply(path, (gs.xyz + d["d_xyz"]).cpu().numpy()[alive], colors.cpu().numpy()[alive])


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
    render/depth/alpha/d (and ``skinning_render``, the same view in the
    skinning colours, with ``with_skinning_vis``), the result carries the
    overflow counters and the per-tile hit counts of the main render."""
    bg = torch.zeros(3, device=gs.device) if bg is None else bg
    active_sh = gs.max_sh_degree if active_sh is None else active_sh
    if pose is None:
        pose = SW.pose_at(skel, t)
    d = SW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
    common = dict(d_xyz=d["d_xyz"], d_rotation=d["d_rotation"], d_scaling=torch.zeros_like(d["d_scaling"]),
                  active_sh_degree=active_sh, max_per_tile=max_per_tile)
    out = render(cam, gs, bg, **common)
    result = {
        "render": out["render"],
        "depth": out["depth"],
        "alpha": out["alpha"],
        "d": d,
        "overflow_tiles": out["overflow_tiles"],
        "overflow_rect": out["overflow_rect"],
        "tile_counts": out["tile_counts"],
    }
    if with_skinning_vis:
        colors = skinning_colors(d["nn_idx"], d["nn_weight"], skel.net.n_joints)
        result["skinning_render"] = render(cam, gs, bg, override_color=colors, **common)["render"]
    return result


def render_test_set(
    gs: Gaussians,
    skel: SW.SkeletonWarp,
    frames: list[Frame],
    bg: torch.Tensor | None = None,
    lpips_model=None,
    with_skinning_vis: bool = True,
    max_per_tile: int = 1024,
) -> tuple[list[dict], dict, list[np.ndarray]]:
    """Every frame rendered at its time through its own camera (the first
    frame's size and clip planes) and scored: (per-frame metrics, their
    means, the renders as host arrays). Each frame reads the card twice: its
    metric bundle and its image."""
    rows, images = [], []
    for f in frames:
        cam = dataclasses.replace(frames[0].cam, w2c=f.cam.w2c, intrinsics=f.cam.intrinsics, fid=f.fid)
        out = render_rigged(gs, skel, cam, t=f.fid, bg=bg, with_skinning_vis=with_skinning_vis,
                            max_per_tile=max_per_tile)
        rows.append(evaluate_image(out["render"], f.image, lpips_model))
        images.append(out["render"].cpu().numpy())
    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    return rows, means, images


def format_numerical_res(rows: list[dict], means: dict) -> str:
    """The reference's numerical_res.txt per-frame table."""
    keys = list(rows[0])
    lines = ["frame\t" + "\t".join(keys)]
    for i, r in enumerate(rows):
        lines.append(f"{i}\t" + "\t".join(f"{r[k]:.6f}" for k in keys))
    lines.append("mean\t" + "\t".join(f"{means[k]:.6f}" for k in keys))
    return "\n".join(lines) + "\n"


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
