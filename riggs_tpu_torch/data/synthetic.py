"""Procedural articulated scenes with exact ground truth.

Port of ``riggs_tpu/data/synthetic.py:26-310``: a capsule-limb figure of
Gaussian blobs (the three-joint chain or the eleven-joint biped) animated by
a known skeleton, cameras on a ring, and ground-truth frames rendered by the
exact oracle (``render/oracle.py``): images, alpha masks and the masks'
thinned 2D skeletons. ``make_scene_data`` builds a ``SceneData`` for the
training loops. The figures, poses and point clouds are numpy from the
same seeds as the reference's, so both packages build the same scene.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera, make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData, pad_thinned, thin_mask_skeleton
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.ops.fk import forward_kinematics
from riggs_tpu_torch.ops.quaternion import quat_to_rotmat
from riggs_tpu_torch.render.oracle import rasterize_oracle
from riggs_tpu_torch.train.static import compute_scene_extent


def ring_cameras(
    n: int,
    radius: float = 3.0,
    height: float = 0.6,
    width: int = 128,
    image_height: int = 128,
    fov: float = 0.9,
    fids: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> list[Camera]:
    """n cameras on a ring looking at the origin (a blender-style orbit)."""
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(a), height, radius * np.sin(a)])
        z = -pos / np.linalg.norm(pos)  # forward, towards the origin
        up = np.array([0.0, -1.0, 0.0])  # view-space y points down
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1)  # camera-to-world rotation
        T = -R.T @ pos
        fid = float(fids[i]) if fids is not None else 0.0
        cams.append(make_camera(R, T, width, image_height, fovx=fov, fovy=fov, fid=fid, device=device))
    return cams


@dataclasses.dataclass
class StickFigure:
    """An articulated figure of Gaussian blobs with known skinning."""

    points: np.ndarray  # (N, 3) rest positions
    colors: np.ndarray  # (N, 3)
    scales: np.ndarray  # (N, 3)
    opacity: np.ndarray  # (N,)
    joints: np.ndarray  # (J, 3) rest joints
    parents: tuple  # (J,)
    skin_idx: np.ndarray  # (N,) rigid bone assignment (joint index)
    # (joint, axis 0|1|2, amplitude scale, phase) per animated joint, read by
    # pose_at_time; empty means the two-segment chain's animation
    anim: tuple = ()


def make_stick_figure(seed: int = 0, points_per_seg: int = 120) -> StickFigure:
    """A three-joint chain: root at the origin's foot, two segments up."""
    rng = np.random.default_rng(seed)
    joints = np.array([[0.0, -0.6, 0.0], [0.0, 0.0, 0.0], [0.0, 0.6, 0.0]], np.float32)
    parents = (0, 0, 1)
    segs = [(joints[0], joints[1], 1), (joints[1], joints[2], 2)]
    pts, cols, skin = [], [], []
    palette = np.array([[0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.2, 0.3, 0.9]], np.float32)
    for a, b, j in segs:
        t = rng.uniform(size=(points_per_seg, 1)).astype(np.float32)
        core = a + t * (b - a)
        off = rng.normal(size=(points_per_seg, 3)).astype(np.float32) * 0.05
        pts.append(core + off)
        cols.append(np.tile(palette[j][None], (points_per_seg, 1)))
        skin.append(np.full(points_per_seg, j))
    points = np.concatenate(pts)
    n = points.shape[0]
    return StickFigure(
        points=points,
        colors=np.concatenate(cols),
        scales=np.full((n, 3), 0.035, np.float32),
        opacity=np.full(n, 0.9, np.float32),
        joints=joints,
        parents=parents,
        skin_idx=np.concatenate(skin),
    )


def make_biped_figure(seed: int = 0, points_per_seg: int = 120) -> StickFigure:
    """An eleven-joint biped: torso, head, two two-segment arms and legs."""
    rng = np.random.default_rng(seed)
    joints = np.array(
        [
            [0.0, -0.10, 0.0],   # 0 pelvis (root)
            [0.0, 0.35, 0.0],    # 1 chest
            [0.0, 0.70, 0.0],    # 2 head
            [-0.35, 0.33, 0.0],  # 3 L elbow
            [-0.62, 0.08, 0.0],  # 4 L hand
            [0.35, 0.33, 0.0],   # 5 R elbow
            [0.62, 0.08, 0.0],   # 6 R hand
            [-0.16, -0.50, 0.0], # 7 L knee
            [-0.20, -0.92, 0.0], # 8 L foot
            [0.16, -0.50, 0.0],  # 9 R knee
            [0.20, -0.92, 0.0],  # 10 R foot
        ],
        np.float32,
    )
    parents = (0, 0, 1, 1, 3, 1, 5, 0, 7, 0, 9)
    segs = [(parents[j], j) for j in range(1, len(parents))]
    rng_cols = np.random.default_rng(7)
    palette = rng_cols.uniform(0.15, 0.95, size=(len(parents), 3)).astype(np.float32)
    pts, cols, skin = [], [], []
    for p, j in segs:
        t = rng.uniform(size=(points_per_seg, 1)).astype(np.float32)
        core = joints[p] + t * (joints[j] - joints[p])
        off = rng.normal(size=(points_per_seg, 3)).astype(np.float32) * 0.04
        pts.append(core + off)
        cols.append(np.tile(palette[j][None], (points_per_seg, 1)))
        skin.append(np.full(points_per_seg, j))
    points = np.concatenate(pts)
    n = points.shape[0]
    # swinging arms and legs in anti-phase, a head nod and a torso sway
    anim = (
        (3, 2, 1.0, 0.0), (5, 2, -1.0, 0.0),     # shoulders (z swing)
        (4, 2, 0.5, 0.9), (6, 2, -0.5, 0.9),     # elbows
        (7, 0, 0.8, np.pi), (9, 0, -0.8, np.pi), # hips (x swing)
        (8, 0, 0.4, 1.2), (10, 0, -0.4, 1.2),    # knees
        (2, 0, 0.25, 0.5), (1, 2, 0.15, 2.0),    # head nod, torso sway
    )
    return StickFigure(
        points=points,
        colors=np.concatenate(cols),
        scales=np.full((n, 3), 0.030, np.float32),
        opacity=np.full(n, 0.9, np.float32),
        joints=joints,
        parents=parents,
        skin_idx=np.concatenate(skin),
        anim=anim,
    )


def pose_at_time(fig: StickFigure, t: float, amplitude: float = 0.7) -> np.ndarray:
    """Ground-truth per-joint local rotations (J, 4) at normalized time t."""
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (len(fig.parents), 1))
    if fig.anim:
        axes = np.eye(3, dtype=np.float32)
        for j, ax, amp, phase in fig.anim:
            ang = amplitude * amp * np.sin(2 * np.pi * t + phase)
            a = axes[ax] * np.sin(ang / 2)
            quats[j] = [np.cos(ang / 2), a[0], a[1], a[2]]
        return quats
    angle1 = amplitude * np.sin(2 * np.pi * t)
    angle2 = 0.5 * amplitude * np.sin(2 * np.pi * t + 1.3)
    for j, ang in ((1, angle1), (2, angle2)):
        quats[j] = [np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)]  # about z
    return quats


def deform_points(fig: StickFigure, quats: np.ndarray) -> np.ndarray:
    """Rigidly skin the points by their bone's global transform (exact LBS).
    The forward kinematics runs in float32 on the CPU."""
    rots = quat_to_rotmat(torch.as_tensor(quats, dtype=torch.float32))
    _, G = forward_kinematics(rots, torch.as_tensor(fig.joints, dtype=torch.float32), fig.parents)
    G = G.numpy()
    Rg = G[fig.skin_idx, :3, :3]
    tg = G[fig.skin_idx, :3, 3]
    return np.einsum("nab,nb->na", Rg, fig.points) + tg


def _oracle(fig: StickFigure, pts: np.ndarray, cam: Camera, bg: np.ndarray) -> dict:
    dev = cam.device
    n = pts.shape[0]
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    return rasterize_oracle(cam, as_t(pts), as_t(fig.colors), as_t(fig.opacity), as_t(fig.scales), as_t(rot),
                            as_t(bg))


def render_frame(fig: StickFigure, cam: Camera, t: float | None = None, bg: np.ndarray | None = None) -> np.ndarray:
    """Ground-truth render (H, W, 3) at time t (None: the rest pose)."""
    pts = fig.points if t is None else deform_points(fig, pose_at_time(fig, t))
    bg = np.zeros(3, np.float32) if bg is None else bg
    return _oracle(fig, pts, cam, bg)["image"].cpu().numpy()


def make_dataset(
    n_cams: int = 8,
    n_frames: int = 8,
    width: int = 128,
    height: int = 128,
    seed: int = 0,
    dynamic: bool = True,
    device: str | torch.device | None = None,
):
    """A small D-NeRF-style dataset: one camera per (view, time) pair.
    Returns (figure, [(camera, image), ...])."""
    dev = resolve_device(device)
    fig = make_stick_figure(seed)
    fids = np.linspace(0, 1, n_frames, endpoint=False) if dynamic else np.zeros(n_frames)
    cams = ring_cameras(n_cams, width=width, image_height=height, device=dev)
    data = []
    for i in range(n_frames):
        cam = dataclasses.replace(cams[i % n_cams], fid=torch.tensor(fids[i], dtype=torch.float32, device=dev))
        data.append((cam, render_frame(fig, cam, fids[i] if dynamic else None)))
    return fig, data


def make_scene_data(
    n_train: int = 12,
    n_test: int = 3,
    n_cams: int = 8,
    width: int = 96,
    height: int = 96,
    seed: int = 0,
    max_thinned: int = 256,
    n_init_points: int = 300,
    render_gt: bool = True,
    figure: str = "chain",
    points_per_seg: int = 120,
    device: str | torch.device | None = None,
):
    """A ``SceneData`` with images, alpha masks and padded thinned 2D
    skeletons, D-NeRF style (train frames evenly spaced in time, test frames
    at seeded times from other cameras), and a seeded initial cloud of
    ``n_init_points`` jittered figure points. Returns (figure, scene)."""
    dev = resolve_device(device)
    mk = make_biped_figure if figure == "biped" else make_stick_figure
    fig = mk(seed, points_per_seg=points_per_seg)
    rng = np.random.default_rng(seed)
    cams = ring_cameras(n_cams, width=width, image_height=height, device=dev)

    def build_frames(fids, cam_offset=0):
        frames = []
        for i, t in enumerate(fids):
            cam = dataclasses.replace(cams[(i + cam_offset) % n_cams],
                                      fid=torch.tensor(t, dtype=torch.float32, device=dev))
            if not render_gt:  # cameras and shapes only
                frames.append(Frame(
                    cam=cam, image=torch.zeros((height, width, 3), device=dev),
                    alpha_mask=torch.zeros((height, width), device=dev),
                    thinned=torch.zeros((max_thinned, 2), device=dev),
                    thinned_mask=torch.zeros(max_thinned, dtype=torch.bool, device=dev),
                ))
                continue
            out = _oracle(fig, deform_points(fig, pose_at_time(fig, t)), cam, np.zeros(3, np.float32))
            alpha = out["alpha"].cpu().numpy()
            tp, tm = pad_thinned(thin_mask_skeleton(alpha > 0.5), max_thinned)
            frames.append(Frame(
                cam=cam, image=out["image"], alpha_mask=out["alpha"],
                thinned=torch.as_tensor(tp, device=dev), thinned_mask=torch.as_tensor(tm, device=dev),
            ))
        return frames

    train_fids = np.linspace(0, 1, n_train, endpoint=False)
    test_fids = rng.uniform(size=n_test)
    train = build_frames(train_fids)
    test = build_frames(test_fids, cam_offset=3)
    # the requested cloud size: drawn with replacement when the figure has
    # fewer points (the 0.02 jitter separates the duplicates)
    sel = rng.choice(len(fig.points), n_init_points, replace=len(fig.points) < n_init_points)
    init_pts = fig.points[sel] + rng.normal(size=(len(sel), 3)).astype(np.float32) * 0.02
    scene = SceneData(
        init_points=init_pts,
        init_colors=fig.colors[sel],
        is_blender=True,
        train_frames=train,
        test_frames=test,
        cameras_extent=compute_scene_extent(cams),
        white_background=False,
    )
    return fig, scene
