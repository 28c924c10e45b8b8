"""DTU, Plenoptic video (Neu3D) and CMU Panoptic readers.

Port of ``riggs_tpu/data/more_readers.py``, pure numpy as there:

  * DTU (the NeuS layout): ``cameras_sphere.npz`` with each image's
    ``world_mat``, ``scale_mat`` and ``fid``, images masked by ``mask/``,
    the projection matrix decomposed by an RQ decomposition
    (``decompose_projection``, ``load_K_Rt_from_P``) and the reference's
    pose axis swaps;
  * Plenoptic video: LLFF ``poses_bounds.npy``, a directory of frames per
    camera, the cameras of ``hold_id`` held out for test;
  * CMU Panoptic: ``{train,test}_meta.json`` with each timestep's and
    camera's K and w2c, ``seg/`` masks as alpha, the cameras normalized and
    recentred on ``init_pt_cld.npz``'s cloud.

Frames live on ``device``; PIL reads the images.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import focal2fov, make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.train.static import compute_scene_extent


def _to(dev):
    return lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)


def decompose_projection(P: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(K, R, camera centre) of a 3x4 projection matrix (what
    ``cv2.decomposeProjectionMatrix`` gives), by an RQ decomposition."""
    M = P[:3, :3]
    E = np.asarray([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=M.dtype)
    Q, R_ = np.linalg.qr((E @ M).T)
    K = E @ R_.T @ E
    R = E @ Q.T
    # positive diagonal
    S = np.diag(np.sign(np.diag(K)))
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    center = -np.linalg.solve(M, P[:3, 3])
    return K, R, center


def load_K_Rt_from_P(P: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K (normalized) and the 4x4 camera pose (R^T | centre)."""
    K, R, center = decompose_projection(P)
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = center
    return K, pose


def load_dtu_scene(
    path: str | Path,
    render_camera: str = "cameras_sphere.npz",
    white_background: bool = False,
    n_init_points: int = 100_000,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> SceneData:
    """A DTU scene: every image a train frame, its time ``fid / (n / 12 -
    1)``, a random init cloud from ``seed``."""
    from PIL import Image

    dev = resolve_device(device)
    to = _to(dev)
    path = Path(path)
    cams_npz = np.load(path / render_camera)
    images = sorted((path / "image").glob("*.png"))
    masks = sorted((path / "mask").glob("*.png"))
    n_images = len(images)
    frames, names = [], []
    for idx, (img_path, msk_path) in enumerate(zip(images, masks)):
        image = np.asarray(Image.open(img_path), np.float32) / 255.0
        mask = np.asarray(Image.open(msk_path), np.float32) / 255.0
        if mask.ndim == 3:
            mask = mask[..., 0]
        rgb = image[..., :3] * mask[..., None]
        world_mat = cams_npz[f"world_mat_{idx}"].astype(np.float32)
        scale_mat = cams_npz[f"scale_mat_{idx}"].astype(np.float32)
        fid = float(cams_npz[f"fid_{idx}"]) / (n_images / 12 - 1)
        K, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])

        # the reference's pose axis swaps, flips and halved translation
        a, b, c = pose[0:1], pose[1:2], pose[2:3]
        pose = np.concatenate([a, -c, -b, pose[3:]], 0)
        S = np.eye(3, dtype=np.float32)
        S[1, 1] = S[2, 2] = -1
        pose[1, 3] = -pose[1, 3]
        pose[2, 3] = -pose[2, 3]
        pose[:3, :3] = S @ pose[:3, :3] @ S
        a, b, c = pose[0:1], pose[1:2], pose[2:3]
        pose = np.concatenate([a, c, b, pose[3:]], 0)
        pose[:, 3] *= 0.5

        matrix = np.linalg.inv(pose)
        R = -matrix[:3, :3].T
        R[:, 0] = -R[:, 0]
        T = -matrix[:3, 3]
        H, W = rgb.shape[:2]
        cam = make_camera(R, T, W, H, fovx=focal2fov(K[0, 0], W), fovy=focal2fov(K[0, 0], H), fid=fid, device=dev)
        frames.append(Frame(cam=cam, image=to(rgb), alpha_mask=to(mask)))
        names.append(img_path.stem)

    rng = np.random.default_rng(seed)
    pts = (rng.random((n_init_points, 3)).astype(np.float32) * 2.6) - 1.3
    cols = rng.random((n_init_points, 3)).astype(np.float32)
    return SceneData(init_points=pts, init_colors=cols, is_blender=False, train_frames=frames,
                     cameras_extent=compute_scene_extent([f.cam for f in frames]),
                     white_background=white_background, train_image_names=names)


def load_plenoptic_scene(
    path: str | Path,
    num_images: int = 24,
    hold_id: tuple[int, ...] = (0,),
    eval_split: bool = True,
    white_background: bool = False,
    n_init_points: int = 100_000,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> SceneData:
    """A Plenoptic-video scene: the first ``num_images`` frames of each
    camera, times ``i / (num_images - 1)``, the ``hold_id`` cameras the test
    set (all train without ``eval_split``), a random init cloud."""
    from PIL import Image

    dev = resolve_device(device)
    to = _to(dev)
    path = Path(path)
    poses_bounds = np.load(path / "poses_bounds.npy")
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    H, W, focal = poses[0, :, -1]
    n_cameras = poses.shape[0]
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    bottoms = np.broadcast_to(np.array([0, 0, 0, 1.0]), (n_cameras, 1, 4))
    poses = np.concatenate([poses, bottoms], axis=1) @ np.diag([1.0, -1, -1, 1])
    video_paths = sorted((path / "frames").iterdir())

    def read_split(cam_ids):
        frames, names = [], []
        for i in cam_ids:
            matrix = np.linalg.inv(poses[i])
            R, T = matrix[:3, :3].T, matrix[:3, 3]
            for idx, image_name in enumerate(sorted(p.name for p in video_paths[i].iterdir())[:num_images]):
                img = np.asarray(Image.open(video_paths[i] / image_name).convert("RGB"), np.float32) / 255.0
                h, w = img.shape[:2]
                cam = make_camera(R, T, w, h, fovx=focal2fov(focal, w), fovy=focal2fov(focal, h),
                                  fid=idx / (num_images - 1), device=dev)
                frames.append(Frame(cam=cam, image=to(img)))
                names.append(f"{video_paths[i].name}_{Path(image_name).stem}")
        return frames, names

    test_ids = sorted(set(hold_id) & set(range(n_cameras)))
    train_ids = sorted(set(range(n_cameras)) - set(hold_id))
    train, train_names = read_split(train_ids)
    test, _ = read_split(test_ids)
    if not eval_split:
        train, test = train + test, []

    rng = np.random.default_rng(seed)
    pts = (rng.random((n_init_points, 3)).astype(np.float32) * 2.6) - 1.3
    cols = rng.random((n_init_points, 3)).astype(np.float32)
    return SceneData(init_points=pts, init_colors=cols, is_blender=False, train_frames=train, test_frames=test,
                     cameras_extent=compute_scene_extent([f.cam for f in train]),
                     white_background=white_background, train_image_names=train_names)


def load_cmu_scene(
    path: str | Path,
    num_timesteps: int = 20,
    apply_cam_norm: bool = True,
    recenter_by_pcl: bool = True,
    white_background: bool = False,
    device: str | torch.device | None = None,
) -> SceneData:
    """A CMU Panoptic scene: the first ``num_timesteps`` timesteps of every
    camera, times ``t / 150``; with ``apply_cam_norm`` the cameras and the
    cloud moved to the rig's centre and scaled by its radius, with
    ``recenter_by_pcl`` then moved to the cloud's mean."""
    from PIL import Image

    dev = resolve_device(device)
    to = _to(dev)
    path = Path(path)

    def read_split(split):
        md = json.loads((path / f"{split}_meta.json").read_text())
        frames, names = [], []
        for t in range(min(num_timesteps, len(md["fn"]))):
            for c in range(len(md["fn"][t])):
                w, h, k, w2c = md["w"], md["h"], md["k"][t][c], np.asarray(md["w2c"][t][c], np.float32)
                name = md["fn"][t][c]
                img = np.asarray(Image.open(path / "ims" / name).convert("RGB"), np.float32) / 255.0
                seg_path = path / "seg" / name.replace(".jpg", ".png")
                seg = None
                if seg_path.exists():
                    seg = np.asarray(Image.open(seg_path), np.float32)
                    if seg.ndim == 3:
                        seg = seg[..., 0]
                fx, fy = k[0][0], k[1][1]
                cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], w, h, fovx=2 * np.arctan(w / (2 * fx)),
                                  fovy=2 * np.arctan(h / (2 * fy)), fid=t / 150.0, device=dev)
                frames.append(Frame(cam=cam, image=to(img), alpha_mask=None if seg is None else to(seg)))
                names.append(name)
        return frames, names

    train, train_names = read_split("train")
    test = read_split("test")[0] if (path / "test_meta.json").exists() else []

    cams = [f.cam for f in train]
    radius = compute_scene_extent(cams)
    centers = np.stack([np.linalg.inv(c.w2c.cpu().numpy())[:3, 3] for c in cams])
    translate = -centers.mean(0)
    pcd = np.load(path / "init_pt_cld.npz")["data"]
    xyz = pcd[:, :3].astype(np.float32)
    cols = pcd[:, 3:6].astype(np.float32)

    def retranslate(frames, delta, scale=1.0):
        out = []
        for f in frames:
            c2w = np.linalg.inv(f.cam.w2c.cpu().numpy())
            c2w[:3, 3] = (c2w[:3, 3] + delta) / scale
            new_w2c = np.linalg.inv(c2w).astype(np.float32)
            fx, fy = (float(v) for v in f.cam.intrinsics[:2].cpu())
            cam = make_camera(new_w2c[:3, :3].T, new_w2c[:3, 3], f.cam.width, f.cam.height,
                              fovx=2 * np.arctan(f.cam.width / (2 * fx)), fovy=2 * np.arctan(f.cam.height / (2 * fy)),
                              fid=float(f.cam.fid), device=dev)
            out.append(Frame(cam=cam, image=f.image, alpha_mask=f.alpha_mask))
        return out

    if apply_cam_norm:
        train = retranslate(train, translate, radius)
        test = retranslate(test, translate, radius) if test else []
        xyz = (xyz + translate) / radius
    if recenter_by_pcl:
        center = xyz.mean(0)
        train = retranslate(train, -center)
        test = retranslate(test, -center) if test else []
        xyz = xyz - center
    return SceneData(init_points=xyz, init_colors=cols, is_blender=False, train_frames=train, test_frames=test,
                     cameras_extent=compute_scene_extent([f.cam for f in train]),
                     white_background=white_background, train_image_names=train_names)
