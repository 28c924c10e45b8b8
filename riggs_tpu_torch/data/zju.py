"""ZJU-MoCap (HumanNeRF layout) dataset reader.

Port of ``riggs_tpu/data/zju.py``: ``cameras.pkl`` and ``mesh_infos.pkl``,
each image and mask undistorted, the SMPL global transform (Rh, Th) folded
into the extrinsics, the per-frame SMPL vertex priors
(``SMPL_prior/<frame>.npy``) as reference points, thinned skeletons
(``train_thinned/``) and semantic labels (``semantic_seg/``), the train views
and the 17 test views, and the init cloud from ``points3d.ply`` (else a
seeded random cloud). Frames live on ``device``.

The reference undistorts with OpenCV; the port has its own ``undistort``,
the arithmetic of ``cv2.undistort`` in numpy: ``initUndistortRectifyMap``'s
closed-form forward model (k1, k2, p1, p2[, k3]) with each source
coordinate rounded to 1/32 pixel, then ``remap``'s bilinear sum in 15-bit
fixed point, the pixels outside the image 0. PIL reads the images.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData, pad_thinned
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.io.ply import read_ply
from riggs_tpu_torch.train.static import compute_scene_extent

ZJU_TEST_CAMERA_IDS = [2, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20, 22, 23]
MAX_THINNED = 4096  # thinned skeleton pixels kept a frame

INTER_BITS = 5  # remap's sub-pixel bits: coordinates in 1/32 pixel
COEF_BITS = 15  # its bilinear weights sum to 2^15


def _source_coords(K: np.ndarray, D: np.ndarray, width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """For each pixel of the undistorted image, where it samples the
    distorted one, in 1/32 pixel (int64, (H, W) each): the pixel's ray
    through K's inverse, distorted by the forward model and projected by K,
    rounded half to even."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).ravel()
    if D.size not in (4, 5):
        raise ValueError(f"distortion coefficients (k1, k2, p1, p2[, k3]) expected, got {D.size}")
    k1, k2, p1, p2 = D[:4]
    k3 = D[4] if D.size == 5 else 0.0
    ir = np.linalg.inv(K)
    j = np.arange(width, dtype=np.float64)[None, :]
    i = np.arange(height, dtype=np.float64)[:, None]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + K[1, 2]
    scale = float(1 << INTER_BITS)
    return np.rint(u * scale).astype(np.int64), np.rint(v * scale).astype(np.int64)


def undistort(image: np.ndarray, K: np.ndarray, D: np.ndarray) -> np.ndarray:
    """``cv2.undistort(image, K, D)`` of a uint8 (H, W) or (H, W, C) image:
    the new camera matrix is K, the pixels that sample outside the image
    are 0 (the image is padded with a zero border and each neighbour's
    coordinate clipped into it)."""
    if image.dtype != np.uint8:
        raise ValueError(f"undistort takes uint8 images, got {image.dtype}")
    h, w = image.shape[:2]
    iu, iv = _source_coords(K, D, w, h)
    tab = 1 << INTER_BITS
    fx, fy = (iu & (tab - 1)).astype(np.int32), (iv & (tab - 1)).astype(np.int32)
    src = np.pad(image.reshape(h, w, -1), ((1, 1), (1, 1), (0, 0))).astype(np.int32).reshape((h + 2) * (w + 2), -1)
    sx, sy = iu >> INTER_BITS, iv >> INTER_BITS
    cols = [np.clip(sx + d, -1, w) + 1 for d in (0, 1)]
    rows = [(np.clip(sy + d, -1, h) + 1) * (w + 2) for d in (0, 1)]
    scale = 1 << (COEF_BITS - 2 * INTER_BITS)  # the weights' products sum to 2^10, the coefficients to 2^15
    acc = np.full((h, w, src.shape[1]), 1 << (COEF_BITS - 1), np.int32)  # rounding
    for r, wy in zip(rows, (tab - fy, fy)):
        for c, wx in zip(cols, (tab - fx, fx)):
            acc += src[r + c] * (wy * wx * scale)[..., None]
    return (acc >> COEF_BITS).astype(np.uint8).reshape(image.shape)


def _rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (cv.Rodrigues)."""
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def apply_global_tfm_to_camera(E: np.ndarray, Rh: np.ndarray, Th: np.ndarray) -> np.ndarray:
    """Fold the SMPL global transform (Rh axis-angle, Th) into the
    extrinsics E: E @ inverse([R(Rh)^T | -R(Rh)^T Th])."""
    global_tfms = np.eye(4)
    global_rot = _rodrigues(np.asarray(Rh).reshape(3)).T
    global_tfms[:3, :3] = global_rot
    global_tfms[:3, 3] = -global_rot @ np.asarray(Th).reshape(3)
    E4 = np.eye(4)
    E4[: E.shape[0], : E.shape[1]] = E
    return E4 @ np.linalg.inv(global_tfms)


def read_zju_cameras(
    path: str | Path,
    smpl_path: str | Path,
    white_background: bool = False,
    train_num: int = -1,
    device: str | torch.device | None = None,
) -> tuple[list[Frame], int]:
    """The frames of one view directory, in ``cameras.pkl``'s order, and the
    train frame count their times are normalized by (``train_num``; -1: this
    directory's count). The SMPL global transform is always folded in (the
    reference's ``with_smpl_pose`` has no caller that turns it off)."""
    from PIL import Image

    dev = resolve_device(device)
    path, smpl_path = Path(path), Path(smpl_path)
    with open(path / "cameras.pkl", "rb") as f:
        cameras = pickle.load(f)
    with open(path / "mesh_infos.pkl", "rb") as f:
        mesh_infos = pickle.load(f)
    if train_num < 0:
        train_num = len(cameras)
    to = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype).to(dev)

    frames = []
    for fname in cameras:
        idx = int(fname.split("_")[-1])
        image = np.asarray(Image.open(path / "images" / f"{fname}.png"))
        mask = np.asarray(Image.open(path / "masks" / f"{fname}.png"))
        intrin = np.asarray(cameras[fname]["intrinsics"])
        extrin = np.asarray(cameras[fname]["extrinsics"])
        D = np.asarray(cameras[fname]["distortions"])
        image = undistort(image, intrin, D)
        mask = undistort(mask, intrin, D)
        mask = (mask[..., 0] > 0) if mask.ndim == 3 else (mask > 0)
        image = image.astype(np.float32)
        image[~mask] = 255.0 if white_background else 0.0
        rgb = image[..., :3] / 255.0

        thinned = thinned_mask = None
        tp_path = path / "train_thinned" / f"{fname}_thinned.png"
        if tp_path.exists():
            coords = np.argwhere(np.asarray(Image.open(tp_path).convert("L")) > 0).astype(np.float32)
            if len(coords):
                tp, tm = pad_thinned(coords, MAX_THINNED)
                thinned, thinned_mask = to(tp), to(tm, torch.bool)

        seg_path = path / "semantic_seg" / f"{fname}_seg.npy"
        seg = to(np.load(seg_path)[0].astype(np.int32), torch.int32) if seg_path.exists() else None
        rp_path = smpl_path / "SMPL_prior" / f"{fname}.npy"
        ref_pts = to(np.load(rp_path).astype(np.float32)) if rp_path.exists() else None

        extrin = apply_global_tfm_to_camera(extrin, mesh_infos[fname]["Rh"], mesh_infos[fname]["Th"])
        cam = make_camera(extrin[:3, :3].T, extrin[:3, 3], rgb.shape[1], rgb.shape[0], K=intrin,
                          fid=idx / max(train_num - 1, 1), device=dev)
        frames.append(Frame(cam=cam, image=to(rgb), alpha_mask=to(mask.astype(np.float32)), thinned=thinned,
                            thinned_mask=thinned_mask, semantic_seg=seg, reference_points=ref_pts))
    return frames, train_num


def load_zju_scene(
    path: str | Path,
    white_background: bool = False,
    n_init_points: int = 100_000,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> SceneData:
    """A subject directory: ``train/`` and the ``test/view_XX/`` of the 17
    ZJU test cameras that exist, the init cloud from ``points3d.ply`` (colours /255, else grey) or, when
    it is absent, ``n_init_points`` random points in [-1.3, 1.3]^3 with
    random colours from ``seed``."""
    dev = resolve_device(device)
    path = Path(path)
    train, train_num = read_zju_cameras(path / "train", path, white_background, device=dev)
    test = []
    for cid in ZJU_TEST_CAMERA_IDS:
        view = path / "test" / f"view_{cid:02d}"
        if view.exists():
            test += read_zju_cameras(view, path, white_background, train_num=train_num, device=dev)[0]

    ply = path / "points3d.ply"
    if ply.exists():
        cols = read_ply(ply)
        pts = np.stack([cols["x"], cols["y"], cols["z"]], -1)
        rgbs = (np.stack([cols[k] for k in ("red", "green", "blue")], -1) / 255.0 if "red" in cols
                else np.full((len(pts), 3), 0.5, np.float32))
    else:
        rng = np.random.default_rng(seed)
        pts = rng.random((n_init_points, 3)).astype(np.float32) * 2.6 - 1.3
        rgbs = rng.random((n_init_points, 3)).astype(np.float32)
    return SceneData(
        init_points=pts,
        init_colors=rgbs,
        is_blender=False,
        train_frames=train,
        test_frames=test,
        cameras_extent=compute_scene_extent([f.cam for f in train]),
        white_background=white_background,
    )
