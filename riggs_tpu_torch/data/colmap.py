"""COLMAP scene reader (binary and text model formats).

Port of ``riggs_tpu/data/colmap.py``: ``cameras``, ``images`` and
``points3D`` of ``sparse/0`` (or ``sparse``) in COLMAP's binary layout,
else its text layout; the pinhole intrinsics of the SIMPLE_PINHOLE,
PINHOLE, SIMPLE_RADIAL, RADIAL and OPENCV models (their distortion is not
applied, as in the reference); ``qvec2rotmat``; frame times from the sorted
image names; the sparse cloud as the init cloud; every ``llffhold``-th
frame held out for test. Frames live on ``device``; PIL reads the images.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData, pad_thinned, thin_mask_skeleton
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.train.static import compute_scene_extent

# COLMAP camera model ids -> (name, n_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read_next_bytes(f, num_bytes, fmt):
    return struct.unpack("<" + fmt, f.read(num_bytes))


def read_cameras_binary(path: Path) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read_next_bytes(f, 24, "iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = _read_next_bytes(f, 8 * n_params, "d" * n_params)
            cams[cam_id] = dict(model=name, width=int(w), height=int(h), params=np.array(params))
    return cams


def read_images_binary(path: Path) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read_next_bytes(f, 64, "idddddddi")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read_next_bytes(f, 8, "Q")
            f.read(24 * n_pts)  # the 2D points
            images[image_id] = dict(qvec=np.array([qw, qx, qy, qz]), tvec=np.array([tx, ty, tz]), camera_id=cam_id,
                                    name=name.decode())
    return images


def read_points3d_binary(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        xyz = np.zeros((n, 3))
        rgb = np.zeros((n, 3))
        for i in range(n):
            vals = _read_next_bytes(f, 43, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            (track_len,) = _read_next_bytes(f, 8, "Q")
            f.read(8 * track_len)
    return xyz.astype(np.float32), (rgb / 255.0).astype(np.float32)


def read_cameras_text(path: Path) -> dict:
    cams = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = dict(model=parts[1], width=int(parts[2]), height=int(parts[3]),
                                   params=np.array([float(x) for x in parts[4:]]))
    return cams


def read_images_text(path: Path) -> dict:
    images = {}
    lines = [l for l in Path(path).read_text().splitlines() if not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        if len(parts) < 10:
            continue
        images[int(parts[0])] = dict(qvec=np.array([float(x) for x in parts[1:5]]),
                                     tvec=np.array([float(x) for x in parts[5:8]]), camera_id=int(parts[8]),
                                     name=parts[9])
    return images


def read_points3d_text(path: Path) -> tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        xyz.append([float(x) for x in parts[1:4]])
        rgb.append([float(x) for x in parts[4:7]])
    return np.asarray(xyz, np.float32), np.asarray(rgb, np.float32) / 255.0


def _intrinsics_from_colmap(cam: dict) -> np.ndarray:
    p = cam["params"]
    if cam["model"] in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:  # PINHOLE and the models whose first four are fx, fy, cx, cy
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def load_colmap_scene(
    path: str | Path,
    images_dir: str = "images",
    eval_split: bool = True,
    llffhold: int = 8,
    resolution: int = 1,
    max_thinned: int = 2048,
    load_masks: bool = False,
    device: str | torch.device | None = None,
) -> SceneData:
    """``sparse/0`` (the binary model where present) and ``images_dir``; with
    ``load_masks``, ``masks/<stem>.png`` as alpha masks and their thinned
    skeletons. Frame times from the sorted image names."""
    from PIL import Image

    dev = resolve_device(device)
    to = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype).to(dev)
    path = Path(path)
    sparse = path / "sparse" / "0"
    if not sparse.exists():
        sparse = path / "sparse"
    if (sparse / "cameras.bin").exists():
        cams = read_cameras_binary(sparse / "cameras.bin")
        images_meta = read_images_binary(sparse / "images.bin")
        xyz, rgb = read_points3d_binary(sparse / "points3D.bin")
    else:
        cams = read_cameras_text(sparse / "cameras.txt")
        images_meta = read_images_text(sparse / "images.txt")
        xyz, rgb = read_points3d_text(sparse / "points3D.txt")

    metas = sorted(images_meta.values(), key=lambda m: m["name"])
    n = len(metas)
    frames = []
    for idx, m in enumerate(metas):
        K = _intrinsics_from_colmap(cams[m["camera_id"]])
        R = qvec2rotmat(m["qvec"]).T  # the camera-to-world rotation (the reference's convention)
        image = Image.open(path / images_dir / m["name"])
        if resolution > 1:
            image = image.resize((image.width // resolution, image.height // resolution), Image.LANCZOS)
            K = K / resolution
            K[2, 2] = 1.0
        rgb_img = np.asarray(image.convert("RGB"), np.float32) / 255.0
        cam = make_camera(R, m["tvec"], rgb_img.shape[1], rgb_img.shape[0], K=K, fid=idx / max(n - 1, 1), device=dev)
        mask = thinned = thinned_mask = None
        mask_path = path / "masks" / (Path(m["name"]).stem + ".png")
        if load_masks and mask_path.exists():
            marr = np.asarray(Image.open(mask_path).convert("L"), np.float32) / 255.0
            if resolution > 1:
                marr = marr[::resolution, ::resolution]
            mask = to(marr)
            coords = thin_mask_skeleton(marr)
            if len(coords):
                tp, tm = pad_thinned(coords, max_thinned)
                thinned, thinned_mask = to(tp), to(tm, torch.bool)
        frames.append(Frame(cam=cam, image=to(rgb_img), alpha_mask=mask, thinned=thinned, thinned_mask=thinned_mask))

    if eval_split:
        train = [f for i, f in enumerate(frames) if i % llffhold != 0]
        test = [f for i, f in enumerate(frames) if i % llffhold == 0]
    else:
        train, test = frames, []
    return SceneData(
        init_points=xyz,
        init_colors=rgb,
        is_blender=False,
        train_frames=train,
        test_frames=test,
        cameras_extent=compute_scene_extent([f.cam for f in train]),
        white_background=False,
    )
