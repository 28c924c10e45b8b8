"""Blender / D-NeRF dataset reader (the transforms_train.json format).

Port of ``riggs_tpu/data/blender.py``: NeRF c2w matrices converted with the
reference's axis flips, each frame's time from its ``time`` field (or its
index), images composited on the background by their alpha, thinned 2D
skeletons from ``train_thinned/<name>_thinned.png`` (or thinned from the
alpha mask), semantic labels from ``semantic_seg/<name>_seg.npy``, and a
seeded random init cloud. Frames live on ``device`` (``cuda`` unless told
otherwise); PIL is imported when a scene is read.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import focal2fov, fov2focal, make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData, pad_thinned, thin_mask_skeleton
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.train.static import compute_scene_extent


def _nerf_c2w_to_rt(c2w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """NeRF/blender c2w -> (R, T) in the reference's camera convention."""
    matrix = np.linalg.inv(np.asarray(c2w))
    R = -matrix[:3, :3].T
    R[:, 0] = -R[:, 0]
    T = -matrix[:3, 3]
    return R, T


def read_transforms(
    path: str | Path,
    transforms_file: str,
    white_background: bool = False,
    resolution: int = 1,
    max_thinned: int = 2048,
    compute_thinned: bool = True,
    device: str | torch.device | None = None,
) -> tuple[list[Frame], list[str]]:
    """The frames of one transforms file, sorted by the number ending their
    file name, and their image names."""
    from PIL import Image

    dev = resolve_device(device)
    path = Path(path)
    contents = json.loads((path / transforms_file).read_text())
    fovx = contents["camera_angle_x"]
    frames_json = sorted(contents["frames"], key=lambda x: int(Path(x["file_path"]).name.split(".")[0].split("_")[-1]))
    to = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype).to(dev)
    frames, names = [], []
    for idx, fr in enumerate(frames_json):
        fp = fr["file_path"]
        img_path = path / (fp if fp.endswith((".png", ".jpg")) else fp + ".png")
        fid = fr.get("time", idx / len(frames_json))
        image = Image.open(img_path)
        if resolution > 1:
            image = image.resize((image.width // resolution, image.height // resolution), Image.LANCZOS)
        im = np.asarray(image.convert("RGBA"), np.float32) / 255.0
        mask = im[..., 3]
        bg = np.ones(3, np.float32) if white_background else np.zeros(3, np.float32)
        rgb = im[..., :3] * im[..., 3:4] + bg * (1.0 - im[..., 3:4])

        R, T = _nerf_c2w_to_rt(fr["transform_matrix"])
        H, W = rgb.shape[:2]
        fovy = focal2fov(fov2focal(fovx, W), H)
        cam = make_camera(R, T, W, H, fovx=fovx, fovy=fovy, fid=float(fid), device=dev)

        name = img_path.stem
        thinned_path = path / "train_thinned" / f"{name}_thinned.png"
        if thinned_path.exists():
            coords = np.argwhere(np.asarray(Image.open(thinned_path).convert("L")) > 0).astype(np.float32)
            if resolution > 1:
                coords = coords / resolution
        elif compute_thinned:
            coords = thin_mask_skeleton(mask)
        else:
            coords = None
        thinned = thinned_mask = None
        if coords is not None and len(coords) > 0:
            tp, tm = pad_thinned(coords, max_thinned)
            thinned, thinned_mask = to(tp), to(tm, torch.bool)

        seg_path = path / "semantic_seg" / f"{name}_seg.npy"
        seg = to(np.load(seg_path)[0].astype(np.int32), torch.int32) if seg_path.exists() else None
        frames.append(Frame(cam=cam, image=to(rgb), alpha_mask=to(mask), thinned=thinned,
                            thinned_mask=thinned_mask, semantic_seg=seg))
        names.append(name)
    return frames, names


def load_blender_scene(
    path: str | Path,
    white_background: bool = False,
    resolution: int = 1,
    n_init_points: int = 100_000,
    seed: int = 0,
    max_thinned: int = 2048,
    device: str | torch.device | None = None,
) -> SceneData:
    """A D-NeRF scene: the train and (when present) test transforms and a
    random init cloud of ``n_init_points`` in [-1.3, 1.3]^3 with random
    colours, drawn from ``seed``."""
    dev = resolve_device(device)
    path = Path(path)
    train, train_names = read_transforms(path, "transforms_train.json", white_background, resolution, max_thinned,
                                         device=dev)
    test = []
    if (path / "transforms_test.json").exists():
        test = read_transforms(path, "transforms_test.json", white_background, resolution, max_thinned,
                               device=dev)[0]
    rng = np.random.default_rng(seed)
    pts = (rng.random((n_init_points, 3)).astype(np.float32) * 2.6) - 1.3
    cols = rng.random((n_init_points, 3)).astype(np.float32)
    return SceneData(
        init_points=pts,
        init_colors=cols,
        train_frames=train,
        test_frames=test,
        cameras_extent=compute_scene_extent([f.cam for f in train]),
        is_blender=True,
        white_background=white_background,
        train_image_names=train_names,
    )
