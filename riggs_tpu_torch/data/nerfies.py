"""Nerfies / HyperNeRF dataset reader (dataset.json and a json per camera).

Port of ``riggs_tpu/data/nerfies.py``. The scene layout:

  dataset.json      {ids, train_ids, val_ids}
  metadata.json     {id: {time_id (or warp_id), camera_id}}
  scene.json        {scale, center} (optional)
  camera/<id>.json  {orientation (3x3 world-to-camera rows), position,
                     focal_length, principal_point, image_size}
  rgb/<N>x/<id>.png

Focal length and principal point are divided by the scale ``N``; a
principal point at 0 falls back to the image centre. Frames live on
``device``; PIL reads the images.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData, pad_thinned, thin_mask_skeleton
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.train.static import compute_scene_extent


def load_nerfies_scene(
    path: str | Path,
    scale_dir: int = 2,
    white_background: bool = False,
    n_init_points: int = 100_000,
    seed: int = 0,
    max_thinned: int = 2048,
    compute_thinned: bool = False,
    device: str | torch.device | None = None,
) -> SceneData:
    """The train ids' frames and the others' as test frames, each frame's
    time its time id over the largest; the init cloud ``points.npy``
    (recentred and scaled, grey) or ``n_init_points`` random points from
    ``seed``; with ``compute_thinned``, the thinned skeleton of each image's
    non-black pixels."""
    from PIL import Image

    dev = resolve_device(device)
    to = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype).to(dev)
    path = Path(path)
    ds = json.loads((path / "dataset.json").read_text())
    meta = json.loads((path / "metadata.json").read_text())
    scene_meta = json.loads((path / "scene.json").read_text()) if (path / "scene.json").exists() else {}
    coord_scale = scene_meta.get("scale", 1.0)
    scene_center = np.asarray(scene_meta.get("center", [0.0, 0.0, 0.0]))

    all_ids = ds["ids"]
    train_ids = set(ds.get("train_ids", all_ids))
    time_id = lambda i: int(meta[i].get("time_id", meta[i].get("warp_id", 0)))
    max_time = max(time_id(i) for i in all_ids) or 1

    def build(img_id):
        cam_js = json.loads((path / "camera" / f"{img_id}.json").read_text())
        orientation = np.asarray(cam_js["orientation"])  # world-to-camera rotation rows
        position = (np.asarray(cam_js["position"]) - scene_center) * coord_scale
        focal = cam_js["focal_length"] / scale_dir
        pp = np.asarray(cam_js.get("principal_point", [0, 0])) / scale_dir
        rgb = np.asarray(Image.open(path / "rgb" / f"{scale_dir}x" / f"{img_id}.png").convert("RGB"),
                         np.float32) / 255.0
        H, W = rgb.shape[:2]
        K = np.array([[focal, 0, pp[0] if pp[0] > 0 else W / 2], [0, focal, pp[1] if pp[1] > 0 else H / 2],
                      [0, 0, 1]], np.float32)
        cam = make_camera(orientation.T, -orientation @ position, W, H, K=K, fid=time_id(img_id) / max_time,
                          device=dev)
        thinned = thinned_mask = None
        if compute_thinned:
            coords = thin_mask_skeleton(rgb.sum(-1) > 0.05)
            if len(coords):
                tp, tm = pad_thinned(coords, max_thinned)
                thinned, thinned_mask = to(tp), to(tm, torch.bool)
        return Frame(cam=cam, image=to(rgb), thinned=thinned, thinned_mask=thinned_mask)

    train = [build(i) for i in all_ids if i in train_ids]
    test = [build(i) for i in all_ids if i not in train_ids]
    if (path / "points.npy").exists():
        pts = (np.load(path / "points.npy").astype(np.float32) - scene_center) * coord_scale
        cols = np.full((len(pts), 3), 0.5, np.float32)
    else:
        rng = np.random.default_rng(seed)
        pts = rng.random((n_init_points, 3)).astype(np.float32) * 2.6 - 1.3
        cols = rng.random((n_init_points, 3)).astype(np.float32)
    return SceneData(
        init_points=pts,
        init_colors=cols,
        is_blender=False,
        train_frames=train,
        test_frames=test,
        cameras_extent=compute_scene_extent([f.cam for f in train]),
        white_background=white_background,
    )
