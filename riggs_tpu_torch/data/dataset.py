"""Training frames, the scene, and the thinned 2D-skeleton supervision.

Port of ``riggs_tpu/data/dataset.py``: the ``Frame`` container (:24-38),
``pad_thinned`` and ``thin_mask_skeleton`` (:45-65) and ``SceneData``
(:70+). A frame carries its camera, the target image and the optional
supervision the training steps read: the alpha mask and the thinned
2D-skeleton pixels, padded to a fixed count with a validity mask, and the
semantic part labels that skeleton extraction reads, the SMPL reference
points of a ZJU-MoCap frame, and the optical flow to a partner frame that
``train_stage1`` attaches on the frame's device each step of a flow scene.

``SceneData`` keeps the reference's fields, with the point cloud first
(``SceneData(points, colors)`` is a scene with no frames).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.data.thinning import skeleton_pixels


@dataclasses.dataclass
class Frame:
    cam: Camera
    image: torch.Tensor  # (H, W, 3) float32 in [0, 1]
    alpha_mask: torch.Tensor | None = None  # (H, W) float32
    thinned: torch.Tensor | None = None  # (P, 2) (row, col) float32, padded
    thinned_mask: torch.Tensor | None = None  # (P,) bool
    semantic_seg: torch.Tensor | None = None  # (H, W) int32 part labels
    reference_points: torch.Tensor | None = None  # (M, 3) SMPL vertex priors (ZJU-MoCap)
    # optical-flow supervision: the flow to a partner frame in pixels, its
    # validity (cycle-consistent or occlusion-flagged) and the partner's time
    flow: torch.Tensor | None = None  # (H, W, 2)
    flow_mask: torch.Tensor | None = None  # (H, W) float 0/1
    flow_partner_fid: torch.Tensor | None = None  # ()

    @property
    def fid(self) -> torch.Tensor:
        return self.cam.fid


def pad_thinned(coords: np.ndarray, max_points: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad a (P, 2) pixel-coordinate list to (max_points, 2) with a mask; a
    longer list keeps max_points evenly spaced entries."""
    p = coords.shape[0]
    if p >= max_points:
        sel = np.linspace(0, p - 1, max_points).astype(np.int64)
        return coords[sel].astype(np.float32), np.ones(max_points, bool)
    out = np.zeros((max_points, 2), np.float32)
    out[:p] = coords
    mask = np.zeros(max_points, bool)
    mask[:p] = True
    return out, mask


def thin_mask_skeleton(mask: np.ndarray) -> np.ndarray:
    """The 2D skeleton of a foreground mask: (row, col) float32 coordinates
    of the pixels its Zhang-Suen thinning keeps (``data/thinning.py``)."""
    return skeleton_pixels(mask)


@dataclasses.dataclass
class SceneData:
    """Host-side scene: the initial point cloud and its colours (numpy), the
    train and test frames, the camera rig's extent and the scene's flags."""

    init_points: np.ndarray  # (P, 3)
    init_colors: np.ndarray  # (P, 3) in [0, 1]
    is_blender: bool = True
    train_frames: list[Frame] = dataclasses.field(default_factory=list)
    test_frames: list[Frame] = dataclasses.field(default_factory=list)
    cameras_extent: float = 1.0
    white_background: bool = False
    # per-train-frame image names (the optical-flow files key off them)
    train_image_names: list[str] | None = None

    @property
    def time_interval(self) -> float:
        return 1.0 / max(len(self.train_frames), 1)
