"""Training frame container.

Port of ``riggs_tpu/data/dataset.py:24-38`` (the ``Frame`` container) and
of the part of ``SceneData`` (:70+) that ``init_stage1`` reads; the readers
and the rest of the scene come with a later slice. A frame carries its
camera, the target image and the optional supervision the training steps
read: the alpha mask and the thinned 2D-skeleton pixels, padded to a fixed
count with a validity mask.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera


@dataclasses.dataclass
class Frame:
    cam: Camera
    image: torch.Tensor  # (H, W, 3) float32 in [0, 1]
    alpha_mask: torch.Tensor | None = None  # (H, W) float32
    thinned: torch.Tensor | None = None  # (P, 2) (row, col) float32, padded
    thinned_mask: torch.Tensor | None = None  # (P,) bool

    @property
    def fid(self) -> torch.Tensor:
        return self.cam.fid


@dataclasses.dataclass
class SceneData:
    """Host-side scene: the initial point cloud and its colours (numpy) and
    whether the scene is a synthetic (blender) one."""

    init_points: np.ndarray  # (P, 3)
    init_colors: np.ndarray  # (P, 3) in [0, 1]
    is_blender: bool = True
