"""Keypoint bookkeeping for drag editing.

Port of ``riggs_tpu/edit/keypoints.py`` (``DeformKeypoints``): groups of
selected point indices with their current drag targets, plain Python lists
of host numpy positions, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeformKeypoints:
    keypoint_idxs: list = dataclasses.field(default_factory=list)  # flat indices
    keypoints: list = dataclasses.field(default_factory=list)  # positions
    idx_grps: list = dataclasses.field(default_factory=list)  # index groups
    selective_keypoints_idx_list: list = dataclasses.field(default_factory=list)

    def get_kpt_idx(self):
        return self.keypoint_idxs

    def get_kpt(self):
        return self.keypoints

    def add_kpts(self, kpts: np.ndarray, idxs, expand: bool = False):
        """Register a new keypoint group (optionally merged into the current
        selection)."""
        idxs = list(np.atleast_1d(np.asarray(idxs)))
        new = [i for i in idxs if i not in self.keypoint_idxs]
        base = len(self.keypoints)
        self.keypoint_idxs.extend(new)
        self.keypoints.extend(list(np.atleast_2d(np.asarray(kpts))[: len(new)]))
        grp = list(range(base, base + len(new)))
        if expand and self.idx_grps:
            self.idx_grps[-1].extend(grp)
        else:
            self.idx_grps.append(grp)
        self.select_kpt(len(self.idx_grps) - 1)

    def select_kpt(self, grp_idx: int):
        if 0 <= grp_idx < len(self.idx_grps):
            self.selective_keypoints_idx_list = self.idx_grps[grp_idx]

    def get_selective_keypoints_idx(self):
        return [self.keypoint_idxs[i] for i in self.selective_keypoints_idx_list]

    def update_selective_keypoints(self, delta: np.ndarray):
        for i in self.selective_keypoints_idx_list:
            self.keypoints[i] = np.asarray(self.keypoints[i]) + np.asarray(delta)

    def clear(self):
        self.keypoint_idxs.clear()
        self.keypoints.clear()
        self.idx_grps.clear()
        self.selective_keypoints_idx_list.clear()

    def __len__(self):
        return len(self.keypoint_idxs)
