"""Forward kinematics over a static joint tree, batched by depth level.

Port of ``riggs_tpu/ops/fk.py``: joints at the same tree depth are composed
in one batched (L, 4, 4) @ (L, 4, 4) product, so a pose costs depth(tree)
products instead of one per joint.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from riggs_tpu_torch.device import static_index


@lru_cache(maxsize=64)
def _levels(parents: tuple[int, ...]) -> tuple[tuple[int, ...], ...]:
    """Joint indices grouped by tree depth. parents[0] is the root (ignored)."""
    depth = np.zeros(len(parents), dtype=np.int64)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    levels = []
    for d in range(1, int(depth.max()) + 1 if len(parents) > 1 else 1):
        idx = np.nonzero(depth == d)[0]
        if idx.size:
            levels.append(tuple(int(i) for i in idx))
    return tuple(levels)


def local_joint_transforms(
    rot_mats: torch.Tensor, rest_joints: torch.Tensor, parents: Sequence[int]
) -> torch.Tensor:
    """Per-joint local 4x4 transforms: R_j about the rest position of
    parent(j); the root rotates about its own rest position."""
    parents = tuple(int(p) for p in parents)
    pivot = rest_joints[static_index((0,) + parents[1:], rest_joints.device)]
    trans = pivot - torch.einsum("kab,kb->ka", rot_mats, pivot)
    K = rot_mats.shape[0]
    T = torch.zeros((K, 4, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    T[:, :3, :3] = rot_mats
    T[:, :3, 3] = trans
    T[:, 3, 3].fill_(1.0)  # fill_, not a python-scalar setitem (a host tensor)
    return T


def forward_kinematics(
    rot_mats: torch.Tensor, rest_joints: torch.Tensor, parents: Sequence[int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose the skeleton. rot_mats: (K, 3, 3); rest_joints: (K, 3).

    Returns posed joints (K, 3) and global transforms (K, 4, 4)."""
    parents = tuple(int(p) for p in parents)
    T = local_joint_transforms(rot_mats, rest_joints, parents)
    G = T.clone()
    for level in _levels(parents):
        idx = static_index(level, G.device)
        pidx = static_index(tuple(parents[i] for i in level), G.device)
        G[idx] = torch.einsum("lab,lbc->lac", G[pidx], T[idx])
    posed = torch.einsum("kab,kb->ka", G[:, :3, :3], rest_joints) + G[:, :3, 3]
    return posed, G
