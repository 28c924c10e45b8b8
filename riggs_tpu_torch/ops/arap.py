"""As-rigid-as-possible energies over control-node trajectories.

Port of ``riggs_tpu/ops/arap.py:27-84``: the dense (N, K) neighbour table
with a validity mask (``Connectivity``, ``connectivity_from_points``),
``edge_matrix``, the weighted Procrustes fit ``estimate_rotations`` and the
stretch energy ``arap_error``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from riggs_tpu_torch.device import constant
from riggs_tpu_torch.ops.geometry import fit_rotations
from riggs_tpu_torch.ops.knn import knn


class Connectivity(NamedTuple):
    nn_idx: torch.Tensor  # (N, K) int32 neighbour indices
    weight: torch.Tensor  # (N, K) normalized edge weights (0 where invalid)
    valid: torch.Tensor  # (N, K) bool


def connectivity_from_points(
    points: torch.Tensor,
    radius: float = 0.1,
    K: int = 10,
    trajectory: torch.Tensor | None = None,
    least_edge_num: int = 3,
) -> Connectivity:
    """KNN graph: the first ``least_edge_num`` edges always, later ones
    within ``radius``; weights exp(-d2 / mean d2), normalized per node."""
    query = points if trajectory is None else trajectory.reshape(points.shape[0], -1) / trajectory.shape[1]
    d2, idx = knn(query, query, K + 1)
    d2, idx = d2[:, 1:], idx[:, 1:]  # drop self
    keep = torch.ones_like(d2, dtype=torch.bool)
    keep[:, least_edge_num:] = d2[:, least_edge_num:] < radius**2
    mean_d2 = torch.sum(torch.where(keep, d2, 0.0)) / torch.clamp(torch.sum(keep), min=1)
    weight = torch.exp(-d2 / torch.maximum(mean_d2, constant(1e-12, d2)))
    weight = torch.where(keep, weight, 0.0)
    weight = weight / torch.maximum(weight.sum(-1, keepdim=True), constant(1e-12, weight))
    return Connectivity(nn_idx=idx, weight=weight, valid=keep)


def edge_matrix(verts: torch.Tensor, conn: Connectivity) -> torch.Tensor:
    """E[i, k] = v_i - v_{nn[i, k]}, zero where invalid: (N, K, 3)."""
    e = verts[:, None, :] - verts[conn.nn_idx.to(torch.int64)]
    return torch.where(conn.valid[..., None], e, 0.0)


def estimate_rotations(source: torch.Tensor, target: torch.Tensor, conn: Connectivity) -> torch.Tensor:
    """Per-node best-fit rotation source -> target over its weighted edges."""
    src = edge_matrix(source, conn)
    tgt = edge_matrix(target, conn)
    cov = torch.einsum("nka,nk,nkb->nab", tgt, conn.weight, src)
    return fit_rotations(cov)


def arap_error(nodes_sequence: torch.Tensor, conn: Connectivity) -> torch.Tensor:
    """Sum over frames t >= 1 of the ARAP stretch energy of frame t against
    frame 0. nodes_sequence: (T, N, 3). The rotations are fitted without a
    gradient, as the reference's Procrustes is; the stretch is differentiable."""
    src = edge_matrix(nodes_sequence[0], conn)
    total = torch.zeros((), dtype=nodes_sequence.dtype, device=nodes_sequence.device)
    for tgt_nodes in nodes_sequence[1:]:
        R = estimate_rotations(nodes_sequence[0], tgt_nodes, conn).detach()
        stretch = edge_matrix(tgt_nodes, conn) - torch.einsum("nab,nkb->nka", R, src)
        total = total + torch.sum(conn.weight * torch.sum(stretch**2, dim=-1))
    return total
