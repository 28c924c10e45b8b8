"""As-rigid-as-possible energies over control-node trajectories.

Port of ``riggs_tpu/ops/arap.py``: the dense (N, K) neighbour table
with a validity mask (``Connectivity``, ``connectivity_from_points``),
``edge_matrix``, the weighted Procrustes fit ``estimate_rotations``, the
stretch energy ``arap_error``, ``arap_deformation_loss`` (frame 0 of a
trajectory against one other frame, with the rotation term) and
``geodesic_floyd`` (all-pairs distances over the KNN graph, the animation
path's re-binding). JAX's PRNG
streams cannot be reproduced here, so that other frame ``fid`` is an
argument, drawn by the caller.

``estimate_rotations`` is one hand kernel on the card
(``csrc/rotfit.cu``'s ``riggs_estimate_rotations``: a warp per node sums
its weighted edge products and fits the rotation, no other launch), its
plain version ``estimate_rotations_plain`` (``edge_matrix`` twice, an
einsum, ``fit_rotations_plain``) on the CPU. The stretch terms stay
differentiable stock ops; only the detached rotation is fused.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from riggs_tpu_torch.device import constant
from riggs_tpu_torch.ops import geometry as GEO
from riggs_tpu_torch.ops.knn import knn
from riggs_tpu_torch.ops.quaternion import quat_to_rotmat


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


# the fused kernel's largest neighbour count (csrc/rotfit.cu ROTFIT_MAX_K)
MAX_K = 64


def estimate_rotations_plain(source: torch.Tensor, target: torch.Tensor, conn: Connectivity) -> torch.Tensor:
    """Plain version of ``estimate_rotations``: the weighted edge
    covariance sum_k w (t_i - t_j)(s_i - s_j)^T from ``edge_matrix``, then
    ``fit_rotations_plain``."""
    src = edge_matrix(source, conn)
    tgt = edge_matrix(target, conn)
    cov = torch.einsum("nka,nk,nkb->nab", tgt, conn.weight, src)
    return GEO.fit_rotations_plain(cov)


_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32, torch.bool)


def estimate_rotations(source: torch.Tensor, target: torch.Tensor, conn: Connectivity) -> torch.Tensor:
    """Per-node best-fit rotation source -> target over its weighted edges,
    (N, 3, 3), with no gradient: the fused kernel on CUDA (one launch;
    source and target (N, 3) float32, K <= MAX_K, every row's entries
    contiguous, the rows at any stride), the plain version on the CPU."""
    if source.device.type == "cpu":
        return estimate_rotations_plain(source, target, conn).detach()
    if source.device.type != "cuda":
        raise ValueError(f"unsupported device {source.device}")
    rot = torch.empty((conn.nn_idx.shape[0], 3, 3), dtype=torch.float32, device=source.device)
    args = kernel_args(source, target, conn, rot)
    if rot.shape[0]:
        err = GEO.launch(GEO.load_library().riggs_estimate_rotations, source.device, *args)
        if err != 0:
            raise RuntimeError(f"estimate_rotations launch failed: CUDA error {err}")
        GEO.launches["estimate_rotations"] += 1
    return rot


def kernel_args(source: torch.Tensor, target: torch.Tensor, conn: Connectivity, rot: torch.Tensor) -> tuple:
    """``riggs_estimate_rotations``'s arguments but the stream, once the
    inputs are checked: float32 (N, 3) points, an (N, K) int32 nn_idx,
    float32 weight and bool valid, K <= MAX_K, all on ``rot``'s device and
    each row's entries contiguous."""
    idx, w, v = conn.nn_idx, conn.weight, conn.valid
    n, K = idx.shape
    if (source.dtype, target.dtype, idx.dtype, w.dtype, v.dtype) != _DTYPES \
            or (source.shape, target.shape, w.shape, v.shape) != ((n, 3), (n, 3), (n, K), (n, K)):
        raise ValueError("estimate_rotations takes float32 (N, 3) points and an (N, K) int32 nn_idx, float32 "
                         "weight and bool valid")
    if K > MAX_K:
        raise ValueError(f"estimate_rotations takes at most {MAX_K} neighbours, got {K}")
    dev = rot.device
    if (source.device, target.device, idx.device, w.device, v.device) != (dev, dev, dev, dev, dev) \
            or (source.stride(1), target.stride(1), idx.stride(1), w.stride(1), v.stride(1)) != (1, 1, 1, 1, 1):
        raise ValueError("estimate_rotations: every tensor on one device, each row's entries contiguous")
    return (source.data_ptr(), source.stride(0), target.data_ptr(), target.stride(0), idx.data_ptr(), idx.stride(0),
            w.data_ptr(), w.stride(0), v.data_ptr(), v.stride(0), n, K, rot.data_ptr())


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


def arap_deformation_loss(
    trajectory: torch.Tensor,
    fid: torch.Tensor,
    trajectory_rot: torch.Tensor | None = None,
    K: int = 50,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ARAP energy between frame 0 and frame ``fid`` (a () int64 tensor in
    [1, T)) of a node trajectory (N, T, 3), over the KNN graph of the
    trajectories (K = min(K, N - 1), radius 1/8 of frame 0's bounding-box
    diagonal). Returns (arap error, 100 x rotation error): the rotation
    error compares the best-fit rotations, applied to frame 0's predicted
    rotations, with frame fid's (``trajectory_rot`` (N, T, 4)
    quaternions); 0 without them."""
    n = trajectory.shape[0]
    init = trajectory[:, 0]
    pick = lambda a: torch.index_select(a, 1, fid.reshape(1).to(torch.int64))[:, 0]
    tar = pick(trajectory)
    K = min(K, n - 1)
    radius = torch.linalg.norm(torch.amax(init, dim=0) - torch.amin(init, dim=0)) / 8.0
    conn = connectivity_from_points(init.detach(), radius=radius, K=K, trajectory=trajectory.detach())
    src = edge_matrix(init, conn)
    tgt = edge_matrix(tar, conn)
    R = estimate_rotations(init, tar, conn).detach()
    stretch = tgt - torch.einsum("nab,nkb->nka", R, src)
    err = torch.sum(torch.mean(conn.weight[..., None] * stretch**2, dim=0))
    if trajectory_rot is None:
        return err, torch.zeros((), dtype=err.dtype, device=err.device)
    init_rot = quat_to_rotmat(trajectory_rot[:, 0])
    tar_rot = quat_to_rotmat(pick(trajectory_rot))
    rot_err = torch.sum(torch.mean((torch.einsum("nab,nbc->nac", R, init_rot) - tar_rot) ** 2, dim=0))
    return err, rot_err * 1e2


def knn_graph(points: torch.Tensor, K: int = 8) -> torch.Tensor:
    """The symmetrized (K + 1)-NN graph of ``points`` (N, 3) as a dense
    (N, N) matrix: the edge lengths, each pair's shorter one where both
    ends list it, ``inf`` off the graph."""
    n = points.shape[0]
    d2, idx = knn(points, points, K + 1)
    mat = torch.full((n * n,), torch.inf, dtype=points.dtype, device=points.device)
    rows = torch.arange(n, device=points.device)[:, None] * n
    mat.scatter_reduce_(0, (rows + idx.to(torch.int64)).reshape(-1), torch.sqrt(d2).reshape(-1), reduce="amin")
    mat = mat.view(n, n)
    return torch.minimum(mat, mat.t())


def min_plus_closure(mat: torch.Tensor) -> torch.Tensor:
    """Floyd-Warshall on a dense (N, N) distance matrix: N min-plus
    relaxations through each node in turn, stock ops looped on the device
    (the reference's ``fori_loop``). Each step is exact per element, so the
    result does not depend on the device."""
    m = mat.clone()
    for i in range(m.shape[0]):
        # the sum is formed before the minimum writes into m
        torch.minimum(m, m[:, i, None] + m[None, i, :], out=m)
    return m


def geodesic_floyd(points: torch.Tensor, K: int = 8) -> torch.Tensor:
    """All-pairs geodesic distances (N, N) over the symmetrized (K + 1)-NN
    graph of ``points`` (N, 3); ``inf`` between pieces of a graph that is
    not connected."""
    return min_plus_closure(knn_graph(points, K))
