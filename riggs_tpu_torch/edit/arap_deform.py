"""Interactive drag deformation: Laplacian editing and the iterative ARAP solve.

Port of ``riggs_tpu/edit/arap_deform.py``: a KNN graph with learnable edge
weights (``ArapDeformer``), a Laplacian built from them, and a local-global
ARAP solve (3 iterations of best-fit rotations and a linear solve) that
drags handle points to target positions while the rest follows as rigidly
as possible.

Handles are imposed by Dirichlet row replacement: a handle's row of the
Laplacian becomes an identity row and its right-hand side its target. The
linear solve is ``torch.linalg.solve_ex`` (LU with partial pivoting, as
``jnp.linalg.solve``), which reads nothing back from the card: like the
reference, a singular system (a piece of the graph with no handle) gives
non-finite positions rather than an error. The rotation fit of each
iteration is ``ops/geometry.py:fit_rotations``, on the card the
covariance entry of ``csrc/rotfit.cu`` (one launch per iteration).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.ops.arap import Connectivity, arap_error, connectivity_from_points, edge_matrix
from riggs_tpu_torch.ops.geometry import fit_rotations
from riggs_tpu_torch.ops.quaternion import rotmat_to_quat


@dataclasses.dataclass
class ArapDeformer:
    verts: torch.Tensor  # (N, 3) rest positions
    nn_idx: torch.Tensor  # (N, K) int32
    weight: torch.Tensor  # (N, K) learnable edge weights
    valid: torch.Tensor  # (N, K) bool

    @property
    def conn(self) -> Connectivity:
        return Connectivity(nn_idx=self.nn_idx, weight=self.weight * self.valid, valid=self.valid)

    @property
    def laplacian(self) -> torch.Tensor:
        """L = I - W, (N, N): each row's -w scattered onto its neighbours'
        columns, repeated neighbours summed."""
        n, K = self.nn_idx.shape
        rows = torch.arange(n, device=self.verts.device).repeat_interleave(K)
        eye = torch.eye(n, dtype=self.verts.dtype, device=self.verts.device)
        w = (self.weight * self.valid).reshape(-1)
        return eye.index_put((rows, self.nn_idx.reshape(-1).to(torch.int64)), -w, accumulate=True)


def make_deformer(verts: torch.Tensor, K: int = 16, radius: float | None = None,
                  trajectory: torch.Tensor | None = None) -> ArapDeformer:
    """The deformer over ``verts`` (N, 3): K = min(K, N - 1) neighbours, the
    radius 1/8 of the bounding box's diagonal unless given (one read)."""
    if radius is None:
        radius = float(torch.linalg.norm(torch.amax(verts, 0) - torch.amin(verts, 0)) / 8.0)
    conn = connectivity_from_points(verts, radius=radius, K=min(K, verts.shape[0] - 1), trajectory=trajectory)
    return ArapDeformer(verts=verts, nn_idx=conn.nn_idx, weight=conn.weight, valid=conn.valid)


def solve_with_handles(L: torch.Tensor, b: torch.Tensor, handle_idx: torch.Tensor,
                       handle_pos: torch.Tensor) -> torch.Tensor:
    """Solve L x = b subject to x[handles] = handle_pos (Dirichlet rows)."""
    n = L.shape[0]
    idx = (handle_idx.to(torch.int64),)
    is_handle = torch.zeros(n, dtype=torch.bool, device=L.device).index_put(
        idx, torch.ones_like(idx[0], dtype=torch.bool))
    A = torch.where(is_handle[:, None], torch.eye(n, dtype=L.dtype, device=L.device), L)
    rhs = b.index_put(idx, handle_pos.to(b.dtype))
    return torch.linalg.solve_ex(A, rhs)[0]


def deform_arap(deformer: ArapDeformer, handle_idx: torch.Tensor, handle_pos: torch.Tensor, num_iter: int = 3,
                return_rot: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Drag the handles to ``handle_pos``; returns (positions (N, 3), the
    last iteration's rotations as quaternions (N, 4), or None).

    The Laplacian-editing solve first, then ``num_iter`` times: the best-fit
    rotation of each vertex's weighted edges (Procrustes), and the ARAP
    normal equations' solve with b_i = 1/2 sum_k w_ik (R_i + R_j)(p_i - p_j)."""
    L = deformer.laplacian
    conn = deformer.conn
    nn = conn.nn_idx.to(torch.int64)
    P = edge_matrix(deformer.verts, conn)  # (N, K, 3) rest edges
    p_prime = solve_with_handles(L, L @ deformer.verts, handle_idx, handle_pos)
    R = None
    for _ in range(num_iter):
        Pp = edge_matrix(p_prime, conn)
        cov = torch.einsum("nka,nk,nkb->nab", Pp, conn.weight, P)
        R = fit_rotations(cov)
        Rsum = R[:, None] + R[nn]  # (N, K, 3, 3)
        b = 0.5 * torch.sum(torch.einsum("nkab,nkb->nka", Rsum, P) * conn.weight[..., None], dim=1)
        p_prime = solve_with_handles(L, b, handle_idx, handle_pos)
    return p_prime, (rotmat_to_quat(R) if return_rot else None)


def arap_energy(deformer: ArapDeformer, prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """The ARAP energy of ``cur`` against ``prev`` over the deformer's graph
    (``ops/arap.py:arap_error``: the rotations carry no gradient)."""
    return arap_error(torch.stack([prev, cur]), deformer.conn)


def optimize_weights(deformer: ArapDeformer, prev: torch.Tensor, cur: torch.Tensor, lr: float = 1e-3,
                     steps: int = 1) -> ArapDeformer:
    """``steps`` gradient steps of ``lr`` on the edge weights to better
    explain an observed deformation prev -> cur."""
    w = deformer.weight.detach()
    for _ in range(steps):
        w = w.requires_grad_(True)
        (g,) = torch.autograd.grad(arap_energy(dataclasses.replace(deformer, weight=w), prev, cur), w)
        w = (w - lr * g).detach()
    return dataclasses.replace(deformer, weight=w)


def n_ring_neighbors(nn_idx, idxs, rings: int = 2) -> np.ndarray:
    """Expand a set of point indices by ``rings`` rings of the KNN graph
    (host numpy; ``nn_idx`` a tensor or an array)."""
    nn_idx = nn_idx.cpu().numpy() if isinstance(nn_idx, torch.Tensor) else np.asarray(nn_idx)
    idxs = np.atleast_1d(np.asarray(idxs))
    for _ in range(rings):
        idxs = np.unique(np.concatenate([idxs, nn_idx[idxs].reshape(-1)]))
    return idxs
