"""Nearest neighbours and the chamfer distance.

Port of ``riggs_tpu/ops/knn.py``: ``pairwise_dist2``, ``_small_k`` (top-K
skinning and the node blend), ``_row_k``, ``knn`` (chunked over the
queries), ``mean_knn_dist2`` (the initial Gaussian scales) and
``chamfer_distance`` (:97-129, the skeleton projection loss) and
``ball_query`` (:132, the neighbours within a radius).
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.device import constant


def pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (N, M) of x (N, D) and y (M, D) by the expansion
    |x|^2 - 2 x.y + |y|^2, the cross term one matmul, clamped at 0 with
    ``torch.maximum`` (a tie at 0 splits its gradient, as jnp.maximum's)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    d2 = x2 - 2.0 * (x @ y.t()) + y2.t()
    return torch.maximum(d2, constant(0.0, d2))


def _small_k(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest entries per row of d2 (N, M), ascending, via k (argmin,
    mask) passes. The first minimal index wins a tie, as in the reference;
    ``torch.topk`` promises no tie order."""
    m = d2.shape[-1]
    cols = torch.arange(m, device=d2.device)[None, :]
    vals, idxs = [], []
    cur = d2
    for _ in range(k):
        i = torch.argmin(cur, dim=-1)
        vals.append(torch.gather(cur, -1, i[..., None])[..., 0])
        idxs.append(i.to(torch.int32))
        cur = torch.where(cols == i[..., None], torch.inf, cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


# above this k, one sort beats k reduce passes
_ITER_K_MAX = 8


def _row_k(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row, ascending. Above ``_ITER_K_MAX`` the reference
    takes ``lax.top_k(-d2)``, whose ties go to the lower index; a stable
    ascending sort gives the same order (``torch.topk`` promises none)."""
    if k <= _ITER_K_MAX:
        return _small_k(d2, k)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def knn(x: torch.Tensor, y: torch.Tensor, k: int, chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """For each x, the k nearest points of y: (dist2 (N, k), idx (N, k)
    int32), ascending. Chunked over x to bound the (chunk, M) tile."""
    if x.shape[0] <= chunk:
        return _row_k(pairwise_dist2(x, y), k)
    parts = [_row_k(pairwise_dist2(xb, y), k) for xb in torch.split(x, chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def mean_knn_dist2(points: torch.Tensor, k: int = 3, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest other points
    (the nearest, at distance 0, is itself)."""
    d2, _ = knn(points, points, k + 1, chunk=chunk)
    return torch.mean(d2[:, 1:], dim=-1)


def chamfer_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    norm: int = 1,
) -> torch.Tensor:
    """Symmetric chamfer distance between point sets x (N, D) and y (M, D).

    norm=1 uses L1 point distances, norm=2 squared L2. Masked points neither
    query nor serve as neighbours. The minima are ``torch.amin``, which, as
    ``jnp.min``, splits a tie's gradient evenly."""
    diff = x[:, None, :] - y[None, :, :]
    # |diff| with jnp.abs's gradient at 0 (+1), as train/losses.py:abs_jax
    d = torch.sum(torch.where(diff >= 0, diff, -diff), dim=-1) if norm == 1 else torch.sum(diff * diff, dim=-1)
    big = 1e12
    if y_mask is not None:
        d = torch.where(y_mask[None, :], d, big)
    dx = torch.amin(d, dim=1)  # nearest y for each x
    if x_mask is not None:
        dy = torch.amin(torch.where(x_mask[:, None], d, big), dim=0)
        mean_x = torch.sum(torch.where(x_mask, dx, 0.0)) / torch.clamp(torch.sum(x_mask), min=1)
    else:
        dy = torch.amin(d, dim=0)
        mean_x = torch.mean(dx)
    if y_mask is not None:
        mean_y = torch.sum(torch.where(y_mask, dy, 0.0)) / torch.clamp(torch.sum(y_mask), min=1)
    else:
        mean_y = torch.mean(dy)
    return mean_x + mean_y


def ball_query(x: torch.Tensor, y: torch.Tensor, radius: float, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to k neighbours in y of each x within ``radius`` (pytorch3d's
    ball_query): (dist2 (N, k), idx (N, k) int32), ascending; dist2 = inf
    and idx = -1 where no neighbour qualifies."""
    d2, idx = knn(x, y, k)
    ok = d2 <= radius * radius
    return torch.where(ok, d2, torch.inf), torch.where(ok, idx, -1)
