"""k smallest entries per row, and the chamfer distance.

Port of ``riggs_tpu/ops/knn.py``: ``_small_k`` (top-K bone skinning) and
``chamfer_distance`` (:97-129, the stage-2 skeleton projection loss). The
nearest-neighbour searches of stage 1 come with its slice.
"""
from __future__ import annotations

import torch


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
