"""Farthest point sampling.

Port of ``riggs_tpu/ops/fps.py``: a loop over the samples with a running
min-distance array; masked-out points are never chosen.
"""
from __future__ import annotations

import torch


def farthest_point_sample(
    points: torch.Tensor,
    num_samples: int,
    mask: torch.Tensor | None = None,
    init_idx: int = 0,
) -> torch.Tensor:
    """``num_samples`` int32 indices into points (N, D) by FPS from
    ``init_idx`` (or the first valid point if that one is masked). Each step
    takes the first index of the largest distance, as jnp.argmax does; the
    loop stays on the device (no host read per sample)."""
    n = points.shape[0]
    dev = points.device
    valid = torch.ones(n, dtype=torch.bool, device=dev) if mask is None else mask
    # one-element index tensors: indexing by a 0-dim tensor reads it on the host
    start = torch.full((1,), int(init_idx), dtype=torch.int64, device=dev)
    start = torch.where(valid[start], start, torch.argmax(valid.to(torch.int32)))
    selected = torch.zeros(num_samples, dtype=torch.int64, device=dev)
    selected[:1] = start
    min_d2 = torch.full((n,), torch.inf, dtype=points.dtype, device=dev)
    for i in range(1, num_samples):
        d2 = torch.sum((points - points[selected[i - 1 : i]]) ** 2, dim=-1)
        min_d2 = torch.minimum(min_d2, d2)
        selected[i] = torch.argmax(torch.where(valid, min_d2, -torch.inf))
    return selected.to(torch.int32)
