"""k smallest entries per row, for top-K bone skinning.

Port of ``riggs_tpu/ops/knn.py:_small_k`` only (the rest of the module waits
for the training slice).
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
