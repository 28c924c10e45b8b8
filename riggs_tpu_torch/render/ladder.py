"""Host-side tile-ladder construction from observed per-tile hit counts.

A copy of ``riggs_tpu/render/ladder.py:make_tile_ladder`` and
``ladder_rows`` (numpy only; the port keeps its own copy rather than import
the JAX package). The laddered renderer gives count-sorted tiles
rank-dependent window capacities, shrinking the window gather from
T * max(count) rows to about the area under the sorted-count curve. Bucket
truncation is counted in ``overflow_tiles``, so a stale ladder is detected.
``LadderPolicy`` comes with the training slice.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np

CHUNK = 128  # window caps are multiples of the blend kernel chunk


def make_tile_ladder(
    counts,
    n_buckets: int = 4,
    margin: float = 1.3,
    min_cap: int = CHUNK,
    max_cap: int | None = None,
    quantize: str = "chunk",
) -> tuple[tuple[int, int], ...]:
    """Build a ``tile_ladder`` ((n_tiles, cap), ...) summing to T, caps
    non-increasing, from (T,) or (F, T) observed counts.

    Several probe frames give a per-rank envelope (each frame sorted
    descending, max over frames per rank). ``margin`` is headroom on the
    envelope before rounding up to a CHUNK multiple; ``quantize='pow2'``
    rounds caps to power-of-two multiples of CHUNK instead.
    """
    c = np.asarray(counts)
    if c.ndim == 1:
        c = c[None, :]
    T = c.shape[1]
    env = np.sort(c, axis=1)[:, ::-1].max(axis=0)  # (T,) rank envelope
    if quantize == "pow2":
        need = np.maximum(env * margin, min_cap)
        need = CHUNK * 2 ** np.ceil(np.log2(np.maximum(need / CHUNK, 1.0))).astype(int)
        need = need.astype(int)
    else:
        need = np.maximum(np.ceil(env * margin / CHUNK).astype(int) * CHUNK, min_cap)
    if max_cap is not None:
        need = np.minimum(need, max_cap)
    # need is non-increasing along ranks; a bucket [a, b) uses cap need[a].
    # The candidate boundaries are where need drops, so an exact area
    # minimization over <= n_buckets-1 splits is a small search.
    drops = [r for r in range(1, T) if need[r] < need[r - 1]]
    best, best_area = None, None
    for k in range(0, min(n_buckets - 1, len(drops)) + 1):
        for splits in combinations(drops, k):
            bounds = [0, *splits, T]
            area = sum(
                (bounds[i + 1] - bounds[i]) * int(need[bounds[i]])
                for i in range(len(bounds) - 1)
            )
            if best_area is None or area < best_area:
                best_area = area
                best = tuple(
                    (bounds[i + 1] - bounds[i], int(need[bounds[i]]))
                    for i in range(len(bounds) - 1)
                )
    return best


def ladder_rows(ladder) -> int:
    """Total window rows a ladder materializes (the gather cost)."""
    return int(sum(n * cap for n, cap in ladder))
