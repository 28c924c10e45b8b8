"""Host-side tile-ladder construction from observed per-tile hit counts.

A copy of ``riggs_tpu/render/ladder.py:make_tile_ladder``, ``ladder_rows``
and ``LadderPolicy`` (numpy on the host; the port keeps its own copy rather
than import the JAX package; a fit is the span
``riggs.render_prep.ladder_fit``). The laddered renderer gives count-sorted
tiles rank-dependent window capacities, shrinking the window gather from
T * max(count) rows to about the area under the sorted-count curve. Bucket
truncation is counted in ``overflow_tiles``, so a stale ladder is detected.
``LadderPolicy`` fits and refits a ladder from the training steps' own
counts.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np

from riggs_tpu_torch import trace

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


class LadderPolicy:
    """Probe, fit and refit-on-overflow ladder manager for training loops.

    The policy rides the training steps themselves: every
    ``observe(tile_counts, overflow_tiles)`` folds a step's true per-tile
    hit counts (the binner counts them before truncation, so an overflowing
    step still gives an exact sample) into a rank-sorted running envelope.
    ``ladder`` stays None for the first ``n_probe`` observations (the steps
    render plain windows); it is then fitted once, and refitted whenever a
    step reports ladder truncation (``overflow_tiles > 0``). The envelope
    only grows (it never shrinks after a prune), and the caps are
    power-of-two multiples of CHUNK with ``margin`` headroom, so refits are
    few.
    """

    def __init__(
        self,
        n_buckets: int = 4,
        margin: float = 1.3,
        n_probe: int = 12,
        min_cap: int = CHUNK,
        max_cap: int | None = None,
        quantize: str = "pow2",
    ):
        # n_probe 12: with per-frame count variation a short probe
        # undersamples the envelope and the first frames each refit
        self.n_buckets = n_buckets
        self.margin = margin
        self.n_probe = n_probe
        self.min_cap = min_cap
        self.max_cap = max_cap
        self.quantize = quantize
        self.env = None  # (T,) rank-sorted count envelope
        self.seen = 0
        self.ladder: tuple | None = None
        self.refits = 0

    def observe(self, tile_counts, overflow_tiles: int = 0) -> bool:
        """Fold one step's true counts in; returns True when the ladder
        changed. tile_counts: (T,) or (B, T), each frame's rank-sorted
        counts folded in separately."""
        a = np.asarray(tile_counts)
        if a.ndim == 1:
            a = a[None]
        c = np.sort(a, axis=1)[:, ::-1].max(axis=0)
        self.env = c if self.env is None else np.maximum(self.env, c)
        self.seen += 1
        if self.ladder is None:
            if self.seen >= self.n_probe:
                self._fit()
                return True
            return False
        if overflow_tiles > 0:
            old = self.ladder
            self._fit()
            if self.ladder != old:
                self.refits += 1
                return True
        return False

    def anticipate(self, growth_ratio: float) -> bool:
        """Scale the envelope by ``growth_ratio`` (the alive count after a
        densification over the count before) and refit, so that one refit
        rides ahead of the growth instead of several triggered by overflow
        (which still backstop an underestimate). Returns True when the
        ladder changed."""
        if self.env is None or growth_ratio <= 1.0:
            return False
        self.env = self.env * float(growth_ratio)
        old = self.ladder
        self._fit()
        if self.ladder != old:
            self.refits += 1
            return True
        return False

    def _fit(self):
        with trace.span("riggs.render_prep.ladder_fit"):
            self.ladder = make_tile_ladder(
                self.env, n_buckets=self.n_buckets, margin=self.margin,
                min_cap=self.min_cap, max_cap=self.max_cap, quantize=self.quantize,
            )
