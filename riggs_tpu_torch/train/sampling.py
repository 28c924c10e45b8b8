"""Frame sampling policies: the reference's progressive training windows.

A copy of ``riggs_tpu/train/sampling.py`` (``FrameSampler``; numpy over an
``np.random.Generator``, so one seed picks the same frames in both
packages). Early in training only a sliding window of time-sorted frames is
sampled (plus some frames outside it), growing by ``progressive_stage_ratio``
of the dataset every ``progressive_stage_steps`` iterations; phase A's node
warm-up samples the earliest frames only.
"""
from __future__ import annotations

import numpy as np


class FrameSampler:
    def __init__(self, frames, rng: np.random.Generator):
        self.frames = frames
        self.order = np.argsort([float(f.fid) for f in frames])
        self.rng = rng
        self._stack: list[int] = []

    def _refill(self, candidates: np.ndarray):
        self._stack = list(self.rng.permutation(candidates))

    def sample_uniform(self) -> int:
        if not self._stack:
            self._refill(np.arange(len(self.frames)))
        return int(self._stack.pop())

    def sample_progressive(self, it: int, stage_ratio: float, stage_steps: int) -> int:
        """Sliding window over time-sorted frames + out-of-window refreshers."""
        n = len(self.frames)
        if not self._stack:
            hi = int(min((it / stage_steps + 1) * stage_ratio, 1.0) * n)
            hi = max(hi, 1)
            interval = int(n * stage_ratio)
            lo = max(0, hi - interval)
            window = self.order[lo:hi]
            out_domain = np.concatenate([self.order[:lo], self.order[hi : min(n, hi + interval)]])
            if len(out_domain) >= interval > 0:
                extra = self.rng.choice(out_domain, size=min(interval * 5, len(out_domain)), replace=False)
                window = np.concatenate([window, extra])
            self._refill(window)
        return int(self._stack.pop())

    def sample_warmup(self, max_frames: int = 30, frac: float = 0.01) -> int:
        """Earliest frames only (phase-A node warm-up, train_gui.py:1228-1232)."""
        k = max(max_frames, int(frac * len(self.frames)))
        if not self._stack:
            self._refill(self.order[:k])
        return int(self._stack.pop())

    def sample(self, it: int, progressive: bool, stage_ratio: float, stage_steps: int, warmup_until: int = 0) -> int:
        if warmup_until and it < warmup_until:
            return self.sample_warmup()
        if progressive and it < int(stage_steps / max(stage_ratio, 1e-9)):
            return self.sample_progressive(it, stage_ratio, stage_steps)
        return self.sample_uniform()
