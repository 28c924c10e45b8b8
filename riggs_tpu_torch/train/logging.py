"""Observability: profiler traces, TensorBoard scalars, eval reports.

Port of ``riggs_tpu/train/logging.py``: ``profile_trace`` (a
``torch.profiler`` scope that writes a Chrome trace into ``log_dir``, where
the reference starts ``jax.profiler``; the port's spans and counters,
``riggs_tpu_torch.trace``, are on inside it), ``TrainLogger`` (a
TensorBoard writer from ``torch.utils.tensorboard`` or ``tensorboardX``, and
a no-op when neither imports) and ``evaluation_report``.
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.eval.metrics import evaluate_image


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True):
    """A ``torch.profiler`` scope over the host and, when there is one, the
    card. The counters of ``riggs_tpu_torch.trace`` start from 0; on exit
    the Chrome trace (the spans among the host's ranges) is written to
    ``log_dir/trace.json`` and the counters to ``log_dir/counters.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    trace.reset()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
        (Path(log_dir) / "counters.json").write_text(json.dumps(trace.counters(), sort_keys=True))


class TrainLogger:
    """TensorBoard writer + best-metric tracking. No-op without a log dir or
    without a TensorBoard writer to import."""

    def __init__(self, log_dir: str | Path | None):
        self.writer = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(str(log_dir))
            except ImportError:
                try:
                    from tensorboardX import SummaryWriter

                    self.writer = SummaryWriter(str(log_dir))
                except ImportError:
                    self.writer = None
        self.best = {"psnr": 0.0, "iteration": 0}

    def scalars(self, step: int, prefix: str, values: dict):
        if self.writer is None:
            return
        for k, v in values.items():
            try:
                self.writer.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def image(self, step: int, tag: str, img):
        if self.writer is None:
            return
        self.writer.add_image(tag, np.clip(_host(img), 0, 1), step, dataformats="HWC")

    def histogram(self, step: int, tag: str, values):
        if self.writer is None:
            return
        self.writer.add_histogram(tag, _host(values), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def evaluation_report(
    logger: TrainLogger,
    step: int,
    render_fn: Callable,
    test_frames: list,
    lpips_model=None,
    log_images: int = 3,
    prefix: str = "test",
) -> dict:
    """Held-out evaluation: ``render_fn(frame) -> image`` on every test
    frame, the mean metrics and the first ``log_images`` renders logged (the
    targets too at step 0), the best PSNR tracked. Returns the means."""
    rows = []
    for i, frame in enumerate(test_frames):
        img = render_fn(frame)
        rows.append(evaluate_image(img, frame.image, lpips_model))
        if i < log_images:
            logger.image(step, f"{prefix}/render_{i}", img)
            if step == 0:
                logger.image(step, f"{prefix}/gt_{i}", frame.image)
    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} if rows else {}
    logger.scalars(step, prefix, means)
    if means.get("psnr", 0.0) > logger.best["psnr"]:
        logger.best = {"psnr": means["psnr"], "iteration": step, **means}
    return means
