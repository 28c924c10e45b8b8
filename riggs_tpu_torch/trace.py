"""Spans and counters of the port's layers, live only under ``torch.profiler``.

``span(name)`` is the profiler's own range (``record_function``), entered
only while a profiler session records: the spans share the profiler's clock
with the device's kernels, are kept in the profiler's memory and go out
with its trace (``train/logging.py:profile_trace``, or whatever stops the
session). With no profiler running a span is one check and nothing else.
Every span of the package goes through it.

Spans are named ``riggs.<layer>.<part>``; readers map the second component
to a layer:

  entry        ``riggs.entry.stage2_step``, ``.phase_b_step``, ``.frame``:
               the whole entry (its own glue is what its children leave)
  deform       ``riggs.deform.skeleton``, ``.nodes``: the deformation model
  render_prep  ``riggs.render_prep.setup`` (colours, SH, cov3d, projection),
               ``.bin`` (the binner), ``.windows`` (packing, ladder buckets,
               window gathers, untile), ``.ladder_fit`` (``LadderPolicy``)
  blend        ``riggs.blend.fwd``, ``.bwd``: the blend's entries and its
               autograd backward
  loss_optim   ``riggs.loss.photometric``, ``riggs.loss.regularizers``,
               ``riggs.optim.adam`` (Adam, densification statistics, the
               new state)
  backward     ``riggs.backward.grad``: the autograd call

``count(name, n)`` adds to an in-process counter, again only while a
profiler session records, so the counters cover the traced window:
``host_reads`` (every copy from the device to the host that an entry
makes) and ``frame_renders`` (every render ``FrameHolder`` makes).
``counters()`` reads them and ``reset()`` clears them.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

_OFF = contextlib.nullcontext()
_counts: collections.Counter = collections.Counter()
_lock = threading.Lock()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        with _lock:
            _counts[name] += n


def counters() -> dict[str, int]:
    """The counters since the last ``reset``."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
