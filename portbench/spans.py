"""The program's own spans and counters in a traced window, by layer.

The port names its spans ``riggs.<layer>.<part>`` (``riggs_tpu_torch/trace.py``)
and enters them only while a profiler records, so they are host ranges of
the trace on the profiler's clock. A moment of the window belongs to the
shortest ``riggs.*`` range active over it, on any host thread (the
autograd engine's device thread included), or to ``outside``. The idle gaps
of the device are split at the ranges' boundaries and each piece given to
its moment's layer; a launch call is given to the layer of its start.

A program without the spans (an older commit) gives no ``riggs.*`` range:
the readers then return None, and their metrics are left out of the line.
"""
from __future__ import annotations

import bisect

PREFIX = "riggs."
OUTSIDE = "outside"
# the second component of a span's name -> the layer of the metrics
LAYERS = {"entry": "entry", "deform": "deform", "render_prep": "render_prep", "blend": "blend",
          "loss": "loss_optim", "optim": "loss_optim", "backward": "backward"}
# the host's calls that put work on the device's queue
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
            "cudaMemsetAsync", "cudaGraphLaunch")


def layer_of(name: str) -> str:
    part = name.split(".")[1]
    return LAYERS.get(part, part)


def ranges(trace) -> list:
    """(start, end, layer) of every ``riggs.*`` range of the trace."""
    return [(s, e, layer_of(n)) for n, s, e in trace.host if n.startswith(PREFIX) and e > s]


def segments(rs: list) -> list:
    """The stretches between the ranges' boundaries in time order, each
    (start, end, layer of the shortest range active over it, or OUTSIDE)."""
    bounds = sorted({s for s, _, _ in rs} | {e for _, e, _ in rs})
    by_start = sorted(rs)
    out, active, k = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while k < len(by_start) and by_start[k][0] <= a:
            active.append(by_start[k])
            k += 1
        active = [r for r in active if r[1] > a]
        owner = min(active, key=lambda r: (r[1] - r[0], -r[0]))[2] if active else OUTSIDE
        out.append((a, b, owner))
    return out


def idle_by_layer(trace) -> dict | None:
    """Microseconds of the device's idle gaps by layer (OUTSIDE for what no
    range covers); None without ``riggs.*`` ranges."""
    rs = ranges(trace)
    if not rs:
        return None
    segs = segments(rs)
    out = {OUTSIDE: 0.0}
    j = 0
    for gs, ge in trace.gaps():
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < ge:
            piece = min(ge, segs[k][1]) - max(gs, segs[k][0])
            if piece > 0:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + piece
                covered += piece
            k += 1
        out[OUTSIDE] += (ge - gs) - covered
    return out


def launches_by_layer(trace) -> dict | None:
    """Launch calls (``LAUNCHES``) by the layer of their start; None without
    ``riggs.*`` ranges."""
    rs = ranges(trace)
    if not rs:
        return None
    segs = segments(rs)
    starts = [s for s, _, _ in segs]
    out = {OUTSIDE: 0}
    for n, s, _ in trace.host:
        if n not in LAUNCHES:
            continue
        i = bisect.bisect_right(starts, s) - 1
        owner = segs[i][2] if i >= 0 and s < segs[i][1] else OUTSIDE
        out[owner] = out.get(owner, 0) + 1
    return out


def idle_ms(ctx, layer: str) -> float | None:
    """Idle milliseconds a unit given to ``layer``."""
    idle = idle_by_layer(ctx.trace)
    return None if idle is None or not ctx.units else idle.get(layer, 0.0) / 1e3 / ctx.units


def launches(ctx, layer: str) -> float | None:
    """Launch calls a unit given to ``layer``."""
    n = launches_by_layer(ctx.trace)
    return None if n is None or not ctx.units else n.get(layer, 0) / ctx.units


def counter(ctx, name: str) -> float | None:
    """The program's counter ``name`` over the units: what it counted while
    the profiler recorded. None for a program without the counters."""
    try:
        from riggs_tpu_torch import trace
    except ImportError:  # a program without riggs_tpu_torch/trace.py
        return None
    return trace.counters().get(name, 0) / ctx.units if ctx.units else None
