#!/usr/bin/env python3
"""The port's spans and counters against the totals they split, in one
benchmark cell on the card. One JSON line, then the card's name and limit.

    python3 scripts/torch_trace_audit.py --workload s2-dnerf800.train --seed 123 [--sync-units 5]

Set-up and the traced window as ``portbench/run.py --trace 1`` runs them.
From the trace, per unit: the device's idle time of every layer and outside
the ``riggs.*`` spans (``portbench/spans.py``), their sum against the idle
gaps' and against the window less the busy time; the launch calls of every
layer and outside, their sum against the device's kernels, copies and
memsets; the program's counters. Then ``--sync-units`` more units under
the profiler and ``torch.cuda.set_sync_debug_mode("warn")``: the
synchronizing operations flagged inside the entry (the step or
``ViewerServer.render_frame``), by source line, against the ``host_reads``
counter. Last, the spans' own host cost: the spans a unit in the trace,
and the microseconds of one span entered and left, with the profiler
recording (a one-element kernel launched inside, less the same launch
without a span) and with none.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench import run as R  # noqa: E402  (the benchmark's caches and threads, before torch)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import harness, spans  # noqa: E402
from riggs_tpu_torch import trace  # noqa: E402


def per_unit(d: dict, n: int, scale: float = 1.0) -> dict:
    return {k: v * scale / n for k, v in sorted(d.items())}


def traced(drv, units: int) -> dict:
    """Idle time and launches by layer, and the counters, of ``units``
    units under the profiler."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec = drv.run(units=units)
    tr = harness.trace_of(prof, rec["window_s"])
    n = rec["attempted"]
    idle, launches = spans.idle_by_layer(tr), spans.launches_by_layer(tr)
    return {"units": n, "idle_ms": per_unit(idle, n, 1e-3), "idle_ms_sum": sum(idle.values()) / 1e3 / n,
            "gaps_ms": sum(e - s for s, e in tr.gaps()) / 1e3 / n,
            "window_idle_ms": (tr.window_s - tr.busy_s()) * 1e3 / n,
            "launches": per_unit(launches, n), "launches_sum": sum(launches.values()) / n,
            "device_ops": (len(tr.kernels) + len(tr.copies)) / n, "kernels": len(tr.kernels) / n,
            "counters": per_unit(trace.counters(), n), "spans": len(spans.ranges(tr)) / n}


def sync_audit(drv, units: int) -> dict:
    """Synchronizing operations flagged inside the entry against the
    ``host_reads`` counter, over ``units`` units."""
    obj, attr = (drv.viewer, "render_frame") if hasattr(drv, "viewer") else (drv, "call_step")
    entry, flagged = getattr(obj, attr), []

    def audited(*a, **k):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = entry(*a, **k)
        flagged.extend(f"{Path(w.filename).name}:{w.lineno}" for w in seen if "synchroniz" in str(w.message))
        return out

    with warnings.catch_warnings():  # the first switch in a process is flagged itself
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    setattr(obj, attr, audited)
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec = drv.run(units=units)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        setattr(obj, attr, entry)
    n = rec["attempted"]
    return {"units": n, "flagged": len(flagged) / n, "host_reads": trace.counters().get("host_reads", 0) / n,
            "sites": per_unit(collections.Counter(flagged), n)}


def span_us(traced_: bool, n: int = 5000) -> float:
    """Microseconds a span adds around a one-element kernel's launch, under
    the profiler or with none."""
    x = torch.zeros(1, device="cuda")

    def loop(with_span):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            if with_span:
                with trace.span("riggs.entry.audit"):
                    x.add_(1.0)
            else:
                x.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced_ else contextlib.nullcontext():
        loop(True)  # warm
        return min(loop(True) - loop(False) for _ in range(3))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--sync-units", type=int, default=5)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    drv = cell.driver().Driver(cell.config, cell.traffic, args.seed, dev)
    drv.setup(R.CACHE)
    drv.run(units=cell.traffic["trace_warm_units"])
    harness.sync(dev)
    out = {"workload": args.workload, "seed": args.seed, "traced": traced(drv, cell.traffic["trace_units"]),
           "sync": sync_audit(drv, args.sync_units),
           "span_us": {"traced": span_us(True), "untraced": span_us(False)}}
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
