"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from ``BENCHMARK.json`` (``harness.py``). Set-up runs from process
start to the first timed step or frame; then the window: ``--seconds`` of
steps or frames with ``--trace 0``, which gives the cell's end-to-end
metrics, or the mix's ``trace_units`` under ``torch.profiler`` with
``--trace 1``, which gives its per-layer metrics (``layer_metrics/``).
After the window the program's state is freed and the reference checks
what the timed path produced (``limits/<workload>.json``). The last line
of standard output is one JSON object; the numbers compared, each beside
its limit, close it and standard error.

It runs on the card it finds and nowhere else: without CUDA, or with fewer
cards than the cell asks for, it exits 2 and prints no result. It exits 3,
and prints no result, if the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one host thread for CPU ops: the process drives the card, and idle
# intra-op threads only take cores from its launches
os.environ.setdefault("OMP_NUM_THREADS", "1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str):
    print(msg, file=sys.stderr)
    sys.exit(code)


def run_cell(cell, driver_cls, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set-up, the window, the reference check: the result line's fields
    (without ``device``)."""
    import torch

    from portbench import harness

    limits = cell.limits()
    drv = driver_cls(cell.config, cell.traffic, seed, device)
    drv.setup(CACHE)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    out: dict = {}
    warm = {"attempted": 0, "failed": 0}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        warm = drv.run(units=cell.traffic["trace_warm_units"])  # the allocator's cache settles before the trace
        harness.sync(device)
        with profile(activities=acts) as prof:
            rec = drv.run(units=cell.traffic["trace_units"])
        tr = harness.trace_of(prof, rec["window_s"])
        if torch.device(device).type == "cuda" and not tr.kernels:
            raise RuntimeError("the profiler recorded no kernel in the traced window")
        ctx = drv.layer_context(rec, tr)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["breakdown"] = tr.breakdown()
        out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
    else:
        rec = drv.run(seconds=seconds)
        e2e = drv.end_to_end(rec)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0
    out["attempted"] = drv.setup_rec["attempted"] + warm["attempted"] + rec["attempted"]
    out["failed"] = drv.setup_rec["failed"] + warm["failed"] + rec["failed"]
    out["metrics"] = metrics
    out["checks"] = check(drv, rec, limits)
    return out


def check(drv, rec, limits: dict) -> dict:
    """The reference's readings of what the timed path produced, each with
    its limit."""
    drv.release()
    t0 = time.perf_counter()
    readings = drv.readings(rec)
    print(f"portbench: the reference's check took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    checks = {}
    for name, lim in limits["limits"].items():
        checks[name] = {"value": float(readings[name]), "limit": float(lim)}
    if "min_compared" in limits:
        checks["compared"] = {"value": float(readings["compared"]), "limit": float(limits["min_compared"])}
    return checks


def passed(checks: dict) -> bool:
    ok = True
    for name, c in checks.items():
        v, lim = c["value"], c["limit"]
        good = v >= lim if name == "compared" else (math.isfinite(v) and v <= lim)
        ok = ok and good
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(2, f"portbench: the cell needs {cell.chips} CUDA device(s); this machine has {n}")
    name = torch.cuda.get_device_name(0)
    print(f"portbench: {args.workload} seed {args.seed} on {name}", file=sys.stderr)
    driver = cell.driver().Driver
    out = run_cell(cell, driver, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        fail(3, f"portbench: the process loaded {bad}; the port must not load JAX or the JAX package")
    checks = out.pop("checks")
    correct = passed(checks) and out["failed"] == 0
    device = {"platform": "gpu", "kind": name, "count": cell.chips, "memory_peak_bytes": out.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"], device["window_s"] = out.pop("busy_s"), out.pop("window_s")
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
