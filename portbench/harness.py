"""What every cell shares: finding its files by name, the card's checks,
the profiled window and its reduction to kernels, busy time and idle gaps.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its driver ``drivers/<model>_<kind>.py`` (the
configuration's ``model``, the mix's ``kind``), its check's limits
``limits/<cell>.json`` and each per-layer metric
``layer_metrics/<metric>.py``; adding any of them touches no file here.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "riggs_tpu")
# device events that are ranges of the host's record_function, not work
RANGE_PREFIXES = ("stage2_step.", "portbench.", "ProfilerStep")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, read from disk."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    home: Path  # the benchmark's folder the cell was read from

    @property
    def driver_name(self) -> str:
        return f"{self.config['model']}_{self.traffic['kind']}"

    def driver(self):
        return load_module(self.home / "drivers" / f"{self.driver_name}.py", f"portbench_driver_{self.driver_name}")

    def reader(self, metric: str):
        return load_module(self.home / "layer_metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))

    def limits(self) -> dict:
        return json.loads((self.home / "limits" / f"{self.name}.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    home = root / HERE.name

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(w["chips"]), config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((home / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]), home=home)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``riggs_tpu_torch`` is not ``riggs_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def tf32():
    """Float32 matmuls and convolutions in TF32, the precision below the
    configuration's float32 with TF32 off: the control's."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the profiled window
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """The device's kernels and the host's ranges of one profiled window,
    in microseconds on the profiler's clock."""

    kernels: list = field(default_factory=list)  # (name, start, end)
    copies: list = field(default_factory=list)  # memcpy / memset (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end) of host ops and ranges
    window_s: float = 0.0

    def intervals(self):
        return sorted((s, e) for _, s, e in self.kernels + self.copies)

    def busy_s(self) -> float:
        """The union of the device's operation intervals, in seconds."""
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in self.intervals():
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def device_s(self, match) -> float:
        """Seconds of the kernels whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def gaps(self):
        """(start, end) of every stretch in which the device ran nothing."""
        out, cur_e = [], None
        for s, e in self.intervals():
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return out

    def breakdown(self, top: int = 10, labelled: int = 400) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the innermost host op or range around each
        of the ``labelled`` longest gaps)."""
        by_name: dict[str, float] = {}
        for n, s, e in self.kernels + self.copies:
            by_name[n[:160]] = by_name.get(n[:160], 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle: dict[str, float] = {}
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        he = np.array([h[2] for h in self.host], dtype=np.float64)
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:labelled]:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = names[inside[np.argmin(he[inside] - hs[inside])]] if inside.size else "host outside any op"
            idle[label[:160]] = idle.get(label[:160], 0.0) + (e - s) / 1e6
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}


def _is_range(name: str) -> bool:
    return name.startswith(RANGE_PREFIXES)


def trace_of(prof, window_s: float) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a Trace."""
    from torch.autograd import DeviceType

    tr = Trace(window_s=window_s)
    for e in prof.events():
        name, s, t = e.name, e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or _is_range(name):
                continue
            (tr.copies if name.startswith(("Memcpy", "Memset")) else tr.kernels).append((name, s, t))
        else:
            tr.host.append((name, s, t))
    return tr


@dataclass
class LayerContext:
    """What a per-layer reader reads: the trace of the profiled window, its
    units (steps or frames), the host's enqueue time of each unit, and the
    work the harness counted for those units from their inputs."""

    trace: Trace
    units: int
    host_s: list
    flops: float
    bounds_ms: dict  # kernel -> the least time the card could take, summed over the units
    kernel_match: dict  # kernel -> predicate on a profiler kernel name


def blend_fwd(name: str) -> bool:
    return "blend_fwd" in name


def blend_bwd(name: str) -> bool:
    return "blend_bwd" in name


def gemm(name: str) -> bool:
    n = name.lower()
    return "gemm" in n or "cutlass" in n or "xmma" in n or "gemv" in n
