"""The harness finds a cell's configuration, traffic mix, driver and
per-layer metrics by their names alone: in a temporary copy of the
benchmark, a configuration, a mix, a per-layer metric and a cell added
only as new files and new entries run without an edit to any file that
was there."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from portbench import harness
from portbench import run as R

ROOT = Path(__file__).resolve().parent.parent.parent
READER = '''"""The slowest enqueue of a traced step."""


def read(ctx):
    return 1e3 * max(ctx.host_s) if ctx.host_s else None
'''


def test_new_files_and_entries_run_without_an_edit(tmp_path):
    home = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", home, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in home.rglob("*") if p.is_file()}

    cfg = json.loads((home / "configs" / "riggs-s2-dnerf800.json").read_text())
    cfg["name"] = "riggs-s2-small"
    cfg["avatar"].update(capacity=2048, n_alive=1500)
    cfg["frames"].update(n_frames=5, size=64)
    (home / "configs" / "riggs-s2-small.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "train-tail.json").read_text())
    mix.update(start_it=90001, max_steps=50, trace_warm_units=1, trace_units=3)
    (home / "traffic" / "train-late.json").write_text(json.dumps(mix))
    (home / "layer_metrics" / "host_ms_max.train.py").write_text(READER)
    (home / "limits" / "s2-small.late.json").write_text((home / "limits" / "s2-dnerf800.train.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "riggs-s2-small", "source": "https://arxiv.org/abs/2503.16822",
                             "file": "portbench/configs/riggs-s2-small.json", "reduced": ["avatar"], "why": "test"})
    bench["workloads"].append({"name": "s2-small.late", "config": "riggs-s2-small", "traffic": "train-late",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "host_ms_max.train", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "entry", "moves": "train_step_ms", "workloads": ["s2-small.late"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_step_ms", "host_ms.train"):
            m["workloads"].append("s2-small.late")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("s2-small.late", root=tmp_path)
    assert cell.home == home and cell.traffic["start_it"] == 90001 and cell.config["avatar"]["n_alive"] == 1500
    assert [m["name"] for m in cell.end_to_end] == ["train_step_ms", "setup_s"]
    out = R.run_cell(cell, cell.driver().Driver, 7, 1.0, True, torch.device("cpu"), time.perf_counter())
    assert out["metrics"]["host_ms_max.train"]["value"] >= out["metrics"]["host_ms.train"]["value"] > 0
    assert R.passed(out["checks"])
    assert all(p.read_bytes() == b for p, b in before.items())
