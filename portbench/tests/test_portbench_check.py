"""The check that decides ``correct``, driven through a whole run of each
cell at a CPU test's size (the card's look skipped): the plain reference
holds the program's timed path within every limit, and each fault a cell
can have, planted underneath the timed path, makes ``correct`` false. The
control (the reference in TF32) needs the card."""
from __future__ import annotations

import contextlib
import time

import pytest
import torch

from portbench import faults
from portbench import run as R

SEED = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def one_run(cell, fault=None, trace=False):
    with faults.planted(fault) if fault else contextlib.nullcontext():
        out = R.run_cell(cell, cell.driver().Driver, SEED, 3.0, trace, torch.device("cpu"), time.perf_counter())
    return out


@pytest.mark.parametrize("name", ["s2-dnerf800.train", "s1-dnerf800.train", "s2-dnerf800.view"])
def test_the_reference_holds_the_program(tiny_cell, name):
    out = one_run(tiny_cell(name))
    assert out["failed"] == 0 and out["attempted"] > 0
    assert R.passed(out["checks"]), out["checks"]
    assert set(out["checks"]) == set(tiny_cell(name).limits()["limits"]) | (
        {"compared"} if "min_compared" in tiny_cell(name).limits() else set())


@pytest.mark.parametrize("name,fault", [("s2-dnerf800.train", "frozen"), ("s2-dnerf800.train", "tile"),
                                        ("s1-dnerf800.train", "frozen"), ("s1-dnerf800.train", "tile"),
                                        ("s2-dnerf800.view", "tile")])
def test_a_planted_fault_makes_the_run_incorrect(tiny_cell, name, fault):
    out = one_run(tiny_cell(name), fault)
    assert not R.passed(out["checks"]), out["checks"]


@pytest.mark.parametrize("name,unit", [("s2-dnerf800.train", "train"), ("s2-dnerf800.view", "frame")])
def test_a_traced_run_checks_the_same(tiny_cell, name, unit):
    out = one_run(tiny_cell(name), trace=True)
    assert R.passed(out["checks"]) and "breakdown" in out
    assert out["metrics"][f"host_ms.{unit}"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["s2-dnerf800.train", "s1-dnerf800.train", "s2-dnerf800.view"])
def test_the_control_is_not_correct(card, tiny_cell, name):
    cell = tiny_cell(name)
    cell.config["avatar"].update(capacity=16384, n_alive=12000)
    cell.config["frames"]["size"] = 256
    cell.config.get("view", {})["size"] = 256
    drv = cell.driver().Driver(cell.config, cell.traffic, SEED, card)
    drv.setup(None)
    rec = drv.run(units=cell.traffic["check_window"]) if cell.traffic["kind"] == "view" else {}
    drv.release()
    r = drv.control_readings(rec)
    limits = cell.limits()["limits"]
    assert any(r[k] > v for k, v in limits.items()), (r, limits)
