"""The check that decides ``correct`` for the ZJU-MoCap cell, as
``test_portbench_check.py`` drives it for the others: a whole run at a CPU
test's size passes, each planted fault makes it incorrect, a traced run
checks the same, and the control (the reference in TF32, on the card)
fails a limit."""
from __future__ import annotations

import pytest

from portbench import run as R
from portbench.tests.test_portbench_check import SEED, one_run

CELL = "s2-zju1024.train"


def test_the_reference_holds_the_program(tiny_cell):
    out = one_run(tiny_cell(CELL))
    assert out["failed"] == 0 and out["attempted"] > 0
    assert R.passed(out["checks"]), out["checks"]
    assert set(out["checks"]) == set(tiny_cell(CELL).limits()["limits"])


@pytest.mark.parametrize("fault", ["frozen", "tile"])
def test_a_planted_fault_makes_the_run_incorrect(tiny_cell, fault):
    out = one_run(tiny_cell(CELL), fault)
    assert not R.passed(out["checks"]), out["checks"]


def test_a_traced_run_checks_the_same(tiny_cell):
    out = one_run(tiny_cell(CELL), trace=True)
    assert R.passed(out["checks"]) and "breakdown" in out
    assert out["metrics"]["host_ms.train"]["value"] > 0


@pytest.mark.card
def test_the_control_is_not_correct(card, tiny_cell):
    cell = tiny_cell(CELL)
    cell.config["avatar"].update(capacity=16384, n_alive=12000)
    cell.config["frames"]["size"] = 256
    drv = cell.driver().Driver(cell.config, cell.traffic, SEED, card)
    drv.setup(None)
    drv.release()
    r = drv.control_readings({})
    limits = cell.limits()["limits"]
    assert any(r[k] > v for k, v in limits.items()), (r, limits)
