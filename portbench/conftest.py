"""Test settings of the benchmark's own tests (``portbench/tests``).

Tests marked ``card`` need a CUDA device; each decides inside the test,
through the ``card`` fixture, whether one is there, and skips on the CPU.
``tiny_cell`` shrinks a cell to a size that runs on the CPU in seconds: the
same widths, fewer Gaussians, frames and pixels.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 matmuls run only on the card")
    return torch.device("cuda", 0)


def shrink(cell):
    """The cell at a CPU test's size (every width kept)."""
    cell.config["avatar"].update(capacity=2048, n_alive=1500)
    cell.config["frames"].update(n_frames=6, size=64)
    cell.config.get("view", {}).update(size=64)
    cell.traffic.update(max_steps=100, max_frames=200, trace_warm_units=1,
                        trace_units=max(2, cell.traffic.get("check_window", 0)))
    return cell


@pytest.fixture
def tiny_cell():
    import torch

    from portbench import harness

    torch.manual_seed(0)
    return lambda name, root=ROOT: shrink(harness.load_cell(name, root))
