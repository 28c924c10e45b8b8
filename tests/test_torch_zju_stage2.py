"""Stage-2 steps of ``make_stage2_auto`` on ZJU-MoCap frames, held to the
benchmark's plain reference (``portbench/reference/``).

The frames are ``portbench/scene_zju.py``'s: ring cameras with a K of
their own (the principal point off the centre), the subject's global
transform folded into the extrinsics, black targets outside the body's
mask, the 2-D skeleton points padded to 4 096. On the CPU, at 64 x 64
with 2 048 slots and every width kept, the program's first three steps
(``portbench/drivers/stage2_zju_train.py``'s set-up) agree with the
reference's at ``tests/test_torch_stage2_step.py``'s tolerances: loss
1e-5; render 3e-5; deformation and the parameters' change 1e-5; the first
gradient atol 1e-4, rtol 1e-3 (the blend backward's bound). With one
camera's principal point moved 4 px on the reference's side alone, the
render no longer agrees.

The card test (marked ``card``; it skips without a CUDA device) replays
the step's CUDA graphs on frames of all six train cameras at the cell's
size (1024 x 1024, 65 536 slots) and holds every replay to the eager
``stage2_step`` bit for bit:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -q -s tests/test_torch_zju_stage2.py -m card
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import stage2_zju_train

CELL = "s2-zju1024.train"
SEED = 2**31 + 21
TOL = {"loss": 1e-5, "render": 3e-5, "deform": 1e-5, "change": 1e-5}
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the suite's other torch files: under its
    parallel workers the idle threads' spinning slows a file many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver(device, **frames):
    cell = harness.load_cell(CELL)
    cfg = cell.config
    if device.type == "cpu":
        cfg["avatar"].update(capacity=2048, n_alive=1500)
        cfg["frames"].update(n_frames=4, size=64, cameras=[1, 5])
    cfg["frames"].update(frames)
    return stage2_zju_train.Driver(cfg, cell.traffic, SEED, device)


def _render_gap(side, ref) -> float:
    return max(float((a["render"] - b["render"]).abs().max()) for a, b in zip(side["render"], ref["render"]))


@pytest.fixture(scope="module")
def steps():
    """The program's first three steps on the CPU, what they produced, and
    the driver (its state freed) for the reference's side."""
    torch.manual_seed(0)
    drv = _driver(torch.device("cpu"))
    drv.setup(None)
    side = drv.program_side()
    drv.release()
    return drv, side


def test_the_frames_are_a_zju_capture(steps):
    drv, _ = steps
    fr = drv.frames
    intr = fr.intrinsics
    assert not torch.equal(intr[0], intr[1]) and torch.equal(intr[0], intr[2])  # two cameras, in turn
    assert bool(((intr[:, 2:] - 32).abs() > 0.5).all())  # the principal point off the centre
    assert fr.thinned.shape[1] == 4096 and 0 < int(fr.thinned_mask.sum(1).min())
    assert float(fr.image[fr.alpha == 0].abs().max()) == 0.0 and float(drv.bg.abs().max()) == 0.0
    assert len({int(u) % 2 for u in drv.order[:3]}) == 2  # the first steps see both cameras


def test_three_auto_steps_match_the_plain_reference(steps):
    drv, side = steps
    ref = drv.reference_steps(3)
    np.testing.assert_allclose(side["loss"], ref["loss"], atol=TOL["loss"], rtol=0)
    for k in range(3):
        for key in ("render", "alpha", "depth"):
            torch.testing.assert_close(side["render"][k][key], ref["render"][k][key], atol=TOL["render"], rtol=0)
        for key in ("d_xyz", "d_nodes", "template_offsets"):
            torch.testing.assert_close(side["deform"][k][key], ref["deform"][k][key], atol=TOL["deform"], rtol=0)
    assert set(side["grad1"]) == set(ref["grad1"])
    for p, g in ref["grad1"].items():
        torch.testing.assert_close(side["grad1"][p], g, **GRAD_TOL, msg=lambda m, p=p: f"{p}: {m}")
        torch.testing.assert_close(side["params"][p], ref["params"][p], atol=TOL["change"], rtol=0,
                                   msg=lambda m, p=p: f"{p}: {m}")


def test_a_principal_point_moved_on_the_reference_side_fails_the_render(steps):
    drv, side = steps
    cam = int(drv.order[0]) % 2
    saved = drv.frames.intrinsics
    moved = saved.clone()
    moved[cam::2, 2] += 4.0
    drv.frames.intrinsics = moved
    try:
        ref = drv.reference_steps(3)
    finally:
        drv.frames.intrinsics = saved
    assert _render_gap(side, ref) > TOL["render"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured and replayed only on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_replays_on_frames_of_six_cameras_are_the_eager_step_bit_for_bit(card):
    """At the cell's size: the driver's set-up (the ladder fitted to 24
    frames, four of each camera; three eager steps), then 14 steps through
    ``make_stage2_auto`` beside 14 of the eager ``stage2_step`` from a copy
    of the same state, over frames of all six cameras and the template
    frame. Metrics and every state leaf agree bit for bit."""
    from tests.test_torch_step_graph import _leaves, _reference_step

    drv = _driver(card, n_frames=24)
    drv.setup(None)
    auto, given, ref = drv.step_fn, drv.state, copy.deepcopy(drv.state)
    kw = dict(use_chamfer=True, lambda_dssim=drv.pcfg.opt.lambda_dssim, max_per_tile=drv.pcfg.pipe.max_per_tile,
              isotropic=False, tile_ladder=drv.ladder)
    pdx, pdj = drv.program_extra
    g = auto.graphs
    replays_before, replayed, mismatched = g.replays, set(), []
    uids = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0, 13, 20]
    for k, uid in enumerate(uids):
        it = drv.it + k
        n = g.replays
        given, m = auto(given, drv.pframes[uid], uid, drv.bg, pdx, pdj, it=it, **kw)
        ref, rm = _reference_step(drv.pcfg, ref, drv.pframes[uid], uid, drv.bg, pdx, pdj, it, **kw)
        torch.cuda.synchronize()
        if g.replays > n:
            replayed.add(tuple(drv.frames.intrinsics[uid].tolist()))
        mismatched += [(k, name) for name, v in rm.items() if not torch.equal(m[name], v)]
        got = _leaves(given)
        mismatched += [(k, name) for name, v in _leaves(ref).items() if not torch.equal(got[name], v)]
    print(f"[zju replay] {torch.cuda.get_device_name(0)}: {len(uids)} steps at {drv.frames.width}^2, "
          f"{given.gs.capacity} slots; eager {g.eager}, captures {g.captures}, replays {g.replays - replays_before} "
          f"on {len(replayed)} distinct K; mismatches {mismatched}")
    assert not mismatched
    assert len(replayed) == 6
