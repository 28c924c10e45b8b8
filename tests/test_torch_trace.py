"""The port's spans and counters (``riggs_tpu_torch/trace.py``) on the CPU.

Under ``torch.profiler`` a stage-2 step, a phase-B step and a viewer frame
record the spans of their layers (``riggs.<layer>.<part>``), each inside
its entry's span, and the viewer counts its renders and host reads; with no
profiler a span enters no ``record_function`` and nothing is counted. The
card's figures (the counters against ``torch.cuda.set_sync_debug_mode``)
are the benchmark's traced runs.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from riggs_tpu_torch import trace
from riggs_tpu_torch.camera import make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.models import skeleton_warp as TSW
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.optim import adam_init
from riggs_tpu_torch.viz import web_viewer as TV

SIZE = 32
RENDER = {"riggs.render_prep.setup", "riggs.render_prep.bin", "riggs.render_prep.windows", "riggs.blend.fwd"}
TRAIN = RENDER | {"riggs.loss.photometric", "riggs.loss.regularizers", "riggs.backward.grad", "riggs.blend.bwd",
                  "riggs.optim.adam"}


def _frame(gs, cam):
    with torch.no_grad():
        out = render(cam, gs, torch.zeros(3), active_sh_degree=gs.max_sh_degree, max_per_tile=512)
    thinned = torch.zeros((16, 2))
    thinned[:8] = torch.rand(8, 2, generator=torch.Generator().manual_seed(0)) * SIZE
    return Frame(cam=dataclasses.replace(cam, fid=torch.tensor(0.4)), image=out["render"].clamp(0, 1) * 0.8,
                 alpha_mask=(out["alpha"] > 0.5).float(), thinned=thinned, thinned_mask=torch.arange(16) < 8)


def _cam():
    return make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), SIZE, SIZE, fovx=0.9, fovy=0.9, device="cpu")


@pytest.fixture(scope="module")
def stage2():
    rng = np.random.default_rng(5)
    joints = rng.normal(scale=0.3, size=(5, 3)).astype(np.float32)
    gs = TG.create_from_pcd(rng.normal(scale=0.3, size=(150, 3)), rng.uniform(size=(150, 3)), capacity=192,
                            max_sh_degree=1, device="cpu")
    skel = TSW.init_skeleton_warp(joints, (0, 0, 1, 1, 2), generator=torch.Generator().manual_seed(1), device="cpu")
    state = TS2.Stage2State(gs=gs, skel=skel, opt_gs=adam_init(gs.params_dict()),
                            opt_skel=adam_init(skel.params_dict()),
                            stats_gs=TG.init_densify_stats(192, device="cpu"), proj_loss=torch.full((2,), 1e5),
                            it=torch.zeros((), dtype=torch.int32))
    cfg = Config()
    cfg.model.sh_degree, cfg.model.use_template_offsets, cfg.model.use_skinning_weight_mlp = 1, True, True
    fr = _frame(gs, _cam())
    with torch.no_grad():
        counts = render(fr.cam, gs, torch.zeros(3), max_per_tile=512)["tile_counts"].numpy()
    step = TS2.make_stage2_auto(cfg, template_idx=0)
    ladder = make_tile_ladder(counts[None], n_buckets=2)
    return lambda: step(state, fr, 0, torch.zeros(3), torch.zeros((2, 192, 3)), torch.zeros((2, 5, 3)), it=15001,
                        max_per_tile=512, tile_ladder=ladder)


@pytest.fixture(scope="module")
def phase_b():
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(150, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    cfg = Config()
    cfg.model.capacity, cfg.model.node_num, cfg.model.gs_with_motion_mask = 192, 24, True
    state = TS1.init_stage1(SceneData(pts, rng.uniform(size=(150, 3))), cfg,
                            generator=torch.Generator().manual_seed(0), device="cpu")
    fr = _frame(state.gs, _cam())
    step = TS1.make_phase_b_auto(cfg)
    return lambda: step(state, fr, torch.zeros(3), TNW.arap_sample_times(device="cpu"), it=5000, use_chamfer=True,
                        max_per_tile=512)


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    rng = np.random.default_rng(7)
    joints = rng.normal(scale=0.3, size=(5, 3)).astype(np.float32)
    gs = TG.create_from_pcd(rng.normal(scale=0.3, size=(150, 3)), rng.uniform(size=(150, 3)), capacity=192,
                            max_sh_degree=1, device="cpu")
    skel = TSW.init_skeleton_warp(joints, (0, 0, 1, 1, 2), generator=torch.Generator().manual_seed(1), device="cpu")
    return TV.ViewerServer(gs, skel=skel, width=SIZE, height=SIZE, device="cpu",
                           pose_lib_path=tmp_path_factory.mktemp("viewer") / "poses.json")


def _traced(fn):
    """fn() under the profiler (host only), the counters from 0: (its
    result, the riggs.* ranges as (name, start, end), the counters)."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("riggs.")]
    return out, spans, trace.counters()


def _nested_under(spans, entry):
    (s0, e0), = [(s, e) for n, s, e in spans if n == entry]
    return all(s0 <= s and e <= e0 for _, s, e in spans)


def test_stage2_step_records_its_layers_under_its_entry(stage2):
    stage2()  # the constants' caches filled outside the profile
    _, spans, counts = _traced(stage2)
    assert {n for n, _, _ in spans} == TRAIN | {"riggs.entry.stage2_auto", "riggs.entry.stage2_step",
                                                "riggs.deform.skeleton"}
    # make_stage2_auto's own span around stage2_step's, every layer inside that
    assert _nested_under(spans, "riggs.entry.stage2_auto")
    assert _nested_under([sp for sp in spans if sp[0] != "riggs.entry.stage2_auto"], "riggs.entry.stage2_step")
    # a blend forward and backward for each bucket of the ladder that holds tiles
    assert sum(n == "riggs.blend.fwd" for n, _, _ in spans) == sum(n == "riggs.blend.bwd" for n, _, _ in spans) >= 1
    _, _, again = _traced(stage2)
    assert counts.get("host_reads", 0) == again.get("host_reads", 0)


def test_phase_b_step_records_its_layers_under_its_entry(phase_b):
    phase_b()
    _, spans, _ = _traced(phase_b)
    assert {n for n, _, _ in spans} == TRAIN | {"riggs.entry.phase_b_auto", "riggs.entry.phase_b_step",
                                                "riggs.deform.nodes"}
    # make_phase_b_auto's own span around phase_b_step's, every layer inside that
    assert _nested_under(spans, "riggs.entry.phase_b_auto")
    assert _nested_under([sp for sp in spans if sp[0] != "riggs.entry.phase_b_auto"], "riggs.entry.phase_b_step")


def test_viewer_frame_counts_its_renders_and_reads(viewer, monkeypatch):
    renders = []
    real = TV.render
    monkeypatch.setattr(TV, "render", lambda *a, **k: renders.append(1) or real(*a, **k))
    img, spans, counts = _traced(lambda: viewer.render_frame(0.3, 0.2, 2.5, 0.5))
    assert img.shape == (SIZE, SIZE, 3)
    assert {n for n, _, _ in spans} == RENDER | {"riggs.entry.frame", "riggs.deform.skeleton"}
    assert _nested_under(spans, "riggs.entry.frame")
    assert counts["frame_renders"] == len(renders) == 1 and counts["host_reads"] >= 1
    # a window of 32 rows holds no tile of this frame: a second render on a
    # fitted ladder, its counts copied to the host for the fit
    renders.clear()
    monkeypatch.setattr(viewer, "frames", TV.FrameHolder(32))
    _, spans, counts = _traced(lambda: viewer.render_frame(0.3, 0.2, 2.5, 0.5))
    assert "riggs.render_prep.ladder_fit" in {n for n, _, _ in spans}
    assert counts["frame_renders"] == len(renders) == 2 and counts["host_reads"] == 3


def test_without_a_profiler_nothing_is_entered_or_counted(stage2, viewer, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.reset()
    stage2()
    viewer.render_frame(0.3, 0.2, 2.5, 0.5)
    assert trace.counters() == {}
    with trace.span("riggs.entry.frame"):
        trace.count("host_reads", 3)
    assert trace.counters() == {}


def test_only_the_trace_module_names_record_function():
    root = Path(trace.__file__).parent
    named = sorted(str(p.relative_to(root)) for p in root.rglob("*.py") if "record_function" in p.read_text())
    assert named == ["trace.py"]
