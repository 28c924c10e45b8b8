"""``make_phase_b_auto``'s static-buffer step and its CUDA graphs
(``riggs_tpu_torch/train/step_graph.py``, shared with ``make_stage2_auto``).

On the CPU the step runs eagerly through the same buffers that a graph
replays on the card: it must give ``phase_b_step``'s results bit for bit,
also when a leaf is replaced, a state is densified or its node set grows,
and when every call after the warm-up re-runs the body of the call that was
"captured" (a stand-in graph whose replay calls that body: the body may read
nothing but the static buffers). Two sequences: the schedule's tail on a
ladder with the chamfer (as the benchmark's stage-1 cell runs it), and the
motion-mask and flow losses on plain windows, where the ARAP and motion
lambdas move every step and each frame brings another flow. The card test
(marked ``card``; it skips without a CUDA device) holds real replays to the
eager ``phase_b_step`` at the benchmark's operating point on the H100:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -q -s tests/test_torch_phase_b_graph.py

(``--noconftest``: the tests' conftest imports JAX, which a machine that
runs only the port need not have; this file does not.)
"""
from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from riggs_tpu_torch.camera import make_camera
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.optim import tree_leaves
from riggs_tpu_torch.train.step_graph import StepGraphs

CELL = Path(__file__).resolve().parent.parent / "portbench" / "configs" / "riggs-s1-dnerf800.json"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as the suite's other torch files: under its
    parallel workers the idle threads' spinning slows a file many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured and replayed only on the card")
    return torch.device("cuda", 0)


def _scene(device, cfg, n, size, n_frames, seed=3):
    """A seeded stage-1 state of ``n`` points and ``n_frames`` frames of it
    seen from an arc: each image the state's own render, dimmed, its alpha
    mask, 2-D skeleton points, and a flow to another frame's time."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    state = TS1.init_stage1(SceneData(pts, rng.uniform(size=(n, 3))), cfg,
                            generator=torch.Generator(device=device).manual_seed(0), device=device)
    frames = []
    for i, a in enumerate(np.linspace(-0.4, 0.4, n_frames)):
        R = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, 1.0, 0.0], [np.sin(a), 0.0, np.cos(a)]])
        cam = make_camera(R, np.array([0.0, 0.0, 2.0]), size, size, fovx=0.9, fovy=0.9, fid=i / n_frames,
                          device=device)
        with torch.no_grad():
            out = render(cam, state.gs, torch.ones(3, device=device), active_sh_degree=0, max_per_tile=1024)
        thinned = torch.zeros((16, 2), device=device)
        thinned[:8] = torch.as_tensor(rng.uniform(0, size, size=(8, 2)).astype(np.float32), device=device)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        frames.append(Frame(cam=cam, image=out["render"].clamp(0, 1) * 0.8, alpha_mask=(out["alpha"] > 0.5).float(),
                            thinned=thinned, thinned_mask=torch.arange(16, device=device) < 8,
                            flow=as_t(rng.normal(scale=2.0, size=(size, size, 2))),
                            flow_mask=as_t(rng.uniform(size=(size, size)) > 0.3),
                            flow_partner_fid=as_t(((i + 1) % n_frames) / n_frames).reshape(())))
    return state, frames


def _small(n_frames=4):
    cfg = Config()
    cfg.model.capacity, cfg.model.node_num, cfg.model.gs_with_motion_mask = 192, 24, True
    state, frames = _scene("cpu", cfg, 150, 32, n_frames)
    return cfg, state, frames


def _reference_step(cfg, state, frame, bg, arap_t, it, **kw):
    """``phase_b_step`` eagerly, with the rates and flags that
    ``make_phase_b_auto`` derives at ``it`` as host floats, and the
    iteration incremented as the auto step does."""
    gauss_lrs, warp_lrs = TS1.stage1_lr_fns_f32(cfg)
    new, m = TS1.phase_b_step(state, frame, bg, gauss_lrs(it), warp_lrs(it), arap_t, **kw,
                              **TS1.phase_b_flags(cfg, it))
    return dataclasses.replace(new, it=state.it + 1), m


def _leaves(st) -> dict:
    """Every tensor of a stage-1 state by name (the dataclasses' tensor
    fields, the warp's parameters and buffers, the Adam trees)."""
    out = {}
    for name in ("gs", "node_gs", "stats_gs", "stats_node"):
        obj = getattr(st, name)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                out[f"{name}.{f.name}"] = v
    out.update({f"warp.{k}": v for k, v in st.warp.named_parameters()})
    out.update({f"warp.{k}": v for k, v in st.warp.named_buffers()})
    for name in ("opt_gs", "opt_node", "opt_warp"):
        opt = getattr(st, name)
        for i, v in enumerate(tree_leaves((opt.mu, opt.nu, opt.count))):
            out[f"{name}.{i}"] = v
    out["it"] = st.it
    return out


def _reset_opacity(st):
    """``train_stage1``'s opacity reset: new opacity leaves and moments."""
    view = TS1.reset_opacity_step(TS1.Stage1TrainView(st.gs, st.opt_gs, st.stats_gs))
    return dataclasses.replace(st, gs=view.gs, opt_gs=view.opt)


def _densify(st):
    """A Gaussian densification from fixed split noise, every Gaussian with
    a gradient cloned or split: every tensor of the Gaussians, their moments
    and statistics a new one of the same shape."""
    noise = TG.split_noise(st.gs.capacity, generator=torch.Generator().manual_seed(4), device="cpu")
    view = TS1.densify_step(TS1.Stage1TrainView(st.gs, st.opt_gs, st.stats_gs), noise, 0.0, 1.0)
    return dataclasses.replace(st, gs=view.gs, opt_gs=view.opt, stats_gs=view.stats)


class _FakeGraph:
    """A stand-in for a CUDA graph on the CPU: its replay re-runs the body
    it was captured from, which must read only the static buffers."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(StepGraphs, "capturable", staticmethod(lambda device: True))
    monkeypatch.setattr(StepGraphs, "_capture", lambda self, fn, device: _FakeGraph(fn))


# (frame, what happens to the state before the step): an opacity reset (a
# replaced leaf) at step 4, a Gaussian densification at step 5 (new tensors,
# the same shapes: copied in), node densify/prune at step 6 (new nodes: new
# buffers, the graphs dropped), the rates moving every step
SEQUENCE = [(1, None), (2, None), (3, None), (0, None), (1, "reset"), (2, "densify"), (3, "nodes"), (0, None),
            (1, None), (2, None)]
# (start it, keywords, (eager, captures, replays) with stand-in graphs)
SEQUENCES = {
    # the schedule's tail as the stage-1 cell runs it: the chamfer, a ladder
    "tail": (12001, dict(use_chamfer=True), (6, 2, 4)),
    # the ARAP and motion-mask lambdas move every step; a flow a frame
    "motion_flow": (9001, dict(use_chamfer=True, use_motion_loss=True, use_flow_loss=True), (6, 2, 4)),
}


@pytest.mark.parametrize("sequence", list(SEQUENCES))
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "stand_in_replays"])
def test_static_buffer_step_is_phase_b_step_bit_for_bit(graphed, sequence, request):
    if graphed:
        request.getfixturevalue("fake_graphs")
    start, kw, counts = SEQUENCES[sequence]
    cfg, state, frames = _small()
    bg = torch.ones(3)
    if sequence == "tail":
        with torch.no_grad():
            tc = np.stack([render(f.cam, state.gs, bg, max_per_tile=512)["tile_counts"].numpy() for f in frames])
        kw = dict(kw, tile_ladder=make_tile_ladder(tc, n_buckets=2), max_per_tile=512)
    else:
        kw = dict(kw, max_per_tile=512)
        lam = [TS1.phase_b_flags(cfg, start + k) for k in range(len(SEQUENCE))]
        for name in ("lambda_arap", "lambda_motion"):  # what the sequence is for
            assert len({f[name] for f in lam}) == len(SEQUENCE) and min(f[name] for f in lam) > 0
    gen = torch.Generator().manual_seed(2)
    ref = copy.deepcopy(state)
    auto = TS1.make_phase_b_auto(cfg)
    given, prev, nodes = state, None, []
    for k, (uid, event) in enumerate(SEQUENCE):
        it = start + k
        if event == "reset":
            given, ref = _reset_opacity(given), _reset_opacity(ref)
        elif event == "densify":
            given, ref = _densify(given), _densify(ref)
        elif event == "nodes":
            given = TS1.node_densify_prune(given, cfg, 0.0)
            ref = TS1.node_densify_prune(ref, cfg, 0.0)
        nodes.append(given.warp.node_num)
        arap_t = TNW.arap_sample_times(gen, device="cpu")
        given, m = auto(given, frames[uid], bg, arap_t, it=it, **kw)
        ref, rm = _reference_step(cfg, ref, frames[uid], bg, arap_t, it, **kw)
        assert list(m) == list(rm)
        for name, v in rm.items():
            assert m[name].dtype == v.dtype and torch.equal(m[name], v), (k, name)
        got, want = _leaves(given), _leaves(ref)
        assert list(got) == list(want)
        for name, v in want.items():
            assert torch.equal(got[name], v), (k, name)
        if prev is not None:  # step k's metrics outlive step k + 1
            for name, v in prev[1].items():
                assert torch.equal(prev[0][name], v), (k - 1, name)
        prev = (m, {name: v.clone() for name, v in m.items()})
    assert nodes[6] > nodes[5], nodes  # the node set grew: new buffers
    assert ("flow" in m) == (sequence == "motion_flow") and float(m["arap"]) > 0
    g = auto.graphs
    # one key: three eager calls, then the capture (and its first replay) at
    # step 3, replays at 4 and 5; the new buffers of step 6 drop the graph:
    # three eager calls again, the capture at step 9
    assert (g.eager, g.captures, g.replays) == (counts if graphed else (len(SEQUENCE), 0, 0))
    assert int(given.it) == int(state.it) + len(SEQUENCE)


def test_the_key_and_the_capture_after_three_eager_calls(fake_graphs):
    cfg, state, frames = _small()
    bg = torch.ones(3)
    auto = TS1.make_phase_b_auto(cfg)
    g = auto.graphs
    with torch.no_grad():
        counts = render(frames[1].cam, state.gs, bg, max_per_tile=512)["tile_counts"].numpy()
    ladder = make_tile_ladder(counts[None], n_buckets=2)
    no_flow = [dataclasses.replace(f, flow=None, flow_mask=None, flow_partner_fid=None) for f in frames]

    def step(uid, it, fr=None, **kw):
        nonlocal state
        kw.setdefault("max_per_tile", 512)
        state, _ = auto(state, no_flow[uid] if fr is None else fr, bg, TNW.arap_sample_times(device="cpu"), it=it,
                        use_chamfer=True, **kw)
        return len(g.seen)

    assert step(1, 12001) == 1
    assert step(2, 12002) == 1 and step(3, 12010) == 1  # a new frame, it, rates and lambdas: the same key
    assert (g.eager, g.captures) == (3, 0)
    assert step(1, 12011) == 1 and (g.eager, g.captures, g.replays) == (3, 1, 1)  # the fourth call captures
    assert step(2, 12012) == 1 and (g.captures, g.replays) == (1, 2)
    assert step(1, 12013, tile_ladder=ladder) == 2  # a ladder
    assert step(1, 12014, max_per_tile=1024) == 3  # a cap
    assert step(1, 500) == 4  # a flag: the warm-up
    assert step(1, 12015, fr=frames[1]) == 5  # a frame that carries a flow
    assert step(1, 12016, fr=frames[1], use_flow_loss=True) == 6  # the flow loss
    assert (g.eager, g.captures, g.replays) == (8, 1, 2)
    assert sorted(g.seen.values()) == [1, 1, 1, 1, 1, 3]


@pytest.mark.card
def test_replays_on_the_card_match_the_eager_phase_b_step(card):
    """At the stage-1 cell's operating point (800 x 800, 131 072 slots,
    100 000 alive, 512 nodes, K 3, the cell's configuration), from one
    seeded state, make_phase_b_auto (graphed after three eager calls of a
    key) against the eager phase_b_step on four paths: the fitted ladder,
    plain windows, the flow and motion-mask losses on plain windows (each
    frame another flow), and the ladder with the node set grown after the
    first capture (new buffers: the graphs and their pool dropped, a second
    capture into a new pool). Every metric and state leaf agrees bit for
    bit on every step."""
    pcfg = json.loads(CELL.read_text())
    cfg = Config.from_json(json.dumps(pcfg["riggs"]))
    cfg.model.capacity, cfg.model.node_num = pcfg["avatar"]["capacity"], 512
    state, frames = _scene(card, cfg, pcfg["avatar"]["n_alive"], pcfg["frames"]["size"], 4)
    assert (state.gs.capacity, state.warp.node_num, state.warp.K) == (131072, 512, 3)
    bg = torch.ones(3, device=card)
    with torch.no_grad():
        tc = torch.stack([render(f.cam, state.gs, bg, max_per_tile=1024)["tile_counts"] for f in frames])
    ladder = make_tile_ladder(tc.cpu().numpy(), n_buckets=cfg.pipe.ladder_buckets)
    cap = int(-(-int(tc.max()) // 128) * 128)
    on_ladder = dict(use_chamfer=True, max_per_tile=cfg.pipe.max_per_tile, tile_ladder=ladder)
    # label: (start it, keywords, (eager, captures, replays) over the steps)
    paths = {"ladder": (70001, on_ladder, (3, 1, 5)),
             "plain": (70001, dict(use_chamfer=True, max_per_tile=cap), (3, 1, 5)),
             "flow": (9001, dict(use_chamfer=True, use_motion_loss=True, use_flow_loss=True, max_per_tile=cap),
                      (3, 1, 5)),
             "nodes": (70001, on_ladder, (6, 2, 2))}
    gen = torch.Generator(device=card).manual_seed(2)
    uids = [1, 2, 3, 0, 1, 2, 3, 0]
    report = {}
    for label, (start, kw, counts) in paths.items():
        given, ref = copy.deepcopy(state), copy.deepcopy(state)
        auto = TS1.make_phase_b_auto(cfg)
        bitwise, differing = True, set()
        for k, uid in enumerate(uids):
            if label == "nodes" and k == 4:  # after the capture at step 3
                given = TS1.node_densify_prune(given, cfg, 0.0)
                ref = TS1.node_densify_prune(ref, cfg, 0.0)
                assert given.warp.node_num > 512
            arap_t = TNW.arap_sample_times(gen, device=card)
            given, m = auto(given, frames[uid], bg, arap_t, it=start + k, **kw)
            ref, rm = _reference_step(cfg, ref, frames[uid], bg, arap_t, start + k, **kw)
            torch.cuda.synchronize()
            got = dict(_leaves(given), **m)
            for name, v in dict(_leaves(ref), **rm).items():
                if not torch.equal(got[name], v):
                    bitwise = False
                    differing.add((k, name))
        g = auto.graphs
        report[label] = ((g.eager, g.captures, g.replays), counts, bitwise, sorted(differing)[:8])
        del given, ref, auto
        torch.cuda.empty_cache()
    print(f"[phase_b_graph] {torch.cuda.get_device_name(0)}: {len(uids)} steps a path; ((eager, captures, replays), "
          f"expected, bitwise, first differing) {report}")
    for label, (got, counts, bitwise, differing) in report.items():
        assert bitwise, (label, differing)
        assert got == counts, (label, report[label])
