"""``make_stage2_auto``'s static-buffer step and its CUDA graphs
(``riggs_tpu_torch/train/step_graph.py``).

On the CPU the step runs eagerly through the same buffers that a graph
replays on the card: it must give ``stage2_step``'s results bit for bit,
also when a state is copied in from outside and when every call after the
warm-up re-runs the body of the call that was "captured" (a stand-in graph
whose replay calls that body: the body may read nothing but the static
buffers). The key test checks what makes a new graph and when one is
captured, and another which graphs are kept. The card test (marked ``card``; it skips without a CUDA device)
holds real replays to the eager ``stage2_step`` on the H100:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -q -s tests/test_torch_step_graph.py

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
from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.models import skeleton_warp as TSW
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.optim import adam_init, tree_leaves
from riggs_tpu_torch.train.step_graph import StepGraphs

LIMITS = Path(__file__).resolve().parent.parent / "portbench" / "limits" / "s2-dnerf800.train.json"
PARENTS = (0, 0, 1, 1, 2)
TEMPLATE = 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured and replayed only on the card")
    return torch.device("cuda", 0)


def _avatar(device, n=150, capacity=192, size=32, n_frames=4, seed=5):
    """A seeded stage-2 state, ``n_frames`` frames of it seen from an arc
    (their images the avatar's own renders, dimmed), the config and the
    distillation targets; frame ``TEMPLATE`` is the template frame."""
    rng = np.random.default_rng(seed)
    joints = rng.normal(scale=0.3, size=(5, 3)).astype(np.float32)
    gs = TG.create_from_pcd(rng.normal(scale=0.3, size=(n, 3)), rng.uniform(size=(n, 3)), capacity=capacity,
                            max_sh_degree=1, device=device)
    skel = TSW.init_skeleton_warp(joints, PARENTS, generator=torch.Generator(device=device).manual_seed(1),
                                  device=device)
    state = TS2.Stage2State(gs=gs, skel=skel, opt_gs=adam_init(gs.params_dict()),
                            opt_skel=adam_init(skel.params_dict()),
                            stats_gs=TG.init_densify_stats(capacity, device=device),
                            proj_loss=torch.full((n_frames,), 1e5, device=device),
                            it=torch.zeros((), dtype=torch.int32, device=device))
    frames = [_frame(gs, a, i / n_frames, size, device, rng) for i, a in enumerate(np.linspace(-0.4, 0.4, n_frames))]
    cfg = Config()
    cfg.model.sh_degree, cfg.model.use_template_offsets, cfg.model.use_skinning_weight_mlp = 1, True, True
    pdx = torch.as_tensor(rng.normal(scale=1e-3, size=(n_frames, capacity, 3)).astype(np.float32), device=device)
    pdj = torch.as_tensor(rng.normal(scale=1e-3, size=(n_frames, 5, 3)).astype(np.float32), device=device)
    return cfg, state, frames, pdx, pdj


def _frame(gs, angle, t, size, device, rng):
    R = np.array([[np.cos(angle), 0.0, -np.sin(angle)], [0.0, 1.0, 0.0], [np.sin(angle), 0.0, np.cos(angle)]])
    cam = make_camera(R, np.array([0.0, 0.0, 2.0]), size, size, fovx=0.9, fovy=0.9, fid=t, device=device)
    with torch.no_grad():
        out = render(cam, gs, torch.zeros(3, device=device), active_sh_degree=gs.max_sh_degree, max_per_tile=512)
    thinned = torch.zeros((16, 2), device=device)
    thinned[:8] = torch.as_tensor(rng.uniform(0, size, size=(8, 2)).astype(np.float32), device=device)
    return Frame(cam=cam, image=out["render"].clamp(0, 1) * 0.8, alpha_mask=(out["alpha"] > 0.5).float(),
                 thinned=thinned, thinned_mask=torch.arange(16, device=device) < 8)


def _reference_step(cfg, state, frame, uid, bg, pdx, pdj, it, **kw):
    """``stage2_step`` eagerly, with the rates and flags that
    ``make_stage2_auto`` derives at ``it`` as host floats and a host uid."""
    o = cfg.opt
    flags = TS2.stage2_flags(cfg, it, uid, TEMPLATE)
    gs_lr = S.expon_lr_f32(o.position_lr_init, o.position_lr_final, lr_delay_mult=o.position_lr_delay_mult,
                           max_steps=o.position_lr_max_steps)
    skel_lr = S.expon_lr_f32(o.deform_mlp_lr_init, o.deform_mlp_lr_final, lr_delay_mult=o.deform_mlp_lr_delay_mult,
                             max_steps=o.deform_mlp_lr_max_steps)
    lrs_gs = {"xyz": gs_lr(it), "f_dc": o.feature_lr, "f_rest": o.feature_lr / 20.0, "opacity": o.opacity_lr,
              "scaling": o.scaling_lr, "rotation": o.rotation_lr, "feature": o.feature_lr}
    lr_s = 5e-4 if flags["warm"] else skel_lr(max(it - o.skeleton_warm_up, 0))
    return TS2.stage2_step(state, frame, uid, bg, lrs_gs, lr_s, pdx[uid], pdj[uid], **kw, **flags)


def _leaves(st) -> dict:
    """Every tensor of a stage-2 state by name."""
    out = {f"gs.{k}": v for k, v in st.gs.params_dict().items()}
    out["gs.alive"] = st.gs.alive
    out.update({f"skel.{k}": v for k, v in st.skel.named_parameters()})
    out.update({f"skel.{k}": v for k, v in st.skel.named_buffers()})
    for name, opt in (("opt_gs", st.opt_gs), ("opt_skel", st.opt_skel)):
        for i, v in enumerate(tree_leaves((opt.mu, opt.nu, opt.count))):
            out[f"{name}.{i}"] = v
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out[f"stats.{k}"] = getattr(st.stats_gs, k)
    out["proj_loss"], out["it"] = st.proj_loss, st.it
    return out


def _replaced(st, device):
    """A state made outside the step from ``st``'s values: every tensor a
    new one (as a densification or a loaded checkpoint gives), the
    statistics fresh."""
    st = copy.deepcopy(st)
    return dataclasses.replace(st, stats_gs=TG.init_densify_stats(st.gs.capacity, device=device))


def _move_nodes(st):
    """Assign new control nodes to the state's own skeleton, as
    ``train_stage2``'s FPS reset does."""
    st.skel.control_nodes = st.skel.control_nodes + 0.5


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


# (uid, what happens to the state before the step): the template frame at
# step 3, a state replaced from outside at step 5, control nodes assigned to
# the step's own skeleton at step 6, the xyz and skeleton rates moving every
# step (it from 15001)
SEQUENCE = [(1, None), (2, None), (3, None), (0, None), (1, None), (2, "replace"), (3, "nodes"), (1, None)]


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "stand_in_replays"])
def test_static_buffer_step_is_stage2_step_bit_for_bit(graphed, request):
    if graphed:
        request.getfixturevalue("fake_graphs")
    cfg, state, frames, pdx, pdj = _avatar("cpu")
    bg = torch.zeros(3)
    kw = dict(use_chamfer=True, lambda_dssim=0.2, max_per_tile=512)
    ref = copy.deepcopy(state)
    auto = TS2.make_stage2_auto(cfg, template_idx=TEMPLATE)
    given = state
    prev = None
    for k, (uid, event) in enumerate(SEQUENCE):
        it = 15001 + k
        if event == "replace":
            given, ref = _replaced(given, "cpu"), _replaced(ref, "cpu")
        elif event == "nodes":
            _move_nodes(given)
            _move_nodes(ref)
        given, m = auto(given, frames[uid], uid, bg, pdx, pdj, it=it, **kw)
        ref, rm = _reference_step(cfg, ref, frames[uid], uid, bg, pdx, pdj, it, **kw)
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
    g = auto.graphs
    # the frames 1, 2, 3 share a key: three eager calls, then the capture
    # (and its first replay) at step 4, replays at steps 5 to 7
    assert (g.eager, g.captures, g.replays) == ((4, 1, 4) if graphed else (len(SEQUENCE), 0, 0))
    assert int(given.it) == int(state.it) + len(SEQUENCE)
    assert torch.equal(given.skel.control_nodes, ref.skel.control_nodes)


def test_the_key_and_the_capture_after_three_eager_calls(fake_graphs):
    cfg, state, frames, pdx, pdj = _avatar("cpu")
    _, _, small, _, _ = _avatar("cpu", size=48)
    bg = torch.zeros(3)
    auto = TS2.make_stage2_auto(cfg, template_idx=TEMPLATE)
    g = auto.graphs
    with torch.no_grad():
        counts = render(frames[1].cam, state.gs, bg, max_per_tile=512)["tile_counts"].numpy()
    ladder = make_tile_ladder(counts[None], n_buckets=2)

    def step(uid, it, fr=None, **kw):
        nonlocal state
        kw.setdefault("max_per_tile", 512)
        state, _ = auto(state, frames[uid] if fr is None else fr, uid, bg, pdx, pdj, it=it, **kw)
        return len(g.seen)

    assert step(1, 15001) == 1
    assert step(2, 15002) == 1 and step(3, 15010) == 1  # a new frame, it and uid: the same key
    assert (g.eager, g.captures) == (3, 0)
    assert step(1, 15011) == 1 and (g.eager, g.captures, g.replays) == (3, 1, 1)  # the fourth call captures
    assert step(2, 15012) == 1 and (g.captures, g.replays) == (1, 2)
    assert step(TEMPLATE, 15013) == 2  # the template frame's own lambdas
    assert step(1, 15014, tile_ladder=ladder) == 3  # a ladder
    assert step(1, 15015, max_per_tile=1024) == 4  # a cap
    assert step(1, 500) == 5  # a flag: the skeleton's warm-up
    assert step(1, 15016, fr=small[1]) == 6  # a new shape: 48 x 48
    assert (g.eager, g.captures, g.replays) == (8, 1, 2)
    assert sorted(g.seen.values()) == [1, 1, 1, 1, 1, 3]


def _gap(a, b):
    scale = float(b.abs().max())
    err = float((a.double() - b.double()).abs().max())
    return err / scale if scale > 0 else err


def _p999(a, b):
    err = (a - b).abs().flatten().cpu()
    k = max(1, -(-999 * err.numel() // 1000))
    scale = float(b.abs().max())
    q = float(torch.kthvalue(err, k).values)
    return q / scale if scale > 0 else q


@pytest.mark.card
def test_replays_on_the_card_match_the_eager_step(card):
    """From one seeded state, 18 steps through make_stage2_auto (graphed
    after three eager calls of a key) and 18 of the eager stage2_step: the
    template frame at step 5, a state replaced from outside at step 7 (a
    replay), control nodes assigned to the step's own skeleton at step 9, a
    ladder fitted at step 8 and refitted at 12. Loss, metrics and every
    state leaf agree bit for bit, or, where they do not, within the s2
    cell's limits (the loss's relative gap; each leaf's max |d| over its max
    |value| within ``change``); the renders of the two final states too
    (``render_p999``). The counters read what ran: the graphs' own, and the
    trace counters over the last two steps, under the profiler."""
    from riggs_tpu_torch import trace

    limits = json.loads(LIMITS.read_text())["limits"]
    cfg, state, frames, pdx, pdj = _avatar(card, n=12000, capacity=16384, size=256, n_frames=4)
    bg = torch.zeros(3, device=card)
    ref = copy.deepcopy(state)
    auto = TS2.make_stage2_auto(cfg, template_idx=TEMPLATE)
    with torch.no_grad():
        counts = torch.stack([render(f.cam, state.gs, bg, max_per_tile=1024)["tile_counts"] for f in frames])
    ladders = {8: make_tile_ladder(counts.cpu().numpy(), n_buckets=2),
               12: make_tile_ladder(counts.cpu().numpy(), n_buckets=3)}
    uids = [1, 2, 3, 1, 2, TEMPLATE, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2]
    profiled = len(uids) - 2
    seen, captured, modes = {}, set(), []
    ladder, given, bitwise, worst = None, state, True, {}
    trace.reset()
    for k, uid in enumerate(uids):
        it = 20001 + k
        ladder = ladders.get(k, ladder)
        if k == 7:
            given, ref = _replaced(given, card), _replaced(ref, card)
        if k == 9:
            _move_nodes(given)
            _move_nodes(ref)
        kw = dict(use_chamfer=True, lambda_dssim=0.2, max_per_tile=1024, tile_ladder=ladder)
        key, n = (uid == TEMPLATE, ladder), seen.get((uid == TEMPLATE, ladder), 0)
        if key in captured:
            modes.append("replay")
        elif n < 3 or k >= profiled:  # nothing is captured under the profiler
            modes.append("eager")
            seen[key] = n + 1
        else:
            modes.append("capture")
            captured.add(key)
        if k == profiled:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        given, m = auto(given, frames[uid], uid, bg, pdx, pdj, it=it, **kw)
        ref, rm = _reference_step(cfg, ref, frames[uid], uid, bg, pdx, pdj, it, **kw)
        torch.cuda.synchronize()
        for name, v in rm.items():
            same = torch.equal(m[name], v)
            bitwise &= same
            if not same:
                assert v.is_floating_point(), (k, name, m[name], v)
                worst[name] = max(worst.get(name, 0.0), _gap(m[name], v))
        got = _leaves(given)
        for name, v in _leaves(ref).items():
            same = torch.equal(got[name], v)
            bitwise &= same
            if not same:
                assert v.is_floating_point(), (k, name)
                worst["state"] = max(worst.get("state", 0.0), _gap(got[name], v))
    prof.stop()
    with torch.no_grad():
        img = TS2._eval_image(given.gs, given.skel, frames[1].cam, frames[1].fid, bg, max_per_tile=1024)[0]
        img_ref = TS2._eval_image(ref.gs, ref.skel, frames[1].cam, frames[1].fid, bg, max_per_tile=1024)[0]
    render_p999 = _p999(img, img_ref)
    g = auto.graphs
    print(f"[step_graph] {torch.cuda.get_device_name(0)}: {len(uids)} steps, modes {modes}; eager {g.eager}, "
          f"captures {g.captures}, replays {g.replays}; trace counters over the last two steps {trace.counters()}; "
          f"bitwise {bitwise}; worst gaps {worst}; final render p999 {render_p999:.3e}")
    assert (g.eager, g.captures) == (modes.count("eager"), modes.count("capture"))
    assert g.replays == len(uids) - modes.count("eager") and g.captures >= 2 and modes[7] == "replay"
    assert trace.counters().get("step_graph_replays", 0) == 2 and "step_graph_captures" not in trace.counters()
    assert worst.get("loss", 0.0) <= limits["loss"], worst
    assert worst.get("state", 0.0) <= limits["change"], worst
    assert render_p999 <= limits["render_p999"], render_p999


def test_only_the_graphs_of_the_keys_replayed_last_are_kept(fake_graphs):
    """A key that changes as training goes on (a refitted ladder) leaves
    its old graphs behind: ``MAX_GRAPHS`` are kept, the keys replayed last,
    and a key that comes back is captured again at once."""
    from riggs_tpu_torch.train.step_graph import MAX_GRAPHS, WARMUP

    g, calls = StepGraphs(), []
    cpu = torch.device("cpu")
    for key in range(MAX_GRAPHS + 1):
        for _ in range(WARMUP + 1):
            g.run(key, lambda key=key: calls.append(key), cpu)
        g.run(0, lambda: calls.append(0), cpu)  # key 0 is replayed after every capture: it stays
    assert (g.eager, g.captures) == ((MAX_GRAPHS + 1) * WARMUP, MAX_GRAPHS + 1)
    assert list(g.graphs) == [2, 3, 4, 0] and len(g.graphs) == MAX_GRAPHS  # key 1 went
    g.run(1, lambda: calls.append(1), cpu)  # back: captured again, no eager call
    assert (g.eager, g.captures) == ((MAX_GRAPHS + 1) * WARMUP, MAX_GRAPHS + 2)
    assert list(g.graphs) == [3, 4, 0, 1]
    assert calls.count(1) == WARMUP + 2 and g.replays == len(calls) - g.eager
