"""The stage-1 training loop in riggs_tpu and in riggs_tpu_torch, and the
host-side pieces it drives: FrameSampler, LadderPolicy, the synthetic scene
with its thinned skeletons, and train_stage1 itself.

The loop runs 8 phase-A and 16 phase-B steps on make_scene_data(n_train=6,
64 x 64) with a schedule under which every event fires: node-Gaussian
densification (phase A, it 4), node sampling (6) and finalize_nodes, the
ladder fit after the 12 probe steps, Gaussian densification with the
ladder's anticipatory refit (12), a forced node densify/prune (5) and an
opacity reset (9). The port starts from the reference's initial state (via
riggs_tpu_torch.convert) and trains on the reference's frames; its draws
replay the reference's key chain split for split (JaxDraws).

Tolerances: alive masks, node counts, frame picks, ladders and refits
exactly equal; thinned points exactly equal and cameras_extent to 1e-6;
scene images 3e-5 (the oracle's, tests/test_torch_render.py); each
parameter leaf after the loop within three times the reference's own
spread, its max and its median |d| each, plus 1e-6; the loss and PSNR
histories within three times that spread too. The spread is measured in
every run: the reference's loop twice more with its DeformNetwork's weights
changed in the last bit (phase A's regularizers normalize
cancellation-level gradients, so from a fresh Adam state a last-bit change
moves some weights by about their learning rate). The port's readings
against it are printed per leaf; planted faults (a phase's warp or node
Gaussians left untrained, a regularizer weighted 0) must fail the same
comparison.
"""
import contextlib
import dataclasses
import io
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.data import synthetic as JSyn
from riggs_tpu.data.dataset import thin_mask_skeleton as j_thin
from riggs_tpu.render.ladder import LadderPolicy as JLadderPolicy
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu.train.sampling import FrameSampler as JFrameSampler
from riggs_tpu_torch.data import synthetic as TSyn
from riggs_tpu_torch.data.dataset import SceneData as TScene, thin_mask_skeleton as t_thin
from riggs_tpu_torch.render.ladder import LadderPolicy as TLadderPolicy
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config as TConfig
from riggs_tpu_torch.train.sampling import FrameSampler as TFrameSampler

from tests.test_torch_densify import reference_split_noise
from tests.test_torch_phase_a import reference_reg_t
from tests.test_torch_stage1_modules import _reference_arap_t
from tests.test_torch_stage1_step import _port_frame, _port_state
from tests.test_torch_stage2_step import _np, _skel_ref_layout

SEED = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch ops on one intra-op thread: a loop of many small
    ops under the suite's parallel workers otherwise oversubscribes the
    cores, and the idle threads' spinning slowed such files some 40-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Fid:
    def __init__(self, fid):
        self.fid = fid


@pytest.mark.parametrize("mode", ["uniform", "progressive", "warmup"])
def test_frame_sampler_picks_match(mode):
    fids = np.random.default_rng(0).permutation(np.linspace(0, 1, 50, endpoint=False))
    frames = [_Fid(f) for f in fids]
    js, ts = JFrameSampler(frames, np.random.default_rng(5)), TFrameSampler(frames, np.random.default_rng(5))
    kw = dict(progressive=mode == "progressive", stage_ratio=0.2, stage_steps=30,
              warmup_until=40 if mode == "warmup" else 0)
    picks = [(js.sample(it, **kw), ts.sample(it, **kw)) for it in range(120)]
    assert [a for a, _ in picks] == [b for _, b in picks]
    assert len({a for a, _ in picks}) > 5


def test_ladder_policy_ladders_and_refits_match():
    """A recorded count sequence: 12 probe steps, a step past the envelope
    (overflow), growth under densification (anticipate), a shrink."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 900, size=64)
    seq = [(base * rng.uniform(0.8, 1.1, size=64)).astype(np.int32) for _ in range(14)]
    seq.append((base * 3.5).astype(np.int32))
    pols = [JLadderPolicy(n_buckets=4, margin=1.3), TLadderPolicy(n_buckets=4, margin=1.3)]
    trail = [[], []]
    for i, c in enumerate(seq):
        for p, tr in zip(pols, trail):
            # the laddered render's overflow: tiles past their rank's cap
            caps = None if p.ladder is None else np.repeat([cap for _, cap in p.ladder], [n for n, _ in p.ladder])
            of = 0 if caps is None else int((np.sort(c)[::-1] > caps).sum())
            tr.append((p.observe(c, of), p.ladder, p.refits))
            if i == 13:
                tr.append((p.anticipate(2.5), p.ladder, p.refits))
    for p, tr in zip(pols, trail):
        tr.append((p.anticipate(0.5), p.ladder, p.refits))
    assert trail[0] == trail[1]
    assert pols[1].refits >= 2 and pols[1].ladder is not None


def test_thin_mask_skeleton_and_scene_match():
    yy, xx = np.mgrid[:80, :80]
    mask = ((yy - 40) ** 2 / 600 + (xx - 35) ** 2 / 90 < 1) | ((yy - 25) ** 2 / 40 + (xx - 45) ** 2 / 500 < 1)
    np.testing.assert_array_equal(t_thin(mask), j_thin(mask))
    _, js = JSyn.make_scene_data(n_train=6, n_test=2, width=64, height=64, max_thinned=128, n_init_points=200)
    _, ts = TSyn.make_scene_data(n_train=6, n_test=2, width=64, height=64, max_thinned=128, n_init_points=200,
                                 device="cpu")
    np.testing.assert_array_equal(ts.init_points, js.init_points)
    np.testing.assert_array_equal(ts.init_colors, js.init_colors)
    np.testing.assert_allclose(ts.cameras_extent, js.cameras_extent, rtol=1e-6)
    assert ts.time_interval == js.time_interval
    for a, b in zip(js.train_frames + js.test_frames, ts.train_frames + ts.test_frames):
        np.testing.assert_array_equal(b.thinned.numpy(), np.asarray(a.thinned))
        np.testing.assert_array_equal(b.thinned_mask.numpy(), np.asarray(a.thinned_mask))
        np.testing.assert_allclose(b.image.numpy(), np.asarray(a.image), atol=3e-5, rtol=0)
        np.testing.assert_allclose(b.alpha_mask.numpy(), np.asarray(a.alpha_mask), atol=3e-5, rtol=0)
        assert float(b.fid) == float(a.fid)
        np.testing.assert_array_equal(b.cam.w2c.numpy(), np.asarray(a.cam.w2c))
    assert int(ts.train_frames[0].thinned_mask.sum()) > 10


class JaxDraws:
    """train_stage1's draws replayed from the reference loop's key chain:
    one split per phase-A step (then phase_a_step's three), per
    densification and per phase-B step, in the reference's order
    (stage1.py:823, 843, 899-935)."""

    def __init__(self, key):
        self.key = key

    def _next(self):
        self.key, sk = jax.random.split(self.key)
        return sk

    def phase_a(self, fid, time_interval):
        return reference_reg_t(self._next(), jnp.float32(float(fid)), time_interval)

    def phase_b(self):
        return torch.as_tensor(_reference_arap_t(self._next()))

    def split_noise(self, capacity):
        return reference_split_noise(self._next(), capacity)


def _loop_cfg(cls):
    cfg = cls()
    m, o, p = cfg.model, cfg.opt, cfg.pipe
    m.capacity, m.node_num, m.sh_degree, m.hyper_dim = 512, 24, 1, 2
    p.max_per_tile, p.ladder_check_every = 256, 4
    o.iterations_node_rendering, o.iterations_node_sampling, o.node_warm_up = 8, 6, 2
    o.node_max_num_ratio_during_init = 4
    # the interval is both phases': phase A densifies at 4, phase B at 12 only
    o.densification_interval, o.densify_from_iter, o.densify_until_iter = 4, 11, 14
    o.iterations, o.warm_up, o.oneupSHdegree_step = 16, 3, 8
    o.node_force_densify_prune_step, o.opacity_reset_interval = 5, 9
    # thresholds the first steps' gradients reach
    o.densify_grad_threshold, o.percent_dense = 1e-7, 0.02
    return cfg


def _port_scene(js):
    return TScene(js.init_points, js.init_colors, is_blender=js.is_blender,
                  train_frames=[_port_frame(f) for f in js.train_frames], cameras_extent=js.cameras_extent,
                  white_background=js.white_background)


def _reference_loop(jscene, jcfg, init=None):
    """riggs_tpu's train_stage1 (its init_stage1 replaced by ``init`` when
    given), with the refits its ladder telemetry prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), mock.patch.object(JS1, "init_stage1", init or JS1.init_stage1):
        state, hist = JS1.train_stage1(jscene, jcfg, seed=SEED, log_every=1)
    m = re.search(r"\[S1 ladder\] refits=(\d+) ladder=(.*)", out.getvalue())
    return state, hist, int(m.group(1)), m.group(2).strip()


def _scaled_init(init, scale):
    """``init`` with the DeformNetwork's weights scaled by ``scale``."""
    def scaled(*a, **k):
        st = init(*a, **k)
        w = st.warp
        return dataclasses.replace(st, warp=w.replace_params(dict(
            w.params_dict(), mlp=jax.tree.map(lambda x: x * np.float32(scale), w.mlp))))
    return scaled


def _port_loop(loops):
    """The port's loop from the reference's initial state, on the
    reference's frames, with its draws replayed from the reference's keys."""
    events, steps = [], []
    state, hist = TS1.train_stage1(_port_scene(loops["jscene"]), _loop_cfg(TConfig), seed=SEED, log_every=1,
                                   state=_port_state(loops["j0"]), draws=JaxDraws(loops["key"]), events=events,
                                   step_callback=lambda st, it, phase: steps.append((phase, it)), device="cpu")
    return state, hist, events, steps


@pytest.fixture(scope="module")
def loops():
    """The reference's loop, the port's from the reference's initial state,
    and the reference's twice more with its DeformNetwork's weights scaled
    by 1 + 2^-23 and 1 - 2^-24 (its own spread under a last-bit change)."""
    _, jscene = JSyn.make_scene_data(n_train=6, n_test=1, width=64, height=64, max_thinned=128, n_init_points=200)
    # the node Gaussians start black (SH-0 colour clamped at 0): rendered on
    # black they leave every pixel black and phase A's photometric loss has
    # no gradient, so the node densification would select nothing
    jscene = dataclasses.replace(jscene, white_background=True)
    jcfg = _loop_cfg(JConfig)
    key = jax.random.PRNGKey(SEED)
    key, ik = jax.random.split(key)
    init = JS1.init_stage1
    out = dict(jscene=jscene, j0=init(ik, jscene, jcfg), key=key, cfg=jcfg)
    out["jstate"], out["jhist"], out["jrefits"], out["jladder"] = _reference_loop(jscene, jcfg)
    out["nudges"] = [_reference_loop(jscene, jcfg, _scaled_init(init, s)) for s in (1 + 2.0 ** -23, 1 - 2.0 ** -24)]
    out["tstate"], out["thist"], out["events"], out["steps"] = _port_loop(out)
    return out


def test_train_stage1_events_fire_and_counts_match(loops):
    ev, cfg = loops["events"], loops["cfg"]
    # step_callback after every step of both phases
    assert loops["steps"] == ([("A", i) for i in range(cfg.opt.iterations_node_rendering)]
                              + [("B", i) for i in range(cfg.opt.iterations)])
    kinds = [(e["phase"], e["it"], e["event"]) for e in ev]
    for want in [("A", 4, "node_gs densify"), ("A", 6, "node sampling"), ("B", 5, "node densify/prune"),
                 ("B", 12, "gs densify"), ("B", 9, "opacity reset"), ("B", 11, "ladder fit"),
                 ("B", 12, "ladder anticipate")]:
        assert want in kinds, (want, kinds)
    assert not [e for e in ev if e["event"] == "overflow"], ev
    js, ts, cfg = loops["jstate"], loops["tstate"], loops["cfg"]
    np.testing.assert_array_equal(ts.gs.alive.numpy(), np.asarray(js.gs.alive))
    np.testing.assert_array_equal(ts.node_gs.alive.numpy(), np.asarray(js.node_gs.alive))
    assert ts.warp.node_num == js.warp.node_num
    assert int(ts.node_gs.num_alive) == cfg.model.node_num
    dens = {(e["phase"], e["it"]): e for e in ev if "before" in e}
    for k in (("A", 4), ("B", 5), ("B", 12)):
        assert dens[k]["after"] > dens[k]["before"], dens[k]
    final = [e for e in ev if e["event"] == "ladder"][-1]
    assert final["refits"] == loops["jrefits"] == 1
    assert str(final["ladder"]) == loops["jladder"]
    assert int(ts.it) == int(js.it) == cfg.opt.iterations


def _spread(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return (float(d.max()), float(np.median(d))) if d.size else (0.0, 0.0)


def _leaves(state):
    """Every trained leaf of a reference state (alive rows of the clouds)."""
    out = {}
    for name in ("gs", "node_gs"):
        g = getattr(state, name)
        alive = np.asarray(g.alive)
        out.update({f"{name}.{k}": np.asarray(v)[alive] for k, v in g.params_dict().items()})
    out.update({f"warp{jax.tree_util.keystr(p)}": a
                for p, a in jax.tree_util.tree_flatten_with_path(_np(state.warp.params_dict()))[0]})
    return out


PAIRS = ((0, 1), (0, 2), (1, 2))


def _port_leaves(state):
    """Every trained leaf of a port state, in _leaves' names and layout."""
    out = {f"{name}.{k}": v.numpy()[getattr(state, name).alive.numpy()]
           for name in ("gs", "node_gs") for k, v in getattr(state, name).params_dict().items()}
    out.update({f"warp{jax.tree_util.keystr(p)}": a for p, a in
                jax.tree_util.tree_flatten_with_path(_skel_ref_layout(state.warp.params_dict()))[0]})
    return out


def _leaf_readings(loops, tstate):
    """Per leaf: the port's max and median |d| against the reference, the
    reference's own spread (the largest max and median |d| among its three
    runs), and whether the port is within 3x each plus 1e-6."""
    runs = [_leaves(loops["jstate"])] + [_leaves(n[0]) for n in loops["nudges"]]
    port, ref = _port_leaves(tstate), runs[0]
    assert set(port) == set(ref)
    out = {}
    for k in ref:
        if port[k].shape != ref[k].shape:  # a node count or an alive count differs
            out[k] = dict(port_max=np.inf, port_median=np.inf, ref_max=0.0, ref_median=0.0, ok=False)
            continue
        pm, p50 = _spread(port[k], ref[k])
        sm = max(_spread(runs[i][k], runs[j][k])[0] for i, j in PAIRS)
        s50 = max(_spread(runs[i][k], runs[j][k])[1] for i, j in PAIRS)
        out[k] = dict(port_max=pm, port_median=p50, ref_max=sm, ref_median=s50,
                      ok=pm <= 3 * sm + 1e-6 and p50 <= 3 * s50 + 1e-6)
    return out


def _discrete_mismatches(loops, tstate):
    """The discrete outcomes of the port's loop that differ from the
    reference's: alive masks and the node count."""
    js = loops["jstate"]
    bad = [name for name in ("gs", "node_gs")
           if not np.array_equal(getattr(tstate, name).alive.numpy(), np.asarray(getattr(js, name).alive))]
    return bad + (["node_num"] if tstate.warp.node_num != js.warp.node_num else [])


def test_train_stage1_parameters_and_history_match(loops):
    """Each parameter leaf within three times the reference's own spread
    (the largest max and median |d| among its three runs) plus 1e-6, and
    so the loss and PSNR histories of each phase: phase A's regularizers
    normalize cancellation-level gradients (acc_loss divides the second
    difference of the node trajectories by its own detached norm), so from
    a fresh Adam state a last-bit change moves the reference's own weights
    by about their learning rate. Alive masks and counts exactly equal.
    Prints each leaf's readings (pytest -s)."""
    for n in loops["nudges"]:
        np.testing.assert_array_equal(np.asarray(n[0].gs.alive), np.asarray(loops["jstate"].gs.alive))
        assert n[2] == loops["jrefits"]
    assert _discrete_mismatches(loops, loops["tstate"]) == []
    readings = _leaf_readings(loops, loops["tstate"])
    for k, r in readings.items():
        print(f"{k}: port max {r['port_max']:.3e} median {r['port_median']:.3e}; reference spread max "
              f"{r['ref_max']:.3e} median {r['ref_median']:.3e}; ratios {r['port_max'] / max(r['ref_max'], 1e-30):.2f} "
              f"{r['port_median'] / max(r['ref_median'], 1e-30):.2f}")
    bad = {k: r for k, r in readings.items() if not r["ok"]}
    assert not bad, bad
    hists = [loops["jhist"]] + [n[1] for n in loops["nudges"]]
    th = loops["thist"]
    assert [(p, i) for p, i, _ in hists[0]] == [(p, i) for p, i, _ in th]
    for phase in ("A", "B"):
        rows = [[m for p, _, m in h if p == phase] for h in hists]
        trows = [m for p, _, m in th if p == phase]
        for k in ("loss", "psnr"):
            port_d = max(abs(b[k] - a[k]) for a, b in zip(rows[0], trows))
            ref_d = max(abs(rows[i][t][k] - rows[j][t][k]) for i, j in PAIRS for t in range(len(trows)))
            assert port_d <= 3 * ref_d + 1e-6 * max(abs(a[k]) for a in rows[0]), (phase, k, port_d, ref_d)
        for k in ("n_gs", "n_node_gs"):
            assert all(b[k] == a[k] for a, b in zip(rows[0], trows) if k in a), (phase, k)


def _untrained(step_name, field, opt_field):
    """Replace stage 1's ``step_name`` by one that returns ``field`` (and
    its Adam state ``opt_field``) as it was before the step."""
    real = getattr(TS1, step_name)

    def step(state, *a, **k):
        new, metrics = real(state, *a, **k)
        return dataclasses.replace(new, **{field: getattr(state, field), opt_field: getattr(state, opt_field)}), metrics

    return mock.patch.object(TS1, step_name, step)


def _zero_weight(loss_name):
    real = getattr(TS1.NW, loss_name)
    return mock.patch.object(TS1.NW, loss_name, lambda *a, **k: 0.0 * real(*a, **k))


FAULTS = {
    "phase A warp untrained": lambda: _untrained("phase_a_step", "warp", "opt_warp"),
    "phase A node Gaussians untrained": lambda: _untrained("phase_a_step", "node_gs", "opt_node"),
    "phase B warp untrained": lambda: _untrained("phase_b_step", "warp", "opt_warp"),
    "elastic weight 0": lambda: _zero_weight("elastic_loss"),
    "acceleration weight 0": lambda: _zero_weight("acc_loss"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_train_stage1_comparison_rejects_a_planted_fault(loops, fault):
    """The port's loop with ``fault`` planted fails the comparison above: a
    discrete outcome differs, or some leaf leaves its bound."""
    with FAULTS[fault]():
        tstate = _port_loop(loops)[0]
    discrete = _discrete_mismatches(loops, tstate)
    out = [k for k, r in _leaf_readings(loops, tstate).items() if not r["ok"]]
    print(f"{fault}: discrete outcomes differing {discrete}, {len(out)} leaves out of bounds {out}")
    assert discrete or out


def test_loop_modules_import_without_jax():
    """The loop's new modules, numpy-only thinning included, import neither
    jax nor riggs_tpu (test_torch_slice.py walks the whole package too)."""
    import subprocess
    import sys
    from pathlib import Path

    mods = ("riggs_tpu_torch.train.static", "riggs_tpu_torch.train.sampling", "riggs_tpu_torch.data.synthetic",
            "riggs_tpu_torch.data.thinning", "riggs_tpu_torch.train.stage1")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'riggs_tpu')))\n")
    repo = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", (res.stdout, res.stderr)


def test_convert_takes_a_trained_state(loops):
    """stage1_state_from_numpy on the reference loop's final state: after
    densification (its alive masks), with more nodes than node_num (the
    node densify/prune added some) and phase A's node Adam state; every
    leaf carried bit for bit."""
    js, cfg = loops["jstate"], loops["cfg"]
    assert js.warp.node_num != cfg.model.node_num and int(js.opt_node.count) > 0
    ts = _port_state(js, it=int(js.it))
    for name in ("gs", "node_gs"):
        a, b = getattr(js, name), getattr(ts, name)
        np.testing.assert_array_equal(b.alive.numpy(), np.asarray(a.alive))
        for k, v in a.params_dict().items():
            np.testing.assert_array_equal(b.params_dict()[k].numpy(), np.asarray(v), err_msg=f"{name}.{k}")
    ref = jax.tree_util.tree_flatten_with_path(_np(js.warp.params_dict()))[0]
    port = dict(jax.tree_util.tree_flatten_with_path(_skel_ref_layout(ts.warp.params_dict()))[0])
    for path, a in ref:
        np.testing.assert_array_equal(port[path], a, err_msg=jax.tree_util.keystr(path))
    for name in ("opt_gs", "opt_node", "opt_warp"):
        a, b = getattr(js, name), getattr(ts, name)
        conv = _skel_ref_layout if name == "opt_warp" else (lambda t: {k: v.numpy() for k, v in t.items()})
        for m in ("mu", "nu"):
            ra = jax.tree_util.tree_flatten_with_path(_np(getattr(a, m)))[0]
            pb = dict(jax.tree_util.tree_flatten_with_path(conv(getattr(b, m)))[0])
            for path, x in ra:
                np.testing.assert_array_equal(pb[path], x, err_msg=f"{name}.{m}{jax.tree_util.keystr(path)}")
        assert int(b.count) == int(a.count)
    assert ts.warp.node_num == js.warp.node_num and int(ts.it) == int(js.it)
