"""The stage-2 training loop, train_stage2, in riggs_tpu and in
riggs_tpu_torch, from one converted stage-1 state (tests/
test_torch_stage2_init.py's: init_stage1 with perturbed DeformNetwork
weights, no stage-1 training) on make_scene_data(n_train=6, 64 x 64).

The loop runs 16 steps under a schedule in which every event fires: the
skeleton warm-up (steps 0-3), then the photometric phase; the control-node
FPS reset and the template offsets' unlock at 8 (the skinning MLP's at 9);
the ladder fit after the 12 probe steps; a Gaussian densification at 12
with the ladder's anticipatory refit; evaluate_stage2 on the test frame at
15. The port starts from the reference's initial stage-2 state (via
riggs_tpu_torch.convert) and its draws replay the reference's key chain
(Stage2Draws' one method, the split noise).

Tolerances: frame picks, the FPS indices, alive masks, ladders and refits
exactly equal; each parameter leaf after the loop within three times the
reference's own spread, its max and its median |d| each, plus 1e-6; the
loss and PSNR histories and the test metrics within three times that spread
plus 1e-6 of their scale. The spread is measured in every run: the
reference's loop twice more, once with the skeleton's trainable leaves of
its initial state scaled by 1 + 2^-23 and once with the Gaussians' scaled
by 1 - 2^-24. The two packages' Gaussians differ at rounding level from the
first render on, so the spread takes both. Where the port leaves the
skeleton-only spread (one neuron of the skinning MLP, whose column the
reference itself moves ~9.4e-6 on a last-bit change of its Gaussians), it
must sit on the Gaussian-nudged reference's own value, within the same
bound. Planted faults (the skeleton's MLPs or the skinning MLP alone left
untrained, the template offsets never unlocked, the densification
skipped) must fail the same comparison.
"""
import contextlib
import dataclasses
import io
import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from riggs_tpu.train import sampling as JSampling
from riggs_tpu.train import stage2 as JS2
from riggs_tpu_torch.train import sampling as TSampling
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config as TConfig

from tests.test_torch_densify import reference_split_noise
from tests.test_torch_stage1_step import _port_state as _port_stage1
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_stage2_init import base_cfg, port_scene, stage1_fixture
from tests.test_torch_stage2_step import _np, _skel_ref_layout

SEED = 5
N_STEPS = 16


def loop_cfg(cls):
    cfg = base_cfg(cls)
    m, o, p = cfg.model, cfg.opt, cfg.pipe
    o.num_gs_sample = 0
    m.use_skinning_weight_mlp = m.use_template_offsets = True
    m.skeleton_gs_sample_num = 64
    p.max_per_tile, p.ladder_check_every = 256, 4
    o.iterations_stage2, o.skeleton_warm_up, o.optimize_template_offsets_iters = N_STEPS, 4, 8
    o.gs_densification_iterations, o.densify_from_iter, o.densify_until_iter, o.densification_interval = 9, 5, 14, 4
    # thresholds the first steps' gradients reach
    o.densify_grad_threshold, o.percent_dense = 1e-7, 0.02
    return cfg


class JaxDraws:
    """train_stage2's split noise replayed from the reference loop's key
    chain: PRNGKey(seed), one split for init_stage2, one per densification
    (stage2.py:538-539, 614)."""

    def __init__(self, seed):
        self.key, self.init_key = jax.random.split(jax.random.PRNGKey(seed))

    def split_noise(self, capacity):
        self.key, sk = jax.random.split(self.key)
        return reference_split_noise(sk, capacity)


class _Record:
    """Frame picks (FrameSampler.sample), FPS indices and test metrics of a
    loop, from wrappers around either package's functions."""

    def __init__(self, sampling, stage2):
        self.picks, self.fps, self.tests = [], [], []
        real_sample, real_fps, real_eval = sampling.FrameSampler.sample, stage2.farthest_point_sample, stage2.evaluate_stage2
        rec = self

        def sample(self_, *a, **k):
            out = real_sample(self_, *a, **k)
            rec.picks.append(out)
            return out

        def fps(*a, **k):
            out = real_fps(*a, **k)
            rec.fps.append(np.asarray(out))
            return out

        def evaluate(*a, **k):
            out = real_eval(*a, **k)
            rec.tests.append(out)
            return out

        self.patches = [mock.patch.object(sampling.FrameSampler, "sample", sample),
                        mock.patch.object(stage2, "farthest_point_sample", fps),
                        mock.patch.object(stage2, "evaluate_stage2", evaluate)]

    def __enter__(self):
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def _scaled_init(scale, part):
    """The reference's init_stage2 with every trainable leaf of one part of
    its state ("gs" or "skel") scaled by ``scale``."""
    real = JS2.init_stage2

    def init(*a, **k):
        st, info, frames = real(*a, **k)
        if scale != 1.0:
            mul = lambda t: jax.tree.map(lambda x: x * np.float32(scale), t)
            sub = getattr(st, part)
            st = dataclasses.replace(st, **{part: sub.replace_params(mul(sub.params_dict()))})
        return st, info, frames

    return init


def _reference_loop(fx, scale=1.0, part="skel"):
    """riggs_tpu's train_stage2 (one part of its initial state's leaves
    scaled), with its frame picks, FPS indices, test metrics and ladder
    telemetry."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), _Record(JSampling, JS2) as rec, \
            mock.patch.object(JS2, "init_stage2", _scaled_init(scale, part)):
        state, _, hist = JS2.train_stage2(fx["j1"], fx["js"], fx["jcfg"], seed=SEED, log_every=1, test_every=N_STEPS - 1)
    m = re.search(r"\[S2 ladder\] refits=(\d+) ladder=(.*)", out.getvalue())
    return dict(state=state, hist=hist, rec=rec, refits=int(m.group(1)), ladder=m.group(2).strip())


def _port_init(fx):
    """The reference's initial stage-2 state, converted."""
    draws = JaxDraws(SEED)
    js, _, _ = JS2.init_stage2(draws.init_key, fx["j1"], fx["js"], fx["jcfg"])
    skel = js.skel
    from riggs_tpu_torch import convert

    adam = lambda o: (_np(o.mu), _np(o.nu), int(o.count))
    return convert.stage2_state_from_numpy(
        _np(js.gs.params_dict()), np.asarray(js.gs.alive), js.gs.max_sh_degree, _np(skel.params_dict()),
        np.asarray(skel.joints), skel.net.parents, adam(js.opt_gs), adam(js.opt_skel),
        tuple(np.asarray(a) for a in (js.stats_gs.xyz_gradient_accum, js.stats_gs.denom, js.stats_gs.max_radii2d)),
        np.asarray(js.proj_loss), isotropic=js.gs.isotropic, with_motion_mask=js.gs.with_motion_mask,
        K=skel.net.K, use_skinning_mlp=skel.net.use_skinning_mlp, use_template_offsets=skel.net.use_template_offsets,
        control_nodes=np.asarray(skel.control_nodes), device="cpu")


def _port_loop(fx):
    events, steps = [], []
    with _Record(TSampling, TS2) as rec:
        state, info, hist = TS2.train_stage2(
            _port_stage1(fx["j1"]), port_scene(fx["js"]), loop_cfg(TConfig), seed=SEED, log_every=1,
            test_every=N_STEPS - 1, state=_port_init(fx), draws=JaxDraws(SEED), events=events,
            step_callback=lambda st, it: steps.append(it), device="cpu")
    return dict(state=state, info=info, hist=hist, rec=rec, events=events, steps=steps)


@pytest.fixture(scope="module")
def loops():
    js, jcfg, j1 = stage1_fixture(loop_cfg, n_test=1)
    fx = dict(js=js, jcfg=jcfg, j1=j1)
    fx["ref"] = _reference_loop(fx)
    # the skeleton's nudge first, the Gaussians' second
    fx["nudges"] = [_reference_loop(fx, 1 + 2.0 ** -23, "skel"), _reference_loop(fx, 1 - 2.0 ** -24, "gs")]
    fx["port"] = _port_loop(fx)
    return fx


def test_train_stage2_events_fire_and_discrete_outcomes_match(loops):
    ref, port = loops["ref"], loops["port"]
    assert port["steps"] == list(range(N_STEPS))
    kinds = [(e["it"], e["event"]) for e in port["events"]]
    for want in [(8, "fps reset"), (11, "ladder fit"), (12, "gs densify"), (12, "ladder anticipate"),
                 (N_STEPS - 1, "test")]:
        assert want in kinds, (want, kinds)
    assert not [e for e in port["events"] if e["event"] == "overflow"], port["events"]
    dens = [e for e in port["events"] if e["event"] == "gs densify"][0]
    assert dens["after"] > dens["before"], dens
    assert port["rec"].picks == ref["rec"].picks and len(set(ref["rec"].picks)) > 3
    assert len(ref["rec"].fps) == len(port["rec"].fps) == 1
    np.testing.assert_array_equal(port["rec"].fps[0], ref["rec"].fps[0])
    reset = [e for e in port["events"] if e["event"] == "fps reset"][0]
    np.testing.assert_array_equal(reset["idx"].numpy(), ref["rec"].fps[0])
    js, ts = ref["state"], port["state"]
    np.testing.assert_array_equal(ts.gs.alive.numpy(), np.asarray(js.gs.alive))
    # the reset's rows of the means, which the steps before it trained
    np.testing.assert_allclose(ts.skel.control_nodes.numpy(), np.asarray(js.skel.control_nodes), atol=1e-6, rtol=0)
    final = [e for e in port["events"] if e["event"] == "ladder"][-1]
    assert final["refits"] == ref["refits"] >= 1
    assert str(final["ladder"]) == ref["ladder"]
    assert int(ts.it) == int(js.it) == N_STEPS


def _spread(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return (float(d.max()), float(np.median(d))) if d.size else (0.0, 0.0)


def _leaves(state):
    """Every trained leaf of a reference state (alive rows of the Gaussians)."""
    alive = np.asarray(state.gs.alive)
    out = {f"gs.{k}": np.asarray(v)[alive] for k, v in state.gs.params_dict().items()}
    out.update({f"skel{jax.tree_util.keystr(p)}": a
                for p, a in jax.tree_util.tree_flatten_with_path(_np(state.skel.params_dict()))[0]})
    return out


def _port_leaves(state):
    alive = state.gs.alive.numpy()
    out = {f"gs.{k}": v.detach().numpy()[alive] for k, v in state.gs.params_dict().items()}
    out.update({f"skel{jax.tree_util.keystr(p)}": a for p, a in
                jax.tree_util.tree_flatten_with_path(_skel_ref_layout(state.skel.params_dict()))[0]})
    return out


PAIRS = ((0, 1), (0, 2), (1, 2))


def _leaf_readings(loops, tstate):
    """Per leaf: the port's max and median |d| against the reference, the
    reference's own spread over its three runs, and whether the port is
    within 3x each plus 1e-6."""
    runs = [_leaves(loops["ref"]["state"])] + [_leaves(n["state"]) for n in loops["nudges"]]
    port, ref = _port_leaves(tstate), runs[0]
    assert set(port) == set(ref)
    out = {}
    for k in ref:
        if port[k].shape != ref[k].shape:
            out[k] = dict(port_max=np.inf, port_median=np.inf, ref_max=0.0, ref_median=0.0, ok=False)
            continue
        pm, p50 = _spread(port[k], ref[k])
        sm = max(_spread(runs[i][k], runs[j][k])[0] for i, j in PAIRS)
        s50 = max(_spread(runs[i][k], runs[j][k])[1] for i, j in PAIRS)
        out[k] = dict(port_max=pm, port_median=p50, ref_max=sm, ref_median=s50,
                      ok=pm <= 3 * sm + 1e-6 and p50 <= 3 * s50 + 1e-6)
    return out


def _discrete_mismatches(loops, port):
    ref = loops["ref"]
    bad = []
    if not np.array_equal(port["state"].gs.alive.numpy(), np.asarray(ref["state"].gs.alive)):
        bad.append("alive")
    if len(port["rec"].fps) != 1 or not np.array_equal(port["rec"].fps[0], ref["rec"].fps[0]):
        bad.append("fps")
    if port["rec"].picks != ref["rec"].picks:
        bad.append("picks")
    return bad


def test_train_stage2_parameters_history_and_test_metrics_match(loops):
    for n in loops["nudges"]:
        np.testing.assert_array_equal(np.asarray(n["state"].gs.alive), np.asarray(loops["ref"]["state"].gs.alive))
        assert n["refits"] == loops["ref"]["refits"]
    assert _discrete_mismatches(loops, loops["port"]) == []
    readings = _leaf_readings(loops, loops["port"]["state"])
    for k, r in readings.items():
        print(f"{k}: port max {r['port_max']:.3e} median {r['port_median']:.3e}; reference spread max "
              f"{r['ref_max']:.3e} median {r['ref_median']:.3e}")
    bad = {k: r for k, r in readings.items() if not r["ok"]}
    assert not bad, bad
    hists = [loops["ref"]["hist"]] + [n["hist"] for n in loops["nudges"]]
    th = loops["port"]["hist"]
    assert [i for i, _ in hists[0]] == [i for i, _ in th] == list(range(N_STEPS))
    for k in ("loss", "psnr"):
        rows = [[m[k] for _, m in h] for h in hists]
        port_d = max(abs(b - a) for a, b in zip(rows[0], [m[k] for _, m in th]))
        ref_d = max(abs(rows[i][t] - rows[j][t]) for i, j in PAIRS for t in range(N_STEPS))
        assert port_d <= 3 * ref_d + 1e-6 * max(abs(a) for a in rows[0]), (k, port_d, ref_d)
    tests = [loops["ref"]["rec"].tests[0]] + [n["rec"].tests[0] for n in loops["nudges"]]
    ptest = loops["port"]["rec"].tests[0]
    event = [e for e in loops["port"]["events"] if e["event"] == "test"][0]
    assert {k: event[k] for k in ptest} == ptest
    for k in ("psnr", "ssim", "ms_ssim"):
        ref_d = max(abs(tests[i][k] - tests[j][k]) for i, j in PAIRS)
        assert abs(ptest[k] - tests[0][k]) <= 3 * ref_d + 1e-6 * abs(tests[0][k]), (k, ptest[k], tests[0][k], ref_d)


def test_port_leaves_the_skeleton_only_spread_only_where_the_gaussian_nudge_does(loops):
    """Every entry where the port is further from the reference than 3x the
    skeleton-only spread plus 1e-6 holds the Gaussian-nudged reference's
    value within that bound: the port took a branch the reference itself
    takes on a last-bit change of its Gaussians."""
    base, skel, gs = (_leaves(r["state"]) for r in [loops["ref"]] + loops["nudges"])
    port = _port_leaves(loops["port"]["state"])
    outliers = 0
    for k in base:
        lim = 3 * _spread(skel[k], base[k])[0] + 1e-6
        far = np.abs(port[k].astype(np.float64) - base[k]) > lim
        if far.any():
            gap = np.abs(port[k].astype(np.float64) - gs[k])[far]
            cols = sorted(set(np.argwhere(far)[:, -1].tolist()))
            print(f"{k}: {int(far.sum())} entries past the skeleton-only bound {lim:.3e} (last index {cols}); port "
                  f"max |d| {np.abs(port[k] - base[k])[far].max():.3e}, from the Gaussian-nudged reference "
                  f"max {gap.max():.3e}")
            assert gap.max() <= lim, (k, gap.max(), lim)
            outliers += int(far.sum())
    print(f"{outliers} entries past the skeleton-only bound in all")


def _untrained(part):
    """The skeleton's parameters whose name holds ``part`` keep their
    weights through every step."""
    real = TS2.stage2_step

    def step(state, *a, **k):
        keep = {n: p.detach().clone() for n, p in state.skel.named_parameters() if part in n}
        new, metrics = real(state, *a, **k)
        with torch.no_grad():
            for n, p in new.skel.named_parameters():
                if n in keep:
                    p.copy_(keep[n])
        return new, metrics

    return mock.patch.object(TS2, "stage2_step", step)


def _offsets_locked():
    real = TS2.stage2_flags
    return mock.patch.object(TS2, "stage2_flags", lambda *a, **k: dict(real(*a, **k), enable_to=False))


def _no_densification():
    return mock.patch.object(TS2, "densify_step", lambda state, *a, **k: state)


FAULTS = {
    "skeleton MLPs untrained": lambda: _untrained("mlp"),
    "skinning MLP untrained": lambda: _untrained("weight_mlp"),
    "template offsets never unlocked": _offsets_locked,
    "densification skipped": _no_densification,
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_train_stage2_comparison_rejects_a_planted_fault(loops, fault):
    with FAULTS[fault]():
        port = _port_loop(loops)
    discrete = _discrete_mismatches(loops, port)
    out = [k for k, r in _leaf_readings(loops, port["state"]).items() if not r["ok"]]
    print(f"{fault}: discrete outcomes differing {discrete}, {len(out)} leaves out of bounds {out}")
    assert discrete or out


def test_train_stage2_raises_for_what_is_not_ported(tmp_path):
    """train_stage2's model_path, logger and resume are ported
    (tests/test_torch_eval_io.py), and so are the sharded checkpoints and
    the pipeline's frame-parallel --dp (ROADMAP A11): the sharded pair
    round-trips the loop's state and --dp 2 --dp_tile 2 parses. The viewer
    and debugging flags (A10) parse too: the pipeline lacks nothing now
    (tests/test_torch_cli.py runs each)."""
    import copy

    from riggs_tpu_torch.io import checkpoint as TC
    from scripts import torch_run_pipeline
    from scripts.torch_scaling_bench import build_tiny_scene

    state = build_tiny_scene(32, 32, n_train=2, render_gt=False, device="cpu")[1]
    TC.save_checkpoint_sharded(tmp_path, 4, state)
    back, it = TC.load_checkpoint_sharded(tmp_path, copy.deepcopy(state))
    want = TC.state_to_numpy(state)
    got = TC.state_to_numpy(back)
    assert it == 4 and set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    args = torch_run_pipeline.parse_args(["--synthetic", "--dp", "2", "--dp_tile", "2"])
    assert (args.dp, args.dp_tile) == (2, 2)
    args = torch_run_pipeline.parse_args(["--synthetic", "--viewer_port", "8000", "--gui_port", "6009",
                                          "--detect_anomaly"])
    assert (args.viewer_port, args.gui_port, args.detect_anomaly) == (8000, 6009, True)
