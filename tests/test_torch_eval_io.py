"""The evaluation back half and the entry points of riggs_tpu_torch against
riggs_tpu: render_test_set (with and without the skinning render),
format_numerical_res, skinning_colors and render_test_set_stage1 on the
reference's untrained rig of make_scene_data at 64 x 64; train_stage2
resumed from one checkpoint by both packages (the CLI twins are in
tests/test_torch_cli.py).

The rig: tests/test_torch_stage2_init.py's stage-1 state (its DeformNetwork
perturbed so that the nodes move) and the reference's init_stage2 on it,
carried to the port through riggs_tpu_torch.convert. Tolerances: images 3e-5
(tests/test_torch_synthesis.py's), skinning colours 1e-6, psnr 1e-4 dB,
ssim and ms_ssim 1e-5; overflow counters exactly equal.

Resume: the reference's train_stage2 runs steps 0-8 of
tests/test_torch_stage2_loop.py's schedule and saves its best-PSNR
checkpoint at the test evaluation of step 6, past the 4-step warm-up. Both
packages resume from that file (its iteration 6 runs again, as in the
reference) to step 8: the control-node FPS reset at 8, then a test
evaluation and a best-PSNR checkpoint at 8. Held as that file's loop test
holds its loop: frame picks, FPS indices and alive masks exactly equal; each
parameter leaf within three times the reference's own spread (its resumes
from the same file with the skeleton's leaves scaled by 1 + 2^-23 and with
the Gaussians' scaled by 1 - 2^-24) plus 1e-6; the logger's scalar calls
the same (step, prefix, keys) in the same order, their values within three
times the spread plus 1e-6 of their scale; the newest checkpoint the same
iteration in both model paths, each holding its package's final state.
"""
import contextlib
import dataclasses
import io
import json
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import camera as JCam
from riggs_tpu.camera import poses as JPoses
from riggs_tpu.data import blender as JB
from riggs_tpu.eval import render_stage1 as JR1
from riggs_tpu.eval import synthesis as JS
from riggs_tpu.io import checkpoint as JC
from riggs_tpu.io import obj as JO
from riggs_tpu.models import skeleton_warp as JSW
from riggs_tpu.train import sampling as JSampling
from riggs_tpu.train import stage2 as JS2
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.camera import poses as TPoses
from riggs_tpu_torch.eval import render_stage1 as TR1
from riggs_tpu_torch.eval import synthesis as TSyn
from riggs_tpu_torch.io import checkpoint as TC
from riggs_tpu_torch.train import sampling as TSampling
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config as TConfig

from tests.test_torch_io import _port_stage2
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_stage1_step import _port_state as _port_stage1
from tests.test_torch_stage2_init import port_scene, stage1_fixture
from tests.test_torch_stage2_loop import PAIRS, JaxDraws, _leaf_readings, _Record, loop_cfg

SEED = 5
T_SAVE = 6  # the first run's checkpoint (its test evaluation), past the 4-step warm-up
T_END = 9  # the resumed runs: steps 6, 7, 8
TEST_AT = 8


@pytest.fixture(scope="module")
def fx():
    js, jcfg, j1 = stage1_fixture(loop_cfg, n_test=2)
    init = JS2.init_stage2(JaxDraws(SEED).init_key, j1, js, _cfg(JConfig, T_END))
    return dict(js=js, jcfg=jcfg, j1=j1, init=init, j2=init[0], t2=_port_stage2(init[0]), ts=port_scene(js))


@contextlib.contextmanager
def _cached_reference(fx, steps: dict):
    """The reference's train_stage2 with its init_stage2 computed once
    (every run here calls it with the same key, PRNGKey(SEED)'s first split,
    and inputs) and one jitted step per (config, template frame): the same
    functions, compiled once for all runs."""
    real_auto = JS2.make_stage2_auto

    def init(key, s1, scene, cfg):
        assert s1 is fx["j1"] and scene is fx["js"] and np.array_equal(key, JaxDraws(SEED).init_key)
        return fx["init"]

    def auto(cfg, template_idx):
        key = (cfg.to_json(), template_idx)
        if key not in steps:
            steps[key] = real_auto(cfg, template_idx)
        return steps[key]

    with mock.patch.object(JS2, "init_stage2", init), mock.patch.object(JS2, "make_stage2_auto", auto):
        yield


def _close(port, ref, atol, name):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=0, err_msg=name)


def _assert_rows(port_rows, ref_rows):
    for p, r in zip(port_rows, ref_rows, strict=True):
        assert list(p) == list(r)
        assert abs(p["psnr"] - r["psnr"]) <= 1e-4, (p, r)
        for k in ("ssim", "ms_ssim"):
            assert abs(p[k] - r[k]) <= 1e-5, (k, p, r)


@pytest.mark.parametrize("vis", [True, False])
def test_render_test_set_matches(fx, vis):
    j2, t2, js, ts = fx["j2"], fx["t2"], fx["js"], fx["ts"]
    rows, means, images = JS.render_test_set(j2.gs, j2.skel, js.test_frames, with_skinning_vis=vis,
                                             max_per_tile=512)
    trows, tmeans, timages = TSyn.render_test_set(t2.gs, t2.skel, ts.test_frames, with_skinning_vis=vis,
                                                  max_per_tile=512)
    assert len(trows) == 2
    _assert_rows(trows, rows)
    _assert_rows([tmeans], [means])
    for a, b in zip(timages, images, strict=True):
        assert a.shape == (64, 64, 3)
        _close(a, b, 3e-5, "render")
    text = TSyn.format_numerical_res(trows, tmeans)
    assert text == JS.format_numerical_res(trows, tmeans)
    assert text.splitlines()[0] == "frame\tpsnr\tssim\tms_ssim" and text.splitlines()[-1].startswith("mean\t")


def test_render_rigged_skinning_render_and_colors_match(fx):
    j2, t2, js, ts = fx["j2"], fx["t2"], fx["js"], fx["ts"]
    jf, tf = js.test_frames[0], ts.test_frames[0]
    ref = jax.jit(lambda: JS.render_rigged(j2.gs, j2.skel, jf.cam, t=jf.fid, with_skinning_vis=True,
                                           max_per_tile=512))()
    port = TSyn.render_rigged(t2.gs, t2.skel, tf.cam, t=tf.fid, with_skinning_vis=True, max_per_tile=512)
    for k in ("render", "alpha", "skinning_render"):
        _close(port[k], ref[k], 3e-5, k)
    assert int(port["overflow_tiles"]) == 0 and int(port["overflow_rect"]) == 0
    assert float(port["skinning_render"].max()) > 0.1
    assert not torch.allclose(port["skinning_render"], port["render"])
    d = port["d"]
    J = t2.skel.net.n_joints
    colors = TSyn.skinning_colors(d["nn_idx"], d["nn_weight"], J)
    _close(colors, JS.skinning_colors(jnp.asarray(d["nn_idx"].numpy()), jnp.asarray(d["nn_weight"].numpy()), J),
           1e-6, "skinning colours")
    assert TSyn._joint_colors(J, colors.device) is TSyn._joint_colors(J, colors.device)  # made once


def test_dump_skinning_weights_ply_matches(fx, tmp_path):
    """The port's dump against the reference's dump_skinning_weights_ply,
    its body jitted (posed points and skinning colours, written by
    riggs_tpu's write_colored_pointcloud_ply)."""
    j2, t2 = fx["j2"], fx["t2"]

    @jax.jit
    def posed(gs, skel):
        pose = JSW.pose_at(skel, jnp.asarray(0.4))
        d = JSW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
        return gs.xyz + d["d_xyz"], JS.skinning_colors(d["nn_idx"], d["nn_weight"], skel.net.n_joints)

    pts, colors = posed(j2.gs, j2.skel)
    alive = np.asarray(j2.gs.alive)
    JO.write_colored_pointcloud_ply(tmp_path / "j.ply", np.asarray(pts)[alive], np.asarray(colors)[alive])
    TSyn.dump_skinning_weights_ply(tmp_path / "t.ply", t2.gs, t2.skel, t=0.4)
    jl, tl = (p.read_text().splitlines() for p in (tmp_path / "j.ply", tmp_path / "t.ply"))
    assert tl[:10] == jl[:10] and len(tl) == len(jl) == 10 + int(t2.gs.num_alive)
    jv, tv = (np.array([[float(x) for x in line.split()] for line in lines[10:]]) for lines in (jl, tl))
    _close(tv[:, :3], jv[:, :3], 1e-5, "posed points")
    assert np.abs(tv[:, 3:] - jv[:, 3:]).max() <= 1  # uchar colours, a rounding apart at most


def test_render_test_set_stage1_matches(fx):
    j1, js, ts = fx["j1"], fx["js"], fx["ts"]
    t1 = _port_stage1(j1)
    rows, means, images = JR1.render_test_set_stage1(j1.gs, j1.warp, js.test_frames, max_per_tile=512)
    trows, tmeans, timages = TR1.render_test_set_stage1(t1.gs, t1.warp, ts.test_frames, max_per_tile=512)
    _assert_rows(trows, rows)
    for a, b in zip(timages, images, strict=True):
        _close(a, b, 3e-5, "stage-1 render")
    jf, tf = js.test_frames[1], ts.test_frames[1]
    ref = jax.jit(lambda: JR1.render_deformed(j1.gs, j1.warp, jf.cam, jf.fid, max_per_tile=512)["d_nodes"])()
    port = TR1.render_deformed(t1.gs, t1.warp, tf.cam, tf.fid, max_per_tile=512)
    _close(port["d_nodes"], ref, 1e-5, "d_nodes")
    # the sweeps: render_deformed at the sweep's times (and, for the spiral, the reference's cameras)
    frames = TR1.interpolate_time_stage1(t1.gs, t1.warp, tf.cam, n_frames=2, max_per_tile=512)
    assert torch.equal(torch.from_numpy(frames[1]),
                       TR1.render_deformed(t1.gs, t1.warp, tf.cam, 1.0, max_per_tile=512)["render"])
    spiral = TR1.interpolate_all_stage1(t1.gs, t1.warp, width=32, height=32, n_frames=2, max_per_tile=512)
    assert len(spiral) == 2 and spiral[1].shape == (32, 32, 3) and np.isfinite(spiral[1]).all()
    for i, c2w in enumerate(JPoses.spherical_ring(2, radius=4.0)):
        R, T = JB._nerf_c2w_to_rt(c2w)
        jc = JCam.make_camera(R, T, 32, 32, fovx=0.9, fovy=0.9, fid=i / 2)
        tc = convert.camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), i / 2, 32, 32, device="cpu")
        img = TR1.render_deformed(t1.gs, t1.warp, tc, i / 2, max_per_tile=512)["render"].numpy()
        np.testing.assert_array_equal(spiral[i], img)
    np.testing.assert_array_equal(np.stack(TPoses.spherical_ring(5)), np.stack(JPoses.spherical_ring(5)))
    np.testing.assert_array_equal(TPoses.bezier_curve(np.eye(3), 7), JPoses.bezier_curve(np.eye(3), 7))


class RecordingLogger:
    """A TrainLogger stand-in: every scalars call, values as host floats."""

    def __init__(self):
        self.calls = []

    def scalars(self, step, prefix, values):
        self.calls.append((step, prefix, {k: float(v) for k, v in values.items()}))


def _cfg(cls, n_iters):
    cfg = loop_cfg(cls)
    cfg.opt.iterations_stage2 = n_iters
    return cfg


@pytest.fixture(scope="module")
def resumed(fx, tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    j1, js = fx["j1"], fx["js"]
    steps = {}
    with contextlib.redirect_stdout(io.StringIO()), _cached_reference(fx, steps):
        JS2.train_stage2(j1, js, _cfg(JConfig, T_END), seed=SEED, test_every=T_SAVE, model_path=root / "first")
    assert JC.search_max_iteration(root / "first" / "checkpoints") == T_SAVE
    # the spread's starting points: the same checkpoint with one part's leaves scaled
    for scale, part in ((1 + 2.0 ** -23, "skel"), (1 - 2.0 ** -24, "gs")):
        st, _ = JC.load_checkpoint(root / "first", fx["j2"])
        sub = getattr(st, part)
        st = dataclasses.replace(st, **{part: sub.replace_params(
            jax.tree.map(lambda x: x * np.float32(scale), sub.params_dict()))})
        JC.save_checkpoint(root / part, T_SAVE, st)

    def ref_run(src):
        dst = root / f"ref_{src}"
        shutil.copytree(root / src / "checkpoints", dst / "checkpoints")
        logger = RecordingLogger()
        with contextlib.redirect_stdout(io.StringIO()) as out, _cached_reference(fx, steps), \
                _Record(JSampling, JS2) as rec:
            state, _, _ = JS2.train_stage2(j1, js, _cfg(JConfig, T_END), seed=SEED, log_every=1, test_every=TEST_AT,
                                           model_path=dst, logger=logger, resume=True)
        assert f"resumed stage-2 from iteration {T_SAVE}" in out.getvalue()
        return dict(state=state, rec=rec, logger=logger, path=dst)

    out = dict(ref=ref_run("first"), nudges=[ref_run("skel"), ref_run("gs")])
    assert len(steps) == 1
    dst = root / "port"
    shutil.copytree(root / "first" / "checkpoints", dst / "checkpoints")
    events, logger = [], RecordingLogger()
    with _Record(TSampling, TS2) as rec:
        state, _, _ = TS2.train_stage2(_port_stage1(j1), fx["ts"], _cfg(TConfig, T_END), seed=SEED, log_every=1,
                                       test_every=TEST_AT, model_path=dst, logger=logger, resume=True,
                                       draws=JaxDraws(SEED), events=events, device="cpu")
    out["port"] = dict(state=state, rec=rec, logger=logger, path=dst, events=events)
    out["root"] = root
    return out


def test_resumed_train_stage2_matches_the_reference(resumed):
    ref, port = resumed["ref"], resumed["port"]
    kinds = [(e["it"], e["event"]) for e in port["events"]]
    for want in [(T_SAVE, "resume"), (TEST_AT, "fps reset"), (TEST_AT, "test"), (TEST_AT, "checkpoint")]:
        assert want in kinds, (want, kinds)
    assert port["rec"].picks == ref["rec"].picks and len(port["rec"].picks) == T_END - T_SAVE
    assert len(port["rec"].fps) == len(ref["rec"].fps) == 1
    np.testing.assert_array_equal(port["rec"].fps[0], ref["rec"].fps[0])
    np.testing.assert_array_equal(port["state"].gs.alive.numpy(), np.asarray(ref["state"].gs.alive))
    assert int(port["state"].it) == int(ref["state"].it) == T_END
    for n in resumed["nudges"]:
        assert n["rec"].picks == ref["rec"].picks
        np.testing.assert_array_equal(np.asarray(n["state"].gs.alive), np.asarray(ref["state"].gs.alive))
    readings = _leaf_readings(resumed, port["state"])
    bad = {k: r for k, r in readings.items() if not r["ok"]}
    assert not bad, bad


def test_resumed_logger_calls_and_newest_checkpoint_match(resumed):
    ref, port = resumed["ref"], resumed["port"]
    runs = [ref["logger"].calls] + [n["logger"].calls for n in resumed["nudges"]]
    pc = port["logger"].calls
    shape = lambda calls: [(s, p, sorted(v)) for s, p, v in calls]
    assert shape(pc) == shape(runs[0]) == shape(runs[1]) == shape(runs[2])
    assert [(s, p) for s, p, _ in pc] == [(T_SAVE, "train_skeleton"), (T_SAVE + 1, "train_skeleton"),
                                          (TEST_AT, "train_skeleton"), (TEST_AT, "test")]
    for i, (s, p, vals) in enumerate(pc):
        for k, v in vals.items():
            rows = [r[i][2][k] for r in runs]
            spread = max(abs(rows[a] - rows[b]) for a, b in PAIRS)
            scale = max(abs(r[j][2][k]) for r in runs[:1] for j in range(len(pc)) if k in r[j][2])
            assert abs(v - rows[0]) <= 3 * spread + 1e-6 * scale, (s, p, k, v, rows)
    for run in (ref, port):
        assert TC.search_max_iteration(run["path"] / "checkpoints") == TEST_AT
        assert (run["path"] / "point_cloud" / f"iteration_{TEST_AT}" / "point_cloud.ply").exists()
    newest = lambda run: np.load(run["path"] / "checkpoints" / f"iteration_{TEST_AT}" / "state.npz")
    with newest(port) as tp, newest(ref) as jp:
        assert sorted(tp.files) == sorted(jp.files)
        port_final, ref_final = TC.state_to_numpy(port["state"]), JC._flatten(ref["state"])
        for k in tp.files:  # the state at the checkpoint is the final state, but for the step counter
            if k != ".it":
                np.testing.assert_array_equal(tp[k], port_final[k], err_msg=k)
                np.testing.assert_array_equal(jp[k], ref_final[k], err_msg=k)


def test_resume_falls_back_to_the_initial_state(fx, resumed, tmp_path):
    """A checkpoint inside the warm-up, or none, means training from the
    initial state at step 0 (the reference keeps the loaded state inside the
    warm-up; ROADMAP Queue C)."""
    early = tmp_path / "early"
    shutil.copytree(resumed["root"] / "first" / "checkpoints" / f"iteration_{T_SAVE}",
                    early / "checkpoints" / "iteration_2")
    for path, reason in ((early, "inside the warm-up"), (tmp_path / "none", "no checkpoints")):
        events = []
        state, _, _ = TS2.train_stage2(_port_stage1(fx["j1"]), fx["ts"], _cfg(TConfig, 1), seed=SEED,
                                       model_path=path, resume=True, events=events, device="cpu")
        assert events[0]["event"] == "no resume" and reason in events[0]["reason"], events[0]
        assert int(state.it) == 1


def test_logging_helpers(fx, tmp_path):
    """evaluation_report's means and best-PSNR record against riggs_tpu's
    on the same renders; a TrainLogger without a log dir is a no-op;
    profile_trace writes a Chrome trace and the port's counters."""
    from riggs_tpu.train import logging as JL
    from riggs_tpu_torch.train import logging as TL

    t2, ts = fx["t2"], fx["ts"]
    _, _, images = TSyn.render_test_set(t2.gs, t2.skel, ts.test_frames, with_skinning_vis=False, max_per_tile=512)
    by_frame = {id(f): torch.from_numpy(img) for f, img in zip(ts.test_frames, images)}
    jframes = fx["js"].test_frames
    jby = {id(f): jnp.asarray(img) for f, img in zip(jframes, images)}
    tl, jl = TL.TrainLogger(None), JL.TrainLogger(None)
    port = TL.evaluation_report(tl, 7, lambda f: by_frame[id(f)], ts.test_frames)
    ref = JL.evaluation_report(jl, 7, lambda f: jby[id(f)], jframes)
    _assert_rows([port], [ref])
    assert tl.writer is None and tl.best["iteration"] == 7 and tl.best["psnr"] == port["psnr"]
    with TL.profile_trace(tmp_path / "trace"):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert json.loads((tmp_path / "trace" / "counters.json").read_text()) == {}
    with TL.profile_trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()
