"""The ZJU-MoCap branch in riggs_tpu and in riggs_tpu_torch: the reader with
its undistortion, the reference-point step, and train_stage1 on a ZJU scene,
and ROADMAP C5 in both directions.

The subject directory is written into tmp_path in the HumanNeRF layout: 4
train frames and one test view of 2 at 64 x 64, each camera with a
principal point tens of pixels off the centre, nonzero distortion (k1, k2,
p1, p2, k3) and a seeded SMPL global transform; masks, thinned skeletons,
semantic labels, M = 200 reference points a frame, and points3d.ply with
the same M points (the reference runs a ZJU scene only at capacity == M).

Tolerances: the port's undistort bitwise equal to cv2.undistort (uint8
images and masks, so no mask pixel flips); the two readers' scenes as
tests/test_torch_readers.py holds them (images, masks and reference points
exactly, cameras 1e-6); the reference-point step's parameters, Adam moments
and metrics within 1e-5, its Adam moments starting at count 5 (no sign(g)
first step); the loop: frame picks exactly, losses within 1e-4 relative,
the warp and the Gaussians within 1e-4 of the reference's after 4 + 4
steps; C5: the port's loss and gradients at capacity 256 > M within 1e-6
relative of its own at capacity == M (the sums run over other lengths).
"""
import contextlib
import dataclasses
import io
import pickle
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from riggs_tpu.io.ply import write_ply
from riggs_tpu.data import zju as JZ
from riggs_tpu.data.scene import load_scene as j_load_scene
from riggs_tpu.train import optim as JO
from riggs_tpu.train import sampling as JSampling
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch.data import zju as TZ
from riggs_tpu_torch.data.dataset import SceneData as TScene
from riggs_tpu_torch.data.scene import load_scene as t_load_scene
from riggs_tpu_torch.train import sampling as TSampling
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config as TConfig
from riggs_tpu_torch.train.optim import grad_tree

from tests.test_torch_readers import assert_scenes_equal
from tests.test_torch_stage1_loop import SEED, JaxDraws, one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_stage1_step import _port_state, _skel_ref_layout
from tests.test_torch_stage2_step import _assert_tree, _moments, _np, _second_moments

M, SIZE = 200, 64


def _look_at_origin(angle, dist=3.0):
    """A world-to-camera (4, 4) on a circle of radius ``dist`` about the y
    axis, looking at the origin, y down."""
    R = np.array([[np.cos(angle), 0.0, -np.sin(angle)], [0.0, -1.0, 0.0], [-np.sin(angle), 0.0, -np.cos(angle)]])
    center = np.array([dist * np.sin(angle), 0.1, dist * np.cos(angle)])
    E = np.eye(4)
    E[:3, :3], E[:3, 3] = R, -R @ center
    return E


def write_zju_subject(root, n_train=4, size=SIZE, m=M, seed=0):
    """A HumanNeRF-layout subject: train/ and test/view_02/, each frame's
    camera the extrinsics that, after the SMPL global transform is folded
    in, look at the origin; a blob of ``m`` points about the origin, its
    per-frame reference points moved a little, points3d.ply the same
    points."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(m, 3)) * [0.25, 0.45, 0.12]).astype(np.float32)
    cols = rng.integers(0, 256, size=(m, 3)).astype(np.float32)
    write_ply(root / "points3d.ply", dict(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], red=cols[:, 0], green=cols[:, 1],
                                          blue=cols[:, 2]))
    (root / "SMPL_prior").mkdir(parents=True)
    yy, xx = np.mgrid[:size, :size]

    def view(d, names, angles):
        for sub in ("images", "masks", "train_thinned", "semantic_seg"):
            (d / sub).mkdir(parents=True)
        cameras, infos = {}, {}
        for name, a in zip(names, angles):
            K = np.array([[size * 1.1, 0, size / 2 + rng.uniform(8, 14)],
                          [0, size * 1.05, size / 2 - rng.uniform(8, 14)], [0, 0, 1]])
            D = np.array([rng.uniform(-0.3, -0.1), rng.uniform(0.02, 0.1), rng.uniform(-3e-3, 3e-3),
                          rng.uniform(-3e-3, 3e-3), rng.uniform(-0.05, 0.0)])
            Rh, Th = rng.normal(scale=0.15, size=3), rng.normal(scale=0.1, size=3)
            G = np.eye(4)
            G[:3, :3] = JZ._rodrigues(Rh).T
            G[:3, 3] = -G[:3, :3] @ Th
            cameras[name] = {"intrinsics": K, "extrinsics": _look_at_origin(a) @ G, "distortions": D[None]}
            infos[name] = {"Rh": Rh, "Th": Th, "poses": np.zeros(72)}
            img = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
            mask = (((yy - size / 2) ** 2 / 500 + (xx - size / 2) ** 2 / 200) < 1).astype(np.uint8) * 255
            Image.fromarray(img).save(d / "images" / f"{name}.png")
            Image.fromarray(mask).save(d / "masks" / f"{name}.png")
            thin = np.zeros((size, size), np.uint8)
            thin[size // 4: 3 * size // 4, size // 2] = 255
            Image.fromarray(thin).save(d / "train_thinned" / f"{name}_thinned.png")
            np.save(d / "semantic_seg" / f"{name}_seg.npy", rng.integers(0, 5, size=(1, size, size)))
            moved = pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
            np.save(root / "SMPL_prior" / f"{name}.npy", moved)
        for fname, obj in (("cameras.pkl", cameras), ("mesh_infos.pkl", infos)):
            with open(d / fname, "wb") as f:
                pickle.dump(obj, f)

    names = [f"frame_{i:06d}" for i in range(n_train)]
    view(root / "train", names, np.radians(np.linspace(-20, 20, n_train)))
    view(root / "test" / "view_02", names[:2], np.radians([35.0, 40.0]))
    return pts


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    root = tmp_path_factory.mktemp("zju") / "377"
    write_zju_subject(root)
    js = j_load_scene(root)
    ts = t_load_scene(root, device="cpu")
    return dict(root=root, jscene=js, tscene=ts)


@pytest.mark.parametrize("shape,K,D", [
    ((160, 200, 3), [[180.0, 0, 93.3], [0, 175.0, 88.7], [0, 0, 1]], [-0.28, 0.11, 0.002, -0.0015, -0.02]),
    ((1024, 1024), [[1030.0, 0, 540.2], [0, 1028.5, 497.9], [0, 0, 1]], [[-0.41, 0.25, 0.0011, -0.0007, -0.09]]),
    ((96, 128, 4), [[100.0, 0, 40.0], [0, 100.0, 70.0], [0, 0, 1]], [0.1, -0.05, 0.01, 0.02]),
], ids=["rgb", "mask_1024", "rgba_4coef"])
def test_undistort_matches_cv2_bitwise(shape, K, D):
    """Random uint8 images (a 0/255 mask at ZJU-MoCap's 1024 x 1024):
    bitwise equal to cv2.undistort, so no thresholded mask pixel flips."""
    rng = np.random.default_rng(len(shape))
    img = (rng.integers(0, 256, size=shape, dtype=np.uint8) if len(shape) == 3
           else (rng.uniform(size=shape) < 0.5).astype(np.uint8) * 255)
    K, D = np.asarray(K), np.asarray(D)
    ours, theirs = TZ.undistort(img, K, D), cv2.undistort(img, K, D)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert int(np.abs(ours.astype(int) - theirs.astype(int)).max()) == 0
    assert (ours != img).any()


def test_zju_reader_matches(subject):
    """The two readers on the subject: the same frames, cameras (off-centre
    K, the global transform folded in), reference points, images and masks
    (the undistortion bitwise), thinned points, labels and init cloud."""
    js, ts = subject["jscene"], subject["tscene"]
    assert_scenes_equal(js, ts)
    assert len(ts.train_frames) == 4 and len(ts.test_frames) == 2 and len(ts.init_points) == M
    f = ts.train_frames[0]
    assert f.reference_points.shape == (M, 3) and f.semantic_seg is not None and f.thinned is not None
    assert abs(float(f.cam.intrinsics[2]) - SIZE / 2) > 7 and not ts.is_blender
    np.testing.assert_array_equal(TZ.apply_global_tfm_to_camera(np.eye(4)[:3], [0.1, 0.2, 0.3], [1, 2, 3]),
                                  JZ.apply_global_tfm_to_camera(np.eye(4)[:3], [0.1, 0.2, 0.3], [1, 2, 3]))
    # the init cloud's points land in the image of every train camera
    from riggs_tpu_torch.camera.camera import project_points

    for fr in ts.train_frames:
        pix, z = project_points(fr.cam, torch.as_tensor(ts.init_points))
        assert bool((z > 0).all()) and bool(((pix > 0) & (pix < SIZE)).all(-1).float().mean() > 0.9)


def _cfg(cls, capacity=M):
    cfg = cls()
    m, o, p = cfg.model, cfg.opt, cfg.pipe
    m.capacity, m.node_num, m.sh_degree, m.hyper_dim = capacity, 24, 1, 2
    p.max_per_tile = 256
    o.iterations_node_rendering, o.iterations, o.warm_up = 4, 4, 2
    o.densify_from_iter, o.node_force_densify_prune_step, o.opacity_reset_interval = 100, 100, 100
    return cfg


def _warp_moments(init):
    """``init`` with the warp's and the Gaussians' Adam moments at count 5
    (seeded): no sign(g) first step magnifies last-bit differences."""
    def wrapped(*a, **k):
        st = init(*a, **k)
        rng = np.random.default_rng(9)
        opt = lambda p: JO.AdamState(mu=_moments(rng, p, 1e-3), nu=_second_moments(rng, p), count=jnp.int32(5))
        return dataclasses.replace(st, opt_warp=opt(st.warp.params_dict()), opt_gs=opt(st.gs.params_dict()))
    return wrapped


@pytest.fixture(scope="module")
def ref_state(subject):
    return _warp_moments(JS1.init_stage1)(jax.random.PRNGKey(1), subject["jscene"], _cfg(JConfig))


@pytest.mark.parametrize("it", [0, 3])
def test_phase_ref_auto_step_matches(subject, ref_state, it):
    """make_phase_ref_auto's step on the first train frame (the chamfer on):
    the warp, its Adam moments and the metrics; the Gaussians untouched."""
    js = dataclasses.replace(ref_state, it=jnp.int32(it))
    jf, tf = subject["jscene"].train_frames[1], subject["tscene"].train_frames[1]
    jnew, jm = JS1.make_phase_ref_auto(_cfg(JConfig))(js, jf, jnp.zeros(3), use_chamfer=True)
    ts = _port_state(js, it=it)
    gs_before = {k: v.clone() for k, v in ts.gs.params_dict().items()}
    tnew, tm = TS1.make_phase_ref_auto(_cfg(TConfig))(ts, tf, it=it, use_chamfer=True)
    _assert_tree(jnew.warp.params_dict(), _skel_ref_layout(tnew.warp.params_dict()), "warp", atol=1e-5, rtol=0)
    _assert_tree(jnew.opt_warp.mu, _skel_ref_layout(tnew.opt_warp.mu), "mu", atol=1e-5, rtol=0)
    _assert_tree(jnew.opt_warp.nu, _skel_ref_layout(tnew.opt_warp.nu), "nu", atol=1e-5, rtol=0)
    assert set(tm) == set(jm) == {"loss", "ref_loss", "chamfer"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(tnew.it) == int(jnew.it) == it + 1 and int(tnew.opt_warp.count) == 6
    assert all(torch.equal(v, gs_before[k]) for k, v in tnew.gs.params_dict().items())


class _RefDraws(JaxDraws):
    def phase_ref(self):
        self._next()  # the reference splits its key before the branch


def _recording(cls, log):
    real = cls.sample

    def rec(self, *a, **k):
        out = real(self, *a, **k)
        log.append(out)
        return out
    return mock.patch.object(cls, "sample", rec)


@pytest.fixture(scope="module")
def zju_loops(subject, ref_state):
    key = jax.random.PRNGKey(SEED)
    key, _ = jax.random.split(key)
    init = _warp_moments(JS1.init_stage1)
    out = {}
    jpicks, tpicks = [], []
    with _recording(JSampling.FrameSampler, jpicks), contextlib.redirect_stdout(io.StringIO()), \
            mock.patch.object(JS1, "init_stage1", init):
        out["jstate"], out["jhist"] = JS1.train_stage1(subject["jscene"], _cfg(JConfig), seed=SEED, log_every=1)
    j0 = init(jax.random.split(jax.random.PRNGKey(SEED))[1], subject["jscene"], _cfg(JConfig))
    events, steps = [], []
    with _recording(TSampling.FrameSampler, tpicks):
        out["tstate"], out["thist"] = TS1.train_stage1(
            subject["tscene"], _cfg(TConfig), seed=SEED, log_every=1, state=_port_state(j0), draws=_RefDraws(key),
            events=events, step_callback=lambda st, it, ph: steps.append((ph, it)), device="cpu")
    out.update(jpicks=jpicks, tpicks=tpicks, events=events, steps=steps, j0=j0)
    return out


def test_train_stage1_reference_point_branch_matches(zju_loops):
    """4 reference-point steps (no render, no node event, no
    finalize_nodes), then 4 phase-B steps: the same frame picks, losses
    and, after the loop, warp and Gaussians."""
    r = zju_loops
    assert r["tpicks"] == r["jpicks"] and len(r["tpicks"]) == 8
    assert r["steps"] == [("A", i) for i in range(4)] + [("B", i) for i in range(4)]
    assert not [e for e in r["events"] if e["phase"] == "A"]
    jh, th = r["jhist"], r["thist"]
    assert [(p, it) for p, it, _ in th] == [(p, it) for p, it, _ in jh]
    for (p, it, jm), (_, _, tm) in zip(jh, th):
        keys = ("loss", "ref_loss", "chamfer") if p == "A" else ("loss", "psnr", "arap", "chamfer")
        assert set(keys) <= set(jm) and set(keys) <= set(tm), (p, it)
        for k in keys:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=f"{p} {k} at it {it}")
    js, ts = r["jstate"], r["tstate"]
    for k, v in js.gs.params_dict().items():
        np.testing.assert_allclose(ts.gs.params_dict()[k].numpy(), np.asarray(v), atol=1e-4, rtol=0, err_msg=k)
    _assert_tree(js.warp.params_dict(), _skel_ref_layout(ts.warp.params_dict()), "warp", atol=1e-4, rtol=0)
    # no finalize_nodes: the node Gaussians were never trained
    np.testing.assert_array_equal(ts.node_gs.xyz.numpy(), np.asarray(r["j0"].node_gs.xyz))


def test_c5_reference_fails_past_capacity_m(subject):
    """riggs_tpu's reference-point step subtracts the (capacity, 3)
    positions from the (M, 3) points: at its default-like capacity > M its
    train_stage1 fails at the first step (so does scripts/run_zju.py, which
    passes no --capacity: the default is 65 536)."""
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(TypeError, match="broadcast|shapes"):
        JS1.train_stage1(subject["jscene"], _cfg(JConfig, capacity=256), seed=SEED)


def test_c5_port_past_capacity_m_equals_its_own_at_m(subject):
    """The port at capacity 256 > M: the points in the first M slots, the
    mean over the alive slots; its loss and warp gradients equal its own at
    capacity == M (the same warp: the reference's init from one key); a
    cloud of another count than M raises, naming C5."""
    tf = subject["tscene"].train_frames[2]
    out = {}
    for cap in (M, 256):
        js = JS1.init_stage1(jax.random.PRNGKey(4), subject["jscene"], _cfg(JConfig, capacity=cap))
        ts = _port_state(js)
        assert int(ts.gs.num_alive) == M and ts.gs.capacity == cap
        params = ts.warp.params_dict()
        loss, aux = TS1.phase_ref_loss(params, ts, tf)
        out[cap] = (loss, aux, _skel_ref_layout(grad_tree(loss, params)))
    (l0, a0, g0), (l1, a1, g1) = out[M], out[256]
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    np.testing.assert_allclose(a1["ref_loss"].item(), a0["ref_loss"].item(), rtol=1e-6)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(g0)[0], jax.tree_util.tree_leaves(g1)):
        s = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b / s, a / s, atol=1e-6, rtol=0, err_msg=jax.tree_util.keystr(path))
    assert max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(g0)) > 0
    ts = subject["tscene"]
    fewer = TScene(ts.init_points[:150], ts.init_colors[:150], is_blender=False, train_frames=ts.train_frames,
                   cameras_extent=ts.cameras_extent)
    with pytest.raises(ValueError, match="C5"):
        TS1.train_stage1(fewer, _cfg(TConfig, capacity=256), device="cpu")
