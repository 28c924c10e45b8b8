"""The ARAP editor of riggs_tpu_torch against riggs_tpu on the same numpy
inputs: edit/arap_deform.py (the deformer, deform_arap, arap_energy,
optimize_weights, n_ring_neighbors), edit/keypoints.py, edit/pose_edit.py
(rotate_joint, compose_pose_edit, retarget_pose, PoseLibrary's file both
ways and its interpolation), edit/session.py (pick, drag, d_xyz) and
camera/orbit.py. tests/test_edit.py is the template; its grid cases run
here on the port.

Tolerances: the deformer's graph exactly and its weights 1e-6 (the KNN's
squared distances differ in the last bit between the packages); deform_arap's
positions 2e-5 of the cloud's extent (a dense f32 LU solve and three SVD
fits chained in each package) and its quaternions 1e-5 up to sign;
optimize_weights' weights 1e-6; quaternions of the pose edits 1e-6;
EditSession's picks exactly, its control points and d_xyz 2e-5 of the
extent; the orbit camera's matrices 1e-6. PoseLibrary's files cross bitwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import orbit as JO
from riggs_tpu.camera.camera import make_camera as j_make_camera
from riggs_tpu.edit import arap_deform as JA
from riggs_tpu.edit import keypoints as JK
from riggs_tpu.edit import pose_edit as JP
from riggs_tpu.edit import session as JS
from riggs_tpu_torch.camera import orbit as TO
from riggs_tpu_torch.camera.camera import make_camera as t_make_camera
from riggs_tpu_torch.camera.camera import project_points
from riggs_tpu_torch.convert import arap_deformer_from_numpy
from riggs_tpu_torch.edit import arap_deform as TA
from riggs_tpu_torch.edit import keypoints as TK
from riggs_tpu_torch.edit import pose_edit as TP
from riggs_tpu_torch.edit import session as TS
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

EXTENT_TOL = 2e-5  # of the cloud's extent


def _t(a):
    return torch.tensor(np.asarray(a))


def _cloud(n=120, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * np.array([1.0, 0.5, 0.3])).astype(np.float32)


def grid_points(n=6, spacing=0.2):
    xs = np.arange(n) * spacing
    pts = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    return np.concatenate([pts, np.zeros((pts.shape[0], 1))], -1).astype(np.float32)


def _up_to_sign(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1)).max())


@pytest.fixture(scope="module")
def arap():
    """The reference's deformer over a seeded 120-point cloud, the port's
    built by make_deformer and the port's converted from the reference's,
    and a drag of three handles solved in the reference."""
    pts = _cloud()
    jd = JA.make_deformer(jnp.asarray(pts), K=8)
    rng = np.random.default_rng(1)
    idx = np.array([0, 7, 50], np.int32)
    pos = pts[idx] + rng.normal(scale=0.3, size=(3, 3)).astype(np.float32)
    jp, jq = JA.deform_arap(jd, jnp.asarray(idx), jnp.asarray(pos))
    return dict(pts=pts, jd=jd, idx=idx, pos=pos, jp=np.asarray(jp), jq=np.asarray(jq),
                extent=float(np.linalg.norm(pts.max(0) - pts.min(0))))


def test_make_deformer_matches(arap):
    jd = arap["jd"]
    td = TA.make_deformer(_t(arap["pts"]), K=8)
    np.testing.assert_array_equal(td.nn_idx.numpy(), np.asarray(jd.nn_idx))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_allclose(td.weight.numpy(), np.asarray(jd.weight), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.laplacian.numpy(), np.asarray(jd.laplacian), rtol=0, atol=1e-6)


def test_deform_arap_matches(arap):
    """From one deformer (converted), positions within EXTENT_TOL of the
    extent and quaternions up to sign; the handles on their targets."""
    jd = arap["jd"]
    td = arap_deformer_from_numpy(*(np.asarray(a) for a in (jd.verts, jd.nn_idx, jd.weight, jd.valid)), device="cpu")
    tp, tq = TA.deform_arap(td, _t(arap["idx"]), _t(arap["pos"]))
    np.testing.assert_allclose(tp.numpy(), arap["jp"], rtol=0, atol=EXTENT_TOL * arap["extent"])
    assert _up_to_sign(tq.numpy(), arap["jq"]) <= 1e-5
    np.testing.assert_array_equal(tp.numpy()[arap["idx"]], arap["pos"])
    assert TA.deform_arap(td, _t(arap["idx"]), _t(arap["pos"]), return_rot=False)[1] is None


def test_optimize_weights_matches(arap):
    jd = arap["jd"]
    td = arap_deformer_from_numpy(*(np.asarray(a) for a in (jd.verts, jd.nn_idx, jd.weight, jd.valid)), device="cpu")
    jw = JA.optimize_weights(jd, jnp.asarray(arap["pts"]), jnp.asarray(arap["jp"]), lr=1e-2, steps=2)
    tw = TA.optimize_weights(td, _t(arap["pts"]), _t(arap["jp"]), lr=1e-2, steps=2)
    assert not tw.weight.requires_grad
    assert float(np.abs(np.asarray(jw.weight) - np.asarray(jd.weight)).max()) > 1e-4  # the steps move them
    np.testing.assert_allclose(tw.weight.numpy(), np.asarray(jw.weight), rtol=0, atol=1e-6)
    e = lambda d, m: float(m(d, _t(arap["pts"]), _t(arap["jp"])))
    assert e(tw, TA.arap_energy) < e(td, TA.arap_energy)


class TestArapDeformGrid:
    """tests/test_edit.py's grid cases, on the port."""

    def test_handles_reach_targets(self):
        pts = _t(grid_points())
        d = TA.make_deformer(pts, K=6)
        handle_pos = torch.stack([pts[0], pts[35] + torch.tensor([0.3, 0.0, 0.2])])
        new_pts, quats = TA.deform_arap(d, torch.tensor([0, 35]), handle_pos)
        np.testing.assert_allclose(new_pts[[0, 35]].numpy(), handle_pos.numpy(), atol=1e-3)
        assert quats.shape == (36, 4)

    def test_rigid_translation_propagates(self):
        pts = _t(grid_points())
        d = TA.make_deformer(pts, K=6)
        off = torch.tensor([0.5, -0.1, 0.2])
        idx = torch.tensor([0, 5, 30, 35])
        new_pts, _ = TA.deform_arap(d, idx, pts[idx] + off)
        np.testing.assert_allclose(new_pts.numpy(), (pts + off).numpy(), atol=5e-2)

    def test_energy_zero_for_rigid(self):
        pts = _t(grid_points())
        d = TA.make_deformer(pts, K=6)
        assert float(TA.arap_energy(d, pts, pts + torch.tensor([1.0, 2.0, 3.0]))) < 1e-8

    def test_n_ring_matches(self):
        td = TA.make_deformer(_t(grid_points()), K=4)
        for rings in (1, 2):
            ring = TA.n_ring_neighbors(td.nn_idx, [0], rings=rings)
            np.testing.assert_array_equal(ring, JA.n_ring_neighbors(td.nn_idx.numpy(), [0], rings=rings))
        assert len(TA.n_ring_neighbors(td.nn_idx, [0], 2)) > len(TA.n_ring_neighbors(td.nn_idx, [0], 1)) >= 2


def test_keypoints_match():
    """The same calls on both: the same lists after each."""
    state = lambda kp: (list(kp.keypoint_idxs), [np.asarray(k).tolist() for k in kp.keypoints],
                        [list(g) for g in kp.idx_grps], kp.get_selective_keypoints_idx(), len(kp))
    kps = (JK.DeformKeypoints(), TK.DeformKeypoints())
    calls = [("add_kpts", (np.zeros((2, 3)), [4, 7])), ("add_kpts", (np.ones((1, 3)), [9])),
             ("add_kpts", (np.full((2, 3), 2.0), [9, 11]), {"expand": True}), ("select_kpt", (0,)),
             ("update_selective_keypoints", (np.array([1.0, 0, 0]),)), ("select_kpt", (5,)), ("clear", ())]
    for name, args, *kw in calls:
        for kp in kps:
            getattr(kp, name)(*args, **(kw[0] if kw else {}))
        assert state(kps[1]) == state(kps[0]), name
        if name == "update_selective_keypoints":
            np.testing.assert_allclose(kps[1].keypoints[0], [1, 0, 0])


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_pose_edits_match():
    rng = np.random.default_rng(2)
    rot = _quats(rng, 5)
    axis, angle = rng.normal(size=3), 0.7
    np.testing.assert_array_equal(TP.axis_angle_quat(axis, angle), JP.axis_angle_quat(axis, angle))
    out = TP.rotate_joint(_t(rot), 2, axis, angle)
    np.testing.assert_allclose(out.numpy(), np.asarray(JP.rotate_joint(jnp.asarray(rot), 2, axis, angle)), atol=1e-6)
    np.testing.assert_array_equal(out.numpy()[[0, 1, 3, 4]], rot[[0, 1, 3, 4]])
    edit = _quats(rng, 5)
    np.testing.assert_allclose(TP.compose_pose_edit(_t(rot), _t(edit)).numpy(),
                               np.asarray(JP.compose_pose_edit(jnp.asarray(rot), jnp.asarray(edit))), atol=1e-6)
    ident = np.tile(np.float32([1, 0, 0, 0]), (5, 1))
    np.testing.assert_allclose(TP.compose_pose_edit(_t(rot), _t(ident)).numpy(), rot, atol=1e-6)


@pytest.mark.parametrize("dst_joints", [5, 8], ids=["same_count", "nearest"])
def test_retarget_pose_matches(dst_joints):
    rng = np.random.default_rng(3)
    src = rng.normal(size=(5, 3)).astype(np.float32)
    dst = rng.normal(size=(dst_joints, 3)).astype(np.float32)
    rot, trans = _quats(rng, 5), rng.normal(size=3).astype(np.float32)
    jr, jt = JP.retarget_pose(src, dst, rot, trans)
    tr, tt = TP.retarget_pose(_t(src), dst, _t(rot), trans)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tt, jt)
    assert tr.shape == (dst_joints, 4)


def test_pose_library_crosses_between_packages(tmp_path):
    """A file written by either package loads in the other to the same
    arrays (the files themselves are byte-identical), and both interpolate
    the same sequence."""
    rng = np.random.default_rng(4)
    poses = {n: (_quats(rng, 3), rng.normal(size=3).astype(np.float32)) for n in ("a", "b", "c")}
    jl, tl = JP.PoseLibrary(tmp_path / "j.json"), TP.PoseLibrary(tmp_path / "t.json")
    for n, (r, t) in poses.items():
        jl.add(n, jnp.asarray(r), jnp.asarray(t))
        tl.add(n, _t(r), _t(t))
    jl.save()
    tl.save()
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    for reader, path in ((TP.PoseLibrary, "j.json"), (JP.PoseLibrary, "t.json")):
        lib = reader(tmp_path / path)
        for n, (r, t) in poses.items():
            got = lib.get(n)
            assert got[0].dtype == np.float32
            np.testing.assert_array_equal(got[0], r)
            np.testing.assert_array_equal(got[1], t)
    jr, jt = JP.PoseLibrary(tmp_path / "t.json").interpolate(["a", "b", "c"], frames_per_segment=5)
    tr, tt = TP.PoseLibrary(tmp_path / "j.json").interpolate(["a", "b", "c"], frames_per_segment=5, device="cpu")
    assert tuple(tr.shape) == (10, 3, 4) and tuple(tt.shape) == (10, 3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    assert json.loads((tmp_path / "t.json").read_text())["a"]["global_trans"] == poses["a"][1].tolist()


def _session_cams(w=96):
    R = np.diag([1.0, -1.0, -1.0])
    T = np.array([0.0, 0.0, 3.0])
    return (j_make_camera(R, T, w, w, fovx=0.9, fovy=0.9), t_make_camera(R, T, w, w, fovx=0.9, fovy=0.9, device="cpu"))


@pytest.mark.parametrize("ctrl", ["fps", "given"])
def test_edit_session_matches(ctrl):
    """Both sessions over one cloud: the same controls and blend, the same
    picks (one expanded, one missed), two drags' control points and d_xyz,
    then clear."""
    pts = _cloud(200, seed=5)
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    given = pts[::8][:24] if ctrl == "given" else None  # the FPS case's count: one compile of each reference jit
    js = JS.EditSession(pts, n_ctrl=24, ctrl_points=given)
    ts = TS.EditSession(_t(pts), n_ctrl=24, ctrl_points=given, device="cpu")
    np.testing.assert_allclose(ts.ctrl_rest.numpy(), js.ctrl_rest, rtol=0, atol=0)
    np.testing.assert_array_equal(ts.blend_idx.numpy(), js.blend_idx)
    np.testing.assert_allclose(ts.blend_w.numpy(), js.blend_w, rtol=0, atol=1e-6)
    jc, tc = _session_cams()
    rc = TS.project_nodes_2d(tc, ts.ctrl_rest).numpy()
    for k, (i, expand) in enumerate(((3, False), (11, True))):
        px, py = rc[i, 1] + 0.4, rc[i, 0] - 0.3
        assert ts.pick(tc, px, py, expand=expand) == js.pick(jc, px, py, expand=expand) == i
    assert ts.pick(tc, -500.0, -500.0) == js.pick(jc, -500.0, -500.0) == -1
    assert ts.kps.get_selective_keypoints_idx() == js.kps.get_selective_keypoints_idx() == [3, 11]
    for dx, dy in ((6.0, -4.0), (-2.5, 9.0)):
        ts.drag(tc, dx, dy)
        js.drag(jc, dx, dy)
        np.testing.assert_allclose(np.asarray(ts.kps.keypoints), np.asarray(js.kps.keypoints), atol=1e-6)
        np.testing.assert_allclose(ts.ctrl_cur.numpy(), js.ctrl_cur, rtol=0, atol=EXTENT_TOL * extent)
        np.testing.assert_allclose(ts.d_xyz.numpy(), js.d_xyz, rtol=0, atol=EXTENT_TOL * extent)
    assert float(ts.d_xyz.abs().max()) > 1e-2
    ts.clear()
    js.clear()
    assert len(ts.kps) == 0 and float(ts.d_xyz.abs().max()) == 0.0
    np.testing.assert_array_equal(ts.ctrl_cur.numpy(), ts.ctrl_rest.numpy())


def test_edit_session_needs_a_device_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.EditSession(_cloud(20), n_ctrl=4)


def test_orbit_camera_matches():
    jo, to = JO.OrbitCamera(width=100, height=80, radius=2.0), TO.OrbitCamera(width=100, height=80, radius=2.0)
    for cam in (jo, to):
        cam.orbit(50, 30)
        cam.pan(12, -7)
        cam.scale(1)
        cam.orbit(-123, 45)
    np.testing.assert_array_equal(to.rot, jo.rot)
    np.testing.assert_array_equal(to.position, jo.position)
    np.testing.assert_array_equal(to.view_axis, jo.view_axis)
    jc, tc = jo.to_camera(fid=0.25), to.to_camera(fid=0.25, device="cpu")
    np.testing.assert_allclose(tc.w2c.numpy(), np.asarray(jc.w2c), atol=1e-6)
    np.testing.assert_allclose(tc.intrinsics.numpy(), np.asarray(jc.intrinsics), atol=1e-6)
    assert float(tc.fid) == pytest.approx(0.25)
    pix, z = project_points(tc, torch.tensor(to.center[None], dtype=torch.float32))
    np.testing.assert_allclose(pix.numpy()[0], [49.5, 39.5], atol=1e-3)
    assert abs(float(z[0]) - to.radius) < 1e-5
