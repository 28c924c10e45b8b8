"""The stage-1 animation path of riggs_tpu_torch against riggs_tpu on the
same numpy inputs: quat_slerp, slerp_batch and interpolate_key_poses,
geodesic_floyd, get_trajectory, p2dR and warp_forward_animated.

The sizes are tests/test_anim_se3.py's: a 16-node warp over a 200-point
cloud (the reference's init_node_warp, its nodes and DeformNetwork nudged
off init by tests/test_torch_stage1_modules.py's ``_warps``, crossed over
with convert), 60 Gaussians. The rotation fits inside p2dR run on the
plain version here (an SVD in both packages); on the card they run on
csrc/rotfit.cu (chip_smoke.py [anim]).

Tolerances: quaternions, weights and interpolated translations 1e-6; the
geodesic distances 1e-5 relative (the port's KNN distances differ from the
reference's in the last bit; the min-plus steps are exact), their inf
pattern exactly; trajectories 1e-5; p2dR's quaternions 1e-5 (two SVDs of the
same f32 correlations); warp_forward_animated's outputs 1e-4 (the softmax at
temperature 1e-3 scales a last-bit difference of a geodesic distance by
1000), the re-binding's finite / NaN pattern exactly. The inputs are
seeded away from re-binding ties, and the disconnected case is held by its
pattern.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.models import deform_mlp as JD
from riggs_tpu.models import node_warp as JNW
from riggs_tpu.ops import arap as JA
from riggs_tpu.ops import quaternion as JQ
from riggs_tpu.skeleton import interpolation as JI
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.ops import arap as TA
from riggs_tpu_torch.ops import geometry as TGeo
from riggs_tpu_torch.ops import quaternion as TQ
from riggs_tpu_torch.skeleton import interpolation as TI
from tests.test_torch_stage1_modules import _warps
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

QUAT = dict(rtol=0, atol=1e-6)

# the reference's trajectory, p2dR and animated warp jitted: each compiles
# once, where run eagerly every one of their ops compiles on its own
j_get_trajectory = jax.jit(JNW.get_trajectory, static_argnames="t_samp_num")
j_p2dR = jax.jit(JNW.p2dR, static_argnames="K")
j_animated = jax.jit(JNW.warp_forward_animated, static_argnames=("K", "temperature"))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def warps():
    """The reference's 16-node warp over 200 points and the port's."""
    jw, tw, _ = _warps(JD.DeformNetworkDef(), node_num=16, hyper_dim=2, seed=0)
    return jw, tw


@pytest.mark.parametrize("t_shape", ["scalar", "per_quat"])
@pytest.mark.parametrize("case", ["general", "near_parallel"])
def test_quat_slerp_matches(case, t_shape):
    """A general pair (some with a negative dot, so the hemisphere flip
    acts) and a pair 1e-7 apart, and both shapes of t (one scalar; one value
    per quaternion, broadcast over the quaternion axis). The near-parallel
    pair meets the clip of the dot at 1 - 1e-7, which keeps theta at
    acos(1 - 1.2e-7) = 4.9e-4 or more in f32, so sin(theta) never falls
    under the lerp branch's 1e-5 in either package: the clip is what a
    near-parallel pair exercises, and the branch is dead code in both."""
    rng = np.random.default_rng(1)
    q0 = _quats(rng, 12)
    if case == "general":
        q1 = _quats(rng, 12)
        assert (np.sum(q0 * q1, -1) < 0).any() and (np.sum(q0 * q1, -1) > 0).any()
    else:
        q1 = q0 + rng.normal(scale=1e-7, size=q0.shape).astype(np.float32)
    t = np.float32(0.3) if t_shape == "scalar" else rng.uniform(size=12).astype(np.float32)
    ref = np.asarray(JQ.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    got = TQ.quat_slerp(_t(q0), _t(q1), float(t) if t_shape == "scalar" else _t(t)).numpy()
    np.testing.assert_allclose(got, ref, **QUAT)
    if case == "near_parallel":  # every pair at the clip: theta = acos(1 - 1e-7) in f32
        theta = np.arccos(np.float32(1.0 - 1e-7))
        assert 1e-5 < np.sin(theta) < 1e-3


def test_slerp_batch_and_interpolate_key_poses_match():
    """Three key poses of a 24-joint tree, 7 frames a segment."""
    rng = np.random.default_rng(2)
    rots = np.stack([_quats(rng, 24) for _ in range(3)])
    trans = rng.normal(size=(3, 3)).astype(np.float32)
    t = np.linspace(0, 1, 5, dtype=np.float32)
    np.testing.assert_allclose(TI.slerp_batch(_t(rots[0]), _t(rots[1]), _t(t)).numpy(),
                               np.asarray(JI.slerp_batch(jnp.asarray(rots[0]), jnp.asarray(rots[1]), jnp.asarray(t))),
                               **QUAT)
    jr, jt = JI.interpolate_key_poses(jnp.asarray(rots), jnp.asarray(trans), frames_per_segment=7)
    tr, tt = TI.interpolate_key_poses(_t(rots), _t(trans), frames_per_segment=7)
    assert tr.shape == (14, 24, 4) and tt.shape == (14, 3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **QUAT)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **QUAT)
    with pytest.raises(ValueError, match="two key poses"):
        TI.interpolate_key_poses(_t(rots[:1]), _t(trans[:1]))


def _clusters(rng, gap):
    """Two 24-point clusters ``gap`` apart: at K = 3 the graph is in two
    pieces when the gap is large."""
    a = rng.normal(scale=0.2, size=(24, 3))
    b = rng.normal(scale=0.2, size=(24, 3)) + np.array([gap, 0, 0])
    return np.concatenate([a, b]).astype(np.float32)


@pytest.mark.parametrize("case", ["connected", "disconnected"])
def test_geodesic_floyd_matches(case):
    """All-pairs geodesic distances over the 4-NN graph of 48 points: one
    connected graph (a single cloud), and two clusters far apart, whose
    cross distances are inf in both packages."""
    rng = np.random.default_rng(3)
    pts = rng.normal(scale=0.3, size=(48, 3)).astype(np.float32) if case == "connected" else _clusters(rng, 50.0)
    ref = np.asarray(JA.geodesic_floyd(jnp.asarray(pts), K=3))
    got = TA.geodesic_floyd(_t(pts), K=3).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    assert np.isinf(ref).any() == (case == "disconnected")
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-6)
    # the graph, then the relaxation, whose min-plus steps are exact on any device
    n = len(pts)
    graph = TA.knn_graph(_t(pts), K=3)
    assert graph.shape == (n, n) and torch.equal(graph, graph.t())
    assert np.array_equal(TA.min_plus_closure(graph).numpy(), got)


def test_get_trajectory_matches(warps):
    jw, tw = warps
    for T in (4, 8):
        ref = np.asarray(j_get_trajectory(jw, t_samp_num=T))
        got = TNW.get_trajectory(tw, t_samp_num=T).detach().numpy()
        assert got.shape == (16, T, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert float(np.abs(ref - ref[:, :1]).max()) > 1e-3  # the nudged network moves the nodes


def _rot_z(ang):
    return np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]], np.float32)


@pytest.mark.parametrize("motion", ["translation", "rotation", "drag"])
def test_p2dR_matches(warps, motion):
    """The reference's TestP2dR cases (a translation gives the identity, a
    global rotation about z is recovered) and a seeded drag of six nodes."""
    jw, tw = warps
    p0 = np.asarray(jw.nodes[:, :3])
    if motion == "translation":
        p = p0 + np.array([0.3, 0.1, -0.2], np.float32)
    elif motion == "rotation":
        p = p0 @ _rot_z(0.6).T
    else:
        rng = np.random.default_rng(4)
        p = p0.copy()
        p[rng.choice(16, 6, replace=False)] += rng.normal(scale=0.1, size=(6, 3)).astype(np.float32)
    ref = np.asarray(j_p2dR(jw, jnp.asarray(p), jnp.asarray(p0)))
    got = TNW.p2dR(tw, _t(p), _t(p0)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if motion == "translation":
        assert float(np.abs(got[:, 1:]).max()) < 1e-3
    elif motion == "rotation":
        np.testing.assert_allclose(got[:, 0], np.cos(0.3), atol=1e-3)


def test_p2dR_fits_through_fit_rotations(warps, monkeypatch):
    """p2dR's rotations come from ops/geometry.py:fit_rotations, one call
    on the M correlation matrices (the kernel's wrapper on the card)."""
    _, tw = warps
    calls = []
    real = TGeo.fit_rotations

    def spy(cov):
        calls.append(tuple(cov.shape))
        return real(cov)

    monkeypatch.setattr(TNW, "fit_rotations", spy)
    p0 = tw.nodes[:, :3].detach()
    TNW.p2dR(tw, p0 + 0.1, p0)
    assert calls == [(16, 3, 3)]


def _gaussians(seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(60, 3)).astype(np.float32)


@pytest.mark.parametrize("bias", ["zero", "shift", "drag"])
def test_warp_forward_animated_matches(warps, bias):
    """The reference's TestAnimated inputs (60 Gaussians, t = 0.4, no
    features, the motion mask all on): no bias (the rotation deltas the
    identity), a shift of every node by 0.5 along x (the Gaussians follow by
    0.5 on average), and a seeded drag of five nodes; every output of both
    packages, the re-binding's indices exactly."""
    jw, tw = warps
    x = _gaussians()
    mm = np.ones((60, 1), np.float32)
    b = np.zeros((16, 3), np.float32)
    if bias == "shift":
        b[:, 0] = 0.5
    elif bias == "drag":
        rng = np.random.default_rng(5)
        b[rng.choice(16, 5, replace=False)] = rng.normal(scale=0.2, size=(5, 3))
    ref = j_animated(jw, jnp.asarray(x), jnp.asarray(0.4), None, jnp.asarray(mm), jnp.asarray(b))
    got = TNW.warp_forward_animated(tw, _t(x), torch.tensor(0.4), None, _t(mm), _t(b))
    assert set(k for k, v in got.items() if v is not None) == set(k for k, v in ref.items() if v is not None)
    for k, v in ref.items():
        if v is None:
            continue
        g = got[k].detach().numpy()
        if k == "nn_idx":
            np.testing.assert_array_equal(g, np.asarray(v))
        else:
            np.testing.assert_allclose(g, np.asarray(v), rtol=0, atol=1e-4, err_msg=k)
    rb = got["d_rotation_bias"].detach().numpy()
    if bias == "zero":
        assert float(np.abs(rb[:, 0] - 1.0).max()) < 1e-3
    if bias == "shift":
        base = TNW.warp_forward(tw, _t(x), torch.tensor(0.4), None, _t(mm))["d_xyz"].detach().numpy()
        np.testing.assert_allclose((got["d_xyz"].detach().numpy() - base)[:, 0].mean(), 0.5, atol=1e-2)


def test_warp_forward_animated_rebinding_matches_on_a_disconnected_graph():
    """Posed nodes in two clusters far apart (10 and 6 nodes; the 4-NN
    graph in two pieces): each Gaussian reaches only its cluster's nodes,
    and with K = 12 every Gaussian's K geodesically nearest nodes include
    inf distances, whose softmax weights are 0 (a Gaussian's own nearest
    node is always at a finite distance, so no weight row is all inf).
    Both packages give the same finite pattern (all finite), and the same
    values."""
    rng = np.random.default_rng(6)
    pcl = np.concatenate([rng.normal(scale=0.1, size=(100, 3)),
                          rng.normal(scale=0.1, size=(100, 3)) + [40.0, 0, 0]]).astype(np.float32)
    jw = JNW.init_node_warp(jax.random.PRNGKey(0), pcl, 16, hyper_dim=2)
    from riggs_tpu_torch import convert
    from tests.test_torch_stage1_modules import _np, _tnet

    tw = convert.node_warp_from_numpy(_np(jw.params_dict()), _tnet(JD.DeformNetworkDef()), K=jw.K, hyper_dim=2,
                                      device="cpu")
    x = pcl[rng.choice(200, 60, replace=False)] + rng.normal(scale=0.02, size=(60, 3)).astype(np.float32)
    mm = np.ones((60, 1), np.float32)
    b = np.zeros((16, 3), np.float32)
    b[:3] = 0.05
    ref = j_animated(jw, jnp.asarray(x), jnp.asarray(0.4), None, jnp.asarray(mm), jnp.asarray(b), K=12)
    got = TNW.warp_forward_animated(tw, _t(x), torch.tensor(0.4), None, _t(mm), _t(b), K=12)
    geo = np.asarray(JA.geodesic_floyd(jnp.asarray(np.asarray(jw.nodes[:, :3])), K=3))
    assert sorted(np.isfinite(geo).sum(1).tolist()) == [6] * 6 + [10] * 10
    for k in ("d_xyz", "d_rotation_bias"):
        r, g = np.asarray(ref[k]), got[k].detach().numpy()
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), err_msg=k)
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=0, atol=1e-4, err_msg=k)
