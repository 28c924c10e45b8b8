"""The port's math modules against riggs_tpu on the same numpy inputs:
camera, quaternion, SH, geometry, FK, the k-pass argmin, the MLP blocks and
the Gaussian container's activations.

Tolerance: 1e-5 absolute (f32 module math), integer outputs exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import camera as JC
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import mlp as JM
from riggs_tpu.ops import fk as JFK
from riggs_tpu.ops import geometry as JGEO
from riggs_tpu.ops.knn import _small_k as j_small_k
from riggs_tpu.ops import quaternion as JQ
from riggs_tpu.ops import sh as JSH
from riggs_tpu_torch import convert
from riggs_tpu_torch.camera import camera as TC
from riggs_tpu_torch.models import mlp as TM
from riggs_tpu_torch.ops import fk as TFK
from riggs_tpu_torch.ops import geometry as TGEO
from riggs_tpu_torch.ops import knn as TKNN
from riggs_tpu_torch.ops import quaternion as TQ
from riggs_tpu_torch.ops import sh as TSH

ATOL = 1e-5


def _close(ref, port, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_camera_matches():
    rng = np.random.default_rng(0)
    q = rng.normal(size=4)
    R = np.asarray(JQ.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))
    T = rng.normal(size=3)
    for kw in (dict(fovx=0.9, fovy=0.7), dict(K=np.array([[90.0, 0, 40], [0, 95.0, 31], [0, 0, 1]]))):
        jc = JC.make_camera(R, T, 80, 64, fid=0.3, **kw)
        tc = TC.make_camera(R, T, 80, 64, fid=0.3, device="cpu", **kw)
        _close(jc.w2c, tc.w2c, 0)
        _close(jc.intrinsics, tc.intrinsics, 0)
        _close(jc.fid, tc.fid, 0)
        _close(jc.tanfovx, tc.tanfovx, 0)
        _close(JC.camera_center(jc), TC.camera_center(tc))
        pts = rng.normal(size=(50, 3)).astype(np.float32) + np.asarray(JC.camera_center(jc)) * 0.1
        (jp, jz), (tp, tz) = JC.project_points(jc, jnp.asarray(pts)), TC.project_points(tc, _t(pts))
        _close(jz, tz)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-3)
    assert TC.fov2focal(0.9, 80) == JC.fov2focal(0.9, 80)
    assert TC.focal2fov(90.0, 80) == JC.focal2fov(90.0, 80)


def test_quaternion_matches():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    a[0] = 0.0  # zero quat stays finite
    _close(JQ.quat_normalize(jnp.asarray(a)), TQ.quat_normalize(_t(a)))
    _close(JQ.quat_multiply(jnp.asarray(a), jnp.asarray(b)), TQ.quat_multiply(_t(a), _t(b)))
    _close(JQ.quat_to_rotmat(jnp.asarray(a)), TQ.quat_to_rotmat(_t(a)))
    # rotmat -> quat over all four Shepperd branches (w, x, y, z largest)
    qs = np.concatenate([b, np.eye(4, dtype=np.float32), -np.eye(4, dtype=np.float32)])
    m = np.asarray(JQ.quat_to_rotmat(jnp.asarray(qs)))
    _close(JQ.rotmat_to_quat(jnp.asarray(m)), TQ.rotmat_to_quat(_t(m)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_matches(degree):
    rng = np.random.default_rng(2)
    sh = rng.normal(size=(40, 16, 3)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(JSH.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)), TSH.eval_sh(degree, _t(sh), _t(d)))
    rgb = rng.uniform(size=(40, 3)).astype(np.float32)
    _close(JSH.rgb_to_sh_dc(jnp.asarray(rgb)), TSH.rgb_to_sh_dc(_t(rgb)))
    assert TSH.sh_dim(degree) == JSH.sh_dim(degree)


def test_point_segment_dist2_matches():
    rng = np.random.default_rng(3)
    a, b, p = (rng.normal(size=s).astype(np.float32) for s in ((6, 3), (6, 3), (70, 3)))
    b[2] = a[2]  # a degenerate (zero-length) segment
    _close(JGEO.point_segment_dist2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(p)),
           TGEO.point_segment_dist2(_t(a), _t(b), _t(p)))


def test_forward_kinematics_matches():
    rng = np.random.default_rng(4)
    parents = (0, 0, 1, 2, 1, 4, 0, 6)
    assert TFK._levels(parents) == JFK._levels(parents)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    rot = np.asarray(JQ.quat_to_rotmat(jnp.asarray(q)))
    joints = rng.normal(size=(8, 3)).astype(np.float32)
    (jp, jg), (tp, tg) = (
        JFK.forward_kinematics(jnp.asarray(rot), jnp.asarray(joints), parents),
        TFK.forward_kinematics(_t(rot), _t(joints), parents),
    )
    _close(jp, tp)
    _close(jg, tg)


def test_small_k_matches_with_ties():
    rng = np.random.default_rng(5)
    d2 = rng.integers(0, 6, size=(50, 9)).astype(np.float32)  # many exact ties
    (jv, ji), (tv, ti) = j_small_k(jnp.asarray(d2), 3), TKNN._small_k(_t(d2), 3)
    _close(jv, tv, 0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_positional_embed_matches():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    for f in (0, 1, 4, 10):
        _close(JM.positional_embed(jnp.asarray(x), f), TM.positional_embed(_t(x), f))
        assert TM.embed_dim(3, f) == JM.embed_dim(3, f)
    # block order: x, then per frequency sin(2^k x) for all dims, then cos
    e = TM.positional_embed(_t(x), 2).numpy()
    np.testing.assert_allclose(e[:, 3:6], np.sin(x), atol=1e-6)
    np.testing.assert_allclose(e[:, 6:9], np.cos(x), atol=1e-6)
    np.testing.assert_allclose(e[:, 9:12], np.sin(2 * x), atol=1e-6)


def test_mlp_skip_order_matches():
    """Reference weights (d_in, d_out) load transposed; the skip concat is [x, h]."""
    rng = np.random.default_rng(7)
    p = JM.mlp_init(jax.random.PRNGKey(0), 13, 32, 5, 6, skips=(2,), out_kind="kaiming")
    m = TM.MLP(13, 32, 5, 6, skips=(2,))
    with torch.no_grad():
        convert._load_mlp(m, jax.tree.map(np.asarray, p))
    assert m.layers[3].in_features == 32 + 13
    x = rng.normal(size=(11, 13)).astype(np.float32)
    with torch.no_grad():
        _close(JM.mlp_apply(p, jnp.asarray(x), skips=(2,)), m(_t(x)))
    with pytest.raises(ValueError):
        convert._load_mlp(TM.MLP(13, 32, 5, 5, skips=(2,)), jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("kind", ["kaiming", "normal", "torch_default"])
def test_linear_init_is_seeded(kind):
    a = TM.make_linear(64, 8, kind, std=0.1, generator=torch.Generator().manual_seed(3))
    b = TM.make_linear(64, 8, kind, std=0.1, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = {"kaiming": np.sqrt(6 / 64), "normal": 1.0, "torch_default": 1 / 8}[kind]
    assert float(a.weight.detach().abs().max()) <= bound


@pytest.mark.parametrize("isotropic", [False, True])
def test_gaussians_activations_match(isotropic):
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    gs = JG.create_from_pcd(pts, rng.uniform(size=(30, 3)).astype(np.float32), 40, isotropic=isotropic)
    p = dict(jax.tree.map(np.asarray, gs.params_dict()))
    p["rotation"] = rng.normal(size=p["rotation"].shape).astype(np.float32)
    p["opacity"] = rng.normal(size=p["opacity"].shape).astype(np.float32)
    p["feature"] = rng.normal(size=p["feature"].shape).astype(np.float32)
    gs = gs.replace_params(jax.tree.map(jnp.asarray, p))
    tg = convert.gaussians_from_numpy(p, np.asarray(gs.alive), gs.max_sh_degree, isotropic, True, device="cpu")
    for name in ("get_scaling", "get_rotation", "get_opacity", "get_features", "motion_mask"):
        _close(getattr(gs, name), getattr(tg, name))
    assert tg.capacity == gs.capacity and int(tg.num_alive) == int(gs.num_alive)
    sg = convert.gaussians_from_numpy(p, np.asarray(gs.alive), 3, isotropic, True, shared_scale=True, device="cpu")
    import dataclasses

    _close(dataclasses.replace(gs, shared_scale=True).get_scaling, sg.get_scaling)
