"""The port's image metrics, dual-quaternion helpers and dual-quaternion
skinning against riggs_tpu on the same numpy inputs: ms_ssim and
evaluate_image (eval/metrics.py), qt_to_dq / dq_to_qt / dq_blend / dq_apply
(ops/quaternion.py), cal_nn_weight_skeleton (top-K and dense, with and
without the skinning MLP) and deform_by_pose_dq (models/skeleton_warp.py).

Tolerance: 1e-5 absolute for every float output (f32 math in both), the
gathered joint indices exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.eval import metrics as JMet
from riggs_tpu.models import skeleton_warp as JSW
from riggs_tpu.ops import quaternion as JQ
from riggs_tpu_torch import convert
from riggs_tpu_torch.eval import metrics as TMet
from riggs_tpu_torch.models import skeleton_warp as TSW
from riggs_tpu_torch.ops import quaternion as TQ

ATOL = 1e-5


def _close(ref, port, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach() if isinstance(port, torch.Tensor) else port),
                               np.asarray(ref), atol=atol, rtol=0)


def _images(seed, h=64, w=80, b=None):
    """A smooth image in [0, 1] and a noisy, shifted copy of it."""
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if b is None else (b, h, w, 3)
    base = rng.uniform(size=shape)
    for ax in (-3, -2):
        base = (base + np.roll(base, 1, axis=ax) + np.roll(base, -1, axis=ax)) / 3.0
    other = np.clip(np.roll(base, 2, axis=-2) + rng.normal(scale=0.05, size=shape), 0.0, 1.0)
    return base.astype(np.float32), other.astype(np.float32)


@pytest.mark.parametrize("seed,batch", [(0, None), (1, 2)])
def test_ms_ssim_matches(seed, batch):
    a, b = _images(seed, b=batch)
    ref = float(JMet.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    port = float(TMet.ms_ssim(torch.as_tensor(a), torch.as_tensor(b)))
    assert 0.0 < ref < 1.0
    assert abs(port - ref) <= ATOL, (port, ref)
    # identical images: exactly 1 in both up to rounding
    assert abs(float(TMet.ms_ssim(torch.as_tensor(a), torch.as_tensor(a))) - 1.0) <= ATOL


def test_avg_pool2_drops_the_odd_edge_like_the_reference():
    a = np.random.default_rng(2).uniform(size=(1, 9, 7, 3)).astype(np.float32)
    _close(JMet._avg_pool2(jnp.asarray(a)), TMet._avg_pool2(torch.as_tensor(a)))


def test_evaluate_image_matches():
    a, b = _images(3)
    ref = JMet.evaluate_image(jnp.asarray(a), jnp.asarray(b))
    port = TMet.evaluate_image(torch.as_tensor(a), torch.as_tensor(b))
    assert set(port) == set(ref) == {"psnr", "ssim", "ms_ssim"}
    for k in ref:
        assert abs(port[k] - ref[k]) <= ATOL * max(1.0, abs(ref[k])), (k, port[k], ref[k])
    # with an LPIPS model the bundle gains lpips_<net> (tests/test_torch_lpips.py holds it to riggs_tpu)
    lp = TMet.LpipsModel.random_init(torch.Generator().manual_seed(0), net="alex", device="cpu")
    with_lp = TMet.evaluate_image(torch.as_tensor(a), torch.as_tensor(b), lpips_model=lp)
    assert list(with_lp) == ["psnr", "ssim", "ms_ssim", "lpips_alex"]
    assert {k: with_lp[k] for k in port} == port
    assert with_lp["lpips_alex"] == float(lp(torch.as_tensor(a), torch.as_tensor(b)))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_dual_quaternion_helpers_match():
    rng = np.random.default_rng(4)
    q, t = _quats(rng, 12), rng.normal(size=(12, 3)).astype(np.float32)
    jr, jd = JQ.qt_to_dq(jnp.asarray(q * 1.7), jnp.asarray(t))
    tr, td = TQ.qt_to_dq(torch.as_tensor(q * 1.7), torch.as_tensor(t))
    _close(jr, tr)
    _close(jd, td)
    for a, b in zip(JQ.dq_to_qt(jr * 2.0, jd * 2.0), TQ.dq_to_qt(tr * 2.0, td * 2.0)):
        _close(a, b)
    # blend over K = 4 bones per point, weights normalized; some bones in the far hemisphere
    qr = np.asarray(jr).reshape(3, 4, 4) * np.where(rng.uniform(size=(3, 4, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    qd = np.array(jd).reshape(3, 4, 4)
    w = rng.uniform(size=(3, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    jb = JQ.dq_blend(jnp.asarray(qr), jnp.asarray(qd), jnp.asarray(w))
    tb = TQ.dq_blend(torch.as_tensor(qr), torch.as_tensor(qd), torch.as_tensor(w))
    for a, b in zip(jb, tb):
        _close(a, b)
    x = rng.normal(size=(3, 3)).astype(np.float32)
    _close(JQ.dq_apply(*jb, jnp.asarray(x)), TQ.dq_apply(*tb, torch.as_tensor(x)))


PARENTS = (-1, 0, 1, 2, 1, 4, 0, 6)


def _skel(K, mlp, seed=5):
    """A reference SkeletonWarp on an 8-joint tree (its skinning MLP's head
    perturbed so that it matters) and the port's copy."""
    rng = np.random.default_rng(seed)
    joints = rng.normal(scale=0.4, size=(len(PARENTS), 3)).astype(np.float32)
    js = JSW.init_skeleton_warp(jax.random.PRNGKey(seed), joints, PARENTS, K=K, use_skinning_mlp=mlp,
                                use_template_offsets=False)
    if mlp:
        wm = dict(js.weight_mlp)
        wm["head"] = {k: v + jnp.asarray(rng.normal(scale=0.5, size=v.shape), jnp.float32)
                      for k, v in wm["head"].items()}
        js = js.replace_params(dict(js.params_dict(), skinning_mlp=wm))
    ts = convert.skeleton_warp_from_numpy(jax.tree.map(np.asarray, js.params_dict()), joints, PARENTS, K=K,
                                          use_skinning_mlp=mlp, use_template_offsets=False, device="cpu")
    x = rng.normal(scale=0.5, size=(200, 3)).astype(np.float32)
    return js, ts, x


@pytest.mark.parametrize("K,mlp", [(3, False), (3, True), (-1, False), (-1, True)])
def test_cal_nn_weight_skeleton_matches(K, mlp):
    js, ts, x = _skel(K, mlp)
    jw, jd2, jidx = JSW.cal_nn_weight_skeleton(js, jnp.asarray(x))
    tw, td2, tidx = TSW.cal_nn_weight_skeleton(ts, torch.as_tensor(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(jd2, td2)
    _close(jw, tw)
    assert tw.shape == (200, 3 if K > 0 else len(PARENTS) - 1)


@pytest.mark.parametrize("K", [3, -1])
def test_deform_by_pose_dq_matches(K):
    js, ts, x = _skel(K, True)
    rng = np.random.default_rng(6)
    rot = (np.array([1.0, 0, 0, 0]) + rng.normal(scale=0.3, size=(len(PARENTS), 4))).astype(np.float32)
    trans = rng.normal(scale=0.1, size=3).astype(np.float32)
    mask = (rng.uniform(size=(200, 1)) < 0.8).astype(np.float32)
    jo = JSW.deform_by_pose_dq(js, jnp.asarray(x), jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(mask))
    to = TSW.deform_by_pose_dq(ts, torch.as_tensor(x), torch.as_tensor(rot), torch.as_tensor(trans),
                               torch.as_tensor(mask))
    for k in ("d_xyz", "d_rotation", "d_scaling", "d_nodes", "nn_weight", "template_offsets"):
        _close(jo[k], to[k])
    np.testing.assert_array_equal(to["nn_idx"].numpy(), np.asarray(jo["nn_idx"]))
    assert float(np.abs(np.asarray(jo["d_xyz"])).max()) > 1e-2  # the pose moves the points
