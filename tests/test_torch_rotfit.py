"""fit_rotations and estimate_rotations, the ARAP rotation fit that runs as
hand kernels on the card (riggs_tpu_torch/csrc/rotfit.cu: the covariance
entry and the fused one, which builds each node's covariance from its
edges), on the CPU.

The CUDA kernels run only on the card, where chip_smoke.py holds them to
their plain versions on every stage-1 step's ARAP fits and on planted
ill-posed fits (cov = 0, rank 1, near-reflections, NaN; a node with no
valid edge, collinear edges) against the choices the source documents.
Here: the wrappers run the plain versions on CPU tensors, count no launch
and refuse other devices, and the plain versions agree with riggs_tpu's
fit_rotations and estimate_rotations.

A fit is ill-posed where min(s1 + s2, s1 + d s3, s2 + d s3) < 1e-2 s1
(d = det(U V^T)): f32 rounding moves R by about s1 over that sum. Limits:
max |d R| 1e-5 on well-posed rows; det(R) = 1 within 1e-5 on every row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.ops import arap as JA
from riggs_tpu.ops import geometry as JGeo
from riggs_tpu_torch.ops import arap as TA
from riggs_tpu_torch.ops import geometry as TGeo

def _well_posed(cov):
    u, s, vt = np.linalg.svd(np.asarray(cov, np.float64))
    d = np.sign(np.linalg.det(u @ vt))
    low = np.minimum(np.minimum(s[:, 0] + s[:, 1], s[:, 0] + d * s[:, 2]), s[:, 1] + d * s[:, 2])
    return low >= 1e-2 * s[:, 0]


def _covariances(seed):
    """Random matrices, ARAP-like correlations of neighbour edges under a
    rotation (some nearly coplanar), and a few near-reflections."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(200, 3, 3))]
    edges = rng.normal(size=(200, 6, 3)) * np.where(rng.uniform(size=(200, 1, 1)) < 0.3, [1.0, 1.0, 1e-3], 1.0)
    q = rng.normal(size=(200, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                    2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1).reshape(200, 3, 3)
    tgt = np.einsum("nab,nkb->nka", rot, edges) + rng.normal(scale=0.05, size=edges.shape)
    out.append(np.einsum("nka,nkb->nab", tgt, edges))
    out.append(np.einsum("nab,bc->nac", rng.normal(size=(50, 3, 3)), np.diag([1.0, 1.0, -1.0])))
    return np.concatenate(out).astype(np.float32)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    cov = torch.as_tensor(_covariances(0))
    before = dict(TGeo.launches)
    np.testing.assert_array_equal(TGeo.fit_rotations(cov).numpy(), TGeo.fit_rotations_plain(cov).numpy())
    assert TGeo.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        TGeo.fit_rotations(torch.zeros((2, 3, 3), device="meta"))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_the_reference(seed):
    cov = _covariances(seed)
    plain = TGeo.fit_rotations_plain(torch.as_tensor(cov)).numpy()
    ref = np.asarray(JGeo.fit_rotations(jnp.asarray(cov)))
    well = _well_posed(cov)
    assert well.mean() > 0.9
    assert np.abs(plain - ref)[well].max() <= 1e-5
    np.testing.assert_allclose(np.linalg.det(plain.astype(np.float64)), 1.0, atol=1e-5)


def _edge_sets(K, seed, n=120):
    """Source points, a target that rotates each node's fan (with noise),
    and an (n, K) connectivity with random neighbours, about a quarter of
    the edges invalid and node 0 with none valid; weights normalized over
    the valid edges. Both packages' Connectivity."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32)
    rot = _rotations_np(rng)
    tgt = (src @ rot.T + rng.normal(scale=0.05, size=src.shape)).astype(np.float32)
    idx = np.stack([rng.choice(np.delete(np.arange(n), i), K, replace=False) for i in range(n)]).astype(np.int32)
    valid = rng.uniform(size=(n, K)) < 0.75
    valid[:, :2] = True
    valid[0] = False
    w = np.where(valid, rng.uniform(0.1, 1.0, size=(n, K)), 0.0)
    w = (w / np.maximum(w.sum(-1, keepdims=True), 1e-12)).astype(np.float32)
    jc = JA.Connectivity(nn_idx=jnp.asarray(idx), weight=jnp.asarray(w), valid=jnp.asarray(valid))
    tc = TA.Connectivity(nn_idx=torch.as_tensor(idx), weight=torch.as_tensor(w), valid=torch.as_tensor(valid))
    cov = np.einsum("nka,nk,nkb->nab", np.where(valid[..., None], tgt[:, None] - tgt[idx], 0.0), w,
                    np.where(valid[..., None], src[:, None] - src[idx], 0.0))
    return src, tgt, jc, tc, cov


def _rotations_np(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@pytest.mark.parametrize("K", [10, 50])
def test_estimate_rotations_plain_matches_the_reference(K):
    """The plain version against riggs_tpu's estimate_rotations on edge fans
    with invalid edges and one node with none valid (both give the
    identity there); max |d R| 1e-5 on the well-posed fits, det(R) = 1
    within 1e-5 on every fit."""
    src, tgt, jc, tc, cov = _edge_sets(K, seed=K)
    plain = TA.estimate_rotations_plain(torch.as_tensor(src), torch.as_tensor(tgt), tc).numpy()
    ref = np.asarray(JA.estimate_rotations(jnp.asarray(src), jnp.asarray(tgt), jc))
    well = _well_posed(cov) & (np.abs(cov).max(axis=(1, 2)) > 0)
    assert well.mean() > 0.9 and not well[0]
    assert np.abs(plain - ref)[well].max() <= 1e-5
    np.testing.assert_array_equal(plain[0], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(ref[0], np.eye(3, dtype=np.float32))
    np.testing.assert_allclose(np.linalg.det(plain.astype(np.float64)), 1.0, atol=1e-5)


def test_estimate_rotations_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version, detached, and counts
    no launch; on another device it raises."""
    src, tgt, _, tc, _ = _edge_sets(10, seed=3)
    s = torch.as_tensor(src).requires_grad_(True)
    before = dict(TGeo.launches)
    got = TA.estimate_rotations(s, torch.as_tensor(tgt), tc)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), TA.estimate_rotations_plain(s, torch.as_tensor(tgt), tc).detach().numpy())
    assert TGeo.launches == before and set(before) == {"fit_rotations", "estimate_rotations"}
    meta = TA.Connectivity(*(x.to("meta") for x in tc))
    with pytest.raises(ValueError, match="unsupported device"):
        TA.estimate_rotations(s.to("meta"), torch.as_tensor(tgt).to("meta"), meta)


def test_kernel_args_check_the_inputs_the_kernel_reads():
    """The fused kernel's arguments (built on any device, so checked here):
    pointers and row strides of the five inputs, n, K and the output;
    a wrong dtype or shape, K above MAX_K, rows whose entries are not
    contiguous or an input on another device are refused."""
    src, tgt, _, tc, _ = _edge_sets(10, seed=5)
    s, t = torch.as_tensor(src), torch.as_tensor(tgt)
    rot = torch.empty((s.shape[0], 3, 3))
    args = TA.kernel_args(s, t, tc, rot)
    assert args == (s.data_ptr(), 3, t.data_ptr(), 3, tc.nn_idx.data_ptr(), 10, tc.weight.data_ptr(), 10,
                    tc.valid.data_ptr(), 10, s.shape[0], 10, rot.data_ptr())
    wide = torch.cat([s, t], dim=1)  # rows at stride 6, entries contiguous: taken as they are
    assert TA.kernel_args(wide[:, :3], wide[:, 3:], tc, rot)[:4] == (wide.data_ptr(), 6, wide[:, 3:].data_ptr(), 6)
    bad = {"dtype": (s.double(), t, tc), "shape": (s[:-1], t, tc),
           "K": (s, t, TA.Connectivity(*(x.repeat(1, 7) for x in tc))),
           "rows": (s.t().contiguous().t(), t, tc),
           "device": (s, t, TA.Connectivity(tc.nn_idx, tc.weight, tc.valid.to("meta")))}
    for what, (a, b, c) in bad.items():
        with pytest.raises(ValueError):
            TA.kernel_args(a, b, c, rot)
