"""fit_rotations, the ARAP rotation fit that runs as a hand kernel on the
card (riggs_tpu_torch/csrc/rotfit.cu), on the CPU.

The CUDA kernel runs only on the card, where chip_smoke.py holds it to its
plain version on every stage-1 step's covariances and on planted ill-posed
fits (cov = 0, rank 1, near-reflections, NaN) against the choices the
source documents. Here: the wrapper runs the plain version on a CPU tensor
and refuses other devices, and the plain version agrees with riggs_tpu's
fit_rotations.

A fit is ill-posed where min(s1 + s2, s1 + d s3, s2 + d s3) < 1e-2 s1
(d = det(U V^T)): f32 rounding moves R by about s1 over that sum. Limits:
max |d R| 1e-5 on well-posed rows; det(R) = 1 within 1e-5 on every row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.ops import geometry as JGeo
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
