"""The port's forward blends (riggs_tpu_torch/render/blend.py) against the
reference's Pallas kernels in interpret mode, on the same numpy windows.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are held against those versions on the card by chip_smoke.py.

Tolerances: out rows rgb/acc 3e-5 and depth 2e-4, as
tests/test_pallas_blend.py holds the Pallas kernel to the jnp blend (the
interpret-mode kernel runs its cumsum and accumulation as bf16 hi/lo split
matmuls, the port as f32 running sums); tentry 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.render import pallas_blend as PB
from riggs_tpu_torch.render import blend as B

TILES_X = 2


def _windows(rng, T, MAX, extent=72.0):
    """Random gaussian-major windows (T, MAX, 10) over a 2x2-tile image."""
    g = np.zeros((T, MAX, 10), np.float32)
    g[..., 0:2] = rng.uniform(-8, extent, (T, MAX, 2))
    s = rng.uniform(0.005, 0.05, (T, MAX))
    g[..., 2] = s
    g[..., 3] = rng.uniform(-0.3, 0.3, (T, MAX)) * s
    g[..., 4] = s * rng.uniform(0.5, 1.5, (T, MAX))
    g[..., 5] = rng.uniform(0.05, 0.99, (T, MAX))
    g[..., 6:9] = rng.uniform(0, 1, (T, MAX, 3))
    g[..., 9] = rng.uniform(1, 5, (T, MAX))
    return g


def _saturate(g, row, tile):
    """Make window row ``row`` (rendering ``tile``) dense and opaque, so the
    tile's transmittance drops below 1e-4 within the first chunk."""
    ox, oy = (tile % TILES_X) * 32, (tile // TILES_X) * 32
    g[row, :, 0] = ox + np.linspace(0, 31, g.shape[1])
    g[row, :, 1] = oy + np.linspace(31, 0, g.shape[1])
    g[row, :, 2:5] = [0.002, 0.0, 0.002]
    g[row, :, 5] = 0.95
    return g


def _to_cm(g):
    gcm = np.zeros((g.shape[0], 16, g.shape[1]), np.float32)
    gcm[:, :10] = g.transpose(0, 2, 1)
    return gcm


def _assert_out(out_ref, out_port):
    out_ref = np.asarray(out_ref)
    out_port = out_port.numpy()
    rows = [0, 1, 2, 4, 5, 6, 7]
    np.testing.assert_allclose(out_port[:, rows], out_ref[:, rows], atol=3e-5, rtol=0)
    np.testing.assert_allclose(out_port[:, 3], out_ref[:, 3], atol=2e-4, rtol=0)


# counts: a full multi-chunk tile, one ending mid-chunk, an empty tile, one
# whose count ends inside the first chunk
COUNTS = np.array([384, 200, 0, 77], np.int32)


def test_blend_cm_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    g = _to_cm(_saturate(_windows(rng, 4, 384), 0, 0))
    out_ref, (_, _, tentry_ref) = PB._pallas_blend_fwd(jnp.asarray(g), jnp.asarray(COUNTS), TILES_X, True)
    out, tentry = B.blend_cm(torch.as_tensor(g), torch.as_tensor(COUNTS), TILES_X)
    _assert_out(out_ref, out)
    np.testing.assert_allclose(tentry.numpy(), np.asarray(tentry_ref), atol=1e-5, rtol=0)
    # the dense tile saturates: later chunks enter below 1e-4 everywhere
    assert float(tentry[0, -1].max()) < B.T_EPS


def test_blend_permuted_gm_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    tids = np.array([3, 1, 0, 2], np.int32)
    g = _saturate(_windows(rng, 4, 384), 0, 3)
    out_ref, (*_, tentry_ref) = PB._pb_perm_gm_fwd(
        jnp.asarray(g), jnp.asarray(COUNTS), jnp.asarray(tids), TILES_X, True
    )
    out, tentry = B.blend_permuted_gm(
        torch.as_tensor(g), torch.as_tensor(COUNTS), torch.as_tensor(tids), TILES_X
    )
    _assert_out(out_ref, out)
    np.testing.assert_allclose(tentry.numpy(), np.asarray(tentry_ref), atol=1e-5, rtol=0)
    assert float(tentry[0, -1].max()) < B.T_EPS
    # rows past the count are masked: garbage there changes nothing
    g2 = g.copy()
    for t, n in enumerate(COUNTS):
        g2[t, n:, 5] = 0.99
        g2[t, n:, 6:10] = 1e3
    out2, tentry2 = B.blend_permuted_gm(
        torch.as_tensor(g2), torch.as_tensor(COUNTS), torch.as_tensor(tids), TILES_X
    )
    assert torch.equal(out2, out) and torch.equal(tentry2, tentry)


def test_blend_writes_tentry_for_skipped_chunks():
    """An empty tile blends nothing and keeps T = 1 at every chunk entry."""
    rng = np.random.default_rng(3)
    g = _to_cm(_windows(rng, 4, 384))
    out, tentry = B.blend_cm(torch.as_tensor(g), torch.as_tensor(COUNTS), TILES_X)
    assert torch.all(out[2] == 0)
    assert torch.all(tentry[2] == 1)
    assert torch.all(tentry[:, 0] == 1)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    g = torch.zeros((2, 16, 128))
    counts = torch.zeros(2, dtype=torch.int32)
    B.reset_launches()
    with pytest.raises(ValueError):
        B.blend_cm(g.double(), counts, 1)
    with pytest.raises(ValueError):
        B.blend_cm(torch.zeros((2, 16, 100)), counts, 1)
    with pytest.raises(ValueError):
        B.blend_cm(g, counts.long(), 1)
    with pytest.raises(ValueError):
        B.blend_permuted_gm(torch.zeros((2, 128, 10)), counts, torch.zeros(3, dtype=torch.int32), 1)
    out, tentry = B.blend_cm(g, counts, 1)
    assert out.shape == (2, 8, 1024) and tentry.shape == (2, 1, 1024)
    # the plain version ran: no kernel launch is counted
    assert set(B.launches) == {"blend_cm", "blend_permuted_gm", "blend_runs",
                               "blend_cm_bwd", "blend_permuted_gm_bwd", "blend_runs_bwd",
                               "blend_cm_offset", "blend_cm_offset_bwd"}
    assert all(n == 0 for n in B.launches.values())
