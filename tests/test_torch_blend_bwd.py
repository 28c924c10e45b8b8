"""The port's blend backward (riggs_tpu_torch/render/blend.py) against the
reference's Pallas backward kernels in interpret mode (jax.vjp of
pallas_blend / pallas_blend_permuted_gm), and against torch autograd
through the plain forward, on the windows of tests/test_torch_blend.py.

On the CPU the autograd Functions run the plain backward versions; the CUDA
kernels are held against those versions on the card by chip_smoke.py.

Tolerance on dg: atol 1e-4, rtol 1e-3 (tests/test_pallas_blend.py:44), on
each attribute's gradients divided by their largest |reference| value: the
cotangents here are unit normals per pixel, so the conic gradients reach
~1e4 and their small elements are sums that cancel to ~1e-6 of the column.
Rows of skipped chunks, rows past the count and the channel-major padding
rows must be exactly 0: the window gathers send their gradients to real
Gaussians.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.render import pallas_blend as PB
from riggs_tpu_torch.render import blend as B

from tests.test_torch_blend import COUNTS, TILES_X, _saturate, _to_cm, _windows

TOL = dict(atol=1e-4, rtol=1e-3)
TIDS = np.array([3, 1, 0, 2], np.int32)


def _dout(seed, T=4):
    return np.random.default_rng(seed).normal(size=(T, 8, 1024)).astype(np.float32)


def _cm_case(seed=1):
    return _to_cm(_saturate(_windows(np.random.default_rng(seed), 4, 384), 0, 0))


def _gm_case(seed=2):
    return _saturate(_windows(np.random.default_rng(seed), 4, 384), 0, 3)


def _assert_dg(dg, ref, attr_axis):
    """assert_allclose per attribute, scaled by the attribute's largest |ref|."""
    axes = tuple(a for a in range(dg.ndim) if a != attr_axis % dg.ndim)
    scale = np.maximum(np.abs(ref).max(axis=axes, keepdims=True), 1e-30)
    np.testing.assert_allclose(dg / scale, ref / scale, **TOL)


def _port_cm_grad(g, dout):
    gt = torch.tensor(g, requires_grad=True)
    out, _ = B.blend_cm(gt, torch.as_tensor(COUNTS), TILES_X)
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    return dg.numpy()


def _port_gm_grad(g, dout):
    gt = torch.tensor(g, requires_grad=True)
    out, _ = B.blend_permuted_gm(gt, torch.as_tensor(COUNTS), torch.as_tensor(TIDS), TILES_X)
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    return dg.numpy()


def _assert_zero_rows_cm(dg):
    """Padding rows, chunks past the count and chunks entered saturated."""
    assert np.all(dg[:, 10:] == 0)
    for t, n in enumerate(COUNTS):
        first_skipped = -(-n // 128) * 128
        assert np.all(dg[t, :, first_skipped:] == 0), t
    assert np.all(dg[0, :, 128:] == 0)  # the saturated tile: chunks 1, 2 skipped


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_cm_bwd_matches_pallas_interpret(seed):
    g, dout = _cm_case(), _dout(seed)
    _, vjp = jax.vjp(lambda x: PB.pallas_blend(x, jnp.asarray(COUNTS), TILES_X, True), jnp.asarray(g))
    (ref,) = vjp(jnp.asarray(dout))
    dg = _port_cm_grad(g, dout)
    _assert_dg(dg, np.asarray(ref), 1)
    _assert_zero_rows_cm(dg)
    assert np.abs(dg[:, :10]).max(axis=(0, 2)).min() > 0  # every attribute gets a gradient


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_permuted_gm_bwd_matches_pallas_interpret(seed):
    g, dout = _gm_case(), _dout(seed)
    _, vjp = jax.vjp(
        lambda x: PB.pallas_blend_permuted_gm(x, jnp.asarray(COUNTS), jnp.asarray(TIDS), TILES_X, True),
        jnp.asarray(g),
    )
    (ref,) = vjp(jnp.asarray(dout))
    dg = _port_gm_grad(g, dout)
    _assert_dg(dg, np.asarray(ref), -1)
    for t, n in enumerate(COUNTS):
        assert np.all(dg[t, n:] == 0), t  # rows past the count
    assert np.all(dg[0, 128:] == 0)  # the saturated tile's skipped chunks
    assert np.abs(dg).max(axis=(0, 1)).min() > 0


def test_blend_bwd_plain_matches_autograd_of_plain_forward():
    """An independent check: torch autograd through _blend_plain."""
    dout = torch.as_tensor(_dout(5))
    g = torch.tensor(_cm_case(3), requires_grad=True)
    out, _ = B.blend_cm_plain(g, torch.as_tensor(COUNTS), TILES_X)
    (ref,) = torch.autograd.grad(out, g, dout)
    _assert_dg(_port_cm_grad(_cm_case(3), dout.numpy()), ref.numpy(), 1)
    g = torch.tensor(_gm_case(4), requires_grad=True)
    out, _ = B.blend_permuted_gm_plain(g, torch.as_tensor(COUNTS), torch.as_tensor(TIDS), TILES_X)
    (ref,) = torch.autograd.grad(out, g, dout)
    _assert_dg(_port_gm_grad(_gm_case(4), dout.numpy()), ref.numpy(), -1)


def test_blend_bwd_ignores_garbage_past_the_count():
    """Rows past the count (the ladder's invalid slots read row 0's
    Gaussian) change neither the gradient of the real rows nor their own 0."""
    g, dout = _gm_case(), _dout(0)
    g2 = g.copy()
    for t, n in enumerate(COUNTS):
        g2[t, n:, 5] = 0.99
        g2[t, n:, 6:10] = 1e3
    assert np.array_equal(_port_gm_grad(g, dout), _port_gm_grad(g2, dout))


def test_blend_function_takes_strided_dout_and_checks_inputs():
    """dout arrives strided from the untile transposes; the backward
    wrappers check shapes and types as the forward ones do."""
    g = torch.tensor(_cm_case(), requires_grad=True)
    counts = torch.as_tensor(COUNTS)
    out, tentry = B.blend_cm(g, counts, TILES_X)
    assert not tentry.requires_grad
    dout = torch.as_tensor(_dout(0)).transpose(1, 2).contiguous().transpose(1, 2)
    assert not dout.is_contiguous()
    B.reset_launches()
    (dg,) = torch.autograd.grad(out, g, dout)
    assert B.plain_bwd_calls["blend_cm_bwd"] == 1 and B.launches["blend_cm_bwd"] == 0
    np.testing.assert_array_equal(dg.numpy(), _port_cm_grad(_cm_case(), _dout(0)))
    with pytest.raises(ValueError):
        B.blend_cm_bwd(g.detach(), counts, tentry[:, :2], dout, TILES_X)
    with pytest.raises(ValueError):
        B.blend_cm_bwd(g.detach(), counts, tentry, dout.double(), TILES_X)
    with pytest.raises(ValueError):
        B.blend_permuted_gm_bwd(torch.zeros((4, 384, 10)), counts, torch.as_tensor(TIDS), tentry, dout[:, :5], TILES_X)
