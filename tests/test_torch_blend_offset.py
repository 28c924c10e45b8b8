"""The offset entry of the channel-major blend (``blend_cm_fwd`` /
``blend_cm_bwd`` with a ``tile_offset``) against the reference's ``pallas_blend_offset`` in
interpret mode, forward and through ``jax.vjp``, on a shard of four tiles
of a 3 x 3-tile image: offset 0, a multiple of tiles_x (the shard starts a
tile row lower) and an offset that is not (both px and py move).

On the CPU the wrappers run their plain versions; the kernels themselves
are held on the card by chip_smoke.py ([edges]: the rows of the full call).

Tolerances: out rgb/acc 3e-5, depth 2e-4, tentry 1e-5 and dg atol 1e-4,
rtol 1e-3 per attribute column, as tests/test_torch_blend.py and
tests/test_torch_blend_bwd.py hold the plain-window entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.render import pallas_blend as PB
from riggs_tpu_torch.render import blend as B

from tests.test_torch_blend import _assert_out, _to_cm
from tests.test_torch_blend_bwd import _assert_dg
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

TILES_X, T_LOCAL, MAX = 3, 4, 384
COUNTS = np.array([384, 200, 0, 77], np.int32)


def _shard_windows(seed, offset):
    """Gaussian-major windows (T_LOCAL, MAX, 10) whose splats lie around
    their global tile t + offset; the first row dense and opaque (its tile
    saturates within its first chunk)."""
    rng = np.random.default_rng(seed)
    g = np.zeros((T_LOCAL, MAX, 10), np.float32)
    tiles = np.arange(T_LOCAL) + offset
    ox = ((tiles % TILES_X) * 32).astype(np.float32)[:, None]
    oy = ((tiles // TILES_X) * 32).astype(np.float32)[:, None]
    g[..., 0] = ox + rng.uniform(-6, 38, (T_LOCAL, MAX))
    g[..., 1] = oy + rng.uniform(-6, 38, (T_LOCAL, MAX))
    s = rng.uniform(0.005, 0.05, (T_LOCAL, MAX))
    g[..., 2] = s
    g[..., 3] = rng.uniform(-0.3, 0.3, (T_LOCAL, MAX)) * s
    g[..., 4] = s * rng.uniform(0.5, 1.5, (T_LOCAL, MAX))
    g[..., 5] = rng.uniform(0.05, 0.99, (T_LOCAL, MAX))
    g[..., 6:9] = rng.uniform(0, 1, (T_LOCAL, MAX, 3))
    g[..., 9] = rng.uniform(1, 5, (T_LOCAL, MAX))
    g[0, :, 0] = ox[0] + np.linspace(0, 31, MAX)
    g[0, :, 1] = oy[0] + np.linspace(31, 0, MAX)
    g[0, :, 2:5] = [0.002, 0.0, 0.002]
    g[0, :, 5] = 0.95
    return _to_cm(g)


OFFSETS = [0, TILES_X, 5]


@pytest.mark.parametrize("offset", OFFSETS, ids=["zero", "row", "mid_row"])
def test_blend_cm_offset_matches_pallas_blend_offset(offset):
    g = _shard_windows(offset + 1, offset)
    dout = np.random.default_rng(offset + 7).normal(size=(T_LOCAL, 8, 1024)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda a: PB.pallas_blend_offset(a, jnp.asarray(COUNTS), jnp.int32(offset), TILES_X, True),
                           jnp.asarray(g))
    (dg_ref,) = vjp(jnp.asarray(dout))
    _, (_, _, _, tentry_ref) = PB._pb_off_fwd(jnp.asarray(g), jnp.asarray(COUNTS), jnp.int32(offset), TILES_X, True)

    gt = torch.tensor(g, requires_grad=True)
    fwd = lambda g_, c_, tx: B.blend_cm_fwd(g_, c_, tx, offset)
    bwd = lambda g_, c_, te_, do_, tx: B.blend_cm_bwd(g_, c_, te_, do_, tx, offset)
    out, tentry = B.BlendFn.apply(gt, fwd, bwd, TILES_X, torch.as_tensor(COUNTS))
    _assert_out(out_ref, out.detach())
    np.testing.assert_allclose(tentry.numpy(), np.asarray(tentry_ref), atol=1e-5, rtol=0)
    # the splats lie in their global tiles: the shard's tiles see them
    assert float(out[1, 4].detach().max()) > 0.5 and float(tentry[0, -1].max()) < B.T_EPS
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    _assert_dg(dg.numpy(), np.asarray(dg_ref), attr_axis=1)
    assert np.all(dg.numpy()[:, 10:] == 0)


def test_offset_is_the_rows_of_the_full_call():
    """Blending rows [k, k + n) of a full 9-tile call with offset k gives
    rows k..k+n-1 of the full call's out and tentry bit for bit, and its
    dg within 1e-6 of each column's largest value (the plain backward
    batches its products over the active tiles, and the CPU's sums round
    with the batch; each kernel block reduces one (tile, chunk) pair, and
    [edges] holds them on the card); the counters keep the offset entry
    apart (no launch on the CPU: the plain-backward calls)."""
    full = np.concatenate([_shard_windows(11, 0), _shard_windows(12, 4), _shard_windows(13, 8)[:1]])
    counts = np.concatenate([COUNTS, COUNTS, COUNTS[:1]])
    dout = torch.as_tensor(np.random.default_rng(5).normal(size=(9, 8, 1024)).astype(np.float32))
    gt = torch.as_tensor(full)
    out_f, te_f = B.blend_cm_fwd(gt, torch.as_tensor(counts), TILES_X)
    dg_f = B.blend_cm_bwd(gt, torch.as_tensor(counts), te_f, dout, TILES_X)
    B.reset_launches()
    for k, n in ((0, 4), (3, 3), (5, 4)):
        c = torch.as_tensor(counts[k:k + n])
        out, te = B.blend_cm_fwd(gt[k:k + n], c, TILES_X, k, counter="blend_cm_offset")
        dg = B.blend_cm_bwd(gt[k:k + n], c, te, dout[k:k + n].contiguous(), TILES_X, k, counter="blend_cm_offset_bwd")
        for a, b in ((out, out_f[k:k + n]), (te, te_f[k:k + n])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        ref = dg_f[k:k + n].numpy()
        scale = np.maximum(np.abs(ref).max(axis=(0, 2), keepdims=True), 1e-30)
        np.testing.assert_allclose(dg.numpy() / scale, ref / scale, rtol=0, atol=1e-6)
    assert B.plain_bwd_calls["blend_cm_offset_bwd"] == 3 and B.plain_bwd_calls["blend_cm_bwd"] == 0
    assert all(v == 0 for v in B.launches.values())
