"""The aligned-runs render path of riggs_tpu_torch against riggs_tpu on the
same numpy inputs: render's overflow_budget, the runs binner, the runs blend
and its backward (plain versions on the CPU) against pallas_blend_runs in
interpret mode and its VJP, rasterize_tiled(binning="runs") forward and
backward, and render_auto's escalation of the instance budget.

Tolerances: integer outputs (count, sblk, gid, the overflow counters) exactly
equal; blend out rows rgb/acc 2e-5, depth 2e-4, tentry 1e-5; blend dg atol
1e-4, rtol 1e-3 on each attribute scaled by its largest |reference|
(tests/test_torch_blend_bwd.py); rendered image and alpha 2e-5 and gradients
5e-5 (tests/test_render.py:126,151). The Pallas backward leaves the blocks
past the last run unwritten (NaN in interpret mode): dg is compared on the
blocks it writes, and the port's must be exactly 0 elsewhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.models import gaussians as JG
from riggs_tpu.render import api as JAPI
from riggs_tpu.render import binning as JB
from riggs_tpu.render import pallas_blend as PB
from riggs_tpu.render.tiles import rasterize_tiled as j_rasterize
from riggs_tpu_torch.convert import gaussians_from_numpy
from riggs_tpu_torch.render import api as TAPI
from riggs_tpu_torch.render import binning as TB
from riggs_tpu_torch.render import blend as B
from riggs_tpu_torch.render.tiles import rasterize_tiled as t_rasterize

from tests.test_torch_blend import COUNTS, TILES_X, _saturate, _windows
from tests.test_torch_blend_bwd import _assert_dg, _dout
from tests.test_torch_render import _cams, _projected, _scene, _t

CHUNKS = 3


def _runs_case(seed, spare=2):
    """The windows of tests/test_torch_blend.py (tile 0 saturated) laid out
    as aligned runs: tile t's count rows at block sblk[t], zeros past it,
    ``spare`` unused blocks (the last the spare block) holding garbage that
    no chunk reads."""
    w = _saturate(_windows(np.random.default_rng(seed), 4, CHUNKS * 128), 0, 0)
    nblk = -(-COUNTS // 128)
    sblk = np.concatenate([[0], np.cumsum(nblk)[:-1]]).astype(np.int32)
    m2b = int(nblk.sum()) + spare
    g = np.zeros((16, m2b * 128), np.float32)
    for t, n in enumerate(COUNTS):
        g[:10, sblk[t] * 128 : sblk[t] * 128 + n] = w[t, :n].T
    g[:10, int(nblk.sum()) * 128 : (m2b - 1) * 128] = 7.0
    return g, sblk, int(nblk.sum())


def _port_grad(g, sblk, dout):
    gt = torch.tensor(g, requires_grad=True)
    out, _ = B.blend_runs(gt, torch.as_tensor(COUNTS), torch.as_tensor(sblk), CHUNKS, TILES_X)
    (dg,) = torch.autograd.grad(out, gt, torch.as_tensor(dout))
    return dg.numpy()


def test_render_reports_overflow_budget():
    """render returns overflow_budget on every path, as the reference does:
    0 where the binner keeps no budget, the dropped slots on the runs path."""
    rng = np.random.default_rng(0)
    means, colors, opacity, scales, rots = _scene(rng, 200, extent=0.5)
    jgs = JG.create_from_pcd(means, colors, capacity=256, max_sh_degree=0, with_motion_mask=False)
    tgs = gaussians_from_numpy(jax.tree.map(np.asarray, jgs.params_dict()), np.asarray(jgs.alive), 0,
                               with_motion_mask=False, device="cpu")
    jc, tc = _cams(64, 64)
    for kw in (dict(), dict(binning="runs", max_per_tile=256, max_instances=64)):
        a = JAPI.render(jc, jgs, jnp.zeros(3), **kw)
        with torch.no_grad():
            b = TAPI.render(tc, tgs, torch.zeros(3), **kw)
        assert b["overflow_budget"].dtype == torch.int32 and b["overflow_budget"].shape == ()
        assert int(b["overflow_budget"]) == int(a["overflow_budget"])
        assert (int(b["overflow_budget"]) > 0) == bool(kw)
        assert int(b["overflow"]) == int(a["overflow"])
        np.testing.assert_allclose(b["render"].numpy(), np.asarray(a["render"]), atol=2e-5, rtol=0)


RUNS_CASES = {
    "default": dict(max_per_tile=256),
    "budget_overflow": dict(max_per_tile=256, max_instances=200),
    "rect_overflow": dict(max_per_tile=256, max_tiles_per_gaussian=1),
    "tile_truncation": dict(max_per_tile=128, max_tiles_per_gaussian=9),
}


@pytest.mark.parametrize("case", sorted(RUNS_CASES))
def test_bin_gaussians_runs_matches(case):
    rng = np.random.default_rng(3)
    jp, tp, _ = _projected(rng, 300, 160, 128, extent=0.8, log_scale=(-3.5, -1.0))
    kw = RUNS_CASES[case]
    jb = JB.bin_gaussians_runs(jp, 160, 128, **kw)
    tb = TB.bin_gaussians_runs(tp, 160, 128, **kw)
    for name in ("count", "overflow", "overflow_budget"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_array_equal(tb.runs.gid.numpy(), np.asarray(jb.runs.gid), err_msg="gid")
    np.testing.assert_array_equal(tb.runs.sblk.numpy(), np.asarray(jb.runs.sblk), err_msg="sblk")
    assert tb.runs.gid.dtype == tb.runs.sblk.dtype == torch.int32
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    assert (int(tb.overflow_budget) > 0) == (case == "budget_overflow")
    if case == "rect_overflow":
        assert int(tb.overflow) > int(TB.bin_gaussians_runs(tp, 160, 128, max_per_tile=256).overflow)
    if case == "tile_truncation":
        assert int(tb.count.max()) > kw["max_per_tile"]


def test_blend_runs_matches_pallas_interpret():
    g, sblk, _ = _runs_case(1)
    out_ref, (*_, tentry_ref) = PB._pb_runs_fwd(
        jnp.asarray(g), jnp.asarray(COUNTS), jnp.asarray(sblk), CHUNKS, TILES_X, True
    )
    out, tentry = B.blend_runs(torch.as_tensor(g), torch.as_tensor(COUNTS), torch.as_tensor(sblk), CHUNKS, TILES_X)
    out_ref = np.asarray(out_ref)
    rows = [0, 1, 2, 4, 5, 6, 7]
    np.testing.assert_allclose(out.numpy()[:, rows], out_ref[:, rows], atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy()[:, 3], out_ref[:, 3], atol=2e-4, rtol=0)
    np.testing.assert_allclose(tentry.numpy(), np.asarray(tentry_ref), atol=1e-5, rtol=0)
    assert float(tentry[0, -1].max()) < B.T_EPS  # the saturated tile
    assert torch.all(out[2] == 0) and torch.all(tentry[2] == 1)  # the empty tile


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_runs_bwd_matches_pallas_interpret(seed):
    g, sblk, used = _runs_case(2)
    dout = _dout(seed)
    _, vjp = jax.vjp(
        lambda x: PB.pallas_blend_runs(x, jnp.asarray(COUNTS), jnp.asarray(sblk), CHUNKS, TILES_X, True),
        jnp.asarray(g),
    )
    (ref,) = vjp(jnp.asarray(dout))
    ref = np.asarray(ref)
    dg = _port_grad(g, sblk, dout)
    written = np.r_[0 : used * 128, g.shape[1] - 128 : g.shape[1]]  # the runs and the spare block
    _assert_dg(dg[:10, written], ref[:10, written], 0)
    assert np.all(ref[10:, written] == 0) and np.all(dg[10:] == 0)
    assert np.all(dg[:, used * 128 :] == 0)  # unused blocks and the spare block
    assert np.abs(dg[:10]).max(axis=1).min() > 0  # every attribute gets a gradient
    # the saturated tile's later chunks and the rows past each count get 0
    assert np.all(dg[:, 128:384] == 0)
    for t, n in enumerate(COUNTS):
        start = int(sblk[t]) * 128
        assert np.all(dg[:, start + n : start + -(-n // 128) * 128] == 0), t


def test_blend_runs_bwd_plain_matches_autograd_of_plain_forward():
    """An independent check of the runs backward formulas (the six sums taken
    directly, d_op = sum draw * exp(power)): torch autograd through the plain
    forward, on the blocks the runs cover."""
    g, sblk, used = _runs_case(3)
    dout = torch.as_tensor(_dout(4))
    gt = torch.tensor(g, requires_grad=True)
    out, _ = B.blend_runs_plain(gt, torch.as_tensor(COUNTS), torch.as_tensor(sblk), CHUNKS, TILES_X)
    (ref,) = torch.autograd.grad(out, gt, dout)
    dg = _port_grad(g, sblk, dout.numpy())
    _assert_dg(dg[:10, : used * 128], ref.numpy()[:10, : used * 128], 0)


def test_blend_runs_wrappers_check_inputs_and_count_no_cpu_launch():
    g, sblk, _ = _runs_case(0)
    counts, sb = torch.as_tensor(COUNTS), torch.as_tensor(sblk)
    B.reset_launches()
    for bad in (
        (torch.as_tensor(g).double(), counts, sb),
        (torch.as_tensor(g)[:, :200], counts, sb),
        (torch.as_tensor(g)[:10], counts, sb),
        (torch.as_tensor(g), counts.long(), sb),
        (torch.as_tensor(g), counts, sb[:3]),
    ):
        with pytest.raises(ValueError):
            B.blend_runs(*bad, CHUNKS, TILES_X)
    out, tentry = B.blend_runs(torch.as_tensor(g), counts, sb, CHUNKS, TILES_X)
    with pytest.raises(ValueError):
        B.blend_runs_bwd(torch.as_tensor(g), counts, sb, tentry[:2], torch.zeros_like(out), TILES_X)
    dg = B.blend_runs_bwd(torch.as_tensor(g), counts, sb, tentry, torch.zeros_like(out), TILES_X)
    assert torch.all(dg == 0)
    assert B.plain_bwd_calls["blend_runs_bwd"] == 1
    assert all(n == 0 for n in B.launches.values()) and "blend_runs" in B.launches and "blend_runs_bwd" in B.launches


def test_runs_blocks_resolves_chunks_past_the_run_to_the_spare_block():
    """_runs_gidx: chunks past a tile's run and chunks of empty tiles read
    the spare block; a run that overflows the budget is clamped to it."""
    counts = torch.tensor([300, 0, 129, 5], dtype=torch.int32)
    sblk = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    blk = B.runs_blocks(counts, sblk, 3, 6)
    assert blk.tolist() == [[0, 1, 2], [5, 5, 5], [3, 4, 5], [5, 5, 5]]
    assert B.runs_blocks(counts, sblk, 3, 4).tolist() == [[0, 1, 2], [3, 3, 3], [3, 3, 3], [3, 3, 3]]


def _render_both(rng, n, kw, w=64, h=64):
    means, colors, opacity, scales, rots = _scene(rng, n, extent=0.4)
    jc, tc = _cams(w, h)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    a = j_rasterize(jc, *(jnp.asarray(x) for x in (means, colors, opacity, scales, rots, bg)), **kw)
    b = t_rasterize(tc, *_t(means, colors, opacity, scales, rots, bg), **kw)
    return a, b


def test_rasterize_tiled_runs_matches():
    rng = np.random.default_rng(8)
    a, b = _render_both(rng, 300, dict(binning="runs", max_per_tile=512))
    np.testing.assert_allclose(b["image"].numpy(), np.asarray(a["image"]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(b["alpha"].numpy(), np.asarray(a["alpha"]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(b["depth"].numpy(), np.asarray(a["depth"]), atol=2e-4, rtol=0)
    for k in ("overflow", "overflow_tiles", "overflow_rect", "overflow_budget", "max_count", "tile_counts"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
    assert int(b["max_count"]) > 128 and int(b["overflow"]) == 0
    # the same function as the sort binner's plain windows
    c = t_rasterize(_cams(64, 64)[1], *_t(*_scene(np.random.default_rng(8), 300, extent=0.4),
                                          np.array([0.2, 0.1, 0.4], np.float32)), max_per_tile=512)
    np.testing.assert_allclose(b["image"].numpy(), c["image"].numpy(), atol=2e-5, rtol=0)


def test_rasterize_tiled_runs_grads_match():
    """tests/test_render.py:129-151's loss on the runs path: d(means,
    opacity, scales) against the reference's."""
    rng = np.random.default_rng(11)
    means, colors, opacity, scales, rots = _scene(rng, 60)
    jc, tc = _cams(64, 64)
    target = 0.5

    def jloss(m, o, s):
        out = j_rasterize(jc, m, jnp.asarray(colors), o, s, jnp.asarray(rots), jnp.zeros(3),
                          binning="runs", max_per_tile=128)
        return jnp.mean((out["image"] - target) ** 2)

    ja = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(means), jnp.asarray(opacity), jnp.asarray(scales))
    m, o, s = (torch.tensor(x, requires_grad=True) for x in (means, opacity, scales))
    out = t_rasterize(tc, m, *_t(colors), o, s, *_t(rots), torch.zeros(3), binning="runs", max_per_tile=128)
    tg = torch.autograd.grad(torch.mean((out["image"] - target) ** 2), (m, o, s))
    for a, b, name in zip(ja, tg, ("means", "opacity", "scales")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5, rtol=0, err_msg=name)
        assert float(b.abs().max()) > 0, name
    assert B.plain_bwd_calls["blend_runs_bwd"] > 0


def _recorded_caps(monkeypatch, module):
    calls = []
    orig = module.render

    def rec(*args, **kw):
        calls.append((kw["max_per_tile"], kw["max_tiles_per_gaussian"], kw["max_instances"]))
        return orig(*args, **kw)

    monkeypatch.setattr(module, "render", rec)
    return calls


@pytest.mark.parametrize("start", [dict(max_instances=16), dict(max_tiles_per_gaussian=1, max_per_tile=128)],
                         ids=["budget", "rect_and_tiles"])
def test_render_auto_runs_escalates_like_the_reference(monkeypatch, start):
    """render_auto(binning="runs") walks the same caps as the reference's
    (an overflow_budget doubles max_instances from the given value, or from
    4 * capacity) and ends with the same untruncated render."""
    rng = np.random.default_rng(12)
    means, colors, opacity, scales, rots = _scene(rng, 300, extent=0.4)
    scales[:4] = 0.3  # splats that cover many tiles
    jgs = JG.create_from_pcd(means, colors, capacity=320, max_sh_degree=0, with_motion_mask=False)
    jgs = dataclasses.replace(jgs, scaling=jnp.asarray(np.pad(np.log(scales), ((0, 20), (0, 0)), constant_values=-9.0)))
    tgs = gaussians_from_numpy(jax.tree.map(np.asarray, jgs.params_dict()), np.asarray(jgs.alive), 0,
                               with_motion_mask=False, device="cpu")
    jc, tc = _cams(64, 64)
    jcalls = _recorded_caps(monkeypatch, JAPI)
    tcalls = _recorded_caps(monkeypatch, TAPI)
    a = JAPI.render_auto(jc, jgs, jnp.zeros(3), binning="runs", **start)
    with torch.no_grad():
        b = TAPI.render_auto(tc, tgs, torch.zeros(3), binning="runs", **start)
    assert tcalls == jcalls and len(tcalls) > 1
    assert int(b["overflow"]) == int(a["overflow"]) == 0
    np.testing.assert_allclose(b["render"].numpy(), np.asarray(a["render"]), atol=2e-5, rtol=0)


def test_runs_keeps_the_reference_errors():
    rng = np.random.default_rng(13)
    args = _t(*_scene(rng, 10), np.zeros(3, np.float32))
    _, tc = _cams(32, 32)
    with pytest.raises(ValueError):
        t_rasterize(tc, *args, binning="runs", tile_ladder=((1, 128),))
    with pytest.raises(ValueError):
        t_rasterize(tc, *args, binning="runs", tile_shard_mesh=object())
