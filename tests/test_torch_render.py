"""The port's render modules against riggs_tpu on the same numpy scenes:
projection, the sort and dense binners, the tile ladder, the oracle and
rasterize_tiled on its plain-window and laddered paths.

Tolerances: projected floats 1e-5 relative; integer outputs (radius, mask,
count, starts, gid_sorted, overflow counters) exactly equal; images and
alpha 3e-5, depth 2e-4 (tests/test_pallas_blend.py's bounds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import make_camera as jmake_camera
from riggs_tpu.render import binning as JB
from riggs_tpu.render import ladder as JL
from riggs_tpu.render.oracle import rasterize_oracle as j_oracle
from riggs_tpu.render.project import build_cov3d_packed as j_cov, project_gaussians as j_project
from riggs_tpu.render.tiles import rasterize_tiled as j_rasterize
from riggs_tpu_torch.convert import camera_from_numpy
from riggs_tpu_torch.render import binning as TB
from riggs_tpu_torch.render import ladder as TL
from riggs_tpu_torch.render.oracle import rasterize_oracle as t_oracle
from riggs_tpu_torch.render.project import Projected, build_cov3d_packed as t_cov, project_gaussians as t_project
from riggs_tpu_torch.render.tiles import _gather_windows, rasterize_tiled as t_rasterize


def _scene(rng, n, extent=1.0, log_scale=(-3.5, -2.0)):
    means = (rng.normal(size=(n, 3)) * extent).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    scales = np.exp(rng.uniform(*log_scale, size=(n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    rots = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return means, colors, opacity, scales, rots


def _cams(w, h, fov=1.0, z=3.0):
    jc = jmake_camera(np.eye(3), np.array([0, 0, z]), w, h, fovx=fov, fovy=fov)
    tc = camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), np.asarray(jc.fid), w, h, device="cpu")
    return jc, tc


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _projected(rng, n, w, h, extent=1.0, log_scale=(-3.5, -2.0)):
    means, colors, opacity, scales, rots = _scene(rng, n, extent, log_scale)
    jc, _ = _cams(w, h)
    jp = j_project(jc, jnp.asarray(means), j_cov(jnp.asarray(scales), jnp.asarray(rots)))
    tp = Projected(*_t(*jp))
    return jp, tp, opacity


def test_project_gaussians_matches():
    rng = np.random.default_rng(0)
    means, colors, opacity, scales, rots = _scene(rng, 400, extent=1.5)
    means[:20, 2] = 3.5  # behind the camera
    alive = np.arange(400) % 7 != 0
    jc, tc = _cams(96, 64)
    jp = j_project(jc, jnp.asarray(means), j_cov(jnp.asarray(scales), jnp.asarray(rots)), jnp.asarray(alive))
    m, s, r, a = _t(means, scales, rots, alive)
    tp = t_project(tc, m, t_cov(s, r), a)
    np.testing.assert_allclose(t_cov(s, r).numpy(), np.asarray(j_cov(jnp.asarray(scales), jnp.asarray(rots))), rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    np.testing.assert_allclose(tp.mean2d.numpy(), np.asarray(jp.mean2d), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth), rtol=1e-6)
    np.testing.assert_allclose(tp.conic.numpy(), np.asarray(jp.conic), rtol=1e-5, atol=1e-7)
    assert 0 < int(tp.mask.sum()) < 400


BIN_CASES = {
    "default": dict(max_tiles_per_gaussian=16),
    "no_tiers": dict(max_tiles_per_gaussian=16, giant_cap=0),
    "mid_and_giant": dict(max_tiles_per_gaussian=4, mid_cap=64, mid_side=4, giant_cap=32, giant_side=8),
    "small_caps": dict(max_tiles_per_gaussian=1, mid_cap=5, mid_side=2, giant_cap=3, giant_side=3),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
@pytest.mark.parametrize("cull", [True, False])
def test_bin_gaussians_sorted_matches(case, cull):
    rng = np.random.default_rng(3)
    jp, tp, opacity = _projected(rng, 300, 160, 128, extent=0.8, log_scale=(-3.5, -1.0))
    kw = BIN_CASES[case]
    jop = jnp.where(jp.mask, jnp.asarray(opacity), 0.0) if cull else None
    top = torch.where(tp.mask, torch.as_tensor(opacity), 0.0) if cull else None
    jb = JB.bin_gaussians_sorted(jp, 160, 128, max_per_tile=256, opacity=jop, **kw)
    tb = TB.bin_gaussians_sorted(tp, 160, 128, max_per_tile=256, opacity=top, **kw)
    for name in ("count", "starts", "gid_sorted", "idx", "valid", "overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    if case == "small_caps":
        assert int(tb.overflow) > 0
    if case == "default":
        assert int(tb.count.max()) > 0 and int(tb.overflow) == 0


def test_extra_tier_pad_clears_last_gaussian():
    """The reference marks its tier's handled Gaussians with
    ``handled.at[gi].set(gok)``; pad slots are clipped to N-1 and, written
    last, clear a real True at N-1. A big Gaussian in the last slot therefore
    keeps its pass-1 rect overflow although the mid tier enumerated it; the
    same Gaussian in slot 0 does not. The port reproduces this."""
    rng = np.random.default_rng(4)
    n = 40
    means, colors, opacity, scales, rots = _scene(rng, n, extent=0.5)
    scales[:] = 0.005
    jc, tc = _cams(128, 128)
    for slot, expect_overflow in ((n - 1, True), (0, False)):
        s, m = scales.copy(), means.copy()
        s[slot], m[slot] = 0.4, 0.0  # one central splat spanning 3-4 tiles a side
        jp = j_project(jc, jnp.asarray(m), j_cov(jnp.asarray(s), jnp.asarray(rots)))
        tp = Projected(*_t(*jp))
        kw = dict(max_tiles_per_gaussian=4, mid_cap=8, mid_side=4, giant_cap=0)
        jb = JB.bin_gaussians_sorted(jp, 128, 128, max_per_tile=256, **kw)
        tb = TB.bin_gaussians_sorted(tp, 128, 128, max_per_tile=256, **kw)
        assert int(tb.overflow) == int(jb.overflow)
        assert (int(tb.overflow) > 0) == expect_overflow
        np.testing.assert_array_equal(tb.gid_sorted.numpy(), np.asarray(jb.gid_sorted))


def test_sort_breaks_depth_ties_by_gid():
    """Exactly tied depths (and -0.0 vs 0.0) order by gid, as the reference's
    three-key sort does."""
    rng = np.random.default_rng(5)
    jp, tp, _ = _projected(rng, 200, 64, 64, extent=0.3)
    depth = np.asarray(jp.depth).copy()
    depth[1::3] = depth[0::3][: len(depth[1::3])]
    jp = jp._replace(depth=jnp.asarray(depth))
    tp = tp._replace(depth=torch.as_tensor(depth))
    jb = JB.bin_gaussians_sorted(jp, 64, 64, max_per_tile=512)
    tb = TB.bin_gaussians_sorted(tp, 64, 64, max_per_tile=512)
    np.testing.assert_array_equal(tb.gid_sorted.numpy(), np.asarray(jb.gid_sorted))


def test_dense_binner_matches():
    rng = np.random.default_rng(6)
    jp, tp, _ = _projected(rng, 250, 96, 96, extent=0.6)
    jb = JB.bin_gaussians(jp, 96, 96, max_per_tile=128)
    tb = TB.bin_gaussians(tp, 96, 96, max_per_tile=128)
    for name in ("count", "idx", "valid"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)


@pytest.mark.parametrize("quantize", ["chunk", "pow2"])
def test_make_tile_ladder_matches(quantize):
    rng = np.random.default_rng(7)
    counts = (rng.pareto(1.5, size=(3, 48)) * 90).astype(np.int32)
    for n_buckets in (1, 3, 5):
        kw = dict(n_buckets=n_buckets, quantize=quantize)
        assert TL.make_tile_ladder(counts, **kw) == JL.make_tile_ladder(counts, **kw)
        assert TL.make_tile_ladder(counts[0], max_cap=512, **kw) == JL.make_tile_ladder(counts[0], max_cap=512, **kw)
    lad = TL.make_tile_ladder(counts)
    assert TL.ladder_rows(lad) == JL.ladder_rows(lad)


def _render_pair(rng, w, h, n, extent, kw_j, kw_t=None, alive=None):
    means, colors, opacity, scales, rots = _scene(rng, n, extent)
    jc, tc = _cams(w, h)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    ja = [jnp.asarray(a) for a in (means, colors, opacity, scales, rots, bg)]
    ta = _t(means, colors, opacity, scales, rots, bg)
    jal = None if alive is None else jnp.asarray(alive)
    tal = None if alive is None else torch.as_tensor(alive)
    a = j_rasterize(jc, *ja, alive=jal, **kw_j)
    b = t_rasterize(tc, *ta, alive=tal, **(kw_t if kw_t is not None else kw_j))
    return a, b, (jc, tc, ja, ta, jal, tal)


def _assert_images(a, b):
    np.testing.assert_allclose(b["image"].numpy(), np.asarray(a["image"]), atol=3e-5, rtol=0)
    np.testing.assert_allclose(b["alpha"].numpy(), np.asarray(a["alpha"]), atol=3e-5, rtol=0)
    np.testing.assert_allclose(b["depth"].numpy(), np.asarray(a["depth"]), atol=2e-4, rtol=0)


def test_rasterize_tiled_plain_windows_matches():
    rng = np.random.default_rng(8)
    alive = np.arange(400) % 5 != 0
    a, b, _ = _render_pair(rng, 96, 80, 400, 0.4, dict(max_per_tile=256, blend="pallas"), dict(max_per_tile=256), alive)
    _assert_images(a, b)
    for k in ("overflow", "overflow_tiles", "overflow_rect", "max_count", "tile_counts"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)
    assert int(b["max_count"]) > 128  # more than one chunk


def test_rasterize_tiled_ladder_matches_and_counts_truncation():
    rng = np.random.default_rng(9)
    probe_j, probe_t, (jc, tc, ja, ta, _, _) = _render_pair(
        rng, 128, 128, 400, 0.4, dict(max_per_tile=512, blend="pallas"), dict(max_per_tile=512)
    )
    counts = probe_t["tile_counts"].numpy()
    ladder = TL.make_tile_ladder(counts, n_buckets=3, margin=1.0)
    assert ladder == JL.make_tile_ladder(np.asarray(probe_j["tile_counts"]), n_buckets=3, margin=1.0)
    a = j_rasterize(jc, *ja, max_per_tile=512, blend="pallas", tile_ladder=ladder)
    b = t_rasterize(tc, *ta, max_per_tile=512, tile_ladder=ladder)
    _assert_images(a, b)
    assert int(b["overflow_tiles"]) == int(a["overflow_tiles"]) == 0
    # the ladder renders what the plain windows render
    np.testing.assert_allclose(b["image"].numpy(), probe_t["image"].numpy(), atol=2e-5, rtol=0)
    # a ladder too small for the dense tiles: truncation is counted, equally
    small = ((16, 128),)
    a = j_rasterize(jc, *ja, max_per_tile=512, blend="pallas", tile_ladder=small)
    b = t_rasterize(tc, *ta, max_per_tile=512, tile_ladder=small)
    assert int(b["overflow_tiles"]) == int(a["overflow_tiles"]) > 0
    _assert_images(a, b)
    # a zero-cap bucket renders background only and counts its hits
    zero = ((8, 512), (8, 0))
    a = j_rasterize(jc, *ja, max_per_tile=512, blend="pallas", tile_ladder=zero)
    b = t_rasterize(tc, *ta, max_per_tile=512, tile_ladder=zero)
    assert int(b["overflow_tiles"]) == int(a["overflow_tiles"]) > 0
    _assert_images(a, b)
    with pytest.raises(ValueError):
        t_rasterize(tc, *ta, tile_ladder=((4, 128),))


def test_rasterize_tiled_matches_oracles():
    rng = np.random.default_rng(10)
    a, b, (jc, tc, ja, ta, _, _) = _render_pair(rng, 64, 64, 200, 1.0, dict(max_per_tile=256, blend="pallas"), dict(max_per_tile=256))
    jo = j_oracle(jc, *ja)
    to = t_oracle(tc, *ta)
    _assert_images(jo, to)
    _assert_images(jo, b)
    d = t_rasterize(tc, *ta, max_per_tile=256, binning="dense")
    _assert_images(jo, d)


def test_gather_windows_is_the_masked_gather():
    """_gather_windows against the reference's window gather (invalid slots
    read row 0, then are masked): the same rows, zeros at invalid slots, and
    the same gradient into every packed row."""
    rng = np.random.default_rng(5)
    packed = torch.tensor(rng.normal(size=(50, 10)), dtype=torch.float32, requires_grad=True)
    idx = torch.tensor(rng.integers(0, 50, size=(6, 128)))
    valid = torch.tensor(rng.uniform(size=(6, 128)) < 0.3)
    out = _gather_windows(packed, idx, valid)
    ref = torch.where(valid[..., None], packed[torch.where(valid, idx, 0)], 0.0)
    cot = torch.tensor(rng.normal(size=tuple(out.shape)), dtype=torch.float32)
    (g_out,) = torch.autograd.grad(out, packed, cot)
    (g_ref,) = torch.autograd.grad(ref, packed, cot)
    assert torch.equal(out, ref)
    np.testing.assert_allclose(g_out.numpy(), g_ref.numpy(), rtol=0, atol=1e-6)


def test_deferred_arguments_raise():
    rng = np.random.default_rng(11)
    means, colors, opacity, scales, rots = _t(*_scene(rng, 10))
    _, tc = _cams(32, 32)
    bg = torch.zeros(3)
    # tile sharding composes with the plain-window blend only; on a 1 x 1
    # mesh (one gloo rank in this process) it renders the same frame
    from tests.test_torch_tileshard import one_rank_mesh

    for kw in (dict(binning="runs"), dict(tile_ladder=((1, 256),))):
        with pytest.raises(ValueError, match="plain-window"):
            t_rasterize(tc, means, colors, opacity, scales, rots, bg, tile_shard_mesh=object(), **kw)
    # mean2d_bias is ported: a zero bias renders the same image
    a = t_rasterize(tc, means, colors, opacity, scales, rots, bg)
    with one_rank_mesh() as mesh:
        sharded = t_rasterize(tc, means, colors, opacity, scales, rots, bg, tile_shard_mesh=mesh)
    for k in ("image", "alpha", "depth"):
        assert torch.equal(sharded[k], a[k]), k
    # the compact and sort2 binners are ported: the same image as the sort binner's
    for binning in ("compact", "sort2"):
        c = t_rasterize(tc, means, colors, opacity, scales, rots, bg, binning=binning)
        np.testing.assert_allclose(c["image"].numpy(), a["image"].numpy(), rtol=0, atol=1e-6)
    b = t_rasterize(tc, means, colors, opacity, scales, rots, bg, mean2d_bias=torch.zeros(10, 2))
    assert torch.equal(a["image"], b["image"])
