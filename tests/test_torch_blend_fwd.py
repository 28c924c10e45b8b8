"""The (tile, chunk)-parallel decomposition of the port's forward blend
(riggs_tpu_torch/csrc/blend.cu: blend_fwd, chained over each tile's chunks,
and blend_fwd_combine) written out in plain torch on the CPU: against _blend_plain bit for bit, and against the
reference's Pallas forward kernels in interpret mode on deep windows (2
tiles x 10 chunks, from tests/test_torch_blend_bwd.py). Also a chunk's two
paths in the kernel, row by row: the one walk of a chunk whose entry T is
known, and the second walk of one that summed cum_end first.

The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py; this file shows that the split they rest on computes the
same function: a chunk's log-sum cum_end needs no entry T, only the entry T
passes from chunk to chunk, and each chunk's sums follow from its own.

Tolerances against Pallas: out rows rgb/acc 3e-5 and depth 2e-4, tentry
1e-5 (tests/test_torch_blend.py: the interpret-mode kernel runs its cumsum
and accumulation as bf16 hi/lo split matmuls).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.render import pallas_blend as PB
from riggs_tpu_torch.render import blend as B

from tests.test_torch_blend import TILES_X
from tests.test_torch_blend_bwd import DEEP_CHUNKS, DEEP_COUNTS, SAT_CHUNK, _active, _deep_case


def _chunk_alpha(gt, c, keep, px, py, counts, mask_rows):
    """_blend_plain's alpha of chunk c, op for op, kept for the tiles
    ``keep`` (T,) (and rows before the count with ``mask_rows``)."""
    row = torch.arange(B.G_CHUNK)
    g = gt[:, c * B.G_CHUNK : (c + 1) * B.G_CHUNK]
    mx, my = g[:, :, 0:1], g[:, :, 1:2]
    ca, cb, cc, op = g[:, :, 2:3], g[:, :, 3:4], g[:, :, 4:5], g[:, :, 5:6]
    dx = px - mx
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = op * torch.exp(power)
    raw = torch.where(power > 0.0, 0.0, raw)
    alpha = torch.clamp(raw, max=B.ALPHA_MAX)
    alpha = torch.where(alpha < B.ALPHA_MIN, 0.0, alpha)
    keep = keep[:, None]
    if mask_rows:
        keep = keep & ((c * B.G_CHUNK + row)[None, :] < counts[:, None])
    return g, torch.where(keep[:, :, None], alpha, 0.0)


def _chunk_split_fwd(gt, counts, tids, tiles_x, mask_rows):
    """The kernels' decomposition in plain torch: (i) every started chunk's
    per-pixel cum_end, every pixel alive and no entry T (what a chunk sums
    while it waits for its entry T); (ii) the entry T's chained per tile in
    chunk order, with the tile-wide skip (what the chunks pass on); (iii)
    each active chunk's five sums from its own entry T; (iv) the sums added
    in chunk order (blend_fwd_combine). Returns (out, tentry, active
    (T, C))."""
    T, MAX, _ = gt.shape
    C = MAX // B.G_CHUNK
    p = torch.arange(B.P_TILE)
    tids = tids.to(torch.int64)
    px = ((tids % tiles_x) * B.TILE)[:, None].add(p % B.TILE).to(torch.float32)[:, None, :]
    py = ((tids // tiles_x) * B.TILE)[:, None].add(p // B.TILE).to(torch.float32)[:, None, :]
    counts = counts.to(torch.int64)
    started = [c * B.G_CHUNK < counts for c in range(C)]

    cum_end = torch.zeros((T, C, B.P_TILE))  # (i)
    for c in range(C):
        _, alpha = _chunk_alpha(gt, c, started[c], px, py, counts, mask_rows)
        cum_end[:, c] = torch.cumsum(torch.log1p(-alpha), dim=1)[:, -1]

    tentry = torch.empty((T, C, B.P_TILE))  # (ii)
    active = torch.zeros((T, C), dtype=torch.bool)
    trun = torch.ones((T, B.P_TILE))
    for c in range(C):
        tentry[:, c] = trun
        active[:, c] = started[c] & (torch.amax(trun, dim=1) >= B.T_EPS)
        trun = torch.where(active[:, c, None], trun * torch.exp(cum_end[:, c]), trun)

    part = torch.zeros((T, C, B.FWD_SUMS, B.P_TILE))  # (iii)
    for c in range(C):
        g, alpha = _chunk_alpha(gt, c, active[:, c], px, py, counts, mask_rows)
        cum = torch.cumsum(torch.log1p(-alpha), dim=1)
        t_in = tentry[:, c][:, None, :] * torch.exp(cum)
        w = alpha * (t_in / (1.0 - alpha)) * (t_in >= B.T_EPS)
        v = torch.cat([g[:, :, 6:10], torch.ones_like(g[:, :, 5:6])], dim=2)
        part[:, c] = torch.bmm(v.transpose(1, 2), w)

    out = torch.zeros((T, B.OUT_ROWS, B.P_TILE))  # (iv): each tile's active chunks, in order
    for c in range(C):
        out[:, :5] = torch.where(active[:, c, None, None], out[:, :5] + part[:, c], out[:, :5])
    return out, tentry, active


def _row_sums(g, alpha, t0, drop):
    """A chunk's five sums per pixel as a thread of blend_fwd adds them, row
    by row in blend order: acc += w_j * [rgb, depth, 1]_j. drop=False is the
    path of a chunk whose entry T was known: every pixel over every row, w =
    0 once t_in < 1e-4. drop=True is the second walk of a chunk that summed
    cum_end first: a pixel is alive where t0 >= 1e-4, is dropped after its
    first hit with t_in < 1e-4, and a pixel that misses a row or is dropped
    adds nothing. Returns (sums (T, 5, P), pixels dropped)."""
    v = torch.cat([g[:, :, 6:10], torch.ones_like(g[:, :, 5:6])], dim=2)  # (T, G, 5)
    acc = torch.zeros((alpha.shape[0], 5, B.P_TILE))
    cum = torch.zeros_like(t0)
    alive = t0 >= B.T_EPS if drop else torch.ones_like(t0, dtype=torch.bool)
    for j in range(B.G_CHUNK):
        hit = alive & (alpha[:, j] > 0)
        a = torch.where(hit, alpha[:, j], 0.0)
        cum = cum + torch.log1p(-a)
        t_in = t0 * torch.exp(cum)
        on = hit & (t_in >= B.T_EPS)
        w = torch.where(on, a * (t_in / (1.0 - a)), 0.0)
        add = acc + w[:, None, :] * v[:, j, :, None]
        if drop:
            alive = alive & (on | ~hit)
            acc = torch.where(hit[:, None, :], add, acc)
        else:
            acc = add
    return acc, int((t0 >= B.T_EPS).sum() - alive.sum()) if drop else 0


@pytest.mark.parametrize("layout", ["cm", "gm", "runs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_both_chunk_paths_give_the_same_sums_bitwise(layout, seed):
    """blend_fwd's two paths through an active chunk, row by row as its
    threads add: the one walk from a known entry T (every pixel) and the
    second walk after cum_end (a pixel dropped after its first t_in <
    1e-4) give the same bits in every active chunk of the deep windows, so
    out does not depend on which chunks had to wait. Their sums added in
    chunk order are _blend_plain's out within the kernels' tolerance."""
    gt, counts, tids, mask_rows = _gaussian_major(layout, seed)
    ref_out, _ = B._blend_plain(gt, counts, tids, TILES_X, mask_rows)
    _, tentry, active = _chunk_split_fwd(gt, counts, tids, TILES_X, mask_rows)
    p = torch.arange(B.P_TILE)
    t64 = tids.to(torch.int64)
    px = ((t64 % TILES_X) * B.TILE)[:, None].add(p % B.TILE).to(torch.float32)[:, None, :]
    py = ((t64 // TILES_X) * B.TILE)[:, None].add(p // B.TILE).to(torch.float32)[:, None, :]
    out = torch.zeros((gt.shape[0], 5, B.P_TILE))
    dropped = 0
    for c in range(DEEP_CHUNKS):
        g, alpha = _chunk_alpha(gt, c, active[:, c], px, py, counts.to(torch.int64), mask_rows)
        ready, _ = _row_sums(g, alpha, tentry[:, c], drop=False)
        pending, n = _row_sums(g, alpha, tentry[:, c], drop=True)
        dropped += n
        assert torch.equal(ready.view(torch.int32), pending.view(torch.int32)), f"chunk {c}"
        out = torch.where(active[:, c, None, None], out + ready, out)
    assert dropped > 0  # tile 0 saturates: the second walk drops pixels
    rows = [0, 1, 2, 4]
    assert float((out[:, rows] - ref_out[:, rows]).abs().max()) <= 2e-5
    assert float((out[:, 3] - ref_out[:, 3]).abs().max()) <= 2e-4
    assert not ref_out[:, 5:].any()


def _deep_runs(seed, spare=2):
    """The deep channel-major windows laid out as aligned runs: tile t's
    count rows at block sblk[t], zeros past it, ``spare`` unused blocks (the
    last the spare block) of garbage that no chunk reads. Returns (g_runs,
    sblk)."""
    g, counts, _ = _deep_case("cm", seed)
    w = g[:, :10].transpose(0, 2, 1)
    nblk = -(-counts // 128)
    sblk = np.concatenate([[0], np.cumsum(nblk)[:-1]]).astype(np.int32)
    m2b = int(nblk.sum()) + spare
    g_runs = np.zeros((16, m2b * 128), np.float32)
    for t, n in enumerate(counts):
        g_runs[:10, sblk[t] * 128 : sblk[t] * 128 + n] = w[t, :n].T
    g_runs[:10, int(nblk.sum()) * 128 :] = 7.0
    return g_runs, sblk


def _gaussian_major(layout, seed):
    """(windows (T, MAX, 10), counts, tids, mask_rows) of a deep case as the
    plain version reads it."""
    if layout == "runs":
        g_runs, sblk = _deep_runs(seed)
        counts = torch.as_tensor(DEEP_COUNTS)
        blk = B.runs_blocks(counts, torch.as_tensor(sblk), DEEP_CHUNKS, g_runs.shape[1] // 128)
        return B._runs_windows(torch.as_tensor(g_runs), blk), counts, torch.arange(2), False
    g, counts, tids = _deep_case(layout, seed)
    if layout == "cm":
        g = np.ascontiguousarray(g[:, :10].transpose(0, 2, 1))
    return torch.as_tensor(g), torch.as_tensor(counts), torch.as_tensor(tids), layout == "gm"


@pytest.mark.parametrize("layout", ["cm", "gm", "runs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_split_gives_plain_fwd_bitwise(layout, seed):
    """The (tile, chunk)-parallel split the CUDA forward rests on gives
    _blend_plain's tentry and out bit for bit: a chunk's cum_end needs no
    entry T, so every chunk's can be summed at once and the entry T's chained
    after, and the sums over chunks are added in the plain version's order."""
    gt, counts, tids, mask_rows = _gaussian_major(layout, seed)
    ref_out, ref_tentry = B._blend_plain(gt, counts, tids, TILES_X, mask_rows)
    out, tentry, active = _chunk_split_fwd(gt, counts, tids, TILES_X, mask_rows)
    assert torch.equal(tentry.view(torch.int32), ref_tentry.view(torch.int32))
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert torch.equal(active, torch.as_tensor(_active(ref_tentry.numpy(), counts.numpy())))
    # the cases: tile 0 saturates in chunk SAT_CHUNK, tile 1 stays live to its count
    assert active[0].tolist() == [True] * (SAT_CHUNK + 1) + [False] * (DEEP_CHUNKS - SAT_CHUNK - 1)
    assert active[1].all()


def _pallas_fwd(layout, seed):
    """The Pallas forward in interpret mode on the deep case: (out, tentry)."""
    g, counts, tids = _deep_case(layout if layout != "runs" else "cm", seed)
    if layout == "cm":
        out, (*_, tentry) = PB._pallas_blend_fwd(jnp.asarray(g), jnp.asarray(counts), TILES_X, True)
    elif layout == "gm":
        out, (*_, tentry) = PB._pb_perm_gm_fwd(jnp.asarray(g), jnp.asarray(counts), jnp.asarray(tids), TILES_X, True)
    else:
        g_runs, sblk = _deep_runs(seed)
        out, (*_, tentry) = PB._pb_runs_fwd(jnp.asarray(g_runs), jnp.asarray(counts), jnp.asarray(sblk), DEEP_CHUNKS,
                                             TILES_X, True)
    return np.asarray(out), np.asarray(tentry)


@pytest.mark.parametrize("layout", ["cm", "gm", "runs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_split_matches_pallas_interpret_on_deep_windows(layout, seed):
    """The decomposition against pallas_blend / pallas_blend_permuted_gm /
    pallas_blend_runs in interpret mode, windows from the seed: counts ending
    mid-chunk, tile 0 saturating in chunk 4 of 10."""
    gt, counts, tids, mask_rows = _gaussian_major(layout, seed)
    assert all(int(n) % 128 for n in counts)  # both counts end mid-chunk
    out, tentry, active = _chunk_split_fwd(gt, counts, tids, TILES_X, mask_rows)
    assert not bool(active[0, SAT_CHUNK + 1 :].any()) and float(tentry[0, -1].max()) < B.T_EPS
    out_ref, tentry_ref = _pallas_fwd(layout, seed)
    rows = [0, 1, 2, 4, 5, 6, 7]
    np.testing.assert_allclose(out.numpy()[:, rows], out_ref[:, rows], atol=3e-5, rtol=0)
    np.testing.assert_allclose(out.numpy()[:, 3], out_ref[:, 3], atol=2e-4, rtol=0)
    np.testing.assert_allclose(tentry.numpy(), tentry_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,C", [(0, 3), (2, 0)], ids=["T0", "C0"])
def test_fwd_without_work(T, C):
    """T == 0 or C == 0: out is all zero (rows of no chunk), tentry empty; the
    wrappers give the same on the CPU and count no launch."""
    gt = torch.zeros((T, C * 128, 10))
    counts = torch.full((T,), 5, dtype=torch.int32)
    tids = torch.arange(T, dtype=torch.int32)
    out, tentry, active = _chunk_split_fwd(gt, counts, tids, TILES_X, True)
    assert out.shape == (T, 8, 1024) and not out.any() and tentry.shape == (T, C, 1024) and active.shape == (T, C)
    B.reset_launches()
    for o, te in (B.blend_permuted_gm_fwd(gt, counts, tids, TILES_X),
                  B.blend_cm_fwd(torch.zeros((T, 16, C * 128)), counts, TILES_X),
                  B.blend_runs_fwd(torch.zeros((16, 256)), counts, counts, C, TILES_X)):
        assert o.shape == (T, 8, 1024) and not o.any() and te.shape == (T, C, 1024)
    assert not any(B.launches.values())


def test_fwd_scratch_bytes():
    """The forward's scratch: five f32 sums per (tile, chunk, pixel), then
    the int32 chain state (a ticket, a flag per pair and per tile) and a
    count of active chunks per tile."""
    assert B.fwd_scratch_bytes(625, 45) == (625 * 45 * 5 * 1024 + 1 + 625 * 45 + 2 * 625) * 4
    assert B.fwd_scratch_bytes(0, 45) == B.fwd_scratch_bytes(3, 0) == 0


@pytest.mark.parametrize(
    "variant",
    ["fwd-gm-256", "fwd-all-512", "fwd-4-blocks", "fwd-wait", "fwd-abort", "fwd-scale", "fwd-inplace", "split"])
def test_fwd_variants_build_from_the_source(variant):
    """scripts/torch_bwd_variants.py builds its forward variants of
    csrc/blend.cu by exact text substitution (each must match the shipped
    source once) or, for "fwd-inplace" and "split", by replacing the
    forward's section with scripts/blend_fwd_inplace.cu or
    scripts/blend_fwd_split.cu: each variant differs from the source, and a
    section variant defines its own kernels where the shipped one stood."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("torch_bwd_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = B.CSRC.read_text()
    text = mod.variant_source(src, variant)
    assert text != src
    if variant == "split":
        assert "blend_fwd_scan" in text and "cum_rows" not in text and "int launch_bwd" in text
    if variant == "fwd-inplace":
        assert "add_sums" in text and "blend_fwd_combine<<<" not in text and "int launch_bwd" in text
    if variant.startswith("fwd-") and variant.endswith(("256", "512")):
        assert "Bwd<L>::NT, FWD_MIN_BLOCKS" not in text and "static constexpr int NT = L == kGM ? 512 : 256;" in text
