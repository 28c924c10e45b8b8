"""Tile binning: assign depth-sorted Gaussians to 32x32 screen tiles.

Port of ``riggs_tpu/render/binning.py``: the sort binner
``bin_gaussians_sorted`` (with its mid and giant tiers and the exact cell
cull), the aligned-runs binner ``bin_gaussians_runs``, the dense
reference ``bin_gaussians``, and the two binners whose window gathers have
structural backwards (``render/tiles.py``): ``bin_gaussians_compact`` (one
slot per bbox cell under one global instance budget, no per-Gaussian cap)
with its ``CompactInfo``, and ``bin_gaussians_sorted2`` (the padded cells
of depth-presorted Gaussians on one packed integer key) with its
``GridInfo``. Those two take their per-tile counts from
``_mxu_tile_histogram``, a float32 product of 0/1 interval indicators
(exact below 2^24 hits a tile), as the reference does; their packed sort
keys are int64 once (T + 1) times the key range reaches 2^31.

Instance order is (tile, depth, gid), gid breaking exact depth ties, as the
reference's three-key ``lax.sort`` gives it. Depth and gid are per Gaussian,
so one argsort of N (depth, gid) keys gives each Gaussian a unique rank, and
the instances are then sorted on the single int64 key ``tile * N + rank``.
Truncation is counted, never silent: ``count`` is the true per-tile hit
count, ``overflow`` the bbox cells no tier enumerated.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from riggs_tpu_torch.render.project import Projected

TILE = 32


def _extract_windows(src: torch.Tensor, starts: torch.Tensor, max_per_tile: int) -> torch.Tensor:
    """(T, MAX) windows ``src[starts[t] : starts[t] + MAX]`` of a 1-D array.
    ``src`` must be padded by the caller so no window reads past its end."""
    s = torch.arange(max_per_tile, dtype=torch.int64, device=src.device)[None, :]
    # clamped as XLA clamps a gather: a binner that dropped instances (the
    # compact budget, sort2's rect cap) counts more hits than it sorted
    return src[torch.clamp(starts.to(torch.int64)[:, None] + s, max=src.shape[0] - 1)]


class RunsInfo(NamedTuple):
    """Aligned-runs instance layout (``bin_gaussians_runs``): tile t's
    depth-ordered run occupies the 128-slot blocks [sblk[t], sblk[t] +
    ceil(count[t] / 128)) of one flat slot array; the last block is a spare
    that chunks past a tile's run resolve to."""

    gid: torch.Tensor  # (M2,) int32 gaussian id per slot; N at pad slots
    sblk: torch.Tensor  # (T,) int32 first block of each tile's run


class CompactInfo(NamedTuple):
    """By-product of ``bin_gaussians_compact`` that makes the window
    gather's backward a row gather and a segment sum. "Slot" space: the
    instances of each depth-ordered Gaussian g occupy the slots
    [offsets[g], offsets[g] + cnt[g])."""

    order: torch.Tensor  # (N,) gaussian ids in depth order
    invorder: torch.Tensor  # (N,) inverse permutation of order
    offsets: torch.Tensor  # (N,) slot-run start per depth-ordered gaussian
    cnt: torch.Tensor  # (N,) slot-run length per depth-ordered gaussian
    slot_tile: torch.Tensor  # (M,) tile id per slot (T sentinel when invalid)
    invperm: torch.Tensor  # (M,) sorted position of each slot
    starts: torch.Tensor  # (T,) start of each tile's window in the sorted array


class GridInfo(NamedTuple):
    """By-product of ``bin_gaussians_sorted2``: every instance is a cell of
    the padded (K, N) depth-ordered grid, so the window gather's backward
    writes window gradients to their own cells (no collisions) and sums
    over K. K is not a field: the caller passes it."""

    order: torch.Tensor  # (N,) gaussian ids in depth order
    invorder: torch.Tensor  # (N,) inverse of order
    drank_win: torch.Tensor  # (T, MAX) depth rank per window slot
    grid_win: torch.Tensor  # (T, MAX) flat (k * N + drank) cell per slot, N * K when invalid


class TileBins(NamedTuple):
    idx: torch.Tensor | None  # (T, MAX) gaussian indices into the unsorted inputs
    valid: torch.Tensor | None  # (T, MAX) slot validity
    count: torch.Tensor  # (T,) true hit count per tile (pre-truncation)
    tiles_x: int
    tiles_y: int
    overflow: torch.Tensor  # () truncated bbox cells
    starts: torch.Tensor | None = None  # (T,) window start per tile in gid_sorted
    gid_sorted: torch.Tensor | None = None  # (M,) tile-grouped depth-ordered gaussian ids
    runs: RunsInfo | None = None  # set by bin_gaussians_runs
    overflow_budget: torch.Tensor | None = None  # () instance-budget slots dropped
    compact: CompactInfo | None = None  # set by bin_gaussians_compact
    grid: GridInfo | None = None  # set by bin_gaussians_sorted2


def num_tiles(width: int, height: int, tile: int = TILE) -> tuple[int, int]:
    return -(-width // tile), -(-height // tile)


def _floor_tile(v: torch.Tensor, n: int) -> torch.Tensor:
    """clip(int32(floor(v)), 0, n-1). The clamp runs in float so that values
    beyond int32 saturate as XLA's conversion does (torch's wraps)."""
    return torch.clamp(torch.floor(v), 0, n - 1).to(torch.int32)


def _rects(proj: Projected, tx_n: int, ty_n: int, tile: int):
    """Clamped tile-rectangle bounds per gaussian (CUDA getRect semantics)."""
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    radius = proj.radius
    lox = _floor_tile((mx - radius) / tile, tx_n)
    loy = _floor_tile((my - radius) / tile, ty_n)
    hix = _floor_tile((mx + radius) / tile, tx_n)
    hiy = _floor_tile((my + radius) / tile, ty_n)
    return lox, loy, hix, hiy


def _depth_rank_order(depth: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian ids sorted by (depth, gid); masked-out ones last (depth +inf)."""
    d = depth if mask is None else torch.where(mask, depth, torch.inf)
    d = d + 0.0  # -0.0 -> +0.0: the reference's comparator ties the two zeros
    bits = d.view(torch.int32).to(torch.int64)
    # order-preserving float -> integer map (sign-magnitude to two's complement)
    key = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    N = depth.shape[0]
    key = key * N + torch.arange(N, dtype=torch.int64, device=depth.device)
    return torch.argsort(key)


def bin_gaussians(
    proj: Projected,
    width: int,
    height: int,
    max_per_tile: int = 1024,
    tile: int = TILE,
) -> TileBins:
    """Dense reference binner: exact (T, N) bbox-mask compaction, O(T*N)."""
    tx_n, ty_n = num_tiles(width, height, tile)
    T = tx_n * ty_n
    dev = proj.depth.device

    order = _depth_rank_order(proj.depth, proj.mask)
    mean2d = proj.mean2d[order]
    radius = proj.radius[order]
    mask = proj.mask[order]

    lox = _floor_tile((mean2d[:, 0] - radius) / tile, tx_n)
    loy = _floor_tile((mean2d[:, 1] - radius) / tile, ty_n)
    hix = _floor_tile((mean2d[:, 0] + radius) / tile, tx_n)
    hiy = _floor_tile((mean2d[:, 1] + radius) / tile, ty_n)

    tids = torch.arange(T, dtype=torch.int32, device=dev)
    txs = (tids % tx_n)[:, None]
    tys = (tids // tx_n)[:, None]
    hit = (
        mask[None, :]
        & (txs >= lox[None, :])
        & (txs <= hix[None, :])
        & (tys >= loy[None, :])
        & (tys <= hiy[None, :])
    )  # (T, N) in depth order
    count = torch.sum(hit, dim=1).to(torch.int32)

    # first MAX hit positions per row, in depth order; -1 pads
    N = hit.shape[1]
    pos = torch.arange(N, device=dev)[None, :].expand(T, N)
    key = torch.where(hit, pos, N + pos)
    slots = torch.sort(key, dim=1).values[:, :max_per_tile]
    if slots.shape[1] < max_per_tile:
        slots = torch.nn.functional.pad(slots, (0, max_per_tile - slots.shape[1]), value=N)
    valid = slots < N
    idx = torch.where(valid, order[torch.clamp(slots, max=N - 1)], 0).to(torch.int32)
    return TileBins(
        idx=idx, valid=valid, count=count, tiles_x=tx_n, tiles_y=ty_n,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _cell_cull(proj: Projected, opacity: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor, tile: int) -> torch.Tensor:
    """Exact per-cell keep mask: can any pixel of tile (tx, ty) see alpha >=
    1/255 from this gaussian? The max of the concave EWA quadratic over the
    tile's pixel rect is at the centre if inside, else on one of the four
    edges, where the 1-D maximizer has a closed form. tx, ty: (K, N)."""
    mx, my = proj.mean2d[:, 0][None, :], proj.mean2d[:, 1][None, :]
    a = proj.conic[:, 0][None, :]
    b = proj.conic[:, 1][None, :]
    c = proj.conic[:, 2][None, :]
    lx = tx.to(torch.float32) * tile - mx  # pixel centres at integer coords
    ux = lx + (tile - 1)
    ly = ty.to(torch.float32) * tile - my
    uy = ly + (tile - 1)

    def pw(dx, dy):
        return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    eps = 1e-12
    dyx = clip(-b * lx / torch.clamp(c, min=eps), ly, uy)
    dyu = clip(-b * ux / torch.clamp(c, min=eps), ly, uy)
    dxl = clip(-b * ly / torch.clamp(a, min=eps), lx, ux)
    dxu = clip(-b * uy / torch.clamp(a, min=eps), lx, ux)
    pmax = torch.maximum(
        torch.maximum(pw(lx, dyx), pw(ux, dyu)),
        torch.maximum(pw(dxl, ly), pw(dxu, uy)),
    )
    inside = (lx <= 0) & (ux >= 0) & (ly <= 0) & (uy >= 0)
    pmax = torch.where(inside, 0.0, pmax)
    op = torch.clamp(opacity, 1.0 / 255.0 * 1e-3, 1.0)[None, :]
    thresh = torch.log(1.0 / (255.0 * op))
    return pmax >= thresh


def _nonzero_padded(sel: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(sel, size=size, fill_value=fill)``: the first ``size``
    indices in index order, padded with ``fill``. A running count places
    each selected index, so nothing waits for the card (``torch.nonzero``
    would sync to learn its length)."""
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    keep = sel & (pos < size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=sel.device)
    # unselected entries all land in the extra slot ``size``, dropped below
    out.scatter_(0, torch.where(keep, pos, size), torch.arange(sel.shape[0], device=sel.device))
    return out[:size]


def _sort_instances(depth: torch.Tensor, tile_id: torch.Tensor, gid: torch.Tensor, T: int):
    """Sort instances by (tile, depth, gid), the sentinel tile T last.
    Returns (gid_sorted int32, starts, count) with starts/count (T,) int32."""
    N = depth.shape[0]
    dev = depth.device
    order = _depth_rank_order(depth)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, dtype=torch.int64, device=dev)
    key_sorted = torch.sort(tile_id.to(torch.int64) * N + rank[gid.to(torch.int64)]).values
    tile_sorted = key_sorted // N
    gid_sorted = order[key_sorted % N].to(torch.int32)
    tids = torch.arange(T, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(tile_sorted, tids, right=False).to(torch.int32)
    ends = torch.searchsorted(tile_sorted, tids + 1, right=False).to(torch.int32)
    return gid_sorted, starts, ends - starts


def bin_gaussians_sorted(
    proj: Projected,
    width: int,
    height: int,
    max_per_tile: int = 1024,
    tile: int = TILE,
    max_tiles_per_gaussian: int = 16,
    opacity: torch.Tensor | None = None,
    giant_cap: int = 256,
    giant_side: int = 12,
    mid_cap: int = 0,
    mid_side: int = 4,
) -> TileBins:
    """Bin through one global (tile, depth, gid) instance sort.

    Each Gaussian emits the cells of a side x side window anchored at its
    rect's corner (side = ceil(sqrt(max_tiles_per_gaussian))); with
    ``mid_cap > 0`` up to ``mid_cap`` larger ones get a second
    ``mid_side`` window, and up to ``giant_cap`` giants a ``giant_side``
    window, each enumerating only the cells the lower tiers missed. With
    ``opacity`` given, cells no pixel of which reaches alpha >= 1/255 are
    culled exactly."""
    tx_n, ty_n = num_tiles(width, height, tile)
    T = tx_n * ty_n
    N = proj.mean2d.shape[0]
    dev = proj.depth.device

    lox, loy, hix, hiy = _rects(proj, tx_n, ty_n, tile)
    w_rect = hix - lox + 1
    h_rect = hiy - loy + 1

    side = max(int(np.ceil(np.sqrt(max_tiles_per_gaussian))), 1)
    ks = torch.arange(side * side, dtype=torch.int32, device=dev)
    dx = (ks % side)[:, None]
    dy = (ks // side)[:, None]
    tx = lox[None, :] + dx  # (K, N)
    ty = loy[None, :] + dy
    cell_ok = proj.mask[None, :] & (dx < w_rect[None, :]) & (dy < h_rect[None, :])
    if opacity is not None:
        cell_ok &= _cell_cull(proj, opacity, tx, ty, tile)
    tile_id = [torch.where(cell_ok, ty * tx_n + tx, T).reshape(-1)]  # invalid -> sentinel T
    gid = [torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(side * side, N).reshape(-1)]
    # exact cells the side x side window misses: w*h - min(w,side)*min(h,side)
    rect_overflow_cells = torch.where(
        proj.mask,
        w_rect * h_rect - torch.clamp(w_rect, max=side) * torch.clamp(h_rect, max=side),
        0,
    )

    def extra_tier(sel, cap, lo_side, hi_side, rect_overflow_cells):
        """For up to ``cap`` selected Gaussians, the cells of a hi_side x
        hi_side window that every lower tier missed (dx >= lo_side or dy >=
        lo_side)."""
        gsel = _nonzero_padded(sel, cap, N)
        gok = gsel < N
        gi = torch.clamp(gsel, max=N - 1)
        ks2 = torch.arange(hi_side * hi_side, dtype=torch.int32, device=dev)
        dx2 = (ks2 % hi_side)[:, None]
        dy2 = (ks2 // hi_side)[:, None]
        tx2 = lox[gi][None, :] + dx2  # (K2, cap)
        ty2 = loy[gi][None, :] + dy2
        cell_ok2 = (
            gok[None, :]
            & (dx2 < w_rect[gi][None, :])
            & (dy2 < h_rect[gi][None, :])
            & ((dx2 >= lo_side) | (dy2 >= lo_side))
        )
        if opacity is not None:
            sub = Projected(
                mean2d=proj.mean2d[gi], depth=proj.depth[gi], conic=proj.conic[gi],
                radius=proj.radius[gi], mask=proj.mask[gi],
            )
            cell_ok2 &= _cell_cull(sub, opacity[gi], tx2, ty2, tile)
        tile_id.append(torch.where(cell_ok2, ty2 * tx_n + tx2, T).reshape(-1))
        gid.append(gi.to(torch.int32)[None, :].expand(hi_side * hi_side, cap).reshape(-1))
        # The reference writes ``handled.at[gi].set(gok)``; its pad slots are
        # clipped to N-1 and, written last, clear a real True at N-1. The
        # port keeps that result for parity (recorded in ROADMAP Queue C):
        # an OR-scatter of gok at gi, then slot N-1 kept only if the last
        # slot is real. Nothing reads the card (no boolean-mask index).
        handled = torch.zeros(N, dtype=torch.int32, device=dev)
        handled = handled.scatter_add_(0, gi, gok.to(torch.int32)) > 0
        if cap > 0:
            handled[-1:] &= gok[-1:]
        rect_overflow_cells = torch.where(
            handled,
            w_rect * h_rect - torch.clamp(w_rect, max=hi_side) * torch.clamp(h_rect, max=hi_side),
            rect_overflow_cells,
        )
        return rect_overflow_cells, handled

    lo = side
    mid_handled = None
    if mid_cap > 0 and mid_side > side:
        sel = proj.mask & ((w_rect > side) | (h_rect > side))
        rect_overflow_cells, mid_handled = extra_tier(sel, mid_cap, side, mid_side, rect_overflow_cells)
        lo = mid_side
    if giant_cap > 0:
        sel = proj.mask & ((w_rect > lo) | (h_rect > lo))
        if mid_handled is not None:
            # a giant the mid tier's cap dropped misses its [side, mid_side)
            # ring; leave it to the overflow count
            sel &= mid_handled
        rect_overflow_cells, _ = extra_tier(sel, giant_cap, lo, giant_side, rect_overflow_cells)

    gid_sorted, starts, count = _sort_instances(proj.depth, torch.cat(tile_id), torch.cat(gid), T)

    s = torch.arange(max_per_tile, dtype=torch.int32, device=dev)[None, :]
    valid = s < torch.clamp(count, max=max_per_tile)[:, None]
    gid_pad = torch.nn.functional.pad(gid_sorted, (0, max_per_tile))
    idx = torch.where(valid, _extract_windows(gid_pad, starts, max_per_tile), 0)
    return TileBins(
        idx=idx, valid=valid, count=count, tiles_x=tx_n, tiles_y=ty_n,
        overflow=torch.sum(rect_overflow_cells).to(torch.int32),
        starts=starts, gid_sorted=gid_sorted,
    )


def bin_gaussians_runs(
    proj: Projected,
    width: int,
    height: int,
    max_per_tile: int = 1024,
    tile: int = TILE,
    max_tiles_per_gaussian: int = 16,
    max_instances: int | None = None,
    chunk: int = 128,
) -> TileBins:
    """The (tile, depth, gid) instance sort of the side x side rect windows
    (no tiers, no opacity cull), laid out as aligned runs: each tile's run
    starts at a ``chunk``-aligned slot of one flat (M2,) array, M2 sized for
    ``max_instances`` (default 4 N) instances plus a chunk of alignment per
    tile plus the spare block. Slots past a tile's min(count, max_per_tile)
    hold the sentinel id N. ``overflow_budget`` counts the aligned slots the
    array could not hold; ``overflow`` the rect cells past side x side.

    The reference takes the counts from an f32 matmul of interval
    indicators; here they are the sorted instances per tile, as integers."""
    tx_n, ty_n = num_tiles(width, height, tile)
    T = tx_n * ty_n
    N = proj.mean2d.shape[0]
    dev = proj.depth.device

    lox, loy, hix, hiy = _rects(proj, tx_n, ty_n, tile)
    w_rect = hix - lox + 1
    h_rect = hiy - loy + 1
    side = max(int(np.ceil(np.sqrt(max_tiles_per_gaussian))), 1)
    K = side * side
    ks = torch.arange(K, dtype=torch.int32, device=dev)
    dx = (ks % side)[:, None]
    dy = (ks // side)[:, None]
    cell_ok = proj.mask[None, :] & (dx < w_rect[None, :]) & (dy < h_rect[None, :])
    tile_id = torch.where(cell_ok, (loy[None, :] + dy) * tx_n + lox[None, :] + dx, T).reshape(-1)
    gid = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(K, N).reshape(-1)
    gid_sorted, starts, count = _sort_instances(proj.depth, tile_id, gid, T)

    blocks = (count + chunk - 1) // chunk
    ends_blk = torch.cumsum(blocks, 0, dtype=torch.int32)
    sblk = ends_blk - blocks
    if max_instances is None:
        max_instances = 4 * N
    # + T * chunk: a run wastes under one chunk of alignment, so the budget
    # stays a count of instances; + chunk: the spare block
    M2 = -(-(max_instances + T * chunk) // chunk) * chunk + chunk

    q = torch.arange(M2, dtype=torch.int32, device=dev)
    starts_pad = sblk * chunk
    # empty tiles share their start with the next tile: the last one wins
    tile_q = torch.searchsorted(starts_pad, q, right=True) - 1
    r = q - starts_pad[tile_q]
    src = (starts[tile_q] + r).to(torch.int64)
    valid = r < torch.clamp(count[tile_q], max=max_per_tile)
    gid_runs = torch.where(valid, gid_sorted[torch.clamp(src, 0, K * N - 1)], N).to(torch.int32)

    rect_overflow = torch.sum(torch.where(proj.mask, torch.clamp(w_rect * h_rect - K, min=0), 0))
    budget_overflow = torch.clamp(ends_blk[-1] * chunk - (M2 - chunk), min=0)
    return TileBins(
        idx=None, valid=None, count=count, tiles_x=tx_n, tiles_y=ty_n,
        overflow=rect_overflow.to(torch.int32),
        runs=RunsInfo(gid=gid_runs, sblk=sblk),
        overflow_budget=budget_overflow.to(torch.int32),
    )


def _mxu_tile_histogram(proj: Projected, lox, hix, loy, hiy, tx_n: int, ty_n: int):
    """True per-tile hit counts of the bbox rects (inclusive bounds) as one
    product of the per-axis interval indicators, counts(ty, tx) = sum_g
    Ly[g, ty] Lx[g, tx], in float32 (0/1 inputs: exact, TF32 or not, below
    2^24); and each tile's exclusive prefix sum. Returns (count, starts)
    (T,) int32."""
    dev = proj.mean2d.device
    txs = torch.arange(tx_n, dtype=torch.int32, device=dev)[None, :]
    tys = torch.arange(ty_n, dtype=torch.int32, device=dev)[None, :]
    m = proj.mask[:, None]
    Lx = (m & (txs >= lox[:, None]) & (txs <= hix[:, None])).to(torch.float32)
    Ly = (m & (tys >= loy[:, None]) & (tys <= hiy[:, None])).to(torch.float32)
    count = (Ly.t() @ Lx).reshape(-1).to(torch.int32)
    starts = torch.cumsum(count, 0, dtype=torch.int32) - count
    return count, starts


def _inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def bin_gaussians_sorted2(
    proj: Projected,
    width: int,
    height: int,
    max_per_tile: int = 1024,
    tile: int = TILE,
    max_tiles_per_gaussian: int = 16,
) -> TileBins:
    """Padded binning on one packed key: the Gaussians are depth-ordered
    once (masked ones last), then each emits the cells of a side x side
    window at its rect's corner (side = ceil(sqrt(max_tiles_per_gaussian)),
    K = side^2), keyed (tile, depth rank, cell) in one integer, so the
    instance sort carries no payload. Counts come from the histogram of the
    whole rects. ``overflow`` counts the rect cells past K."""
    tx_n, ty_n = num_tiles(width, height, tile)
    T = tx_n * ty_n
    N = proj.mean2d.shape[0]
    dev = proj.depth.device

    lox, loy, hix, hiy = _rects(proj, tx_n, ty_n, tile)
    count, starts = _mxu_tile_histogram(proj, lox, hix, loy, hiy, tx_n, ty_n)

    order = _depth_rank_order(proj.depth, proj.mask)
    lox_d, loy_d = lox[order], loy[order]
    w_d = (hix - lox + 1)[order]
    h_d = (hiy - loy + 1)[order]
    mask_d = proj.mask[order]

    side = max(int(np.ceil(np.sqrt(max_tiles_per_gaussian))), 1)
    K = side * side
    NK = N * K
    kdt = torch.int64 if (T + 1) * NK >= 2**31 else torch.int32
    ks = torch.arange(K, dtype=kdt, device=dev)
    dx = (ks % side)[:, None]
    dy = (ks // side)[:, None]
    cell_ok = mask_d[None, :] & (dx < w_d[None, :]) & (dy < h_d[None, :])
    tile_id = torch.where(cell_ok, (loy_d[None, :] + dy) * tx_n + lox_d[None, :] + dx, T).to(kdt)  # (K, N)
    drank = torch.arange(N, dtype=kdt, device=dev)[None, :]
    key_sorted = torch.sort(((tile_id * N + drank) * K + ks[:, None]).reshape(-1)).values
    j = key_sorted % NK  # drank * K + k per sorted slot
    drank_sorted = (j // K).to(torch.int64)
    grid_flat_sorted = (j % K) * N + drank_sorted  # k * N + drank

    s = torch.arange(max_per_tile, dtype=torch.int32, device=dev)[None, :]
    valid = s < torch.clamp(count, max=max_per_tile)[:, None]
    drank_win = _extract_windows(torch.nn.functional.pad(drank_sorted, (0, max_per_tile)), starts, max_per_tile)
    grid_win = _extract_windows(torch.nn.functional.pad(grid_flat_sorted, (0, max_per_tile), value=NK),
                                starts, max_per_tile)
    drank_win = torch.where(valid, drank_win, 0)
    grid_win = torch.where(valid, grid_win, NK)  # the sentinel row, dropped by the backward
    rect_overflow = torch.sum(torch.where(proj.mask, torch.clamp((hix - lox + 1) * (hiy - loy + 1) - K, min=0), 0))
    return TileBins(
        idx=order[drank_win], valid=valid, count=count, tiles_x=tx_n, tiles_y=ty_n,
        overflow=rect_overflow.to(torch.int32),
        grid=GridInfo(order=order, invorder=_inverse_permutation(order), drank_win=drank_win, grid_win=grid_win),
    )


def bin_gaussians_compact(
    proj: Projected,
    width: int,
    height: int,
    max_per_tile: int = 1024,
    tile: int = TILE,
    max_instances: int | None = None,
) -> TileBins:
    """Compact binning: one slot per bbox cell of every Gaussian (no
    per-Gaussian tile cap) within one global budget of M slots
    (``max_instances``, default 4 N, rounded up to 128). The Gaussians are
    depth-ordered once; their slot runs are laid out by a cumsum of run
    starts; one sort of the key tile * M + slot groups the slots by tile in
    depth order. Counts come from the histogram. ``overflow`` counts the
    cells past the budget (``render_auto`` doubles ``max_instances`` on
    it)."""
    tx_n, ty_n = num_tiles(width, height, tile)
    T = tx_n * ty_n
    N = proj.mean2d.shape[0]
    dev = proj.depth.device
    M = max_instances if max_instances is not None else 4 * N
    M = max(-(-M // 128) * 128, 128)

    lox, loy, hix, hiy = _rects(proj, tx_n, ty_n, tile)
    count, starts = _mxu_tile_histogram(proj, lox, hix, loy, hiy, tx_n, ty_n)

    order = _depth_rank_order(proj.depth, proj.mask)
    lox_d, loy_d = lox[order], loy[order]
    w_d = (hix - lox + 1)[order]
    cnt = torch.where(proj.mask[order], w_d * (hiy - loy + 1)[order], 0).to(torch.int32)
    ends = torch.cumsum(cnt, 0, dtype=torch.int64)
    offsets = ends - cnt
    total = ends[-1]

    # slot -> depth rank: +1 at every run start, cumsum, -1
    seg = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    seg.index_add_(0, torch.clamp(offsets, max=M), torch.ones_like(offsets))
    grank = torch.clamp(torch.cumsum(seg[:M], 0) - 1, 0, N - 1)
    slot = torch.arange(M, dtype=torch.int64, device=dev)
    valid_slot = slot < torch.clamp(total, max=M)
    k = slot - offsets[grank]
    w_g = torch.clamp(w_d[grank], min=1).to(torch.int64)
    slot_tile = torch.where(valid_slot, (loy_d[grank] + k // w_g) * tx_n + lox_d[grank] + k % w_g, T)

    # one sort: tile in the high part, slot in the low one -> per-tile depth order
    kdt = torch.int64 if (T + 1) * M >= 2**31 else torch.int32
    perm = torch.sort((slot_tile * M + slot).to(kdt)).indices  # the slot at each sorted position
    gid_sorted = order[grank[perm]]
    invperm = _inverse_permutation(perm)

    s = torch.arange(max_per_tile, dtype=torch.int32, device=dev)[None, :]
    valid = s < torch.clamp(count, max=max_per_tile)[:, None]
    win = _extract_windows(torch.nn.functional.pad(gid_sorted, (0, max_per_tile)), starts, max_per_tile)
    return TileBins(
        idx=torch.where(valid, win, 0), valid=valid, count=count, tiles_x=tx_n, tiles_y=ty_n,
        overflow=torch.clamp(total - M, min=0).to(torch.int32),
        compact=CompactInfo(order=order, invorder=_inverse_permutation(order), offsets=offsets, cnt=cnt,
                            slot_tile=slot_tile, invperm=invperm, starts=starts),
    )
