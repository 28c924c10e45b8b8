"""Tiled rasterizer: project, bin, gather per-tile windows, blend, untile.

Port of ``riggs_tpu/render/tiles.py:rasterize_tiled``: the sort binner
(and the dense one), the plain-window blend (``blend.blend_cm``,
``tiles.py:399-437``), the laddered blend (``blend.blend_permuted_gm``,
``tiles.py:294-367``), the aligned-runs binner with its blend
(``blend.blend_runs``, ``tiles.py:368-388``), the compact and sort2
binners on the plain-window blend (``tiles.py:389-393``), the untile step
and the overflow counters. The reference's XLA scan blend (``blend='jnp'``)
has no separate port: the kernels' plain versions take its place on the
CPU.

The result is differentiable in means3d, colors, opacity, scales, rotations
and ``mean2d_bias``: the blends are autograd Functions with backward
kernels. The sort, ladder and runs window gathers (``_gather_windows``) get
their scatter-add backward from autograd, as XLA gave the reference's; the
compact and sort2 gathers are autograd Functions with the reference's
structural backwards (``gather_instances``, ``gather_grid``,
``tiles.py:39-97``).
"""
from __future__ import annotations

import numpy as np
import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.render import blend as _blend
from riggs_tpu_torch.render.binning import (
    TILE,
    CompactInfo,
    GridInfo,
    _extract_windows,
    bin_gaussians,
    bin_gaussians_compact,
    bin_gaussians_runs,
    bin_gaussians_sorted,
    bin_gaussians_sorted2,
)
from riggs_tpu_torch.render.project import build_cov3d_packed, project_gaussians

G_CHUNK = _blend.G_CHUNK


def _round_up(n: int) -> int:
    return -(-n // G_CHUNK) * G_CHUNK


def _gather_windows(packed: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rows ``packed[idx]`` at the valid slots, zeros at the others (idx and
    valid of one shape: (T, MAX) windows or the (M2,) runs).

    The reference gathers every slot, its invalid ones reading row 0. Torch's
    index backward accumulates the duplicates of one row serially, so those
    millions of row-0 reads made the scatter-add most of a training step.
    Here an invalid slot reads row (slot number mod N) instead, which spreads
    its zero gradient over all rows, and is then zeroed: no row has more
    duplicates than the tiles it covers plus a few, and no ``nonzero`` stops
    the host. An invalid slot's zero opacity keeps it out of the plain-window
    blend; the ladder's blend masks rows past the count."""
    spread = torch.arange(valid.numel(), device=idx.device).reshape(valid.shape) % packed.shape[0]
    rows = packed[torch.where(valid, idx, spread)]
    return torch.where(valid[..., None], rows, 0.0)


class _GatherInstances(torch.autograd.Function):
    """``packed[idx]`` (N, D) -> (T, MAX, D) over the compact binner's
    windows. Backward: each Gaussian's instances are one run of slots, so
    each slot reads its window gradient (an inverse-permutation row
    gather), one float32 cumsum runs over the slots, and the differences
    at the run boundaries are the per-Gaussian sums."""

    @staticmethod
    def forward(ctx, packed, idx, compact: CompactInfo):
        ctx.compact = compact
        return packed[idx.to(torch.int64)]

    @staticmethod
    def backward(ctx, dg):
        c = ctx.compact
        T, MAX, D = dg.shape
        t = c.slot_tile
        tc = torch.clamp(t, 0, T - 1)
        s = c.invperm - c.starts[tc].to(torch.int64)
        ok = (t < T) & (s < MAX)
        row = torch.where(ok, tc * MAX + torch.clamp(s, 0, MAX - 1), 0)
        rows = torch.where(ok[:, None], dg.reshape(T * MAX, D)[row], 0.0)  # (M, D)
        csz = torch.nn.functional.pad(torch.cumsum(rows.to(torch.float32), 0), (0, 0, 1, 0))
        M = rows.shape[0]
        # runs past the budget end at its last slot, as XLA clamps the gather
        ends = torch.clamp(c.offsets + c.cnt, max=M)
        per_g = csz[ends] - csz[torch.clamp(c.offsets, max=M)]  # (N, D) depth order
        return per_g[c.invorder], None, None


class _GatherGrid(torch.autograd.Function):
    """``packed[order][drank_win]`` (N, D) -> (T, MAX, D) over the sort2
    binner's windows. Backward: every window slot is its own (k, drank)
    cell of the padded grid, so the window gradients are written (not
    added) to their cells, invalid slots to a sentinel row that is dropped,
    and the cells summed over K."""

    @staticmethod
    def forward(ctx, packed, grid: GridInfo, k: int):
        ctx.grid, ctx.k = grid, k
        return packed[grid.order][grid.drank_win]

    @staticmethod
    def backward(ctx, dg):
        grid, k = ctx.grid, ctx.k
        T, MAX, D = dg.shape
        N = grid.order.shape[0]
        dcells = torch.zeros((N * k + 1, D), dtype=torch.float32, device=dg.device)
        dcells[grid.grid_win.reshape(-1)] = dg.reshape(T * MAX, D).to(torch.float32)
        per_g = dcells[: N * k].reshape(k, N, D).sum(0)  # depth order
        return per_g[grid.invorder], None, None


def gather_instances(packed: torch.Tensor, idx: torch.Tensor, compact: CompactInfo) -> torch.Tensor:
    """(N, D) packed rows -> (T, MAX, D) compact-binner windows, with the
    segment-sum backward."""
    return _GatherInstances.apply(packed, idx, compact)


def gather_grid(packed: torch.Tensor, grid: GridInfo, k: int) -> torch.Tensor:
    """(N, D) packed rows -> (T, MAX, D) sort2 windows, with the
    cell-scatter backward; ``k`` the padded cells per Gaussian."""
    return _GatherGrid.apply(packed, grid, k)


def _blend_plain_windows(gp: torch.Tensor, counts: torch.Tensor, tiles_x: int, mesh) -> torch.Tensor:
    """``blend.blend_cm``'s out, its tiles split over ``mesh``'s tile group
    when a mesh is given (``blend.sharded_blend``)."""
    if mesh is None:
        return _blend.blend_cm(gp, counts, tiles_x)[0]
    return _blend.sharded_blend(mesh, gp, counts, tiles_x)


def rasterize_tiled(
    cam: Camera,
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    bg: torch.Tensor,
    alive: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    cov3d: torch.Tensor | None = None,
    max_per_tile: int = 1024,
    mean2d_bias: torch.Tensor | None = None,
    binning: str = "sort",
    max_tiles_per_gaussian: int = 16,
    max_instances: int | None = None,
    giant_cap: int = 256,
    giant_side: int = 12,
    mid_cap: int = 0,
    mid_side: int = 4,
    tile_ladder: tuple | None = None,
    tile_shard_mesh=None,
) -> dict:
    """Render one view. colors (N, 3) RGB; opacity (N,) activated.

    binning='sort' is the (tile, depth, gid) sort binner; 'runs' the same
    sort laid out as aligned runs under an instance budget
    ``max_instances`` (default 4 N); 'compact' one slot per bbox cell under
    such a budget (no per-Gaussian tile cap; its ``overflow_rect`` counts
    the cells past the budget); 'sort2' the depth-presorted padded binner;
    'dense' the exact dense-mask reference.
    ``tile_ladder`` ((n_tiles, cap), ...) gives the count-sorted tiles
    rank-dependent window capacities (render/ladder.py; sort binner only).
    ``tile_shard_mesh`` (a ``parallel.mesh.Mesh``) splits the plain-window
    blend's tiles over the mesh's tile group, each rank blending its slice
    with the blend's offset entry (``tiles.py:409-432``); it does not
    compose with the ladder or the runs binner.
    Returns image (H, W, 3), depth, alpha, radii, proj, the overflow
    counters (``overflow_budget`` 0 but on the runs path) and the true
    per-tile hit counts.
    """
    if tile_shard_mesh is not None and (tile_ladder is not None or binning == "runs"):
        raise ValueError("tile_shard_mesh composes with the plain-window blend only")
    if binning not in ("sort", "runs", "compact", "sort2", "dense"):
        raise ValueError(f"unknown binning {binning!r}")
    if tile_ladder is not None and binning != "sort":
        raise ValueError("tile_ladder requires binning='sort'")

    with trace.span("riggs.render_prep.setup"):
        if cov3d is None:
            cov3d = build_cov3d_packed(scales, rotations, scale_modifier)
        max_per_tile = _round_up(max_per_tile)
        proj = project_gaussians(cam, means3d, cov3d, alive, mean2d_bias)
        op_masked = torch.where(proj.mask, opacity, 0.0)
    with trace.span("riggs.render_prep.bin"):
        if binning == "sort":
            bins = bin_gaussians_sorted(
                proj, cam.width, cam.height, max_per_tile=max_per_tile,
                max_tiles_per_gaussian=max_tiles_per_gaussian,
                opacity=op_masked.detach(), giant_cap=giant_cap, giant_side=giant_side,
                mid_cap=mid_cap, mid_side=mid_side,
            )
        elif binning == "runs":
            bins = bin_gaussians_runs(
                proj, cam.width, cam.height, max_per_tile=max_per_tile,
                max_tiles_per_gaussian=max_tiles_per_gaussian, max_instances=max_instances,
            )
        elif binning == "compact":
            bins = bin_gaussians_compact(proj, cam.width, cam.height, max_per_tile=max_per_tile,
                                         max_instances=max_instances)
        elif binning == "sort2":
            bins = bin_gaussians_sorted2(proj, cam.width, cam.height, max_per_tile=max_per_tile,
                                         max_tiles_per_gaussian=max_tiles_per_gaussian)
        else:
            bins = bin_gaussians(proj, cam.width, cam.height, max_per_tile=max_per_tile)

    with trace.span("riggs.render_prep.windows"):
        # one packed row per Gaussian: [mean2d, conic, opacity, rgb, depth]
        packed = torch.cat(
            [proj.mean2d, proj.conic, op_masked[:, None], colors, proj.depth[:, None]], dim=-1
        )  # (N, 10)
        T = bins.tiles_x * bins.tiles_y
        if tile_ladder is not None:
            if sum(n for n, _ in tile_ladder) != T:
                raise ValueError(f"tile_ladder bucket sizes must sum to the tile count {T}: {tile_ladder}")
            ordr = torch.argsort(-bins.count, stable=True)
            inv = torch.argsort(ordr)
            cap_max = max(_round_up(cap) for _, cap in tile_ladder)
            gid_pad = torch.nn.functional.pad(bins.gid_sorted, (0, cap_max))
            outs = []
            ladder_overflow = torch.zeros((), dtype=torch.int64, device=packed.device)
            r0 = 0
            for nb, cap in tile_ladder:
                tids_b = ordr[r0 : r0 + nb]
                counts_b = bins.count[tids_b]
                r0 += nb
                if cap == 0:
                    # empty-tile bucket: background only; any count is truncation
                    outs.append(torch.zeros((nb, 8, TILE * TILE), dtype=torch.float32, device=packed.device))
                    ladder_overflow += torch.sum(counts_b)
                    continue
                cap = _round_up(cap)
                win = _extract_windows(gid_pad, bins.starts[tids_b], cap)
                valid = torch.arange(cap, device=win.device)[None, :] < torch.clamp(counts_b, max=cap)[:, None]
                g_b = _gather_windows(packed, win, valid)  # (nb, cap, 10)
                out_b, _ = _blend.blend_permuted_gm(
                    g_b, torch.clamp(counts_b, max=cap).to(torch.int32),
                    tids_b.to(torch.int32), bins.tiles_x,
                )
                outs.append(out_b)
                ladder_overflow += torch.sum(torch.clamp(counts_b - cap, min=0))
            out = torch.cat(outs, dim=0)[inv]  # (T, 8, P) back in tile order
            overflow_tiles = ladder_overflow
        else:
            counts = torch.clamp(bins.count, max=max_per_tile).to(torch.int32)
            overflow_tiles = torch.sum(torch.clamp(bins.count - max_per_tile, min=0))
            if bins.runs is not None:
                # one row per aligned slot; the sentinel slots (id N) are zero rows
                attrs = _gather_windows(packed, bins.runs.gid, bins.runs.gid < packed.shape[0])  # (M2, 10)
                g_runs = torch.nn.functional.pad(attrs, (0, _blend.PACK_ROWS - attrs.shape[-1])).t().contiguous()
                out, _ = _blend.blend_runs(g_runs, counts, bins.runs.sblk, max_per_tile // G_CHUNK, bins.tiles_x)
            elif bins.compact is not None or bins.grid is not None:
                if bins.compact is not None:
                    g = gather_instances(packed, bins.idx, bins.compact)
                else:
                    side = max(int(np.ceil(np.sqrt(max_tiles_per_gaussian))), 1)
                    g = gather_grid(packed, bins.grid, side * side)
                # invalid slots read row 0; their opacity is masked, as the reference masks it
                g = torch.cat([g[..., :5], torch.where(bins.valid, g[..., 5], 0.0)[..., None], g[..., 6:]], dim=-1)
                gp = torch.nn.functional.pad(g, (0, _blend.PACK_ROWS - g.shape[-1])).transpose(1, 2).contiguous()
                out = _blend_plain_windows(gp, counts, bins.tiles_x, tile_shard_mesh)
            else:
                # invalid slots are all zero, their opacity included: the
                # reference's opacity mask (tiles.py:402) is the gather's zeros here
                g = _gather_windows(packed, bins.idx, bins.valid)  # (T, MAX, 10)
                gp = torch.nn.functional.pad(g, (0, _blend.PACK_ROWS - g.shape[-1]))
                gp = gp.transpose(1, 2).contiguous()  # (T, 16, MAX)
                out = _blend_plain_windows(gp, counts, bins.tiles_x, tile_shard_mesh)

        rgb = out[:, 0:3, :].transpose(1, 2)  # (T, P, 3)
        dep = out[:, 3, :]
        acc = out[:, 4, :]

        H, W = cam.height, cam.width
        Hp, Wp = bins.tiles_y * TILE, bins.tiles_x * TILE

        def untile(a):
            c = a.shape[-1] if a.dim() == 3 else 1
            a = a.reshape(bins.tiles_y, bins.tiles_x, TILE, TILE, c)
            return a.permute(0, 2, 1, 3, 4).reshape(Hp, Wp, c)[:H, :W]

        image = untile(rgb) + (1.0 - untile(acc[..., None])) * bg
        overflow_rect = bins.overflow
        overflow_tiles = overflow_tiles.to(torch.int32)
        overflow_budget = bins.overflow_budget
        if overflow_budget is None:
            overflow_budget = torch.zeros((), dtype=torch.int32, device=overflow_rect.device)
        return dict(
            image=image,
            depth=untile(dep[..., None])[..., 0],
            alpha=untile(acc[..., None])[..., 0],
            radii=proj.radius,
            proj=proj,
            overflow=overflow_tiles + overflow_rect + overflow_budget,
            overflow_tiles=overflow_tiles,
            overflow_rect=overflow_rect,
            overflow_budget=overflow_budget,
            max_count=torch.max(bins.count),
            tile_counts=bins.count,  # (T,) true hit counts: the ladder's probe input
        )
