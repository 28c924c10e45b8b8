"""The work the benchmark counts from a step's inputs, on hand-sized cases:
the blend's pairs, hits, rows and least time for a few Gaussians over two
tiles, and the FLOPs of one MLP against PyTorch's own count of the
reference's forward."""
from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline
from portbench.reference import model as RM


def two_tiles():
    """A 64 x 32 frame, two tiles. Tile 0: five broad Gaussians of alpha
    0.95 at every pixel, so each pixel stops at the fourth, where its
    transmittance falls to 6.25e-6. Tile 1: one narrow Gaussian at (40, 10),
    power -(dx^2 + dy^2), whose alpha reaches 1/255 at the 21 pixels with
    dx^2 + dy^2 <= 5."""
    rows = [[5.0, 5.0, 0.0, 0.0, 0.0, 0.95, 0.2, 0.3, 0.4, 2.0 + i] for i in range(5)]
    rows.append([40.0, 10.0, 2.0, 0.0, 2.0, 1.0, 0.5, 0.5, 0.5, 3.0])
    packed = torch.tensor(rows + [[0.0] * 10])  # the padding row
    gid = torch.tensor([0, 1, 2, 3, 4, 5])
    return packed, gid, torch.tensor([0, 5]), torch.tensor([5, 1])


def test_pairs_end_where_the_transmittance_ends_the_walk():
    packed, gid, starts, counts = two_tiles()
    w = roofline.walk(packed, gid, starts, counts, tiles_x=2, width=64, height=32)
    assert w == {"pairs": 4 * 1024 + 1024, "hits": 4 * 1024 + 21, "rows": 4 + 1, "pixels": 2048, "tiles": 2}


def test_bound_is_the_largest_of_bytes_operations_and_sfu():
    packed, gid, starts, counts = two_tiles()
    w = roofline.walk(packed, gid, starts, counts, tiles_x=2, width=64, height=32)
    b = roofline.blend_bounds(w)
    fwd_bytes = 5 * 10 * 4 + 2048 * 5 * 4 + 2 * 4
    ops = 5120 * 16 + 4117 * 13
    sfu = 5120 * 1 + 4117 * 2
    want = max(fwd_bytes / 3.35e12, ops / 33.5e12, sfu / 4.18e12) * 1e3
    assert b["blend_fwd"] == pytest.approx(want, rel=1e-12)
    assert b["blend_bwd"] >= b["blend_fwd"]
    assert roofline.blend_flops(w, backward=False) == ops


def test_mlp_flops_match_pytorchs_count_of_the_reference():
    g = torch.Generator().manual_seed(0)
    d_in, width, depth, n = 63, 256, 8, 17
    dims = roofline.trunk_dims(d_in, width, depth) + [(width, 23)]
    layers = [{"w": torch.randn(o, i, generator=g), "b": torch.randn(o, generator=g)} for i, o in dims]
    p = {"layers": layers[:-1], "head": layers[-1]}
    with FlopCounterMode(display=False) as fc:
        RM.mlp(p, torch.randn(n, d_in, generator=g))
    assert fc.get_total_flops() == n * sum(2 * i * o for i, o in dims)


def test_skeleton_flops_count_both_mlps_per_point():
    cfg = {"skeleton": {"width": 256, "depth": 8, "pose_multires": 8, "weight_multires": 10, "detail_multires": 4}}
    one, two = roofline.skeleton_flops(cfg, 1, 24), roofline.skeleton_flops(cfg, 2, 24)
    per_point = two - one
    weight = sum(2 * i * o for i, o in roofline.trunk_dims(63, 256, 8)) + 2 * 256 * 23
    detail = sum(2 * i * o for i, o in roofline.trunk_dims(27 + 96, 256, 8)) + 2 * 256 * 3
    assert per_point == weight + detail + 2 * 23 * 16
    assert math.isclose(one - per_point, sum(2 * i * o for i, o in roofline.trunk_dims(17, 256, 8)) + 2 * 256 * 99)
