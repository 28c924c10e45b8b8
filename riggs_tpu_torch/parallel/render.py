"""Tile-parallel (pixel-sharded) rendering: one frame across a tile group.

Port of ``riggs_tpu/parallel/render.py``. The Gaussians stay replicated;
projection, binning and the packed window gather run on every rank of the
tile group, and each rank blends its contiguous slice of the tiles through
the blend's offset entry (``rasterize_tiled`` with a ``tile_shard_mesh``,
which calls ``render.blend.sharded_blend``, the port of
``pallas_blend_offset`` under ``shard_map``). The shards' outputs are
gathered over the group, so every rank holds the whole image, and every
rank gets the single-device gradient with no all-reduce (see
``sharded_blend``).
"""
from __future__ import annotations

import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.parallel.mesh import Mesh
from riggs_tpu_torch.render.tiles import rasterize_tiled


def rasterize_tile_sharded(
    mesh: Mesh,
    cam: Camera,
    means3d: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    bg: torch.Tensor,
    alive: torch.Tensor | None = None,
    max_per_tile: int = 1024,
) -> dict:
    """One frame with its tiles blended across the mesh's tile group: the
    sort binner, plain windows (``max_per_tile`` rounded up to 128).
    Returns image, depth, alpha, radii and overflow (the window's and the
    rect cap's).

    It is ``rasterize_tiled(..., tile_shard_mesh=mesh)``, so the frame is
    the single-device one bit for bit. The reference's version bins without
    the opacity cull that its ``rasterize_tiled`` and the port's apply (a
    Gaussian's tile cells where no pixel reaches alpha 1/255 are dropped):
    those instances blend exact zeros, and only the chunk boundaries, so
    the last bits of the sums, move."""
    out = rasterize_tiled(cam, means3d, colors, opacity, scales, rotations, bg, alive=alive,
                          max_per_tile=max_per_tile, tile_shard_mesh=mesh)
    return {k: out[k] for k in ("image", "depth", "alpha", "radii", "overflow")}
