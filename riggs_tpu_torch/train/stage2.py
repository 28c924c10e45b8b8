"""Held-out stage-2 render with capacity escalation.

Port of ``riggs_tpu/train/stage2.py:_eval_image`` and ``eval_image``; the
stage-2 training step comes with the training slice.

``eval_image`` always ends. The reference loops forever on a persistent
``overflow_rect`` while ``tiers`` is set (the tiers tuple overrides the
escalated ``max_tiles_per_gaussian``), and on a persistent ``overflow_tiles``
once ``max_per_tile`` is at its limit. Here a rect overflow under tiers drops
the tiers, and a render that cannot escalate further is returned with a
warning.
"""
from __future__ import annotations

import warnings

import torch

from riggs_tpu_torch.models import skeleton_warp as SW
from riggs_tpu_torch.render.api import render, tier_kwargs

MAX_PER_TILE_LIMIT = 8192
MAX_TILES_LIMIT = 1024


@torch.no_grad()
def _eval_image(gs, skel, cam, t, bg, max_per_tile=512, max_tiles_per_gaussian=16,
                tile_ladder=None, tiers=None):
    """One skeleton_forward + render; returns (image, overflow_tiles,
    overflow_rect, max_count)."""
    d = SW.skeleton_forward(skel, gs.xyz, t, gs.motion_mask)
    kw = dict(max_tiles_per_gaussian=max_tiles_per_gaussian) if tiers is None else tier_kwargs(tiers)
    out = render(
        cam, gs, bg,
        d_xyz=d["d_xyz"],
        d_rotation=d["d_rotation"],
        d_scaling=torch.zeros_like(d["d_scaling"]),
        active_sh_degree=gs.max_sh_degree,
        max_per_tile=max_per_tile,
        tile_ladder=tile_ladder,
        **kw,
    )
    return out["render"], out["overflow_tiles"], out["overflow_rect"], out["max_count"]


def eval_image(gs, skel, cam, t, bg, max_per_tile=512, max_tiles_per_gaussian=16,
               tile_ladder=None, tiers=None):
    """Held-out render, re-rendered with the offending cap raised until
    nothing is truncated: a truncating ladder is dropped; tile overflow jumps
    the window to the observed max count; rect overflow drops the tiers, then
    quadruples the rect cap."""
    while True:
        img, of_t, of_r, max_count = _eval_image(
            gs, skel, cam, t, bg, max_per_tile, max_tiles_per_gaussian,
            tile_ladder=tile_ladder, tiers=tiers,
        )
        of_t, of_r = int(of_t), int(of_r)
        if of_t == 0 and of_r == 0:
            return img
        if tile_ladder is not None:
            tile_ladder = None
            continue
        escalated = False
        if of_t > 0 and max_per_tile < MAX_PER_TILE_LIMIT:
            need = -(-int(max_count) // 128) * 128
            max_per_tile = min(max(need, max_per_tile * 2), MAX_PER_TILE_LIMIT)
            escalated = True
        if of_r > 0:
            if tiers is not None:
                tiers = None
                escalated = True
            elif max_tiles_per_gaussian < MAX_TILES_LIMIT:
                max_tiles_per_gaussian = min(max_tiles_per_gaussian * 4, MAX_TILES_LIMIT)
                escalated = True
        if not escalated:
            warnings.warn(
                f"eval_image hit capacity limits (overflow_tiles={of_t}, "
                f"overflow_rect={of_r}); returning truncated render"
            )
            return img
