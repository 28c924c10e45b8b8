"""High-level render entry point: Gaussians (+ deformation residuals) -> image.

Port of ``riggs_tpu/render/api.py``: ``render`` with the residuals, SH
colour, override colours, motion-mask rendering, scale_const,
scaling_modifier, the per-attribute stop-gradients (``detach_*``) and
``mean2d_bias``, whose gradient is dL/d(mean2d) for the densification
statistics; ``tier_kwargs``; and ``render_auto``'s capacity escalation of
the window (``max_per_tile``), the rect cap (``max_tiles_per_gaussian``)
and the instance budget (``max_instances``, which the runs binner counts
in ``overflow_budget``); ``render_flow``, the screen-space scene flow as
colours for the optical-flow loss.
"""
from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.camera.camera import Camera, camera_center, project_points
from riggs_tpu_torch.device import constant
from riggs_tpu_torch.models.gaussians import Gaussians
from riggs_tpu_torch.ops.quaternion import quat_multiply, quat_normalize
from riggs_tpu_torch.ops.sh import C0, eval_sh
from riggs_tpu_torch.render import oracle as _oracle
from riggs_tpu_torch.render import tiles as _tiles

C0_F32 = float(np.float32(C0))  # the float32 constant the reference multiplies by


def render(
    cam: Camera,
    gs: Gaussians,
    bg: torch.Tensor,
    d_xyz: torch.Tensor | float = 0.0,
    d_rotation: torch.Tensor | float = 0.0,
    d_scaling: torch.Tensor | float = 0.0,
    d_opacity: torch.Tensor | None = None,
    d_color: torch.Tensor | None = None,
    active_sh_degree: int = 0,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    render_motion: bool = False,
    detach_xyz: bool = False,
    detach_scale: bool = False,
    detach_rot: bool = False,
    detach_opacity: bool = False,
    scale_const: float | None = None,
    d_rotation_bias: torch.Tensor | None = None,
    mean2d_bias: torch.Tensor | None = None,
    rasterizer: str = "tiled",
    max_per_tile: int = 1024,
    max_tiles_per_gaussian: int = 16,
    binning: str | None = None,
    max_instances: int | None = None,
    giant_cap: int | None = None,
    mid_cap: int | None = None,
    mid_side: int | None = None,
    tile_ladder: tuple | None = None,
    tile_shard_mesh=None,
) -> dict[str, Any]:
    with trace.span("riggs.render_prep.setup"):
        means3d = gs.xyz + d_xyz
        if scale_const is not None:
            opacity = torch.ones_like(gs.get_opacity)
        else:
            opacity = gs.get_opacity if d_opacity is None else gs.get_opacity + d_opacity

        scales = gs.get_scaling + d_scaling
        rotations = quat_normalize(gs.rotation + d_rotation)
        if d_rotation_bias is not None:
            rotations = quat_multiply(d_rotation_bias, rotations)

        if render_motion:
            mm = gs.motion_mask
            colors = torch.cat([mm, torch.zeros_like(mm), 1.0 - mm], dim=-1)
        elif override_color is not None:
            colors = override_color
        else:
            feats = gs.get_features
            if d_color is not None:
                feats = torch.cat([feats[:, :1] + d_color[:, None], feats[:, 1:]], dim=1)
            dirs = means3d - camera_center(cam)
            # torch.maximum, not clamp: a tie splits its gradient as jnp.maximum's does
            dirs = dirs / torch.maximum(torch.linalg.norm(dirs, dim=-1, keepdim=True), constant(1e-8, dirs))
            if int(active_sh_degree) == 0:
                # C0 * dc + 0.5 rounded once, as the reference's compiled render
                # evaluates it (a fused multiply-add; the float64 product of two
                # float32 values is exact): a black SH-0 splat (dc = -0.5 / C0,
                # the node Gaussians' initial colour) comes out at -7.4e-9 and
                # stays clamped; a rounded product and sum give exactly 0, a tie
                # of the clamp whose half gradient would train its colour
                colors = (feats[:, 0, :].to(torch.float64) * C0_F32 + 0.5).to(torch.float32)
            else:
                colors = eval_sh(int(active_sh_degree), feats, dirs) + 0.5
            colors = torch.maximum(colors, constant(0.0, dirs))

        # after the colours, as the reference orders it: the SH view direction
        # still carries a gradient to the means under detach_xyz
        if detach_xyz:
            means3d = means3d.detach()
        if detach_rot:
            rotations = rotations.detach()
        if detach_scale:
            scales = scales.detach()
        if detach_opacity:
            opacity = opacity.detach()
        if scale_const is not None:
            scales = scale_const * torch.ones_like(scales)

    if rasterizer == "tiled":
        kwargs = dict(max_per_tile=max_per_tile, max_tiles_per_gaussian=max_tiles_per_gaussian)
        for name, val in (
            ("binning", binning), ("max_instances", max_instances), ("giant_cap", giant_cap),
            ("mid_cap", mid_cap), ("mid_side", mid_side), ("tile_ladder", tile_ladder),
            ("tile_shard_mesh", tile_shard_mesh),
        ):
            if val is not None:
                kwargs[name] = val
        fn = _tiles.rasterize_tiled
    else:
        kwargs = {}
        fn = _oracle.rasterize_oracle
    out = fn(
        cam, means3d, colors, opacity[:, 0], scales, rotations, bg,
        alive=gs.alive, scale_modifier=scaling_modifier, mean2d_bias=mean2d_bias, **kwargs,
    )
    zero = torch.zeros((), dtype=torch.int32, device=means3d.device)
    return {
        "render": out["image"],
        "visibility_filter": out["radii"] > 0,
        "radii": out["radii"],
        "depth": out["depth"],
        "alpha": out["alpha"],
        "bg_color": bg,
        "overflow": out.get("overflow", zero),
        "overflow_tiles": out.get("overflow_tiles", zero),
        "overflow_rect": out.get("overflow_rect", zero),
        "overflow_budget": out.get("overflow_budget", zero),
        "max_count": out.get("max_count", zero),
        # (T,) ladder probe input; the oracle has no tiles
        "tile_counts": out.get("tile_counts", torch.zeros((1,), dtype=torch.int32, device=means3d.device)),
    }


def tier_kwargs(tiers: tuple | None) -> dict:
    """(max_tiles_per_gaussian, mid_cap, mid_side) -> render() kwargs."""
    if tiers is None:
        return {}
    return dict(max_tiles_per_gaussian=tiers[0], mid_cap=tiers[1], mid_side=tiers[2])


def render_auto(
    cam: Camera,
    gs: Gaussians,
    bg: torch.Tensor,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 16,
    max_per_tile_limit: int = 8192,
    max_tiles_limit: int = 1024,
    max_instances: int | None = None,
    max_instances_limit: int = 64 * 1024 * 1024,
    **kwargs,
) -> dict[str, Any]:
    """render() with capacity escalation: re-render with the offending cap
    doubled (the rect cap x4) until nothing is truncated, or warn and return
    the truncated render at the limits. A budget overflow doubles
    ``max_instances`` from ``4 * gs.capacity``, the binner's default; on
    ``binning="compact"`` the rect counter is that budget's overflow and
    escalates it too (the compact binner has no rect cap)."""
    compact = kwargs.get("binning") == "compact"
    while True:
        out = render(
            cam, gs, bg, max_per_tile=max_per_tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian, max_instances=max_instances, **kwargs,
        )
        tiles_of = int(out["overflow_tiles"])
        rect_of = int(out["overflow_rect"])
        budget_of = int(out["overflow_budget"])
        if tiles_of == 0 and rect_of == 0 and budget_of == 0:
            return out
        escalated = False
        if tiles_of > 0 and max_per_tile < max_per_tile_limit:
            max_per_tile = min(max_per_tile * 2, max_per_tile_limit)
            escalated = True
        if budget_of > 0 or (rect_of > 0 and compact):
            cur = max_instances if max_instances is not None else 4 * gs.capacity
            if cur < max_instances_limit:
                max_instances = min(cur * 2, max_instances_limit)
                escalated = True
        if rect_of > 0 and not compact and max_tiles_per_gaussian < max_tiles_limit:
            max_tiles_per_gaussian = min(max_tiles_per_gaussian * 4, max_tiles_limit)
            escalated = True
        if not escalated:
            warnings.warn(
                f"render_auto hit capacity limits (overflow_tiles={tiles_of}, "
                f"overflow_rect={rect_of}); returning truncated render"
            )
            return out


def _ndc_xy(cam: Camera, points: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> NDC xy under ``cam`` (the inverse of the pixel
    viewport map)."""
    pix, _ = project_points(cam, points)
    return (2.0 * pix + 1.0) / constant((float(cam.width), float(cam.height)), pix) - 1.0


def render_flow(
    cam1: Camera,
    cam2: Camera,
    gs: Gaussians,
    d_xyz1: torch.Tensor,
    d_xyz2: torch.Tensor,
    d_rotation1: torch.Tensor | float = 0.0,
    max_per_tile: int = 1024,
) -> dict[str, Any]:
    """The screen-space scene flow rendered as colours: channels 0-1 the NDC
    displacement of each Gaussian from (cam1, d_xyz1) to (cam2, d_xyz2),
    channel 2 its motion mask; composited with the Gaussians placed by
    d_xyz1 under cam1 on a zero background, plain windows of
    ``max_per_tile``. The colours are signed. The displacement's positions
    are detached from ``gs.xyz``. Unlike the reference's, the result carries
    the tiled renderer's ``overflow_tiles`` and ``overflow_rect``, so a
    truncated flow render is seen. (The reference's scaling, scale_const
    and oracle options have no caller and are not ported.)"""
    xyz = gs.xyz.detach()
    flow = torch.cat([_ndc_xy(cam2, xyz + d_xyz2) - _ndc_xy(cam1, xyz + d_xyz1), gs.motion_mask], dim=-1)
    rotations = quat_normalize(gs.rotation + d_rotation1)
    out = _tiles.rasterize_tiled(cam1, gs.xyz + d_xyz1, flow, gs.get_opacity[:, 0], gs.get_scaling, rotations,
                                 constant((0.0, 0.0, 0.0), xyz), alive=gs.alive, max_per_tile=max_per_tile)
    return {
        "render": out["image"],
        "depth": out["depth"],
        "alpha": out["alpha"],
        "radii": out["radii"],
        "visibility_filter": out["radii"] > 0,
        "overflow_tiles": out["overflow_tiles"],
        "overflow_rect": out["overflow_rect"],
    }
