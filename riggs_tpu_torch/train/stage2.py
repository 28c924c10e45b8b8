"""Stage-2 (rigged) training step and held-out render.

Port of ``riggs_tpu/train/stage2.py``: ``Stage2State``,
``sample_skeleton_points``, ``stage2_frame_loss`` (photometric + template
offsets + robust 2D-skeleton chamfer + template-fixed pose loss, or the
warmup distillation toward the stage-1 deformations), ``stage2_step`` (value
and gradient, Adam on the skeleton and, outside warmup, on the Gaussians,
densification statistics), ``stage2_flags`` (the staged flags and lambdas
of an iteration) and ``make_stage2_auto`` (every schedule derived from
the caller's iteration count); ``_eval_image`` and ``eval_image``. The training loop
(``train_stage2``) needs the stage-1 slice and comes with it.

The staged flags (``warm``, ``enable_to``, ``enable_sm``, ``use_chamfer``,
``active_sh``) are host values: eager PyTorch has no compiled program whose
recompilation the reference's traced 0/1 weights avoid. A python ``False``
keeps an optional MLP out of the graph, where the reference keeps it in at
weight 0; both give its parameters a zero gradient.

The skeleton's parameters are its ``nn.Module``'s own and are updated in
place (``SkeletonWarp.replace_params``): a step consumes the state it is
given, whose ``skel`` the returned state shares.

``eval_image`` always ends. The reference loops forever on a persistent
``overflow_rect`` while ``tiers`` is set (the tiers tuple overrides the
escalated ``max_tiles_per_gaussian``), and on a persistent ``overflow_tiles``
once ``max_per_tile`` is at its limit. Here a rect overflow under tiers drops
the tiers, and a render that cannot escalate further is returned with a
warning.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch
from torch.profiler import record_function

from riggs_tpu_torch.camera.camera import project_nodes_2d
from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.device import constant, static_index
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.models import skeleton_warp as SW
from riggs_tpu_torch.ops.knn import chamfer_distance
from riggs_tpu_torch.render.api import render, tier_kwargs
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config

MAX_PER_TILE_LIMIT = 8192
MAX_TILES_LIMIT = 1024


@dataclasses.dataclass
class Stage2State:
    gs: G.Gaussians
    skel: SW.SkeletonWarp
    opt_gs: O.AdamState
    opt_skel: O.AdamState
    stats_gs: G.DensifyStats
    proj_loss: torch.Tensor  # (F,) per-frame chamfer history for the robust weights
    it: torch.Tensor  # () int32 iteration counter; stage2_step increments it


def sample_skeleton_points(joints: torch.Tensor, parents, samples_per_bone: int = 8) -> torch.Tensor:
    """``samples_per_bone`` points along every bone (parent to child joint)
    for the 2D-projection chamfer."""
    a = joints[static_index(tuple(int(p) for p in parents[1:]), joints.device)]
    b = joints[1:]
    t = torch.linspace(0.0, 1.0, samples_per_bone, device=joints.device)[:, None, None]
    pts = (1.0 - t) * a[None] + t * b[None]
    return pts.reshape(-1, 3)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even-length
    input (``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


def stage2_frame_loss(
    params: dict,
    state: Stage2State,
    frame: Frame,
    uid: int,
    bg: torch.Tensor,
    mean2d_bias: torch.Tensor,
    pre_d_xyz: torch.Tensor,
    pre_d_joints: torch.Tensor,
    lambda_template_offsets: float,
    lambda_template_fixed: float,
    lambda_chamfer: float = 1e-3,
    lambda_rendering: float = 1.0,
    warm: bool = False,
    active_sh: int = 0,
    enable_to: bool = False,
    enable_sm: bool = False,
    use_chamfer: bool = True,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_ladder: tuple | None = None,
    tiers: tuple | None = None,
):
    """The per-frame stage-2 loss. ``params`` is ``{"gs": ..., "skel": ...}``
    in the ``params_dict`` trees (``params["skel"]`` is written into
    ``state.skel`` unless it holds the module's own parameters). Returns
    (loss, (render output, aux losses, deformation))."""
    gs = state.gs.replace_params(params["gs"])
    skel = state.skel.replace_params(params["skel"])
    d = SW.skeleton_forward(
        skel, gs.xyz.detach(), frame.fid, gs.motion_mask,
        enable_template_offsets=enable_to, enable_skinning_mlp=enable_sm,
    )
    d_xyz, d_rot = d["d_xyz"], d["d_rotation"]
    d_scaling = torch.zeros_like(d["d_scaling"])
    if isotropic:
        d_rot = torch.zeros_like(d_rot)
    loss = torch.zeros((), device=gs.device)
    aux = {}
    if state.skel.net.use_template_offsets:
        # a disabled detail net gives exactly zero offsets, so the term vanishes
        to_loss = torch.mean(d["template_offsets"] ** 2)
        loss = loss + lambda_template_offsets * to_loss
        aux["template_offsets_loss"] = to_loss
    if frame.thinned is not None:
        pts = sample_skeleton_points(d["d_nodes"], state.skel.net.parents)
        proj = project_nodes_2d(frame.cam, pts)
        cd = chamfer_distance(proj, frame.thinned, y_mask=frame.thinned_mask, norm=1)
        # robust per-frame weight from the running loss buffer
        sigma = _median(state.proj_loss) / 2.0
        w = torch.exp(-state.proj_loss[uid] ** 2 / (2.0 * sigma**2))
        loss = loss + lambda_chamfer * float(use_chamfer) * w * cd
        aux["chamfer"] = cd
    # template-fixed pose loss (identity local rotation on the template frame)
    tf_loss = torch.mean((d["local_rotation"] - constant(SW.ROT_BIAS, d["local_rotation"])) ** 2)
    loss = loss + lambda_template_fixed * tf_loss

    out = render(
        frame.cam, gs, bg,
        d_xyz=d_xyz, d_rotation=d_rot, d_scaling=d_scaling,
        active_sh_degree=active_sh, mean2d_bias=mean2d_bias, max_per_tile=max_per_tile,
        tile_ladder=tile_ladder, **tier_kwargs(tiers),
    )
    # warmup distils toward the precomputed stage-1 deformation, the main
    # phase trains photometric (both terms are computed, one weighted 0)
    w_warm = float(warm)
    aux["d_xyz_loss"] = L.l2_loss(d_xyz, pre_d_xyz)
    aux["d_node_loss"] = L.l2_loss(d["d_nodes"], pre_d_joints)
    img_loss = L.photometric_loss(out["render"], frame.image, lambda_dssim)
    aux["img_loss"] = img_loss
    loss = loss + w_warm * (aux["d_xyz_loss"] + aux["d_node_loss"])
    loss = loss + (1.0 - w_warm) * lambda_rendering * img_loss
    return loss, (out, aux, d)


def stage2_step(
    state: Stage2State,
    frame: Frame,
    uid: int,
    bg: torch.Tensor,
    lrs_gs: dict,
    lrs_skel: Any,
    pre_d_xyz: torch.Tensor,
    pre_d_joints: torch.Tensor,
    lambda_template_offsets: float,
    lambda_template_fixed: float,
    lambda_chamfer: float = 1e-3,
    lambda_rendering: float = 1.0,
    warm: bool = False,
    active_sh: int = 0,
    enable_to: bool = False,
    enable_sm: bool = False,
    use_chamfer: bool = True,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_ladder: tuple | None = None,
    tiers: tuple | None = None,
):
    """One stage-2 step: value and gradient of ``stage2_frame_loss`` in the
    Gaussians, the skeleton and ``mean2d_bias``; Adam on the skeleton always
    and on the Gaussians outside warmup (in warmup their parameters and
    moments stay as they are); the densification statistics; the frame's
    chamfer in ``proj_loss``. Returns (new state, metrics)."""
    gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
    params = {"gs": gs_p, "skel": state.skel.params_dict()}
    m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
    # the three parts of a step, named for the profiler (chip_smoke.py reads them)
    with record_function("stage2_step.forward"):
        loss, (out, aux, d) = stage2_frame_loss(
            params, state, frame, uid, bg, m2b, pre_d_xyz, pre_d_joints,
            lambda_template_offsets, lambda_template_fixed,
            lambda_chamfer=lambda_chamfer, lambda_rendering=lambda_rendering,
            warm=warm, active_sh=active_sh, enable_to=enable_to, enable_sm=enable_sm,
            use_chamfer=use_chamfer, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
            isotropic=isotropic, tile_ladder=tile_ladder, tiers=tiers,
        )
    with record_function("stage2_step.backward"):
        gp, gm2b = O.grad_tree(loss, (params, m2b))
    with record_function("stage2_step.update"), torch.no_grad():
        new_skel_p, opt_skel = O.adam_update(gp["skel"], state.opt_skel, params["skel"], lrs_skel)
        if warm:
            gs, opt_gs = state.gs, state.opt_gs
        else:
            new_gs_p, opt_gs = O.adam_update(gp["gs"], state.opt_gs, gs_p, lrs_gs)
            gs = state.gs.replace_params(new_gs_p)
        stats = G.add_densification_stats(
            state.stats_gs, gm2b, out["radii"], out["visibility_filter"],
            frame.cam.width, frame.cam.height,
        )
        proj_loss = state.proj_loss
        if "chamfer" in aux:
            proj_loss = proj_loss.clone()
            proj_loss[uid] = aux["chamfer"]
        metrics = {"loss": loss.detach(), "psnr": L.psnr(out["render"], frame.image), "n_gs": state.gs.num_alive}
        metrics.update({k: v.detach() for k, v in aux.items()})
    new_state = Stage2State(
        gs=gs,
        skel=state.skel.replace_params(new_skel_p),
        opt_gs=opt_gs,
        opt_skel=opt_skel,
        stats_gs=stats,
        proj_loss=proj_loss,
        it=state.it + 1,
    )
    # ladder policy inputs: true per-tile hit counts and truncation counters
    metrics["overflow_tiles"] = out["overflow_tiles"]
    metrics["overflow_rect"] = out["overflow_rect"]
    metrics["tile_counts"] = out["tile_counts"]
    return new_state, metrics


def stage2_flags(cfg: Config, it: int, uid: int, template_idx: int) -> dict:
    """The staged flags and lambdas of iteration ``it`` for frame ``uid``, as
    ``make_stage2_auto`` derives them (keyword arguments of
    ``stage2_frame_loss`` and ``stage2_step``): the skeleton warmup, the
    unlock of the template offsets and the skinning MLP (where the model has
    them), the SH degree, the template-frame lambdas (x1e3 template offsets,
    the template-fixed loss) and the render tiers."""
    o, m, pipe = cfg.opt, cfg.model, cfg.pipe
    is_t = uid == template_idx
    return dict(
        lambda_template_offsets=o.lambda_template_offsets * (1e3 if is_t else 1.0),
        lambda_template_fixed=o.lambda_template_fixed if is_t else 0.0,
        lambda_chamfer=o.lambda_deformed_node_prjection,
        lambda_rendering=o.lambda_rendering_image,
        warm=it < o.skeleton_warm_up,
        active_sh=min(it // o.oneupSHdegree_step, m.sh_degree),
        enable_to=it >= o.optimize_template_offsets_iters if m.use_template_offsets else False,
        enable_sm=it > o.optimize_template_offsets_iters if m.use_skinning_weight_mlp else False,
        tiers=(pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side),
    )


def make_stage2_auto(cfg: Config, template_idx: int):
    """The stage-2 step with every schedule derived from the host iteration
    ``it`` (the caller owns the count; the step still increments the device
    ``state.it``): the learning rates and the flags of ``stage2_flags``."""
    o = cfg.opt
    gs_lr = S.expon_lr_f32(o.position_lr_init, o.position_lr_final,
                           lr_delay_mult=o.position_lr_delay_mult, max_steps=o.position_lr_max_steps)
    skel_lr = S.expon_lr_f32(o.deform_mlp_lr_init, o.deform_mlp_lr_final,
                             lr_delay_mult=o.deform_mlp_lr_delay_mult, max_steps=o.deform_mlp_lr_max_steps)

    def step(state, frame, uid, bg, pre_d_xyz_all, pre_d_joints_all, *, it: int, use_chamfer=True,
             lambda_dssim=0.2, max_per_tile=1024, isotropic=False, tile_ladder=None):
        flags = stage2_flags(cfg, it, uid, template_idx)
        lrs_gs = {
            "xyz": gs_lr(it),
            "f_dc": o.feature_lr,
            "f_rest": o.feature_lr / 20.0,
            "opacity": o.opacity_lr,
            "scaling": o.scaling_lr,
            "rotation": o.rotation_lr,
            "feature": o.feature_lr,
        }
        lr_s = 5e-4 if flags["warm"] else skel_lr(max(it - o.skeleton_warm_up, 0))
        return stage2_step(
            state, frame, uid, bg, lrs_gs, lr_s, pre_d_xyz_all[uid], pre_d_joints_all[uid],
            use_chamfer=use_chamfer, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
            isotropic=isotropic, tile_ladder=tile_ladder, **flags,
        )

    return step


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
