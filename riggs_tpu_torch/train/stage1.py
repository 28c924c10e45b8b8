"""Stage-1 trainer: canonical Gaussians and the node deformation field.

Port of ``riggs_tpu/train/stage1.py``:

  * ``Stage1State``, ``init_stage1``, ``stage1_lr_fns`` (the host float64
    schedules of the frame-parallel loop) and ``stage1_lr_fns_f32`` (the
    float32 twin of ``stage1_lr_fns_jit``);
  * phase A, the nodes trained as isotropic shared-scale SH-0 Gaussians:
    ``phase_a_step`` (photometric loss, the 2D-skeleton chamfer of the
    projected nodes, the elastic, acceleration and ARAP regularizers) and
    ``make_phase_a_auto``;
  * phase B, the Gaussians deformed by the node warp: ``stage1_frame_loss``
    (with the optical-flow term of a flow scene), ``phase_b_step``,
    ``phase_b_flags`` and ``make_phase_b_auto``;
  * phase A of a ZJU-MoCap scene, where the SMPL reference points supervise
    the warp alone: ``phase_ref_loss``, ``phase_ref_step`` and
    ``make_phase_ref_auto``;
  * the node-set events: ``downsample_nodes`` (FPS over the trajectories),
    ``node_densify_prune`` and ``finalize_nodes``, host rebuilds that run
    once per event; ``Stage1TrainView`` for the Gaussian densification;
  * ``train_stage1``, the loop, with ``Stage1Draws``, its random draws.

The auto steps take the iteration ``it`` as a host int from the caller,
which owns the count; each still increments the device ``state.it``. A
step reads nothing from the card. The staged flags are host values: phase
A's detach, chamfer and regularizer toggles are 0/1 weights as the
reference writes them, phase B's ``warm`` detaches d_xyz and d_rotation
(the same values and gradients). Every random draw is an argument: the
regularizers' sample times and the split noise, drawn by the caller (the
loop's ``Stage1Draws``, or a test replaying the reference's keys). Unlike
the reference, the rendering steps report ``overflow_tiles`` and
``overflow_rect``, the flow render's too (``flow_overflow_tiles``,
``flow_overflow_rect``).

The reference-point loss is the reference's where the reference runs it,
at ``capacity`` equal to the number M of reference points (ROADMAP C5:
the reference subtracts the (capacity, 3) positions from the (M, 3) points,
so its own ZJU script, at the default capacity, fails at the first step).
The port puts the points in the first M slots, where ``create_from_pcd``
puts the M points of the scene's cloud, and averages over the alive slots.

The warp's parameters are its ``nn.Module``'s own and are updated in place
(``NodeWarp.replace_params``): a step consumes the state it is given.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.camera.camera import project_nodes_2d
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.data.flow import FlowStore
from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.models import node_warp as NW
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef
from riggs_tpu_torch.ops.fps import farthest_point_sample
from riggs_tpu_torch.ops.knn import chamfer_distance
from riggs_tpu_torch.render.api import render, render_flow, tier_kwargs
from riggs_tpu_torch.render.ladder import LadderPolicy
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.sampling import FrameSampler
from riggs_tpu_torch.train.static import TrainState, densify_step, reset_opacity_step


@dataclasses.dataclass
class Stage1State:
    gs: G.Gaussians
    node_gs: G.Gaussians
    warp: NW.NodeWarp
    opt_gs: O.AdamState
    opt_node: O.AdamState
    opt_warp: O.AdamState
    stats_gs: G.DensifyStats
    stats_node: G.DensifyStats
    it: torch.Tensor  # () int32 iteration counter; the auto steps increment it


def init_stage1(
    scene: SceneData,
    cfg: Config,
    net: DeformNetworkDef | None = None,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> Stage1State:
    """The Gaussians from the scene's point cloud, the node warp (FPS nodes,
    a DeformNetwork seeded from ``generator``), and the node Gaussians: an
    isotropic, shared-scale SH-0 cloud at the nodes with log-scale log(1e-2)
    and room for node_max_num_ratio_during_init times the nodes."""
    m = cfg.model
    gs = G.create_from_pcd(
        scene.init_points, scene.init_colors, capacity=m.capacity, max_sh_degree=m.sh_degree,
        isotropic=m.use_isotropic_gs, fea_dim=m.hyper_dim, with_motion_mask=m.gs_with_motion_mask,
        device=device,
    )
    net = net or DeformNetworkDef(is_blender=scene.is_blender)
    warp = NW.init_node_warp(scene.init_points, node_num=m.node_num, net=net, hyper_dim=m.hyper_dim,
                             d_rot_as_res=m.d_rot_as_res, generator=generator, device=gs.device)
    node_cap = m.node_num * cfg.opt.node_max_num_ratio_during_init
    node_xyz = warp.nodes[:, :3].detach().cpu().numpy()
    node_gs = G.create_from_pcd(node_xyz, np.zeros_like(node_xyz), capacity=node_cap, max_sh_degree=0,
                                isotropic=True, with_motion_mask=False, shared_scale=True, device=gs.device)
    node_gs = dataclasses.replace(node_gs, scaling=torch.full_like(node_gs.scaling, float(np.log(1e-2))))
    return Stage1State(
        gs=gs, node_gs=node_gs, warp=warp,
        opt_gs=O.adam_init(gs.params_dict()),
        opt_node=O.adam_init(node_gs.params_dict()),
        opt_warp=O.adam_init(warp.params_dict()),
        stats_gs=G.init_densify_stats(gs.capacity, device=gs.device),
        stats_node=G.init_densify_stats(node_cap, device=gs.device),
        it=torch.zeros((), dtype=torch.int32, device=gs.device),
    )


def stage1_lr_fns(cfg: Config):
    """(gauss_lrs(it), warp_lrs(it)): the learning rates of an iteration in
    float64 on the host, as ``riggs_tpu``'s ``stage1_lr_fns`` (the
    frame-parallel loop's) computes them; ``stage1_lr_fns_f32`` is the
    auto steps' float32 twin. Only the warp's ``mlp`` group is
    rescheduled."""
    o = cfg.opt
    deform_init = o.position_lr_init * 5.0 * o.deform_lr_scale
    mlp_sched = S.expon_lr(deform_init, o.position_lr_final * o.deform_lr_scale,
                           lr_delay_mult=o.position_lr_delay_mult, max_steps=o.deform_lr_max_steps)
    gs_xyz = S.expon_lr(o.position_lr_init, o.position_lr_final, lr_delay_mult=o.position_lr_delay_mult,
                        max_steps=o.position_lr_max_steps)

    def gauss_lrs(it):
        return {"xyz": gs_xyz(it), "f_dc": o.feature_lr, "f_rest": o.feature_lr / 20.0, "opacity": o.opacity_lr,
                "scaling": o.scaling_lr, "rotation": o.rotation_lr, "feature": o.feature_lr}

    def warp_lrs(it):
        return {"mlp": mlp_sched(it), "nodes": deform_init, "radius": deform_init, "weight": deform_init}

    return gauss_lrs, warp_lrs


def stage1_lr_fns_f32(cfg: Config):
    """(gauss_lrs(it), warp_lrs(it)): the learning rates of an iteration as
    float32 values, as ``stage1_lr_fns_jit`` computes them. The reference's
    quirk stays: only the warp's ``mlp`` group is rescheduled, its nodes,
    radius and weight keep the initial deform lr."""
    o = cfg.opt
    f32 = lambda v: float(np.float32(v))
    deform_init = o.position_lr_init * 5.0 * o.deform_lr_scale
    mlp_sched = S.expon_lr_f32(deform_init, o.position_lr_final * o.deform_lr_scale,
                               lr_delay_mult=o.position_lr_delay_mult, max_steps=o.deform_lr_max_steps)
    gs_xyz = S.expon_lr_f32(o.position_lr_init, o.position_lr_final,
                            lr_delay_mult=o.position_lr_delay_mult, max_steps=o.position_lr_max_steps)

    def gauss_lrs(it):
        return {
            "xyz": gs_xyz(it), "f_dc": f32(o.feature_lr), "f_rest": f32(o.feature_lr / 20.0),
            "opacity": f32(o.opacity_lr), "scaling": f32(o.scaling_lr), "rotation": f32(o.rotation_lr),
            "feature": f32(o.feature_lr),
        }

    def warp_lrs(it):
        return {"mlp": mlp_sched(it), "nodes": f32(deform_init), "radius": f32(deform_init),
                "weight": f32(deform_init)}

    return gauss_lrs, warp_lrs


def stage1_frame_loss(
    params: dict,
    state: Stage1State,
    frame: Frame,
    bg: torch.Tensor,
    mean2d_bias: torch.Tensor,
    arap_t: torch.Tensor,
    lambda_arap: float,
    lambda_motion: float,
    lambda_flow: float = 0.0,
    lambda_chamfer: float = 1e-3,
    warm: bool = False,
    active_sh: int = 0,
    use_chamfer: bool = False,
    use_motion_loss: bool = False,
    use_flow_loss: bool = False,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_ladder: tuple | None = None,
    tiers: tuple | None = None,
):
    """The phase-B per-frame loss. ``params`` is ``{"gs": ..., "warp": ...}``
    in the ``params_dict`` trees (``params["warp"]`` is written into
    ``state.warp`` unless it holds the module's own parameters); ``arap_t``
    the ARAP sample times. With ``use_flow_loss`` and a frame that carries
    flow, the scene flow to the partner frame's time is rendered on plain
    windows and L1-matched to the frame's flow in NDC where the render is
    solid (alpha > 0.9) and the flow valid, weighted by the pair's time gap
    and by how well the photometric render explains the pixel. Returns
    (loss, (render output, aux losses))."""
    gs = state.gs.replace_params(params["gs"])
    warp = state.warp.replace_params(params["warp"])
    with trace.span("riggs.deform.nodes"):
        d = NW.warp_forward(warp, gs.xyz.detach(), frame.fid, gs.feature, gs.motion_mask,
                            local_frame=warp.net.local_frame)
    d_xyz, d_rot = d["d_xyz"], d["d_rotation"]
    if warm:
        d_xyz, d_rot = d_xyz.detach(), d_rot.detach()
    d_scaling = torch.zeros_like(d["d_scaling"])  # the reference zeroes it
    if isotropic:
        d_rot = torch.zeros_like(d_rot)
    out = render(
        frame.cam, gs, bg, d_xyz=d_xyz, d_rotation=d_rot, d_scaling=d_scaling,
        active_sh_degree=active_sh, mean2d_bias=mean2d_bias, max_per_tile=max_per_tile,
        tile_ladder=tile_ladder, **tier_kwargs(tiers),
    )
    with trace.span("riggs.loss.photometric"):
        loss = L.photometric_loss(out["render"], frame.image, lambda_dssim)
    aux = {"img_loss": loss}
    with trace.span("riggs.loss.regularizers"):
        aux["arap"] = NW.arap_loss(warp, arap_t)
        loss = loss + lambda_arap * aux["arap"]
    if use_flow_loss and frame.flow is not None:
        with trace.span("riggs.deform.nodes"):
            d2 = NW.warp_forward(warp, gs.xyz.detach(), frame.flow_partner_fid, gs.feature, gs.motion_mask,
                                 local_frame=warp.net.local_frame)
        fout = render_flow(frame.cam, frame.cam, gs, d_xyz, d2["d_xyz"], d_rot, max_per_tile=max_per_tile)
        with trace.span("riggs.loss.regularizers"):
            gt_flow_ndc = frame.flow / constant((float(frame.cam.width), float(frame.cam.height)), frame.flow) * 2.0
            pair_w = torch.clamp(torch.cos(torch.abs(frame.fid - frame.flow_partner_fid) * math.pi / 2.0), 0.2, 1.0)
            solid = fout["alpha"] > 0.9
            # down-weight the pixels the photometric render explains poorly
            l1w = torch.cos(torch.mean(torch.abs(out["render"].detach() - frame.image), dim=-1) * math.pi / 2.0)
            m = (solid & (frame.flow_mask > 0)).to(torch.float32) * pair_w * l1w
            flow_l1 = L.l1_loss(m[..., None] * gt_flow_ndc, m[..., None] * fout["render"][..., :2])
            loss = loss + lambda_flow * flow_l1
        aux["flow"] = flow_l1
        out = dict(out, flow_overflow_tiles=fout["overflow_tiles"], flow_overflow_rect=fout["overflow_rect"])
    if use_motion_loss and frame.alpha_mask is not None:
        # the motion mask as colour; every other attribute detached, plain
        # windows (the reference renders this pass without the ladder)
        mout = render(
            frame.cam, gs, bg, d_xyz=d_xyz, d_rotation=d_rot, d_scaling=d_scaling, render_motion=True,
            detach_xyz=True, detach_rot=True, detach_scale=True, detach_opacity=True,
            max_per_tile=max_per_tile, **tier_kwargs(tiers),
        )
        with trace.span("riggs.loss.regularizers"):
            loss = loss + lambda_motion * L.l1_loss(mout["render"][..., 0], frame.alpha_mask)
    if frame.thinned is not None:
        with trace.span("riggs.loss.regularizers"):
            proj = project_nodes_2d(frame.cam, d["d_nodes"])
            cd = chamfer_distance(proj, frame.thinned, y_mask=frame.thinned_mask, norm=1)
            loss = loss + lambda_chamfer * float(use_chamfer) * cd
        aux["chamfer"] = cd
    return loss, (out, aux)


def phase_b_step(
    state: Stage1State,
    frame: Frame,
    bg: torch.Tensor,
    lrs_gs: dict,
    lrs_warp: dict,
    arap_t: torch.Tensor,
    lambda_arap: float,
    lambda_motion: float,
    lambda_flow: float = 0.0,
    lambda_chamfer: float = 1e-3,
    warm: bool = False,
    active_sh: int = 0,
    use_chamfer: bool = False,
    use_motion_loss: bool = False,
    use_flow_loss: bool = False,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
    isotropic: bool = False,
    tile_ladder: tuple | None = None,
    tiers: tuple | None = None,
):
    """One phase-B step: value and gradient of ``stage1_frame_loss`` in the
    Gaussians, the warp and ``mean2d_bias``; Adam on both; the
    densification statistics. Returns (new state, metrics)."""
    with trace.span("riggs.entry.phase_b_step"):
        gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
        params = {"gs": gs_p, "warp": state.warp.params_dict()}
        m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
        loss, (out, aux) = stage1_frame_loss(
            params, state, frame, bg, m2b, arap_t, lambda_arap, lambda_motion, lambda_flow, lambda_chamfer,
            warm=warm, active_sh=active_sh, use_chamfer=use_chamfer, use_motion_loss=use_motion_loss,
            use_flow_loss=use_flow_loss, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
            isotropic=isotropic, tile_ladder=tile_ladder, tiers=tiers,
        )
        with trace.span("riggs.backward.grad"):
            gp, gm2b = O.grad_tree(loss, (params, m2b))
        with trace.span("riggs.optim.adam"), torch.no_grad():
            new_gs_p, opt_gs = O.adam_update(gp["gs"], state.opt_gs, gs_p, lrs_gs)
            new_warp_p, opt_warp = O.adam_update(gp["warp"], state.opt_warp, params["warp"], lrs_warp)
            stats = G.add_densification_stats(
                state.stats_gs, gm2b, out["radii"], out["visibility_filter"], frame.cam.width, frame.cam.height,
            )
            metrics = {"loss": loss.detach(), "psnr": L.psnr(out["render"], frame.image), "n_gs": state.gs.num_alive}
            metrics.update({k: v.detach() for k, v in aux.items() if k != "img_loss"})
            new_state = dataclasses.replace(
                state,
                gs=state.gs.replace_params(new_gs_p),
                warp=state.warp.replace_params(new_warp_p),
                opt_gs=opt_gs,
                opt_warp=opt_warp,
                stats_gs=stats,
            )
        # ladder policy inputs: true per-tile hit counts and the truncation counters
        metrics["overflow_tiles"] = out["overflow_tiles"]
        metrics["overflow_rect"] = out["overflow_rect"]
        metrics["tile_counts"] = out["tile_counts"]
        for k in ("flow_overflow_tiles", "flow_overflow_rect"):
            if k in out:
                metrics[k] = out[k]
    return new_state, metrics


def phase_b_flags(cfg: Config, it: int) -> dict:
    """The schedules of iteration ``it`` as ``make_phase_b_auto`` derives
    them (keyword arguments of ``stage1_frame_loss`` and ``phase_b_step``):
    the ARAP, motion-mask and optical-flow lambdas (float32 landmark
    interpolation; the flow's weighs only a step with ``use_flow_loss``),
    the chamfer lambda, the warm-up detach, the SH degree and the render
    tiers."""
    o, pipe = cfg.opt, cfg.pipe
    return dict(
        lambda_arap=S.landmark_interpolate_f32(NW.LAMBDA_ARAP_LANDMARKS, NW.LAMBDA_ARAP_STEPS, it),
        lambda_motion=S.landmark_interpolate_f32(o.lambda_motion_mask_landmarks, o.lambda_motion_mask_steps,
                                                 it, "log"),
        lambda_flow=S.landmark_interpolate_f32(o.lambda_optical_landmarks, o.lambda_optical_steps, it),
        lambda_chamfer=o.lambda_deformed_node_prjection,
        warm=it < o.warm_up,
        active_sh=min(it // o.oneupSHdegree_step, cfg.model.sh_degree),
        tiers=(pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side),
    )


def make_phase_b_auto(cfg: Config):
    """The phase-B step with every schedule derived from the host iteration
    ``it``: the learning rates of ``stage1_lr_fns_f32`` and the flags of
    ``phase_b_flags``. The caller passes the frame, the ARAP sample times,
    ``it`` and the run's constants (chamfer, motion loss, window shape)."""
    gauss_lrs, warp_lrs = stage1_lr_fns_f32(cfg)

    def step(state, frame, bg, arap_t, *, it: int, use_chamfer=False, use_motion_loss=False,
             use_flow_loss=False, lambda_dssim=0.2, max_per_tile=1024, isotropic=False, tile_ladder=None):
        new_state, metrics = phase_b_step(
            state, frame, bg, gauss_lrs(it), warp_lrs(it), arap_t,
            use_chamfer=use_chamfer, use_motion_loss=use_motion_loss, use_flow_loss=use_flow_loss,
            lambda_dssim=lambda_dssim, max_per_tile=max_per_tile, isotropic=isotropic,
            tile_ladder=tile_ladder, **phase_b_flags(cfg, it),
        )
        return dataclasses.replace(new_state, it=state.it + 1), metrics

    return step


# ---------------------------------------------------------------------------
# Phase A: the nodes rendered as Gaussians
# ---------------------------------------------------------------------------


def phase_a_loss(
    params: dict,
    state: Stage1State,
    frame: Frame,
    bg: torch.Tensor,
    mean2d_bias: torch.Tensor,
    reg_t: dict,
    time_interval: float,
    lambda_chamfer: float = 1e-3,
    detach_dxyz: bool = False,
    use_chamfer: bool = False,
    use_reg: bool = True,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 256,
    tiers: tuple | None = None,
):
    """The phase-A loss: the node Gaussians (SH 0) deformed by the
    DeformNetwork at their detached positions, the photometric loss, the
    chamfer of the projected nodes against the thinned skeleton, and
    1e-3 elastic + 1e-5 acceleration + 1e-2 ARAP regularizers. ``params``
    is ``{"node_gs": ..., "warp": ...}`` (``params["warp"]`` is written into
    ``state.warp`` unless it holds the module's own parameters); ``reg_t``
    the regularizers' times: ``elastic`` (8,), ``acc`` () and ``arap`` (2,).
    The three toggles are 0/1 weights: ``w x + (1 - w) x.detach()`` for the
    detach, a 0-weighted term for the others (its gradient is exactly 0).
    Returns (loss, render output)."""
    w_grad = 1.0 - float(detach_dxyz)
    w_ch = float(use_chamfer)
    w_reg = float(use_reg)
    node_gs = state.node_gs.replace_params(params["node_gs"])
    warp = state.warp.replace_params(params["warp"])
    t = frame.fid.reshape(1, 1).expand(node_gs.capacity, 1)
    d_xyz = warp.mlp(node_gs.xyz.detach(), t)["d_xyz"] * node_gs.motion_mask
    d_xyz = w_grad * d_xyz + (1.0 - w_grad) * d_xyz.detach()
    out = render(frame.cam, node_gs, bg, d_xyz=d_xyz, active_sh_degree=0, mean2d_bias=mean2d_bias,
                 max_per_tile=max_per_tile, **tier_kwargs(tiers))
    loss = L.photometric_loss(out["render"], frame.image, lambda_dssim)
    if frame.thinned is not None:
        proj = project_nodes_2d(frame.cam, node_gs.xyz + d_xyz)
        cd = chamfer_distance(proj, frame.thinned, x_mask=node_gs.alive, y_mask=frame.thinned_mask, norm=1)
        loss = loss + lambda_chamfer * w_ch * cd
    reg = 1e-3 * NW.elastic_loss(warp, reg_t["elastic"])
    reg = reg + 1e-5 * NW.acc_loss(warp, reg_t["acc"], delta_t=3 * time_interval)
    reg = reg + 1e-2 * NW.arap_loss(warp, reg_t["arap"])
    return loss + w_reg * reg, out


def phase_a_step(
    state: Stage1State,
    frame: Frame,
    bg: torch.Tensor,
    lrs_node: dict,
    lrs_warp: dict,
    reg_t: dict,
    time_interval: float,
    **kw,
):
    """One phase-A step: value and gradient of ``phase_a_loss`` (``kw`` its
    options) in the node Gaussians, the warp and ``mean2d_bias``; Adam on
    both; the node densification statistics. Returns (new state, metrics)."""
    node_p = {k: v.detach().requires_grad_(True) for k, v in state.node_gs.params_dict().items()}
    params = {"node_gs": node_p, "warp": state.warp.params_dict()}
    m2b = torch.zeros_like(state.node_gs.xyz[:, :2], requires_grad=True)
    loss, out = phase_a_loss(params, state, frame, bg, m2b, reg_t, time_interval, **kw)
    gp, gm2b = O.grad_tree(loss, (params, m2b))
    with torch.no_grad():
        new_node_p, opt_node = O.adam_update(gp["node_gs"], state.opt_node, node_p, lrs_node)
        new_warp_p, opt_warp = O.adam_update(gp["warp"], state.opt_warp, params["warp"], lrs_warp)
        stats = G.add_densification_stats(
            state.stats_node, gm2b, out["radii"], out["visibility_filter"], frame.cam.width, frame.cam.height,
        )
        metrics = {"loss": loss.detach(), "psnr": L.psnr(out["render"], frame.image),
                   "n_node_gs": state.node_gs.num_alive}
    new_state = dataclasses.replace(
        state,
        node_gs=state.node_gs.replace_params(new_node_p),
        warp=state.warp.replace_params(new_warp_p),
        opt_node=opt_node,
        opt_warp=opt_warp,
        stats_node=stats,
    )
    # the reference's phase-A metrics carry neither: its truncation is silent
    metrics["overflow_tiles"] = out["overflow_tiles"]
    metrics["overflow_rect"] = out["overflow_rect"]
    return new_state, metrics


def phase_a_flags(cfg: Config, it: int) -> dict:
    """The toggles of phase-A iteration ``it`` as ``make_phase_a_auto``
    derives them: detach d_xyz before the node warm-up ends, the chamfer
    after node sampling, the regularizers after the warm-up (never with
    ``no_arap_loss``); the chamfer lambda and the render tiers."""
    o, pipe = cfg.opt, cfg.pipe
    return dict(
        lambda_chamfer=o.lambda_deformed_node_prjection,
        detach_dxyz=it < o.node_warm_up,
        use_chamfer=it > o.iterations_node_sampling,
        use_reg=(it > o.node_warm_up) if not o.no_arap_loss else False,
        tiers=(pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side),
    )


def make_phase_a_auto(cfg: Config, time_interval: float):
    """The phase-A step with every schedule derived from the host iteration
    ``it``: the learning rates of ``stage1_lr_fns_f32`` (the node Gaussians
    take the Gaussians' groups) and the toggles of ``phase_a_flags``. The
    caller passes the frame, the regularizers' times and ``it``."""
    gauss_lrs, warp_lrs = stage1_lr_fns_f32(cfg)

    def step(state, frame, bg, reg_t, *, it: int, lambda_dssim=0.2, max_per_tile=256):
        new_state, metrics = phase_a_step(
            state, frame, bg, gauss_lrs(it), warp_lrs(it), reg_t, time_interval,
            lambda_dssim=lambda_dssim, max_per_tile=max_per_tile, **phase_a_flags(cfg, it),
        )
        return dataclasses.replace(new_state, it=state.it + 1), metrics

    return step


# ---------------------------------------------------------------------------
# Phase A of a ZJU-MoCap scene: the reference points supervise the warp
# ---------------------------------------------------------------------------


def phase_ref_loss(warp_params: dict, state: Stage1State, frame: Frame, lambda_chamfer: float = 1e-3,
                   use_chamfer: bool = True):
    """The reference-point loss: the warp's d_xyz of the (detached,
    frozen) Gaussians against the frame's M reference points minus their
    positions, squared and averaged over the alive slots' coordinates, the
    points standing in the first M slots; plus the chamfer of the projected
    deformed nodes against the thinned skeleton. ``warp_params`` is written
    into ``state.warp`` unless it holds the module's own parameters.
    Returns (loss, aux losses)."""
    warp = state.warp.replace_params(warp_params)
    gs = state.gs
    d = NW.warp_forward(warp, gs.xyz.detach(), frame.fid, gs.feature, gs.motion_mask,
                        local_frame=warp.net.local_frame)
    ref = frame.reference_points
    if ref.shape[0] > gs.capacity:
        raise ValueError(f"{ref.shape[0]} reference points do not fit {gs.capacity} Gaussian slots (ROADMAP C5)")
    gt_d_xyz = torch.nn.functional.pad(ref, (0, 0, 0, gs.capacity - ref.shape[0])) - gs.xyz.detach()
    sq = torch.where(gs.alive[:, None], (gt_d_xyz - d["d_xyz"]) ** 2, constant(0.0, gt_d_xyz))
    loss = sq.sum() / (gs.alive.sum() * 3)
    aux = {"ref_loss": loss}
    if use_chamfer and frame.thinned is not None:
        proj = project_nodes_2d(frame.cam, d["d_nodes"])
        cd = chamfer_distance(proj, frame.thinned, y_mask=frame.thinned_mask, norm=1)
        loss = loss + lambda_chamfer * cd
        aux["chamfer"] = cd
    return loss, aux


def phase_ref_step(state: Stage1State, frame: Frame, lrs_warp: dict, lambda_chamfer: float = 1e-3,
                   use_chamfer: bool = True):
    """One reference-point step: value and gradient of ``phase_ref_loss``
    in the warp alone, Adam on the warp; the Gaussians stay as they are. It
    renders nothing (the reference's ``bg`` and ``max_per_tile`` go unused,
    so the port takes neither). Returns (new state, metrics)."""
    params = state.warp.params_dict()
    loss, aux = phase_ref_loss(params, state, frame, lambda_chamfer, use_chamfer)
    gp = O.grad_tree(loss, params)
    with torch.no_grad():
        new_p, opt_warp = O.adam_update(gp, state.opt_warp, params, lrs_warp)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}
    return dataclasses.replace(state, warp=state.warp.replace_params(new_p), opt_warp=opt_warp), metrics


def make_phase_ref_auto(cfg: Config):
    """The reference-point step with the warp's learning rates of the host
    iteration ``it`` (``stage1_lr_fns_f32``) and the config's chamfer
    lambda; it increments the device ``state.it``."""
    _, warp_lrs = stage1_lr_fns_f32(cfg)

    def step(state, frame, *, it: int, use_chamfer=True):
        new_state, metrics = phase_ref_step(state, frame, warp_lrs(it),
                                            lambda_chamfer=cfg.opt.lambda_deformed_node_prjection,
                                            use_chamfer=use_chamfer)
        return dataclasses.replace(new_state, it=state.it + 1), metrics

    return step


# ---------------------------------------------------------------------------
# Node-set events (host rebuilds, once per event)
# ---------------------------------------------------------------------------


@torch.no_grad()
def downsample_nodes(state: Stage1State, cfg: Config, time_num: int = 16) -> Stage1State:
    """Node sampling in the trajectory space ('samp_hyper'): FPS over the
    alive node Gaussians' positions at ``time_num`` times in [0, 1] keeps
    ``node_num`` of them as the warp's nodes (hyper coords 1e-2, radius
    log(0.1 range + 1e-7), weight logits 0) and prunes the rest; fresh Adam
    states for the warp and the node Gaussians, fresh node statistics."""
    node_gs, warp = state.node_gs, state.warp
    x = node_gs.xyz
    M = cfg.model.node_num
    # jnp.linspace's float32 values: i * (1 / (n - 1)), the last exactly 1
    t_np = np.arange(time_num, dtype=np.float32) * (np.float32(1.0) / np.float32(time_num - 1))
    t_np[-1] = 1.0
    t_samp = torch.as_tensor(t_np, device=x.device)
    trans = torch.stack([warp.mlp(x, t.reshape(1, 1).expand(x.shape[0], 1))["d_xyz"] for t in t_samp])  # (T, N, 3)
    hyper = (trans + x[None]).transpose(0, 1).reshape(x.shape[0], -1)
    idx = farthest_point_sample(hyper, M, mask=node_gs.alive).to(torch.int64)
    xs = x[idx]
    new_nodes = torch.cat([xs, torch.full((M, warp.hyper_dim), 1e-2, device=x.device)], dim=-1)
    scene_range = torch.max(xs) - torch.min(xs)
    warp = warp.with_nodes(new_nodes, torch.log(0.1 * scene_range + 1e-7) * torch.ones(M, device=x.device),
                           torch.zeros((M, 1), device=x.device))
    keep = torch.zeros(node_gs.capacity, dtype=torch.bool, device=x.device).index_fill_(0, idx, True)
    node_gs = dataclasses.replace(node_gs, alive=node_gs.alive & keep)
    return dataclasses.replace(
        state,
        warp=warp,
        node_gs=node_gs,
        opt_warp=O.adam_init(warp.params_dict()),
        opt_node=O.adam_init(node_gs.params_dict()),
        stats_node=G.init_densify_stats(node_gs.capacity, device=x.device),
    )


@torch.no_grad()
def node_densify_prune(state: Stage1State, cfg: Config, max_grad: float) -> Stage1State:
    """Node densify and prune: average the Gaussians' gradient importance
    onto each node's KNN fan; add a node at the weighted mean position of
    every node whose importance exceeds ``max_grad``; drop the nodes no
    Gaussian references. A host rebuild of the node set: the kept nodes
    carry their Adam moments, the added ones start fresh. Returns ``state``
    itself when nothing changes."""
    gs, warp = state.gs, state.warp
    s = state.stats_gs
    stats_grad = torch.where(s.denom > 0, s.xyz_gradient_accum / torch.clamp(s.denom, min=1.0), 0.0).cpu().numpy()
    x = gs.xyz.cpu().numpy()
    alive = gs.alive.cpu().numpy()
    weights_g = np.where(alive, stats_grad, 0.0)

    nn_weight, _, nn_idx = NW.cal_nn_weight(warp, gs.xyz, gs.feature)
    nn_weight = nn_weight.cpu().numpy() * alive[:, None]
    nn_idx = nn_idx.cpu().numpy()

    M = warp.node_num
    importance = np.zeros(M)
    edge_count = np.zeros(M)
    avg_x = np.zeros((M, x.shape[1]))
    np.add.at(importance, nn_idx.reshape(-1), (nn_weight * weights_g[:, None]).reshape(-1))
    np.add.at(edge_count, nn_idx.reshape(-1), nn_weight.reshape(-1))
    np.add.at(
        avg_x,
        nn_idx.reshape(-1),
        (nn_weight * weights_g[:, None]).reshape(-1, 1) * np.repeat(x, nn_idx.shape[1], axis=0),
    )
    avg_x = avg_x / np.maximum(importance[:, None], 1e-12)
    importance = importance / (edge_count + 1e-7)

    add_mask = (importance > max_grad) & np.isfinite(avg_x).all(axis=1)
    keep_mask = edge_count > 0
    if add_mask.sum() == 0 and keep_mask.all():
        return state

    old_nodes = warp.nodes.cpu().numpy()
    old_radius = warp.node_radius_log.cpu().numpy()
    old_weight = warp.node_weight_logit.cpu().numpy()
    new_nodes = np.concatenate([
        old_nodes[keep_mask],
        np.concatenate([avg_x[add_mask, :3], 1e-2 * np.ones((add_mask.sum(), warp.hyper_dim))], -1),
    ])
    new_radius = np.concatenate([old_radius[keep_mask], old_radius[add_mask]])
    new_weight = np.concatenate([old_weight[keep_mask], old_weight[add_mask]])
    dev = warp.nodes.device
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    new_warp = warp.with_nodes(as_t(new_nodes), as_t(new_radius), as_t(new_weight))
    # the kept nodes' moments carry over (first), the added nodes' are zero
    keep_idx = torch.as_tensor(np.nonzero(keep_mask)[0], device=dev)
    n_new = new_nodes.shape[0]

    def carry(a):
        fresh = torch.zeros((n_new,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        fresh[: keep_idx.shape[0]] = a[keep_idx]
        return fresh

    opt = state.opt_warp
    new_mu, new_nu = dict(opt.mu), dict(opt.nu)
    for k in ("nodes", "radius", "weight"):
        new_mu[k], new_nu[k] = carry(opt.mu[k]), carry(opt.nu[k])
    return dataclasses.replace(state, warp=new_warp, opt_warp=O.AdamState(mu=new_mu, nu=new_nu, count=opt.count))


@torch.no_grad()
def finalize_nodes(state: Stage1State) -> Stage1State:
    """End of phase A: the warp's node positions become the alive node
    Gaussians' (the first ``node_num`` alive, padded with slot 0, as after
    ``downsample_nodes``). Reads the alive mask from the card once."""
    alive = state.node_gs.alive.cpu().numpy()
    M = state.warp.node_num
    idx = np.zeros(M, np.int64)
    found = np.nonzero(alive)[0][:M]
    idx[: found.shape[0]] = found
    nodes = state.warp.nodes.clone()
    nodes[:, :3] = state.node_gs.xyz[torch.as_tensor(idx, device=nodes.device)]
    warp = state.warp.with_nodes(nodes, state.warp.node_radius_log, state.warp.node_weight_logit)
    return dataclasses.replace(state, warp=warp)


def Stage1TrainView(gs, opt, stats) -> TrainState:
    """A (Gaussians, Adam state, statistics) triple as ``densify_step`` takes it."""
    return TrainState(gs=gs, opt=opt, stats=stats)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


class Stage1Draws:
    """The loop's random draws, one method per draw, from one
    ``torch.Generator`` seeded with ``seed`` on ``device``. A test replays
    the reference's key chain through an object with the same methods."""

    def __init__(self, seed: int, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def phase_a(self, fid: torch.Tensor, time_interval: float) -> dict:
        """A phase-A step's regularizer times (``phase_a_step``'s ``reg_t``)."""
        return {
            "elastic": NW.arap_sample_times(self.gen, t=fid, delta_t=time_interval, t_samp_num=8),
            "acc": NW.sample_time(self.gen, t=fid, delta_t=3 * time_interval),
            "arap": NW.arap_sample_times(self.gen, device=self.device),
        }

    def phase_ref(self) -> None:
        """A reference-point step draws nothing (the reference splits its
        key before the branch all the same: a replay of its chain splits
        here)."""

    def phase_b(self) -> torch.Tensor:
        """A phase-B step's ARAP sample times."""
        return NW.arap_sample_times(self.gen, device=self.device)

    def phase_b_batch(self, n: int) -> torch.Tensor:
        """A frame-parallel step's ARAP sample times, one row per frame of
        its batch of ``n`` (n, t_samp_num)."""
        return torch.stack([self.phase_b() for _ in range(n)])

    def split_noise(self, capacity: int) -> torch.Tensor:
        """A densification's split noise (2, capacity, 3)."""
        return G.split_noise(capacity, generator=self.gen, device=self.device)


def _overflow(metrics: dict) -> tuple[int, ...]:
    """A step's (overflow_tiles, overflow_rect), and its flow render's two
    counters (0 where it rendered none), read in one copy."""
    keys = ("overflow_tiles", "overflow_rect", "flow_overflow_tiles", "flow_overflow_rect")
    vals = torch.stack([metrics[k] for k in keys if k in metrics]).tolist()
    return tuple(int(v) for v in vals) + (0,) * (len(keys) - len(vals))


def _gs_densify(state: Stage1State, draws, o, extent: float, node: bool) -> Stage1State:
    """``densify_step`` on the node Gaussians (``node``) or the Gaussians."""
    gs, opt, stats = (state.node_gs, state.opt_node, state.stats_node) if node else (state.gs, state.opt_gs, state.stats_gs)
    st = densify_step(Stage1TrainView(gs, opt, stats), draws.split_noise(gs.capacity), o.densify_grad_threshold,
                      extent, percent_dense=o.percent_dense)
    if node:
        return dataclasses.replace(state, node_gs=st.gs, opt_node=st.opt, stats_node=st.stats)
    return dataclasses.replace(state, gs=st.gs, opt_gs=st.opt, stats_gs=st.stats)


def train_stage1(
    scene: SceneData,
    cfg: Config,
    seed: int = 0,
    log_every: int = 0,
    eval_every: int = 0,
    eval_fn=None,
    step_callback=None,
    source_path: str | None = None,
    state: Stage1State | None = None,
    draws=None,
    events: list | None = None,
    device: str | torch.device | None = None,
):
    """Train stage 1 on ``scene``; returns (state, history).

    Phase A (``iterations_node_rendering`` steps): ``make_phase_a_auto``
    steps on sampled frames (progressive, with the node warm-up window,
    when ``progressive_train_node``), the node Gaussians densified every
    ``densification_interval`` before ``iterations_node_sampling``, then
    ``downsample_nodes`` at that step and ``finalize_nodes`` at the end.
    A scene whose frames carry reference points (ZJU-MoCap) trains phase A
    with ``make_phase_ref_auto`` instead: no render, no node event, no
    ``finalize_nodes``; its point count must equal the scene's cloud's, or
    the loop raises a ValueError (ROADMAP C5). Phase B (``iterations``
    steps, ``it`` from 0): ``make_phase_b_auto`` steps with ``LadderPolicy``
    riding the first steps; each step's overflow is read one step late
    (the host never waits for the step it just launched) and refits the
    ladder as the reference's triggers say;
    node densify/prune, Gaussian densification (with ``anticipate``) and
    opacity resets with fresh opacity moments. ``history`` holds
    (phase, it, scalar metrics) every ``log_every`` steps. When
    ``raft_neighbouring/`` under ``source_path`` holds a flow file of a
    train image, phase B trains with the optical-flow loss: from the
    warm-up's end, while its lambda is positive, each step draws one of
    its frame's flows (``FlowStore``, from the frame sampler's numpy
    generator, after the frame); a step without one carries zero flow, and
    every step keeps one signature.

    ``state`` replaces ``init_stage1``'s (seeded from ``seed``), ``draws``
    the ``Stage1Draws(seed)`` of the random draws. ``events``, when given,
    receives one dict per event: densifications with the alive counts
    before and after, node sampling and densify/prune with the node counts,
    ladder fits, every step that overflowed (the flow render's as "flow
    overflow"), and at the end of a flow run the number of steps that drew
    a partner. ``step_callback(state, it, phase)``, when given, is called after every step of both phases
    (``phase`` "A" or "B") and that step's events; the reference calls its
    ``step_callback(state, it)`` in phase B only. Runs on ``cuda`` unless
    ``device`` says otherwise."""
    o = cfg.opt
    dev = resolve_device(device)
    frames = scene.train_frames
    use_ref_points = bool(frames) and frames[0].reference_points is not None
    if use_ref_points and frames[0].reference_points.shape[0] != len(scene.init_points):
        raise ValueError(f"{frames[0].reference_points.shape[0]} reference points against a cloud of "
                         f"{len(scene.init_points)}: the points must be the cloud's, slot by slot (ROADMAP C5)")
    if state is None:
        state = init_stage1(scene, cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    draws = Stage1Draws(seed, dev) if draws is None else draws
    bg = torch.ones(3, device=dev) if scene.white_background else torch.zeros(3, device=dev)
    rng = np.random.default_rng(seed)
    ti = scene.time_interval
    history = []
    log = (lambda **e: events.append(e)) if events is not None else (lambda **e: None)
    alive = lambda g: int(g.num_alive)

    # ---- phase A ----------------------------------------------------------
    sampler = FrameSampler(frames, rng)
    step_a = make_phase_a_auto(cfg, ti)
    step_ref = make_phase_ref_auto(cfg)
    prev = None  # (it, metrics) of the previous step: its overflow is read a step late
    for it in range(o.iterations_node_rendering):
        frame = frames[sampler.sample(it, o.progressive_train_node, o.progressive_stage_ratio,
                                      o.progressive_stage_steps,
                                      warmup_until=o.node_warm_up if o.progressive_train_node else 0)]
        if use_ref_points:
            draws.phase_ref()
            state, metrics = step_ref(state, frame, it=it, use_chamfer=frame.thinned is not None)
            if log_every and it % log_every == 0:
                history.append(("A", it, {k: float(v) for k, v in metrics.items()}))
            if step_callback is not None:
                step_callback(state, it, "A")
            continue
        state, metrics = step_a(state, frame, bg, draws.phase_a(frame.fid, ti), it=it, lambda_dssim=o.lambda_dssim,
                                max_per_tile=cfg.pipe.max_per_tile)
        if prev is not None:
            of_t, of_r = _overflow(prev[1])[:2]
            if of_t or of_r:
                log(phase="A", it=prev[0], event="overflow", tiles=of_t, rect=of_r)
        prev = (it, metrics)
        if 0 < it < o.iterations_node_sampling and it % o.densification_interval == 0:
            before = alive(state.node_gs)
            state = _gs_densify(state, draws, o, scene.cameras_extent, node=True)
            log(phase="A", it=it, event="node_gs densify", before=before, after=alive(state.node_gs))
        if it == o.iterations_node_sampling:
            before = alive(state.node_gs)
            state = downsample_nodes(state, cfg)
            log(phase="A", it=it, event="node sampling", before=before, after=alive(state.node_gs),
                nodes=state.warp.node_num)
        if log_every and it % log_every == 0:
            history.append(("A", it, {k: float(v) for k, v in metrics.items()}))
        if step_callback is not None:
            step_callback(state, it, "A")
    if prev is not None:
        of_t, of_r = _overflow(prev[1])[:2]
        if of_t or of_r:
            log(phase="A", it=prev[0], event="overflow", tiles=of_t, rect=of_r)
    if not use_ref_points and o.iterations_node_rendering > o.iterations_node_sampling:
        state = finalize_nodes(state)

    # ---- phase B ----------------------------------------------------------
    flow_store = None
    if source_path is not None and scene.train_image_names is not None:
        fs = FlowStore(source_path, scene.train_image_names, [float(f.fid) for f in frames],
                       [(f.cam.height, f.cam.width) for f in frames], device=dev)
        if any(fs.has_flow(i) for i in range(len(frames))):
            flow_store = fs
    n_partners = 0
    sampler = FrameSampler(frames, rng)
    ladder_pol = None
    if cfg.pipe.use_tile_ladder and cfg.pipe.rasterizer == "tiled":
        ladder_pol = LadderPolicy(n_buckets=cfg.pipe.ladder_buckets, margin=cfg.pipe.ladder_margin)
    densified_at = -1
    state = dataclasses.replace(state, it=torch.zeros((), dtype=torch.int32, device=dev))  # schedules restart
    step_b = make_phase_b_auto(cfg)
    use_chamfer = bool(frames) and frames[0].thinned is not None
    use_motion = o.gt_alpha_mask_as_dynamic_mask and bool(frames) and frames[0].alpha_mask is not None
    prev = None

    def late_overflow(p_it, p_metrics) -> int:
        """Log a step's overflow, read a step late; its render's overflow_tiles."""
        of_t, of_r, ff_t, ff_r = _overflow(p_metrics)
        if of_t or of_r:
            log(phase="B", it=p_it, event="overflow", tiles=of_t, rect=of_r)
        if ff_t or ff_r:
            log(phase="B", it=p_it, event="flow overflow", tiles=ff_t, rect=ff_r)
        return of_t

    def observe(p_it, p_metrics, of_t):
        old = ladder_pol.ladder
        ladder_pol.observe(p_metrics["tile_counts"].cpu().numpy(), of_t)
        if ladder_pol.ladder != old:
            log(phase="B", it=p_it, event="ladder fit" if old is None else "ladder refit", ladder=ladder_pol.ladder,
                refits=ladder_pol.refits)

    for it in range(o.iterations):
        fidx = sampler.sample(it, o.progressive_train, o.progressive_stage_ratio, o.progressive_stage_steps)
        frame = frames[fidx]
        if flow_store is not None:
            sampled = None
            if it >= o.warm_up and S.landmark_interpolate(o.lambda_optical_landmarks, o.lambda_optical_steps, it) > 0:
                sampled = flow_store.sample(fidx, rng)
            n_partners += sampled is not None
            fl, fm, pfid = sampled if sampled is not None else flow_store.no_partner(frame)
            frame = dataclasses.replace(frame, flow=fl, flow_mask=fm, flow_partner_fid=pfid)
        state, metrics = step_b(
            state, frame, bg, draws.phase_b(), it=it, use_chamfer=use_chamfer, use_motion_loss=use_motion,
            use_flow_loss=flow_store is not None, lambda_dssim=o.lambda_dssim, max_per_tile=cfg.pipe.max_per_tile,
            isotropic=cfg.model.use_isotropic_gs, tile_ladder=ladder_pol.ladder if ladder_pol is not None else None,
        )
        if prev is not None:
            p_it, p_metrics = prev
            of_t = late_overflow(p_it, p_metrics)
            if ladder_pol is not None and (ladder_pol.ladder is None or of_t > 0
                                           or p_it % cfg.pipe.ladder_check_every == 0 or p_it == densified_at + 1):
                observe(p_it, p_metrics, of_t)
        prev = (it, metrics)
        node_dp = (
            o.node_enable_densify_prune
            and o.node_densify_from_iter < it < o.node_densify_until_iter
            and it % o.node_densification_interval == 0
            and it > o.warm_up
        ) or it == o.node_force_densify_prune_step
        if node_dp:
            before = state.warp.node_num
            state = node_densify_prune(state, cfg, o.densify_grad_threshold)
            log(phase="B", it=it, event="node densify/prune", before=before, after=state.warp.node_num)
        if o.densify_from_iter < it < o.densify_until_iter and it % o.densification_interval == 0:
            before = alive(state.gs)
            state = _gs_densify(state, draws, o, scene.cameras_extent, node=False)
            after = alive(state.gs)
            densified_at = it
            log(phase="B", it=it, event="gs densify", before=before, after=after)
            if ladder_pol is not None and ladder_pol.ladder is not None:
                # ride ahead of the growth: one refit instead of overflow churn
                if before > 0 and after > before and ladder_pol.anticipate(after / before):
                    log(phase="B", it=it, event="ladder anticipate", ladder=ladder_pol.ladder,
                        refits=ladder_pol.refits)
        if it > 0 and it % o.opacity_reset_interval == 0:
            st = reset_opacity_step(Stage1TrainView(state.gs, state.opt_gs, state.stats_gs))
            state = dataclasses.replace(state, gs=st.gs, opt_gs=st.opt)
            log(phase="B", it=it, event="opacity reset")
        if log_every and it % log_every == 0:
            history.append(("B", it, {k: float(v) for k, v in metrics.items() if v.dim() == 0}))
        if eval_every and eval_fn is not None and it > 0 and it % eval_every == 0:
            eval_fn(state, it)
        if step_callback is not None:
            step_callback(state, it, "B")
    if prev is not None:  # the last step's late read
        of_t = late_overflow(*prev)
        if ladder_pol is not None:
            observe(prev[0], prev[1], of_t)
    if ladder_pol is not None:
        log(phase="B", it=o.iterations, event="ladder", ladder=ladder_pol.ladder, refits=ladder_pol.refits)
    if flow_store is not None:
        log(phase="B", it=o.iterations, event="flow", partners=n_partners)
    return state, history
