"""Stage-1 trainer, phase B: canonical Gaussians deformed by the node warp.

Port of ``riggs_tpu/train/stage1.py:43-110, 157-198, 252-317, 583-774``:
``Stage1State``, ``init_stage1``, ``stage1_lr_fns_f32`` (the float32 twin
of ``stage1_lr_fns_jit``), ``stage1_frame_loss`` (photometric + ARAP +
the motion-mask render + the 2D-skeleton chamfer), ``phase_b_step`` (value
and gradient, Adam on the Gaussians and the warp, densification
statistics), ``phase_b_flags`` (the schedules of an iteration) and
``make_phase_b_auto`` (every schedule derived from ``state.it``). Phase A,
node sampling and densification, Gaussian densification and the training
loop come with the next slice.

As in ``train/stage2.py``, the staged flags are host values; ``warm``
detaches d_xyz and d_rotation where the reference weights them 0/1 (the
same values and gradients). The ARAP regularizer's sample times are an
argument (``arap_t``), drawn by the caller (``node_warp.arap_sample_times``)
where the reference splits a PRNG key. ``use_flow_loss`` raises: the flow
render (``render_flow``) is not ported yet. Unlike the reference, the step
reports ``overflow_rect`` among its metrics.

The warp's parameters are its ``nn.Module``'s own and are updated in place
(``NodeWarp.replace_params``): a step consumes the state it is given.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import project_nodes_2d
from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.models import node_warp as NW
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef
from riggs_tpu_torch.ops.knn import chamfer_distance
from riggs_tpu_torch.render.api import render, tier_kwargs
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config


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
    the ARAP sample times. Returns (loss, (render output, aux losses))."""
    if use_flow_loss:
        raise NotImplementedError("the optical-flow loss needs render_flow, not ported yet (ROADMAP A9)")
    gs = state.gs.replace_params(params["gs"])
    warp = state.warp.replace_params(params["warp"])
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
    loss = L.photometric_loss(out["render"], frame.image, lambda_dssim)
    aux = {"img_loss": loss}
    aux["arap"] = NW.arap_loss(warp, arap_t)
    loss = loss + lambda_arap * aux["arap"]
    if use_motion_loss and frame.alpha_mask is not None:
        # the motion mask as colour; every other attribute detached, plain
        # windows (the reference renders this pass without the ladder)
        mout = render(
            frame.cam, gs, bg, d_xyz=d_xyz, d_rotation=d_rot, d_scaling=d_scaling, render_motion=True,
            detach_xyz=True, detach_rot=True, detach_scale=True, detach_opacity=True,
            max_per_tile=max_per_tile, **tier_kwargs(tiers),
        )
        loss = loss + lambda_motion * L.l1_loss(mout["render"][..., 0], frame.alpha_mask)
    if frame.thinned is not None:
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
    gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
    params = {"gs": gs_p, "warp": state.warp.params_dict()}
    m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
    loss, (out, aux) = stage1_frame_loss(
        params, state, frame, bg, m2b, arap_t, lambda_arap, lambda_motion, lambda_flow, lambda_chamfer,
        warm=warm, active_sh=active_sh, use_chamfer=use_chamfer, use_motion_loss=use_motion_loss,
        use_flow_loss=use_flow_loss, lambda_dssim=lambda_dssim, max_per_tile=max_per_tile,
        isotropic=isotropic, tile_ladder=tile_ladder, tiers=tiers,
    )
    gp, gm2b = O.grad_tree(loss, (params, m2b))
    with torch.no_grad():
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
    return new_state, metrics


def phase_b_flags(cfg: Config, it: int) -> dict:
    """The schedules of iteration ``it`` as ``make_phase_b_auto`` derives
    them (keyword arguments of ``stage1_frame_loss`` and ``phase_b_step``):
    the ARAP and motion-mask lambdas (float32 landmark interpolation), the
    chamfer lambda, the warm-up detach, the SH degree and the render tiers."""
    o, pipe = cfg.opt, cfg.pipe
    return dict(
        lambda_arap=S.landmark_interpolate_f32(NW.LAMBDA_ARAP_LANDMARKS, NW.LAMBDA_ARAP_STEPS, it),
        lambda_motion=S.landmark_interpolate_f32(o.lambda_motion_mask_landmarks, o.lambda_motion_mask_steps,
                                                 it, "log"),
        lambda_chamfer=o.lambda_deformed_node_prjection,
        warm=it < o.warm_up,
        active_sh=min(it // o.oneupSHdegree_step, cfg.model.sh_degree),
        tiers=(pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side),
    )


def make_phase_b_auto(cfg: Config):
    """The phase-B step with every schedule derived from ``state.it``: the
    learning rates of ``stage1_lr_fns_f32`` and the flags of
    ``phase_b_flags``. The caller passes the frame and the ARAP sample times
    and the run's constants (chamfer, motion loss, window shape)."""
    gauss_lrs, warp_lrs = stage1_lr_fns_f32(cfg)

    def step(state, frame, bg, arap_t, use_chamfer=False, use_motion_loss=False, use_flow_loss=False,
             lambda_dssim=0.2, max_per_tile=1024, isotropic=False, tile_ladder=None):
        it = int(state.it)
        new_state, metrics = phase_b_step(
            state, frame, bg, gauss_lrs(it), warp_lrs(it), arap_t,
            use_chamfer=use_chamfer, use_motion_loss=use_motion_loss, use_flow_loss=use_flow_loss,
            lambda_dssim=lambda_dssim, max_per_tile=max_per_tile, isotropic=isotropic,
            tile_ladder=tile_ladder, **phase_b_flags(cfg, it),
        )
        return dataclasses.replace(new_state, it=state.it + 1), metrics

    return step
