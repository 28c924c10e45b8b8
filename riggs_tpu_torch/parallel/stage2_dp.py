"""The frame-parallel stage-2 training loop over a data x tile mesh.

Port of ``riggs_tpu/parallel/stage2_dp.py``: the stage-2 schedule of
``train.stage2.train_stage2`` (the skeleton warm-up, the staged unlock with
the control nodes reset to an FPS of the alive Gaussians, the per-group
learning rates, densification, the test evaluation with best-PSNR
checkpoints) driven by ``make_dp_stage2_step``. Each step takes a batch of
B = the mesh's data size frames, one per data row, and advances the
iteration count by B, so the schedules, the warm-up and unlock boundaries
and the densification cadence fall at the same sample counts as on one
device. With a tile axis larger than 1 each frame's blend is split over its
tile group.

Every rank runs this loop with the same arguments: the initial state, the
frame draws (``FrameSampler`` on a numpy generator seeded with ``seed``),
the densification noise (``Stage2Draws(seed)``) and every host-side phase
are the same on every rank, and the step keeps the state bit for bit the
same on all of them. Only rank 0 writes checkpoints.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from riggs_tpu_torch.data.dataset import SceneData
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.ops.fps import farthest_point_sample
from riggs_tpu_torch.parallel.mesh import Mesh
from riggs_tpu_torch.parallel.train import make_dp_stage2_step, stack_frames, stage2_flags
from riggs_tpu_torch.render.ladder import LadderPolicy
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.sampling import FrameSampler
from riggs_tpu_torch.train.stage2 import Stage2Draws, evaluate_stage2, init_stage2
from riggs_tpu_torch.train.static import TrainState, densify_step


def train_stage2_dp(
    stage1_state,
    scene: SceneData,
    cfg: Config,
    mesh: Mesh,
    seed: int = 0,
    log_every: int = 0,
    test_every: int = 0,
    model_path=None,
    step_callback=None,
    init=None,
    draws=None,
    events: list | None = None,
    device: str | torch.device | None = None,
):
    """Train stage 2 from a trained stage-1 state over ``mesh``; returns
    (state, info, history). ``init`` is a prebuilt (state, info, frames) in
    place of ``init_stage2`` (its skeleton drawn from a generator seeded
    with ``seed``); ``draws`` the ``Stage2Draws(seed)`` of the split noise;
    ``events``, when given, receives the FPS reset, densifications, ladder
    refits and test evaluations as dicts. ``history`` holds (it, scalar
    metrics) every ``log_every`` iterations, and ``step_callback(state,
    it)`` is called after every step. Runs on ``cuda`` unless ``device``
    says otherwise."""
    o = cfg.opt
    dev = resolve_device(device)
    B = mesh.shape["data"]
    log = (lambda **e: events.append(e)) if events is not None else (lambda **e: None)
    if init is not None:
        state, info, frames = init
    else:
        state, info, frames = init_stage2(stage1_state, scene, cfg,
                                          generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    draws = Stage2Draws(seed, dev) if draws is None else draws
    bg = torch.ones(3, device=dev) if scene.white_background else torch.zeros(3, device=dev)
    gs_lr = S.expon_lr_f32(o.position_lr_init, o.position_lr_final, lr_delay_mult=o.position_lr_delay_mult,
                           max_steps=o.position_lr_max_steps)
    skel_lr = S.expon_lr_f32(o.deform_mlp_lr_init, o.deform_mlp_lr_final, lr_delay_mult=o.deform_mlp_lr_delay_mult,
                             max_steps=o.deform_mlp_lr_max_steps)
    history = []
    best_psnr = -1.0
    densified_at = -B - 1
    use_chamfer = frames[0].thinned is not None and o.lambda_deformed_node_prjection > 1e-8
    # the ladder permutes tiles by their count, which the tile shards do not follow
    tile_parallel = mesh.shape["tile"] > 1
    ladder_pol = None
    if cfg.pipe.use_tile_ladder and cfg.pipe.rasterizer == "tiled" and not tile_parallel:
        ladder_pol = LadderPolicy(n_buckets=cfg.pipe.ladder_buckets, margin=cfg.pipe.ladder_margin)

    def build_step():
        return make_dp_stage2_step(
            mesh, use_chamfer=use_chamfer, lambda_chamfer=o.lambda_deformed_node_prjection,
            lambda_rendering=o.lambda_rendering_image, lambda_dssim=o.lambda_dssim,
            max_per_tile=cfg.pipe.max_per_tile, isotropic=cfg.model.use_isotropic_gs,
            tile_parallel=tile_parallel, tile_ladder=ladder_pol.ladder if ladder_pol is not None else None,
        )

    step = build_step()
    sampler = FrameSampler(frames, np.random.default_rng(seed))
    unlocked = False
    n_iters = o.iterations if o.iterations_stage2 is None else o.iterations_stage2
    for it in range(0, n_iters, B):
        warm = it < o.skeleton_warm_up
        if not unlocked and it >= o.optimize_template_offsets_iters:
            # the staged unlock: the control nodes restart from the alive Gaussians
            idx = farthest_point_sample(state.gs.xyz, cfg.model.skeleton_gs_sample_num, mask=state.gs.alive)
            state.skel.control_nodes = state.gs.xyz[idx.to(torch.int64)].detach()
            unlocked = True
            log(it=it, event="fps reset", idx=idx)
        enable_to = cfg.model.use_template_offsets and it >= o.optimize_template_offsets_iters
        enable_sm = cfg.model.use_skinning_weight_mlp and it > o.optimize_template_offsets_iters
        uids = np.array([sampler.sample(it + b, o.progressive_train, o.progressive_stage_ratio,
                                        o.progressive_stage_steps) for b in range(B)], np.int64)
        is_t = uids == info.template_idx
        lam_to = np.float32(o.lambda_template_offsets) * np.where(is_t, 1e3, 1.0).astype(np.float32)
        lam_tf = np.where(is_t, o.lambda_template_fixed, 0.0).astype(np.float32)
        lrs_gs = {"xyz": gs_lr(it), "f_dc": o.feature_lr, "f_rest": o.feature_lr / 20.0, "opacity": o.opacity_lr,
                  "scaling": o.scaling_lr, "rotation": o.rotation_lr, "feature": o.feature_lr}
        lr_s = 5e-4 if warm else skel_lr(max(0, it - o.skeleton_warm_up))
        rows = torch.as_tensor(uids).to(info.d_xyz.device)
        state, metrics = step(
            state, stack_frames([frames[u] for u in uids]), uids, bg, lrs_gs, lr_s, info.d_xyz[rows],
            info.d_joints[rows], lam_to, lam_tf,
            stage2_flags(warm=warm, active_sh=min(it // o.oneupSHdegree_step, cfg.model.sh_degree),
                         enable_to=enable_to, enable_sm=enable_sm),
        )
        if ladder_pol is not None:
            # the overflow of every step (one read): a stale ladder truncates
            # no longer than the step that shows it
            overflow = int(metrics["overflow_tiles"])
            if (ladder_pol.ladder is None or overflow > 0
                    or (it // B) % max(cfg.pipe.ladder_check_every // B, 1) == 0 or it == densified_at + B):
                old = ladder_pol.ladder
                if ladder_pol.observe(metrics["tile_counts"].cpu().numpy(), overflow):
                    step = build_step()
                    log(it=it, event="ladder fit" if old is None else "ladder refit", ladder=ladder_pol.ladder)
        if (not warm and o.gs_densification_iterations < it < o.densify_until_iter and it > o.densify_from_iter
                and (it // B) % max(o.densification_interval // B, 1) == 0):
            before = int(state.gs.num_alive)
            st = densify_step(TrainState(state.gs, state.opt_gs, state.stats_gs), draws.split_noise(state.gs.capacity),
                              o.densify_grad_threshold, scene.cameras_extent, percent_dense=o.percent_dense)
            state = dataclasses.replace(state, gs=st.gs, opt_gs=st.opt, stats_gs=st.stats)
            densified_at = it
            log(it=it, event="gs densify", before=before, after=int(st.gs.num_alive))
        if log_every and (it // B) % max(log_every // B, 1) == 0:
            history.append((it, {k: float(v) for k, v in metrics.items() if v.dim() == 0}))
        if test_every and it > 0 and (it // B) % max(test_every // B, 1) == 0 and scene.test_frames:
            means = evaluate_stage2(state, scene.test_frames, bg)
            log(it=it, event="test", **means)
            if means.get("psnr", 0.0) > best_psnr and model_path is not None:
                best_psnr = means["psnr"]
                if dist.get_rank() == 0:
                    from riggs_tpu_torch.io.checkpoint import save_checkpoint

                    save_checkpoint(model_path, it, state, gs=state.gs)
                    log(it=it, event="checkpoint", psnr=best_psnr)
        if step_callback is not None:
            step_callback(state, it)
    return state, info, history
