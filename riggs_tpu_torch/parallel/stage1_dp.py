"""The frame-parallel stage-1 training loop over a mesh's data axis.

Port of ``riggs_tpu/parallel/stage1_dp.py``. Phase A (the nodes trained as
Gaussians) is short and densification-heavy, so it runs in one process
through ``train.stage1.train_stage1`` with phase B's budget at 0, or the
caller hands in a phase-A-complete state. Phase B then runs frame-parallel:
each step takes a batch of B = the mesh's data size frames, one per data
row (``make_dp_stage1_step``), and advances the iteration count by B, so
the landmark schedules, the densification cadence and the opacity resets
fall at the same sample counts as on one device. The learning rates and
lambdas are the reference loop's host float64 values, rounded to float32.

Every rank runs this loop with the same arguments: the frame draws and the
flow partners (``FrameSampler`` and ``FlowStore.sample`` on one numpy
generator seeded with ``seed``), the ARAP sample times and the split noise
(``Stage1Draws(seed)``, or an object with its ``phase_b_batch`` and
``split_noise``) and every host-side event are the same on every rank, and
the step keeps the state bit for bit the same on all of them. The ladder
policy reads one scalar a step, the batch's overflow, as the reference's
loop does, so its refits land on the same steps.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.data.dataset import SceneData
from riggs_tpu_torch.data.flow import FlowStore
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.models import node_warp as NW
from riggs_tpu_torch.parallel.mesh import Mesh
from riggs_tpu_torch.parallel.train import make_dp_stage1_step, stack_frames, stage1_flags
from riggs_tpu_torch.render.ladder import LadderPolicy
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.sampling import FrameSampler
from riggs_tpu_torch.train.stage1 import (Stage1Draws, Stage1TrainView, _gs_densify, node_densify_prune,
                                          stage1_lr_fns, train_stage1)
from riggs_tpu_torch.train.static import reset_opacity_step


def _f32(lrs: dict) -> dict:
    return {k: float(np.float32(v)) for k, v in lrs.items()}


def train_stage1_dp(
    scene: SceneData,
    cfg: Config,
    mesh: Mesh,
    seed: int = 0,
    log_every: int = 0,
    step_callback=None,
    init=None,
    source_path=None,
    draws=None,
    events: list | None = None,
    device: str | torch.device | None = None,
):
    """Train stage 1 on ``scene`` with phase B frame-parallel over ``mesh``;
    returns (state, history). ``init`` is a phase-A-complete state in place
    of phase A (``train_stage1`` with ``iterations`` 0, seeded with
    ``seed``); ``draws`` the ``Stage1Draws(seed)`` of the ARAP sample times
    and the split noise. With ``source_path`` holding flow files of the
    train images (``raft_neighbouring/``) each frame of a batch draws a flow
    partner from the warm-up's end while the flow lambda is positive, and
    weighs its flow term by it (0, with zero flow, where it drew none).
    ``events``, when given, receives the node densify/prune with the node
    counts, densifications with the alive counts, opacity resets and
    ladder fits as dicts. ``history`` holds ("Bdp", it, scalar metrics)
    every ``log_every`` iterations, and ``step_callback(state, it)`` is
    called after every step. Runs on ``cuda`` unless ``device`` says
    otherwise."""
    o = cfg.opt
    dev = resolve_device(device)
    B = mesh.shape["data"]
    frames = scene.train_frames
    log = (lambda **e: events.append(e)) if events is not None else (lambda **e: None)
    alive = (lambda g: int(g.num_alive)) if events is not None else (lambda g: None)  # a read only when logged
    if init is not None:
        state = init
    else:
        cfg_a = copy.deepcopy(cfg)
        cfg_a.opt.iterations = 0
        state, _ = train_stage1(scene, cfg_a, seed=seed, log_every=log_every, device=dev)
    draws = Stage1Draws(seed, dev) if draws is None else draws
    bg = torch.ones(3, device=dev) if scene.white_background else torch.zeros(3, device=dev)
    rng = np.random.default_rng(seed)

    flow_store = None
    if source_path is not None and scene.train_image_names is not None:
        fs = FlowStore(source_path, scene.train_image_names, [float(f.fid) for f in frames],
                       [(f.cam.height, f.cam.width) for f in frames], device=dev)
        if any(fs.has_flow(i) for i in range(len(frames))):
            flow_store = fs

    gauss_lrs, warp_lrs = stage1_lr_fns(cfg)
    ladder_pol = None
    if cfg.pipe.use_tile_ladder and cfg.pipe.rasterizer == "tiled":
        ladder_pol = LadderPolicy(n_buckets=cfg.pipe.ladder_buckets, margin=cfg.pipe.ladder_margin)

    def build_step():
        return make_dp_stage1_step(
            mesh, use_chamfer=frames[0].thinned is not None,
            use_motion_loss=o.gt_alpha_mask_as_dynamic_mask and frames[0].alpha_mask is not None,
            use_flow_loss=flow_store is not None, lambda_chamfer=o.lambda_deformed_node_prjection,
            lambda_dssim=o.lambda_dssim, max_per_tile=cfg.pipe.max_per_tile, isotropic=cfg.model.use_isotropic_gs,
            tile_ladder=ladder_pol.ladder if ladder_pol is not None else None,
        )

    step = build_step()
    sampler = FrameSampler(frames, rng)
    history = []
    densified_at = -B - 1  # the last iteration an event changed the clouds
    for it in range(0, o.iterations, B):
        uids = [sampler.sample(it + b, o.progressive_train, o.progressive_stage_ratio, o.progressive_stage_steps)
                for b in range(B)]
        arap_ts = draws.phase_b_batch(B)
        lam_arap = S.landmark_interpolate(NW.LAMBDA_ARAP_LANDMARKS, NW.LAMBDA_ARAP_STEPS, it)
        lam_motion = S.landmark_interpolate(o.lambda_motion_mask_landmarks, o.lambda_motion_mask_steps, it,
                                            interpolation="log")
        lam_flow = S.landmark_interpolate(o.lambda_optical_landmarks, o.lambda_optical_steps, it)
        batch = [frames[u] for u in uids]
        lam_flow_b = np.zeros(B, np.float32)
        if flow_store is not None:
            for b, u in enumerate(uids):
                sampled = flow_store.sample(u, rng) if it >= o.warm_up and lam_flow > 0 else None
                if sampled is not None:
                    lam_flow_b[b] = lam_flow
                fl, fm, pfid = sampled if sampled is not None else flow_store.no_partner(batch[b])
                batch[b] = dataclasses.replace(batch[b], flow=fl, flow_mask=fm, flow_partner_fid=pfid)
        state, metrics = step(
            state, stack_frames(batch), bg, _f32(gauss_lrs(it)), _f32(warp_lrs(it)), arap_ts,
            float(np.float32(lam_arap)), float(np.float32(lam_motion)), lam_flow_b,
            stage1_flags(warm=it < o.warm_up, active_sh=min(it // o.oneupSHdegree_step, cfg.model.sh_degree)),
        )
        steps_done = it // B
        if ladder_pol is not None:
            # the batch's overflow every step (one read): a stale ladder
            # truncates no longer than the step that shows it
            overflow = int(metrics["overflow_tiles"])
            if (ladder_pol.ladder is None or overflow > 0
                    or steps_done % max(cfg.pipe.ladder_check_every // B, 1) == 0 or it == densified_at + B):
                old = ladder_pol.ladder
                if ladder_pol.observe(metrics["tile_counts"].cpu().numpy(), overflow):
                    step = build_step()
                    log(it=it, event="ladder fit" if old is None else "ladder refit", ladder=ladder_pol.ladder)
        node_dp = (o.node_enable_densify_prune and o.node_densify_from_iter < it < o.node_densify_until_iter
                   and steps_done % max(o.node_densification_interval // B, 1) == 0
                   and it > o.warm_up) or (it <= o.node_force_densify_prune_step < it + B)
        if node_dp:
            before = state.warp.node_num
            state = node_densify_prune(state, cfg, o.densify_grad_threshold)
            densified_at = it
            log(it=it, event="node densify/prune", before=before, after=state.warp.node_num)
        if o.densify_from_iter < it < o.densify_until_iter and steps_done % max(o.densification_interval // B, 1) == 0:
            before = alive(state.gs)
            state = _gs_densify(state, draws, o, scene.cameras_extent, node=False)
            densified_at = it
            log(it=it, event="gs densify", before=before, after=alive(state.gs))
        if it > 0 and steps_done % max(o.opacity_reset_interval // B, 1) == 0:
            st = reset_opacity_step(Stage1TrainView(state.gs, state.opt_gs, state.stats_gs))
            state = dataclasses.replace(state, gs=st.gs, opt_gs=st.opt)
            log(it=it, event="opacity reset")
        if log_every and steps_done % max(log_every // B, 1) == 0:
            history.append(("Bdp", it, {k: float(v) for k, v in metrics.items() if v.dim() == 0}))
        if step_callback is not None:
            step_callback(state, it)
    return state, history
