"""Trainer of the 'mlp' deform type (the per-Gaussian DeformNetwork baseline).

Port of ``riggs_tpu/train/mlp_deform.py``: ``MlpDeformState``,
``mlp_deform_step`` and the host loop ``train_mlp_deform``. A warm-up
renders the canonical Gaussians (the deformation weighted by 0), then the
Gaussians and the time-conditioned MLP queried at every Gaussian train on
the photometric loss, with the usual densification.

During the warm-up the reference selects the old deform weights and Adam
state after its update, so neither changes by a bit. The port takes the
warm-up from the host iteration and skips the deform's gradient and update
then: the same bits, and no work on a frozen network. Nothing in a step
reads the card; the split noise of each densification is an argument
(``SplitDraws``, or a test replaying the reference's keys).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.data.dataset import Frame, SceneData
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef
from riggs_tpu_torch.models.simple_deform import MlpDeform, mlp_deform_forward
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.static import SplitDraws, TrainState, densify_step


@dataclasses.dataclass
class MlpDeformState:
    gs: G.Gaussians
    deform: MlpDeform
    opt_gs: O.AdamState
    opt_deform: O.AdamState
    stats: G.DensifyStats


def mlp_deform_step(
    state: MlpDeformState,
    frame: Frame,
    bg: torch.Tensor,
    lrs_gs: dict,
    lrs_deform: float,
    warm: bool = False,
    active_sh: int = 0,
    lambda_dssim: float = 0.2,
    max_per_tile: int = 1024,
) -> tuple[MlpDeformState, dict]:
    """One step: the Gaussians deformed by the MLP (weighted by 0 while
    ``warm``) rendered against the frame; Adam on the Gaussians and, past
    the warm-up, on the MLP (written into ``state.deform`` in place); the
    densification statistics. Returns (new state, metrics)."""
    gs_p = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
    deform_p = state.deform.params_dict()
    m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
    gs = state.gs.replace_params(gs_p)
    w = 0.0 if warm else 1.0
    d = mlp_deform_forward(state.deform, gs.xyz, frame.fid, gs.motion_mask)
    out = render(frame.cam, gs, bg, d_xyz=w * d["d_xyz"], d_rotation=w * d["d_rotation"],
                 d_scaling=w * d["d_scaling"], active_sh_degree=active_sh, mean2d_bias=m2b,
                 max_per_tile=max_per_tile)
    loss = L.photometric_loss(out["render"], frame.image, lambda_dssim)
    if warm:
        gp, gm2b = O.grad_tree(loss, (gs_p, m2b))
    else:
        gp, gd, gm2b = O.grad_tree(loss, (gs_p, deform_p, m2b))
    with torch.no_grad():
        new_gs_p, opt_gs = O.adam_update(gp, state.opt_gs, gs_p, lrs_gs)
        opt_deform = state.opt_deform
        if not warm:
            new_d_p, opt_deform = O.adam_update(gd, state.opt_deform, deform_p, lrs_deform)
            state.deform.replace_params(new_d_p)
        stats = G.add_densification_stats(state.stats, gm2b, out["radii"], out["visibility_filter"],
                                          frame.cam.width, frame.cam.height)
        metrics = {"loss": loss.detach(), "psnr": L.psnr(out["render"], frame.image), "n_gs": state.gs.num_alive}
    new_state = MlpDeformState(gs=state.gs.replace_params(new_gs_p), deform=state.deform, opt_gs=opt_gs,
                               opt_deform=opt_deform, stats=stats)
    return new_state, metrics


def stage1_lr_fns(cfg: Config):
    """(gauss_lrs(it), deform_lr(it)): the reference's host ``stage1_lr_fns``
    (float64) rounded to float32, the Gaussians' groups and the MLP's."""
    o = cfg.opt
    f32 = lambda v: float(np.float32(v))
    mlp_sched = S.expon_lr(o.position_lr_init * 5.0 * o.deform_lr_scale, o.position_lr_final * o.deform_lr_scale,
                           lr_delay_mult=o.position_lr_delay_mult, max_steps=o.deform_lr_max_steps)
    gs_xyz = S.expon_lr(o.position_lr_init, o.position_lr_final, lr_delay_mult=o.position_lr_delay_mult,
                        max_steps=o.position_lr_max_steps)

    def gauss_lrs(it):
        return {"xyz": f32(gs_xyz(it)), "f_dc": f32(o.feature_lr), "f_rest": f32(o.feature_lr / 20.0),
                "opacity": f32(o.opacity_lr), "scaling": f32(o.scaling_lr), "rotation": f32(o.rotation_lr),
                "feature": f32(o.feature_lr)}

    return gauss_lrs, lambda it: f32(mlp_sched(it))


def init_mlp_deform_state(scene: SceneData, cfg: Config, generator: torch.Generator | None = None,
                          device: str | torch.device | None = None) -> MlpDeformState:
    """The Gaussians from the scene's cloud and a DeformNetwork (the scene's
    blender flag) seeded from ``generator``, with fresh Adam states."""
    m = cfg.model
    gs = G.create_from_pcd(scene.init_points, scene.init_colors, capacity=m.capacity, max_sh_degree=m.sh_degree,
                           isotropic=m.use_isotropic_gs, fea_dim=m.hyper_dim,
                           with_motion_mask=m.gs_with_motion_mask, device=device)
    deform = MlpDeform(DeformNetworkDef(is_blender=scene.is_blender), generator=generator, device=gs.device)
    return MlpDeformState(gs=gs, deform=deform, opt_gs=O.adam_init(gs.params_dict()),
                          opt_deform=O.adam_init(deform.params_dict()),
                          stats=G.init_densify_stats(gs.capacity, gs.device))


def train_mlp_deform(
    scene: SceneData,
    cfg: Config,
    seed: int = 0,
    log_every: int = 0,
    state: MlpDeformState | None = None,
    draws=None,
    step_callback=None,
    device: str | torch.device | None = None,
):
    """Train the 'mlp' deform type for ``iterations`` steps; returns (state,
    history). Frames are picked by ``np.random.default_rng(seed)``, as the
    reference picks them; the first ``warm_up`` steps keep the MLP frozen;
    the Gaussians densify every ``densification_interval`` steps strictly
    between densify_from_iter and densify_until_iter. ``state`` replaces
    ``init_mlp_deform_state``'s (seeded from ``seed``), ``draws`` the
    ``SplitDraws(seed)`` of the split noise; ``step_callback(state, it)``
    is called after every step. The host reads the card only for the
    ``log_every`` lines. Runs on ``cuda`` unless ``device`` says otherwise."""
    o = cfg.opt
    dev = resolve_device(device)
    if state is None:
        state = init_mlp_deform_state(scene, cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    draws = SplitDraws(seed, dev) if draws is None else draws
    gauss_lrs, deform_lr = stage1_lr_fns(cfg)
    bg = torch.ones(3, device=dev) if scene.white_background else torch.zeros(3, device=dev)
    rng = np.random.default_rng(seed)
    history = []
    for it in range(o.iterations):
        frame = scene.train_frames[rng.integers(len(scene.train_frames))]
        state, metrics = mlp_deform_step(
            state, frame, bg, gauss_lrs(it), deform_lr(it), warm=it < o.warm_up,
            active_sh=min(it // o.oneupSHdegree_step, cfg.model.sh_degree), lambda_dssim=o.lambda_dssim,
            max_per_tile=cfg.pipe.max_per_tile,
        )
        if o.densify_from_iter < it < o.densify_until_iter and it % o.densification_interval == 0:
            st = densify_step(TrainState(state.gs, state.opt_gs, state.stats), draws.split_noise(state.gs.capacity),
                              o.densify_grad_threshold, scene.cameras_extent, percent_dense=o.percent_dense)
            state = dataclasses.replace(state, gs=st.gs, opt_gs=st.opt, stats=st.stats)
        if log_every and it % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((it, m))
            print(f"[mlp {it}] loss={m['loss']:.4f} psnr={m['psnr']:.2f}")
        if step_callback is not None:
            step_callback(state, it)
    return state, history
