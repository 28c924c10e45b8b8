"""Static 3DGS training, and the Gaussian densification events of every loop.

Port of ``riggs_tpu/train/static.py``: ``TrainState`` (a Gaussian cloud
with its Adam state and densification statistics), ``init_state``,
``make_lr_schedules``, ``train_step`` (render, photometric loss, Adam, the
densification statistics), ``densify_step`` (clone, split, prune by
opacity, fresh moments for the placed rows, fresh statistics),
``reset_opacity_step``, ``compute_scene_extent`` and the host loop
``train_static``.

Nothing here reads the card but ``train_static``'s log lines: the
densification's selections are masks and its placements scatters
(``models/gaussians.py``), the learning rates float32 values passed as
python scalars (kernel arguments, no copy). The split's noise is an
argument, drawn by the caller (``SplitDraws``, or a test replaying the
reference's keys).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.train import losses as L
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train import schedule as S
from riggs_tpu_torch.train.config import Config


@dataclasses.dataclass
class TrainState:
    gs: G.Gaussians
    opt: O.AdamState
    stats: G.DensifyStats


def init_state(gs: G.Gaussians) -> TrainState:
    return TrainState(gs=gs, opt=O.adam_init(gs.params_dict()), stats=G.init_densify_stats(gs.capacity, gs.device))


def make_lr_schedules(cfg: Config, spatial_lr_scale: float = 1.0) -> dict:
    """Per-group learning rate as a function of the iteration (float64, as
    the reference's host loop computes it)."""
    o = cfg.opt
    xyz = S.expon_lr(o.position_lr_init * spatial_lr_scale, o.position_lr_final * spatial_lr_scale,
                     lr_delay_mult=o.position_lr_delay_mult, max_steps=o.position_lr_max_steps)
    return {
        "xyz": xyz,
        "f_dc": lambda s: o.feature_lr,
        "f_rest": lambda s: o.feature_lr / 20.0,
        "opacity": lambda s: o.opacity_lr,
        "scaling": lambda s: o.scaling_lr,
        "rotation": lambda s: o.rotation_lr,
        "feature": lambda s: o.feature_lr,
    }


def f32_lrs(lr_fns: dict, it: int) -> dict:
    """The learning rates of iteration ``it`` rounded to float32 (the
    reference's ``jnp.asarray(fn(it), jnp.float32)``)."""
    return {k: float(np.float32(fn(it))) for k, fn in lr_fns.items()}


def train_step(
    state: TrainState,
    cam: Camera,
    gt_image: torch.Tensor,
    bg: torch.Tensor,
    lrs: dict,
    active_sh: int = 0,
    lambda_dssim: float = 0.2,
    rasterizer: str = "tiled",
    max_per_tile: int = 1024,
) -> tuple[TrainState, dict]:
    """One step: the photometric loss of the render, its gradient in the
    Gaussians and in ``mean2d_bias``, Adam, the densification statistics.
    Returns (new state, metrics): loss, psnr, num_alive, overflow (device
    tensors)."""
    params = {k: v.detach().requires_grad_(True) for k, v in state.gs.params_dict().items()}
    m2b = torch.zeros_like(state.gs.xyz[:, :2], requires_grad=True)
    out = render(cam, state.gs.replace_params(params), bg, active_sh_degree=active_sh, mean2d_bias=m2b,
                 rasterizer=rasterizer, max_per_tile=max_per_tile)
    loss = L.photometric_loss(out["render"], gt_image, lambda_dssim)
    gp, gm2b = O.grad_tree(loss, (params, m2b))
    with torch.no_grad():
        new_params, opt = O.adam_update(gp, state.opt, params, lrs)
        stats = G.add_densification_stats(state.stats, gm2b, out["radii"], out["visibility_filter"],
                                          cam.width, cam.height)
        metrics = {"loss": loss.detach(), "psnr": L.psnr(out["render"], gt_image),
                   "num_alive": state.gs.num_alive, "overflow": out["overflow"]}
    return TrainState(gs=state.gs.replace_params(new_params), opt=opt, stats=stats), metrics


@torch.no_grad()
def densify_step(
    state: TrainState,
    noise: torch.Tensor,
    grad_threshold: float,
    scene_extent: float,
    min_opacity: float = 0.005,
    max_screen_size: float = 0.0,
    percent_dense: float = 0.01,
) -> TrainState:
    """Clone the small and split the large Gaussians whose mean screen
    gradient reaches ``grad_threshold``, prune by opacity, zero the moments
    of every placed row and restart the statistics. ``noise``: the split's
    (n_split, C, 3) draws."""
    s = state.stats
    stats_grad = torch.where(s.denom > 0, s.xyz_gradient_accum / torch.clamp(s.denom, min=1.0), 0.0)
    gs, dest_c = G.densify_clone(state.gs, stats_grad, grad_threshold, scene_extent, percent_dense)
    gs, dest_s = G.densify_split(gs, stats_grad, grad_threshold, scene_extent, noise, percent_dense=percent_dense)
    gs = G.prune_by_opacity(gs, min_opacity, s.max_radii2d, max_screen_size, scene_extent)
    opt = O.zero_rows(state.opt, torch.cat([dest_c[None], dest_s], dim=0).reshape(-1))
    return TrainState(gs=gs, opt=opt, stats=G.init_densify_stats(gs.capacity, device=gs.device))


def reset_opacity_step(state: TrainState) -> TrainState:
    """Clamp the opacities to 0.01 and give their moments a fresh start
    (the reference's replace_tensor_to_optimizer)."""
    opt = state.opt
    opt = O.AdamState(mu=dict(opt.mu, opacity=torch.zeros_like(opt.mu["opacity"])),
                      nu=dict(opt.nu, opacity=torch.zeros_like(opt.nu["opacity"])), count=opt.count)
    return TrainState(gs=G.reset_opacity(state.gs), opt=opt, stats=state.stats)


def compute_scene_extent(cams) -> float:
    """NeRF++-style radius of the camera rig: 1.1 times the largest distance
    of a camera centre from their mean."""
    w2c = [c.w2c.detach().cpu().numpy().astype(np.float32) for c in cams]
    centers = np.stack([-m[:3, :3].T @ m[:3, 3] for m in w2c])
    center = centers.mean(0)
    return float(np.max(np.linalg.norm(centers - center, axis=-1)) * 1.1)


class SplitDraws:
    """A loop's densification noise from one ``torch.Generator`` seeded with
    ``seed`` on ``device``. A test replays the reference's key chain through
    an object with the same method."""

    def __init__(self, seed: int, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def split_noise(self, capacity: int) -> torch.Tensor:
        """A densification's split noise (2, capacity, 3)."""
        return G.split_noise(capacity, generator=self.gen, device=self.device)


def train_static(
    data: list,
    cfg: Config,
    iterations: int,
    init_points: np.ndarray,
    init_colors: np.ndarray,
    seed: int = 0,
    bg: torch.Tensor | None = None,
    log_every: int = 0,
    state: TrainState | None = None,
    draws=None,
    step_callback=None,
    device: str | torch.device | None = None,
):
    """Fit a Gaussian cloud to posed images ``data`` [(Camera, image (H, W,
    3))]; returns (state, history). Each step trains on a frame picked by
    ``np.random.default_rng(seed)``, as the reference's loop picks it; the
    Gaussians densify every ``densification_interval`` steps in
    [densify_from_iter, densify_until_iter) past 0 (the screen-size prune
    after the first opacity reset) and their opacities reset every
    ``opacity_reset_interval``. ``state`` replaces the initial state made
    from the point cloud, ``draws`` the ``SplitDraws(seed)`` of the split
    noise; ``step_callback(state, it)`` is called after every step. The
    host reads the card only for the ``log_every`` lines (history holds
    (it, scalar metrics)). Runs on ``cuda`` unless ``device`` says
    otherwise."""
    o = cfg.opt
    dev = resolve_device(device)
    if state is None:
        m = cfg.model
        state = init_state(G.create_from_pcd(init_points, init_colors, capacity=m.capacity,
                                             max_sh_degree=m.sh_degree, isotropic=m.use_isotropic_gs,
                                             with_motion_mask=m.gs_with_motion_mask, device=dev))
    draws = SplitDraws(seed, dev) if draws is None else draws
    lr_fns = make_lr_schedules(cfg)
    scene_extent = compute_scene_extent([c for c, _ in data])
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(bg, dtype=torch.float32, device=dev)
    images = [torch.as_tensor(img, dtype=torch.float32, device=dev) for _, img in data]  # one copy each, up front
    rng = np.random.default_rng(seed)
    history = []
    for it in range(iterations):
        i = rng.integers(len(data))
        state, metrics = train_step(
            state, data[i][0], images[i], bg, f32_lrs(lr_fns, it),
            active_sh=min(it // o.oneupSHdegree_step, cfg.model.sh_degree), lambda_dssim=o.lambda_dssim,
            rasterizer=cfg.pipe.rasterizer, max_per_tile=cfg.pipe.max_per_tile,
        )
        if o.densify_from_iter <= it < o.densify_until_iter and it % o.densification_interval == 0 and it > 0:
            # the screen-size prune starts after the first opacity reset
            state = densify_step(state, draws.split_noise(state.gs.capacity), o.densify_grad_threshold,
                                 scene_extent, max_screen_size=20.0 if it > o.opacity_reset_interval else 0.0,
                                 percent_dense=o.percent_dense)
        if it > 0 and it % o.opacity_reset_interval == 0:
            state = reset_opacity_step(state)
        if log_every and it % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((it, m))
            print(f"[{it}] loss={m['loss']:.4f} psnr={m['psnr']:.2f} alive={int(m['num_alive'])}")
        if step_callback is not None:
            step_callback(state, it)
    return state, history
