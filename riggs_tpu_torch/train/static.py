"""Gaussian densification events of the training loops.

Port of ``riggs_tpu/train/static.py:29-34, 105-140``: ``TrainState`` (a
Gaussian cloud with its Adam state and densification statistics),
``densify_step`` (clone, split, prune by opacity, fresh moments for the
placed rows, fresh statistics), ``reset_opacity_step`` and
``compute_scene_extent``. The static trainer itself (``train_step``,
``train_static``) is not ported yet.

An event reads nothing from the card: the selections are masks and the
placements scatters (``models/gaussians.py``). The split's noise is an
argument, drawn by the caller (``gaussians.split_noise``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.models import gaussians as G
from riggs_tpu_torch.train import optim as O


@dataclasses.dataclass
class TrainState:
    gs: G.Gaussians
    opt: O.AdamState
    stats: G.DensifyStats


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
