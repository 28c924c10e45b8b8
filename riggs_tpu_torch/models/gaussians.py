"""Canonical Gaussian cloud: a capacity-padded tensor container.

Port of ``riggs_tpu/models/gaussians.py:40-184`` (the container, its
activations, its parameter tree and ``create_from_pcd``) and ``:302-328``
(the densification statistics). Every tensor's leading dimension is the
capacity C; ``alive`` marks the used slots. Densification itself (clone,
split, prune) comes with a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.ops.knn import mean_knn_dist2
from riggs_tpu_torch.ops.quaternion import quat_normalize
from riggs_tpu_torch.ops.sh import rgb_to_sh_dc, sh_dim


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass
class Gaussians:
    xyz: torch.Tensor  # (C, 3)
    features_dc: torch.Tensor  # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor  # (C, 1) isotropic or (C, 3); log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quat
    opacity: torch.Tensor  # (C, 1) logit
    feature: torch.Tensor  # (C, F) hyper coords + motion-mask logit (F may be 0)
    alive: torch.Tensor  # (C,) bool
    max_sh_degree: int
    isotropic: bool
    with_motion_mask: bool
    # every splat shares the mean log-scale (node Gaussians)
    shared_scale: bool = False

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def get_scaling(self) -> torch.Tensor:
        s = self.scaling
        if self.isotropic:
            s = s[:, :1].repeat(1, 3)
        if self.shared_scale:
            mean = torch.sum(torch.where(self.alive[:, None], s, 0.0)) / torch.clamp(
                3 * torch.sum(self.alive), min=1
            )
            s = mean.expand(s.shape)
        return torch.exp(s)

    @property
    def get_rotation(self) -> torch.Tensor:
        return quat_normalize(self.rotation)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def motion_mask(self) -> torch.Tensor:
        if self.with_motion_mask and self.feature.shape[-1] > 0:
            return torch.sigmoid(self.feature[:, -1:])
        return torch.ones_like(self.xyz[:, :1])

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    def params_dict(self) -> dict[str, torch.Tensor]:
        """The trainable tensors (alive mask excluded), under the reference's keys."""
        return {
            "xyz": self.xyz,
            "f_dc": self.features_dc,
            "f_rest": self.features_rest,
            "scaling": self.scaling,
            "rotation": self.rotation,
            "opacity": self.opacity,
            "feature": self.feature,
        }

    def replace_params(self, p: dict[str, torch.Tensor]) -> "Gaussians":
        return dataclasses.replace(
            self,
            xyz=p["xyz"],
            features_dc=p["f_dc"],
            features_rest=p["f_rest"],
            scaling=p["scaling"],
            rotation=p["rotation"],
            opacity=p["opacity"],
            feature=p["feature"],
        )


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    max_sh_degree: int = 3,
    isotropic: bool = False,
    fea_dim: int = 0,
    with_motion_mask: bool = True,
    shared_scale: bool = False,
    device: str | torch.device | None = None,
) -> Gaussians:
    """Gaussians from a point cloud: log-scales from the mean squared
    distance to the 3 nearest points (clamped at 1e-7), opacity 0.1,
    identity quaternions (in the dead slots too: a zero quaternion has a
    degenerate normalization gradient), DC colour, features -1e-2 with the
    motion-mask logit at 0."""
    dev = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")
    if with_motion_mask:
        fea_dim += 1
    pts = torch.tensor(np.asarray(points), dtype=torch.float32, device=dev)
    dist2 = torch.clamp(mean_knn_dist2(pts, k=3), min=1e-7)
    log_scale = 0.5 * torch.log(dist2)

    def pad(a):
        return torch.cat([a, torch.zeros((capacity - n,) + a.shape[1:], dtype=a.dtype, device=dev)])

    feature = torch.full((n, fea_dim), -1e-2, device=dev)
    if with_motion_mask:
        feature[:, -1] = 0.0
    rotation = torch.zeros((capacity, 4), device=dev)
    rotation[:, 0] = 1.0
    colors = torch.tensor(np.asarray(colors), dtype=torch.float32, device=dev)
    return Gaussians(
        xyz=pad(pts),
        features_dc=pad(rgb_to_sh_dc(colors)[:, None, :]),
        features_rest=torch.zeros((capacity, sh_dim(max_sh_degree) - 1, 3), device=dev),
        scaling=pad(log_scale[:, None].repeat(1, 1 if isotropic else 3)),
        rotation=rotation,
        opacity=pad(inverse_sigmoid(torch.full((n, 1), 0.1, device=dev))),
        feature=pad(feature),
        alive=torch.arange(capacity, device=dev) < n,
        max_sh_degree=max_sh_degree,
        isotropic=isotropic,
        with_motion_mask=with_motion_mask,
        shared_scale=shared_scale,
    )


@dataclasses.dataclass
class DensifyStats:
    """Screen-space gradient statistics driving clone/split decisions."""

    xyz_gradient_accum: torch.Tensor  # (C,)
    denom: torch.Tensor  # (C,)
    max_radii2d: torch.Tensor  # (C,)


def init_densify_stats(capacity: int, device: str | torch.device | None = None) -> DensifyStats:
    dev = resolve_device(device)
    z = lambda: torch.zeros(capacity, dtype=torch.float32, device=dev)
    return DensifyStats(xyz_gradient_accum=z(), denom=z(), max_radii2d=z())


def add_densification_stats(
    stats: DensifyStats,
    screen_grad: torch.Tensor,
    radii: torch.Tensor,
    visible: torch.Tensor,
    width: int | None = None,
    height: int | None = None,
) -> DensifyStats:
    """Accumulate the norm of the screen-space mean gradients of visible splats.

    ``screen_grad`` is dL/d(mean2d) in pixels (``mean2d_bias``'s gradient).
    The reference CUDA rasterizer's threshold (densify_grad_threshold 2e-4)
    is calibrated to NDC units, so with the render's width and height the
    gradient is scaled by 0.5 * [W, H] first."""
    g = screen_grad[:, :2]
    if width is not None:
        g = g * constant((0.5 * width, 0.5 * height), g)
    gnorm = torch.linalg.norm(g, dim=-1)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + torch.where(visible, gnorm, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(stats.max_radii2d, torch.where(visible, radii, 0.0)),
    )
