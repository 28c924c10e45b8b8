"""Canonical Gaussian cloud: a capacity-padded tensor container.

Port of ``riggs_tpu/models/gaussians.py:40-184`` (the container, its
activations, its parameter tree and ``create_from_pcd``), ``:192-300``
(densification: clone, split, prune, FPS pruning, the opacity reset) and
``:302-328`` (the densification statistics). Every tensor's leading
dimension is the capacity C; ``alive`` marks the used slots.

Densification is a masked scatter into free slots, as in the reference: no
tensor changes size and nothing reads the card. A row that finds no free
slot is dropped (its destination is C, a spare row cut off after the
write). The split's noise, one (C, 3) standard normal draw per child, is an
argument (``split_noise`` draws it from a ``torch.Generator``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.ops.fps import farthest_point_sample
from riggs_tpu_torch.ops.knn import mean_knn_dist2
from riggs_tpu_torch.ops.quaternion import quat_normalize, quat_to_rotmat
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


def _free_slot_map(alive: torch.Tensor, selected: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Map the k-th selected row to the k-th free slot (free slots in index
    order). Returns (dest (C,) int64, C where the row is not placed; ok (C,),
    the selected rows that got a slot)."""
    C = alive.shape[0]
    free_order = torch.argsort(alive.to(torch.int8), stable=True)  # free slots first, as jnp.argsort
    n_free = C - torch.sum(alive)
    k = torch.cumsum(selected.to(torch.int64), 0) - 1  # rank among the selected
    ok = selected & (k < n_free)
    dest = torch.where(ok, free_order[torch.clamp(k, 0, C - 1)], C)
    return dest, ok


def _scatter_rows(gs: Gaussians, dest: torch.Tensor, rows: dict[str, torch.Tensor]) -> Gaussians:
    """Write ``rows[k][i]`` into slot ``dest[i]`` of every parameter and mark
    it alive; writes to slot C are dropped (a (C + 1)-row buffer, cut)."""
    C = gs.capacity

    def put(a, r):
        buf = torch.cat([a, a[:1]])
        buf[dest] = r
        return buf[:C]

    p = gs.params_dict()
    newp = {k: put(p[k], rows[k]) for k in p}
    alive = put(gs.alive, torch.ones_like(gs.alive))
    return dataclasses.replace(gs.replace_params(newp), alive=alive)


def densify_clone(
    gs: Gaussians,
    stats_grad: torch.Tensor,
    grad_threshold: float,
    scene_extent: float,
    percent_dense: float = 0.01,
) -> tuple[Gaussians, torch.Tensor]:
    """Clone the small high-gradient Gaussians into free slots. Returns
    (gs, dest)."""
    max_scale = torch.amax(gs.get_scaling, dim=1)
    selected = gs.alive & (stats_grad >= grad_threshold) & (max_scale <= percent_dense * scene_extent)
    dest, _ = _free_slot_map(gs.alive, selected)
    return _scatter_rows(gs, dest, gs.params_dict()), dest


def split_noise(capacity: int, n_split: int = 2, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """``densify_split``'s draws: (n_split, C, 3) standard normals, one
    (C, 3) draw per child."""
    return torch.randn((n_split, capacity, 3), generator=generator, device=resolve_device(device))


def densify_split(
    gs: Gaussians,
    stats_grad: torch.Tensor,
    grad_threshold: float,
    scene_extent: float,
    noise: torch.Tensor,
    percent_dense: float = 0.01,
) -> tuple[Gaussians, torch.Tensor]:
    """Split the large high-gradient Gaussians: child i of each at
    R (noise[i] * scale) + xyz in a fresh free slot, its scale divided by
    0.8 n_split; then every selected parent dies (placed children or not,
    as the reference's code does). ``noise``: (n_split, C, 3). Returns
    (gs, dests (n_split, C))."""
    n_split = noise.shape[0]
    max_scale = torch.amax(gs.get_scaling, dim=1)
    selected = gs.alive & (stats_grad >= grad_threshold) & (max_scale > percent_dense * scene_extent)
    scales = gs.get_scaling
    R = quat_to_rotmat(gs.rotation)
    dests = []
    for i in range(n_split):
        new_xyz = torch.einsum("nab,nb->na", R, noise[i] * scales) + gs.xyz
        new_scaling = torch.log(scales / (0.8 * n_split))
        if gs.isotropic:
            new_scaling = new_scaling[:, :1]
        rows = dict(gs.params_dict(), xyz=new_xyz, scaling=new_scaling)
        dest, _ = _free_slot_map(gs.alive, selected)  # after the previous child's scatter
        gs = _scatter_rows(gs, dest, rows)
        dests.append(dest)
    gs = dataclasses.replace(gs, alive=gs.alive & ~selected)
    return gs, torch.stack(dests)


def prune(gs: Gaussians, prune_mask: torch.Tensor) -> Gaussians:
    return dataclasses.replace(gs, alive=gs.alive & ~prune_mask)


def prune_by_opacity(
    gs: Gaussians,
    min_opacity: float,
    max_radii2d: torch.Tensor | None = None,
    max_screen_size: float = 0.0,
    scene_extent: float = 0.0,
) -> Gaussians:
    """Kill the Gaussians below ``min_opacity``; with ``max_screen_size``,
    also those whose 2D radius exceeded it or whose largest scale exceeds a
    tenth of the scene extent."""
    m = gs.get_opacity[:, 0] < min_opacity
    if max_screen_size > 0.0 and max_radii2d is not None:
        m = m | (max_radii2d > max_screen_size)
        m = m | (torch.amax(gs.get_scaling, dim=1) > 0.1 * scene_extent)
    return prune(gs, m)


def sampling_and_prune(gs: Gaussians, num_sample: int) -> Gaussians:
    """Keep only an FPS subset of ``num_sample`` alive Gaussians."""
    idx = farthest_point_sample(gs.xyz, num_sample, mask=gs.alive).to(torch.int64)
    keep = torch.zeros(gs.capacity, dtype=torch.bool, device=gs.device).index_fill_(0, idx, True)
    return dataclasses.replace(gs, alive=gs.alive & keep)


def reset_opacity(gs: Gaussians, max_opacity: float = 0.01) -> Gaussians:
    """Clamp every opacity logit to at most logit(max_opacity)."""
    cap = float(np.log(np.float32(max_opacity / (1.0 - max_opacity))))  # inverse_sigmoid in f32
    return dataclasses.replace(gs, opacity=torch.minimum(gs.opacity, constant(cap, gs.opacity)))


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
