"""Multi-resolution hash-grid encoding and the hash deform network.

Port of ``riggs_tpu/models/hash_encoding.py`` (the reference's optional
tinycudann path): L levels of hashed feature tables read with trilinear
weights (the instant-ngp construction), a coarse-to-fine level mask, and a
compact relu MLP with the three deformation heads. The reference writes it
in stock ops, and so does the port.

The instant-ngp hash multiplies uint32 corner coordinates by three primes
modulo 2^32 and XORs them. torch has no general uint32 arithmetic: the
products are taken in int64 (a coordinate is below 2^11, a prime below
2^32), masked to their low 32 bits, XORed, and masked to the table size, a
power of two. A table row's gradient is an index-add: on the card its
summation order is not fixed, so the card's table gradient may differ from
the CPU's in the last bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.models.mlp import MLP, embed_dim, linear_params, make_linear, positional_embed

_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridDef:
    n_levels: int = 16
    log2_table: int = 17
    features: int = 2
    base_res: int = 16
    max_res: int = 512
    in_dim: int = 3

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table

    @property
    def growth(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(np.exp(np.log(self.max_res / self.base_res) / (self.n_levels - 1)))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features

    def resolution(self, level: int) -> int:
        return int(np.floor(self.base_res * self.growth**level))


def init_hash_grid(grid: HashGridDef, generator: torch.Generator | None = None,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """(L, T, F) tables, uniform in [-1e-4, 1e-4) (the instant-ngp init)."""
    dev = resolve_device(device)
    u = torch.rand((grid.n_levels, grid.table_size, grid.features), generator=generator, device=dev)
    return u * 2e-4 - 1e-4


def hash_encode(
    tables: torch.Tensor,
    grid: HashGridDef,
    x: torch.Tensor,
    bbox_min: torch.Tensor | float = 0.0,
    bbox_max: torch.Tensor | float = 1.0,
    level_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """x: (N, D <= 3) -> (N, L * F) hashed trilinear features."""
    xn = (x - bbox_min) / (bbox_max - bbox_min)
    xn = torch.minimum(torch.maximum(xn, constant(0.0, xn)), constant(1.0, xn))  # jnp.clip's tie gradient
    D = grid.in_dim
    n = xn.shape[0]
    corners = np.stack(np.meshgrid(*([np.arange(2)] * D), indexing="ij"), -1).reshape(-1, D)
    outs = []
    for level in range(grid.n_levels):
        pos = xn * grid.resolution(level)
        p0 = torch.floor(pos)
        frac = pos - p0
        p0 = p0.to(torch.int64)
        feat = torch.zeros((n, grid.features), dtype=tables.dtype, device=tables.device)
        for corner in corners:
            h = torch.zeros(n, dtype=torch.int64, device=x.device)
            for d in range(D):
                h = h ^ (((p0[:, d] + int(corner[d])) * _PRIMES[d]) & 0xFFFFFFFF)
            idx = h & (grid.table_size - 1)
            w = frac[:, 0] if corner[0] else 1.0 - frac[:, 0]
            for d in range(1, D):
                w = w * (frac[:, d] if corner[d] else 1.0 - frac[:, d])
            feat = feat + w[:, None] * tables[level].index_select(0, idx)
        outs.append(feat)
    enc = torch.stack(outs, dim=1)  # (N, L, F)
    if level_mask is not None:
        enc = enc * level_mask[None, :, None]
    return enc.reshape(n, -1)


def progressive_level_mask(n_levels: int, step: int, start_level: int = 4, steps_per_level: int = 500) -> np.ndarray:
    """Coarse-to-fine unlock: level l is active once step >= (l - start_level) * steps_per_level."""
    active = start_level + step // max(steps_per_level, 1)
    return (np.arange(n_levels) < active).astype(np.float32)


# the heads: name -> (width out, init std), in the reference's key order
_HEADS = (("warp", 3, 1e-5), ("scaling", 3, 1e-8), ("rotation", 4, 1e-5))


class HashDeformNetwork(nn.Module):
    """Hash-grid features of x and the positional encoding of t through a
    relu trunk of ``depth`` layers of ``width``, then the d_xyz, d_scaling
    and d_rotation heads (normal inits of std 1e-5, 1e-8, 1e-5)."""

    def __init__(self, bbox_min=-1.5, bbox_max=1.5, grid: HashGridDef | None = None, t_multires: int = 6,
                 width: int = 64, depth: int = 2, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.grid = grid or HashGridDef()
        self.t_multires, self.width, self.depth = t_multires, width, depth
        self.tables = nn.Parameter(init_hash_grid(self.grid, generator, dev))
        d_in = self.grid.out_dim + embed_dim(1, t_multires)
        self.mlp = MLP(d_in, width, 0, depth, generator=generator, device=dev)
        for name, d_out, std in _HEADS:
            setattr(self, name, make_linear(width, d_out, "normal", std, generator=generator, device=dev))
        self.register_buffer("bbox_min", torch.full((), float(bbox_min), device=dev))
        self.register_buffer("bbox_max", torch.full((), float(bbox_max), device=dev))

    def params_dict(self) -> dict:
        """The parameters under the reference's tree (linear weights in
        ``nn.Linear``'s (d_out, d_in) layout)."""
        return {"tables": self.tables, "mlp": self.mlp.params_dict(),
                "heads": {name: linear_params(getattr(self, name)) for name, _, _ in _HEADS}}


def apply_hash_deform(net: HashDeformNetwork, x: torch.Tensor, t, level_mask: torch.Tensor | None = None) -> dict:
    """The deformation heads at x (N, 3) and time t (a scalar or (N, 1))."""
    if not isinstance(t, torch.Tensor):  # a fill on the device, not a host copy
        t = torch.full((), t, dtype=torch.float32, device=x.device)
    if t.dim() == 0:
        t = t.reshape(1, 1).expand(x.shape[0], 1)
    enc = hash_encode(net.tables, net.grid, x, net.bbox_min, net.bbox_max, level_mask)
    h = net.mlp.hidden(torch.cat([enc, positional_embed(t, net.t_multires)], dim=-1))
    return {
        "d_xyz": net.warp(h),
        "d_rotation": net.rotation(h),
        "d_scaling": net.scaling(h),
        "d_opacity": None,
        "d_color": None,
        "hidden": h,
    }
