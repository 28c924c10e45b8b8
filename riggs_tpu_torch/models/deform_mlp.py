"""DeformNetwork: the time-conditioned deformation MLP of stage 1.

Port of ``riggs_tpu/models/deform_mlp.py:38-133`` as an ``nn.Module``:

  * positional encodings: x with 10 frequencies, t with 6 (blender) or 10,
    or the progressive-band t encoding under a coarse-to-fine mask;
  * the blender path runs t's encoding through a two-layer timenet to 30;
  * the D = 8, W = 256 relu trunk with the skip-concat after layer D/2;
  * the heads d_xyz, d_scaling, d_rotation (and the optional
    local_rotation, d_opacity, d_color) with their tiny-std normal inits;
  * d_scaling bounded by tanh to log(max_d_scale) when max_d_scale > 0.

``params_dict`` gives the parameters under the reference's tree, linear
weights in ``nn.Linear``'s (d_out, d_in) layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from riggs_tpu_torch.models.mlp import (
    MLP, embed_dim, linear_params, make_linear, positional_embed, positional_embed_masked,
)


@dataclasses.dataclass(frozen=True)
class DeformNetworkDef:
    """Static architecture description."""

    is_blender: bool = True
    depth: int = 8
    width: int = 256
    multires_x: int = 10
    local_frame: bool = False
    pred_opacity: bool = False
    pred_color: bool = False
    progressive_band_time: bool = False
    max_d_scale: float = -1.0

    @property
    def t_multires(self) -> int:
        return 6 if self.is_blender else 10

    @property
    def skips(self) -> tuple:
        return (self.depth // 2,)

    @property
    def x_dim(self) -> int:
        return embed_dim(3, self.multires_x)

    @property
    def t_dim(self) -> int:
        # the masked (progressive-band) encoding has no raw channel
        return 2 * self.t_multires if self.progressive_band_time else embed_dim(1, self.t_multires)

    @property
    def time_out(self) -> int:
        return 30 if self.is_blender else self.t_dim


# the heads: name -> (width out, init std), in the reference's key order
_HEADS = (("warp", 3, 1e-5), ("scaling", 3, 1e-8), ("rotation", 4, 1e-5))
_OPTIONAL_HEADS = (("local_rotation", 4, 1e-4, "local_frame"), ("opacity", 1, 1e-5, "pred_opacity"),
                   ("color", 3, 1e-5, "pred_color"))


class DeformNetwork(nn.Module):
    """The seeded deformation MLP; ``forward(x (..., 3), t (..., 1))``."""

    def __init__(self, net: DeformNetworkDef, generator: torch.Generator | None = None,
                 device: torch.device | None = None):
        super().__init__()
        self.net = net
        self.trunk = MLP(net.x_dim + net.time_out, net.width, 0, net.depth, skips=net.skips,
                         generator=generator, device=device)
        for name, d_out, std in _HEADS:
            setattr(self, name, make_linear(net.width, d_out, "normal", std, generator=generator, device=device))
        self.timenet = None
        if net.is_blender:
            self.timenet = nn.ModuleList([
                make_linear(net.t_dim, 256, "torch_default", generator=generator, device=device),
                make_linear(256, net.time_out, "torch_default", generator=generator, device=device),
            ])
        for name, d_out, std, flag in _OPTIONAL_HEADS:
            on = getattr(net, flag)
            setattr(self, name, make_linear(net.width, d_out, "normal", std, generator=generator, device=device)
                    if on else None)

    def params_dict(self) -> dict:
        p = {"trunk": self.trunk.params_dict()}
        p.update({name: linear_params(getattr(self, name)) for name, _, _ in _HEADS})
        if self.timenet is not None:
            p["timenet"] = [linear_params(lin) for lin in self.timenet]
        for name, _, _, flag in _OPTIONAL_HEADS:
            if getattr(self.net, flag):
                p[name] = linear_params(getattr(self, name))
        return p

    def forward(self, x: torch.Tensor, t: torch.Tensor, band_mask: torch.Tensor | None = None) -> dict:
        net = self.net
        if net.progressive_band_time:
            mask = band_mask if band_mask is not None else torch.ones(net.t_multires, device=t.device)
            t_emb = positional_embed_masked(t, net.t_multires, mask)
        else:
            t_emb = positional_embed(t, net.t_multires)
        if self.timenet is not None:
            t_emb = self.timenet[1](torch.relu(self.timenet[0](t_emb)))
        h = self.trunk.hidden(torch.cat([positional_embed(x, net.multires_x), t_emb], dim=-1))
        d_scaling = self.scaling(h)
        if net.max_d_scale > 0:
            d_scaling = torch.tanh(d_scaling) * float(np.log(net.max_d_scale))
        out = {
            "d_xyz": self.warp(h),
            "d_rotation": self.rotation(h),
            "d_scaling": d_scaling,
            "hidden": h,
            "d_opacity": self.opacity(h) if net.pred_opacity else None,
            "d_color": self.color(h) if net.pred_color else None,
        }
        if net.local_frame:
            out["local_rotation"] = self.local_rotation(h)
        return out
