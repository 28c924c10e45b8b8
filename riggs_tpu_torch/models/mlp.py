"""MLP building blocks: positional embedding, seeded inits, skip-concat MLP.

Port of ``riggs_tpu/models/mlp.py``. The reference keeps weights as (d_in,
d_out) arrays; ``nn.Linear`` keeps (d_out, d_in), so converted weights are
transposed (see ``riggs_tpu_torch/convert.py``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


def embed_dim(input_dim: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dim * (2 * num_freqs + (1 if include_input else 0))


def positional_embed(x: torch.Tensor, num_freqs: int, include_input: bool = True) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{m-1} x), cos(2^{m-1} x)]: per
    frequency a block of sines, then a block of cosines."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., F, D)
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)  # (..., F, 2D)
    enc = enc.reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, enc], dim=-1) if include_input else enc


def progressive_band_mask(num_freqs: int, step: int, n_masking_step: int) -> np.ndarray:
    """Coarse-to-fine frequency mask (the reference's ProgressiveBandFrequency)."""
    if n_masking_step <= 0:
        return np.ones(num_freqs, np.float32)
    x = np.clip(step / n_masking_step * num_freqs - np.arange(num_freqs), 0, 1)
    return ((1.0 - np.cos(np.pi * x)) / 2.0).astype(np.float32)


def positional_embed_masked(x: torch.Tensor, num_freqs: int, mask: torch.Tensor) -> torch.Tensor:
    """Progressive-band encoding: the sin/cos blocks scaled per frequency by
    ``mask``, with no raw input channel."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1) * mask[:, None]
    return enc.reshape(x.shape[:-1] + (-1,))


def make_linear(
    d_in: int,
    d_out: int,
    kind: str = "kaiming",
    std: float = 1e-5,
    generator: torch.Generator | None = None,
    device: torch.device | None = None,
) -> nn.Linear:
    """One seeded linear layer.

    kind='kaiming': kaiming-uniform fan-in relu weights (bound sqrt(6/fan_in)),
    zero bias; 'normal': N(0, std) weights, zero bias; 'torch_default':
    uniform +-1/sqrt(fan_in) weights and bias."""
    lin = nn.Linear(d_in, d_out, device=device)
    with torch.no_grad():
        if kind == "kaiming":
            bound = math.sqrt(6.0 / d_in)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.zero_()
        elif kind == "normal":
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.zero_()
        elif kind == "torch_default":
            bound = 1.0 / math.sqrt(d_in)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
        else:
            raise ValueError(kind)
    return lin


def linear_params(lin: nn.Linear) -> dict:
    """One layer's parameters under the reference's keys."""
    return {"w": lin.weight, "b": lin.bias}


class MLP(nn.Module):
    """Relu MLP with NeRF-style skip concats: after layer i in ``skips`` the
    trunk continues on ``[x, h]``. ``d_out == 0`` builds the trunk only."""

    def __init__(
        self,
        d_in: int,
        d_hidden: int,
        d_out: int,
        depth: int,
        skips: Sequence[int] = (),
        out_kind: str = "normal",
        out_std: float = 1e-5,
        hidden_kind: str = "kaiming",
        generator: torch.Generator | None = None,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.skips = tuple(skips)
        layers = []
        for i in range(depth):
            di = d_in if i == 0 else (d_hidden + d_in if (i - 1) in self.skips else d_hidden)
            layers.append(make_linear(di, d_hidden, hidden_kind, generator=generator, device=device))
        self.layers = nn.ModuleList(layers)
        self.head = (
            make_linear(d_hidden, d_out, out_kind, out_std, generator=generator, device=device)
            if d_out > 0
            else None
        )

    def params_dict(self) -> dict:
        """The parameters under the reference's tree: {"layers": [{"w", "b"},
        ...], "head": {"w", "b"}}. ``w`` is ``nn.Linear``'s (d_out, d_in)
        weight, the transpose of the reference's (d_in, d_out)."""
        p = {"layers": [linear_params(lin) for lin in self.layers]}
        if self.head is not None:
            p["head"] = linear_params(self.head)
        return p

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([x, h], dim=-1)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.hidden(x))
