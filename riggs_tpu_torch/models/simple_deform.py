"""Per-Gaussian MLP deformation ('mlp') and the static ('static') deform type.

Port of ``riggs_tpu/models/simple_deform.py``: ``MlpDeform`` holds the
port's ``DeformNetwork`` queried directly at every Gaussian position (the
D-3DGS / SC-GS baseline), ``mlp_deform_forward`` queries it (the positions
detached, the motion mask applied to the three heads), ``static_forward``
returns zero residuals.
"""
from __future__ import annotations

import torch
from torch import nn

from riggs_tpu_torch.models.deform_mlp import DeformNetwork, DeformNetworkDef
from riggs_tpu_torch.train.optim import tree_map


class MlpDeform(nn.Module):
    """The seeded DeformNetwork of the 'mlp' deform type."""

    def __init__(self, net: DeformNetworkDef | None = None, generator: torch.Generator | None = None,
                 device: torch.device | None = None):
        super().__init__()
        self.net = net or DeformNetworkDef()
        self.mlp = DeformNetwork(self.net, generator=generator, device=device)

    def params_dict(self) -> dict:
        """The parameters under the reference's tree: {"mlp": the
        DeformNetwork's tree}."""
        return {"mlp": self.mlp.params_dict()}

    @torch.no_grad()
    def replace_params(self, p: dict) -> "MlpDeform":
        """Write a tree of ``params_dict``'s structure into the module's
        parameters (in place; a tree of the module's own tensors is a no-op)."""
        tree_map(lambda dst, src: dst is src or dst.copy_(src), self.params_dict(), p)
        return self


def mlp_deform_forward(deform: MlpDeform, x: torch.Tensor, t, motion_mask: torch.Tensor | None = None,
                       band_mask: torch.Tensor | None = None) -> dict:
    """The deformation at each Gaussian. x: (N, 3), detached; t a scalar
    (python or () tensor) or (N, 1)."""
    if not isinstance(t, torch.Tensor):  # a fill on the device, not a host copy
        t = torch.full((), t, dtype=torch.float32, device=x.device)
    if t.dim() == 0:
        t = t.reshape(1, 1).expand(x.shape[0], 1)
    out = dict(deform.mlp(x.detach(), t, band_mask))
    if motion_mask is not None:
        for k in ("d_xyz", "d_rotation", "d_scaling"):
            out[k] = out[k] * motion_mask
    return out


def static_forward(x: torch.Tensor) -> dict:
    """Zero residuals (the reference's StaticNetwork)."""
    return {
        "d_xyz": torch.zeros_like(x),
        "d_rotation": torch.zeros(x.shape[:-1] + (4,), dtype=x.dtype, device=x.device),
        "d_scaling": torch.zeros_like(x),
        "d_opacity": None,
        "d_color": None,
    }
