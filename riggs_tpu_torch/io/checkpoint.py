"""Checkpoints of whole training states, in the JAX package's file format.

Port of ``riggs_tpu/io/checkpoint.py:26-109``. A checkpoint is every leaf of
a ``Stage1State`` or ``Stage2State`` (parameters, alive masks, Adam moments
and counts, densification statistics, the iteration) in one ``.npz``, each
under the key ``jax.tree_util.keystr`` gives it in ``riggs_tpu``: a
dataclass field ``.gs.xyz``, a dict entry ``.skel.pose_mlp['layers'][0]['w']``,
a list item ``[0]``. The port cannot call ``keystr``; ``state_leaves`` is
the explicit table from its own leaves to those keys, and it stores each
linear weight as the reference's (d_in, d_out), the transpose of
``nn.Linear``'s. So a file either package writes loads into the other, bit
for bit. Static fields (SH degree, flags, net widths) are not leaves: the
template supplies them. Directory layout:

  <model_path>/point_cloud/iteration_N/point_cloud.ply   (interchange PLY)
  <model_path>/checkpoints/iteration_N/state.npz         (the whole state)
  <model_path>/skeleton_tree.npz                         (joints, parents, ...)
  <model_path>/cfg.json
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.io.ply import save_gaussians_ply
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train.stage1 import Stage1State, init_stage1
from riggs_tpu_torch.train.stage2 import Stage2State

_GS_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "feature", "alive")
_STATS_FIELDS = ("xyz_gradient_accum", "denom", "max_radii2d")


def _tree(tree, key: str, out: dict):
    """A params_dict-form tree's leaves under their reference keys; the
    ``w`` of a ``{"w", "b"}`` pair is an ``nn.Linear`` weight, stored
    transposed."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                out[f"{key}['{k}']"] = (v, k == "w" and set(tree) == {"w", "b"})
            else:
                _tree(v, f"{key}['{k}']", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _tree(v, f"{key}[{i}]", out)
    else:
        raise TypeError(f"{key}: unexpected {type(tree).__name__} in a parameter tree")


def _fields(obj, names, key: str, out: dict):
    for name in names:
        out[f"{key}.{name}"] = (getattr(obj, name), False)


def _adam(opt, key: str, out: dict):
    _tree(opt.mu, f"{key}.mu", out)
    _tree(opt.nu, f"{key}.nu", out)
    out[f"{key}.count"] = (opt.count, False)


def state_leaves(state: Stage1State | Stage2State) -> dict[str, tuple[torch.Tensor, bool]]:
    """Every leaf of a training state: reference key -> (the state's own
    tensor, whether it is stored transposed). Absent MLPs (no skinning MLP,
    no template offsets) have no leaves, as ``None`` has none in JAX."""
    out: dict = {}
    if isinstance(state, Stage2State):
        _fields(state.gs, _GS_FIELDS, ".gs", out)
        skel = state.skel
        _fields(skel, ("joints", "node_radius_log"), ".skel", out)
        for name in ("pose_mlp", "weight_mlp", "detail_mlp"):
            if getattr(skel, name) is not None:
                _tree(getattr(skel, name).params_dict(), f".skel.{name}", out)
        _fields(skel, ("control_nodes",), ".skel", out)
        _adam(state.opt_gs, ".opt_gs", out)
        _adam(state.opt_skel, ".opt_skel", out)
        _fields(state.stats_gs, _STATS_FIELDS, ".stats_gs", out)
        _fields(state, ("proj_loss", "it"), "", out)
    elif isinstance(state, Stage1State):
        _fields(state.gs, _GS_FIELDS, ".gs", out)
        _fields(state.node_gs, _GS_FIELDS, ".node_gs", out)
        _fields(state.warp, ("nodes", "node_radius_log", "node_weight_logit"), ".warp", out)
        _tree(state.warp.mlp.params_dict(), ".warp.mlp", out)
        for name in ("opt_gs", "opt_node", "opt_warp"):
            _adam(getattr(state, name), f".{name}", out)
        _fields(state.stats_gs, _STATS_FIELDS, ".stats_gs", out)
        _fields(state.stats_node, _STATS_FIELDS, ".stats_node", out)
        _fields(state, ("it",), "", out)
    else:
        raise TypeError(f"no checkpoint layout for {type(state).__name__}")
    return out


def state_to_numpy(state: Stage1State | Stage2State) -> dict[str, np.ndarray]:
    """The state's leaves as host arrays in the reference's layout."""
    return {k: (t.detach().cpu().numpy().T if tr else t.detach().cpu().numpy())
            for k, (t, tr) in state_leaves(state).items()}


def save_state_npz(path: str | Path, state: Stage1State | Stage2State):
    """One compressed ``.npz`` of every leaf (copies the state to the host:
    call it at events only)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **state_to_numpy(state))


def load_state_npz(path: str | Path, template: Stage1State | Stage2State):
    """A copy of ``template`` with every leaf read from ``path``, on the
    template's devices and in its dtypes. Raises ``KeyError`` for a leaf the
    file lacks and ``ValueError`` for one whose shape differs."""
    state = copy.deepcopy(template)
    with np.load(path) as data:
        for key, (t, transposed) in state_leaves(state).items():
            if key not in data.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            want = tuple(t.shape[::-1]) if transposed else tuple(t.shape)
            if arr.shape != want:
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template {want}")
            arr = arr.T.copy() if transposed else arr
            with torch.no_grad():  # fresh storage: no two leaves of the copy share one
                t.set_(torch.from_numpy(arr).to(device=t.device, dtype=t.dtype))
    return state


def stage1_template(scene, cfg, path: str | Path, device: str | torch.device | None = None) -> Stage1State:
    """``init_stage1``'s state with as many warp nodes as the stage-1 state
    file ``path`` holds (the node set of a trained state was sampled,
    densified and pruned): a template ``load_state_npz`` fills."""
    dev = resolve_device(device)
    template = init_stage1(scene, cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    with np.load(path) as data:
        n = data[".warp.nodes"].shape[0]
    w = template.warp
    if n != w.node_num:
        w = w.with_nodes(torch.zeros((n, w.nodes.shape[1]), device=dev), torch.zeros(n, device=dev),
                         torch.zeros((n, 1), device=dev))
        template.warp, template.opt_warp = w, O.adam_init(w.params_dict())
    return template


def save_skeleton_tree(model_path: str | Path, joints, parents, indices, template_idx: int):
    """skeleton_tree.npz under the reference's key names."""
    p = Path(model_path)
    p.mkdir(parents=True, exist_ok=True)
    np.savez(p / "skeleton_tree.npz", nodes=np.asarray(joints), parents=np.asarray(parents),
             indices=np.asarray(indices), template_idx=int(template_idx))


def load_skeleton_tree(model_path: str | Path):
    with np.load(Path(model_path) / "skeleton_tree.npz") as d:
        return d["nodes"], d["parents"], d["indices"], int(d["template_idx"])


def search_max_iteration(folder: str | Path) -> int | None:
    """The latest ``iteration_N`` subdirectory of ``folder``, or None."""
    folder = Path(folder)
    if not folder.exists():
        return None
    iters = [int(m.group(1)) for child in folder.iterdir() if (m := re.fullmatch(r"iteration_(\d+)", child.name))]
    return max(iters) if iters else None


def save_checkpoint(model_path: str | Path, iteration: int, state: Any, gs=None, cfg=None):
    """The whole state, and the interchange PLY of ``gs`` and ``cfg.json``
    when given."""
    base = Path(model_path)
    save_state_npz(base / "checkpoints" / f"iteration_{iteration}" / "state.npz", state)
    if gs is not None:
        save_gaussians_ply(base / "point_cloud" / f"iteration_{iteration}" / "point_cloud.ply", gs)
    if cfg is not None:
        (base / "cfg.json").write_text(cfg.to_json())


def load_checkpoint(model_path: str | Path, template: Any, iteration: int = -1) -> tuple[Any, int]:
    """(state, iteration) of the given or (``-1``) the latest checkpoint."""
    base = Path(model_path) / "checkpoints"
    it = search_max_iteration(base) if iteration == -1 else iteration
    if it is None:
        raise FileNotFoundError(f"no checkpoints under {base}")
    return load_state_npz(base / f"iteration_{it}" / "state.npz", template), it


def save_checkpoint_sharded(model_path: str | Path, iteration: int, state: Any):
    raise NotImplementedError("sharded checkpoints come with the multi-device port (ROADMAP A11)")


def load_checkpoint_sharded(model_path: str | Path, template: Any, iteration: int = -1):
    raise NotImplementedError("sharded checkpoints come with the multi-device port (ROADMAP A11)")
