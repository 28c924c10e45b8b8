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
  <model_path>/sharded/iteration_N/                      (the sharded pair)
  <model_path>/skeleton_tree.npz                         (joints, parents, ...)
  <model_path>/cfg.json

The sharded pair (``save_checkpoint_sharded`` / ``load_checkpoint_sharded``,
the reference's orbax pair at ``riggs_tpu/io/checkpoint.py:112-173``) writes
a state (or a dict of tensors) from the ranks of a process group, each rank
only what it owns: rank 0 the replicated leaves (``replicated.npz``), and
the first rank of each data row its rows of each data-sharded leaf (a
``parallel.mesh.LocalRows`` of a tensor, as ``multihost.global_batch``
returns it) in ``data<d>.npz``; rank 0 also a ``manifest.json`` of every
leaf's global shape, dtype and layout. Zero-size leaves (the (C, 0) feature planes at
hyper_dim 0) are ordinary leaves here. A checkpoint saved on any number of
ranks loads on one or on a mesh of any data size that divides the rows.
"""
from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.io.ply import save_gaussians_ply
from riggs_tpu_torch.parallel.mesh import LocalRows, Mesh
from riggs_tpu_torch.train import optim as O
from riggs_tpu_torch.train.stage1 import Stage1State, init_stage1, stage1_leaves
from riggs_tpu_torch.train.stage2 import Stage2State, stage2_leaves


def state_leaves(state: Stage1State | Stage2State) -> dict[str, tuple[torch.Tensor, bool]]:
    """Every leaf of a training state: reference key -> (the state's own
    tensor, whether it is stored transposed). Absent MLPs (no skinning MLP,
    no template offsets) have no leaves, as ``None`` has none in JAX."""
    if isinstance(state, Stage2State):
        return stage2_leaves(state)
    if not isinstance(state, Stage1State):
        raise TypeError(f"no checkpoint layout for {type(state).__name__}")
    return stage1_leaves(state)


def state_to_numpy(state: Stage1State | Stage2State) -> dict[str, np.ndarray]:
    """The state's leaves as host arrays in the reference's layout."""
    return {k: (t.detach().cpu().numpy().T if tr else t.detach().cpu().numpy())
            for k, (t, tr) in state_leaves(state).items()}


def save_state_npz(path: str | Path, state: Stage1State | Stage2State):
    """One compressed ``.npz`` of every leaf (copies the state to the host:
    call it at events only)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **state_to_numpy(state))


def _fill_state(template: Stage1State | Stage2State, read) -> Stage1State | Stage2State:
    """A copy of ``template`` with every leaf ``read(key)`` (a host array in
    the reference's layout, or None when absent), on the template's devices
    and in its dtypes."""
    state = copy.deepcopy(template)
    for key, (t, transposed) in state_leaves(state).items():
        arr = read(key)
        if arr is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        want = tuple(t.shape[::-1]) if transposed else tuple(t.shape)
        if arr.shape != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template {want}")
        arr = arr.T.copy() if transposed else arr
        with torch.no_grad():  # fresh storage: no two leaves of the copy share one
            t.set_(torch.from_numpy(arr).to(device=t.device, dtype=t.dtype))
    return state


def load_state_npz(path: str | Path, template: Stage1State | Stage2State):
    """A copy of ``template`` with every leaf read from ``path``, on the
    template's devices and in its dtypes. Raises ``KeyError`` for a leaf the
    file lacks and ``ValueError`` for one whose shape differs."""
    with np.load(path) as data:
        return _fill_state(template, lambda key: data[key] if key in data.files else None)


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


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _rows(leaf: LocalRows, mesh: Mesh | None) -> torch.Tensor:
    """The tensor of a ``LocalRows`` leaf, which must hold the rows of
    ``mesh``'s data row."""
    if not isinstance(leaf.tree, torch.Tensor):
        raise TypeError(f"a sharded checkpoint's LocalRows leaf holds one tensor, not {type(leaf.tree).__name__}")
    if mesh is None or (leaf.data, leaf.index) != (mesh.shape["data"], mesh.data):
        raise ValueError(f"rows of data row {leaf.index} of {leaf.data} without that row's mesh")
    return leaf.tree


def save_checkpoint_sharded(model_path: str | Path, iteration: int, state: Any, mesh: Mesh | None = None):
    """Write ``state`` (a ``Stage1State``, a ``Stage2State`` or a dict of
    tensors) under ``<model_path>/sharded/iteration_<iteration>/`` from every
    rank of the group (collective: each rank calls it; one process needs no
    group), each rank only what it owns (see the module's docstring);
    ``mesh`` is the one the ``LocalRows`` leaves of a dict were split over.
    Returns the bytes this rank wrote."""
    path = Path(model_path) / "sharded" / f"iteration_{iteration}"
    rank = _rank()
    if isinstance(state, dict):
        sharded = {k for k, t in state.items() if isinstance(t, LocalRows)}
        arrays = {k: _rows(v, mesh).detach().cpu().numpy() if k in sharded else v.detach().cpu().numpy()
                  for k, v in state.items()}
    else:  # a training state's leaves are replicated
        sharded, arrays = set(), state_to_numpy(state)
    D = mesh.shape["data"] if mesh is not None else 1
    path.mkdir(parents=True, exist_ok=True)
    written = []
    if rank == 0:
        manifest = {"iteration": iteration, "data": D,
                    "leaves": {k: {"shape": [a.shape[0] * D, *a.shape[1:]] if k in sharded else list(a.shape),
                                   "dtype": a.dtype.str, "data_sharded": k in sharded} for k, a in arrays.items()}}
        np.savez(path / "replicated.npz", **{k: a for k, a in arrays.items() if k not in sharded})
        (path / "manifest.json").write_text(json.dumps(manifest))
        written += [path / "replicated.npz", path / "manifest.json"]
    if sharded and mesh.tile == 0:
        np.savez(path / f"data{mesh.data}.npz", **{k: arrays[k] for k in sharded})
        written.append(path / f"data{mesh.data}.npz")
    _barrier()
    return sum(p.stat().st_size for p in written)


def load_checkpoint_sharded(model_path: str | Path, template: Any, iteration: int = -1,
                            mesh: Mesh | None = None) -> tuple[Any, int]:
    """(state, iteration) of the given or (``-1``) the latest sharded
    checkpoint, onto ``template`` (a state, or a dict of tensors: the
    devices and dtypes of the result). A data-sharded leaf loads whole into
    a tensor of the template, and as the rank's rows of ``mesh`` into a
    ``LocalRows`` (``multihost.global_batch``), the result a ``LocalRows``
    alike. Collective where a group exists (every rank reads what it needs
    between two barriers); none is needed otherwise."""
    base = Path(model_path) / "sharded"
    it = search_max_iteration(base) if iteration == -1 else iteration
    if it is None:
        raise FileNotFoundError(f"no sharded checkpoints under {base}")
    path = base / f"iteration_{it}"
    _barrier()
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "replicated.npz") as rep:
        arrays = {k: rep[k] for k in rep.files}
    if any(v["data_sharded"] for v in manifest["leaves"].values()):
        parts = []
        for d in range(manifest["data"]):
            with np.load(path / f"data{d}.npz") as f:
                parts.append({k: f[k] for k in f.files})
        for k in parts[0]:
            arrays[k] = np.concatenate([p[k] for p in parts])

    def read(key, local=False):
        if key not in manifest["leaves"] or key not in arrays:
            return None
        a = arrays[key]
        if local:
            n = a.shape[0] // mesh.shape["data"]
            a = a[n * mesh.data:n * (mesh.data + 1)]
        return a

    if isinstance(template, dict):
        out = {}
        for k, t in template.items():
            local = isinstance(t, LocalRows)
            t = _rows(t, mesh) if local else t
            a = read(k, local=local)
            if a is None:
                raise KeyError(f"checkpoint missing leaf {k}")
            if a.shape != tuple(t.shape):
                raise ValueError(f"shape mismatch for {k}: ckpt {a.shape} vs template {tuple(t.shape)}")
            v = torch.from_numpy(a.copy()).to(device=t.device, dtype=t.dtype)
            out[k] = LocalRows(v, data=mesh.shape["data"], index=mesh.data) if local else v
    else:
        out = _fill_state(template, read)
    _barrier()
    return out, it
