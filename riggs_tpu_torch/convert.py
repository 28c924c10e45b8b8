"""Carry the JAX package's state across as numpy arrays.

Turns ``riggs_tpu`` objects, flattened to numpy (for example with
``jax.tree.map(np.asarray, gs.params_dict())``), into the port's objects.
This module takes numpy only; it never imports ``jax`` or ``riggs_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

from riggs_tpu_torch.camera.camera import Camera
from riggs_tpu_torch.data.dataset import Frame
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.edit.arap_deform import ArapDeformer
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef
from riggs_tpu_torch.models.gaussians import DensifyStats, Gaussians
from riggs_tpu_torch.models.hash_encoding import HashDeformNetwork, HashGridDef
from riggs_tpu_torch.models.node_warp import NodeWarp
from riggs_tpu_torch.models.simple_deform import MlpDeform
from riggs_tpu_torch.models.skeleton_warp import init_skeleton_warp
from riggs_tpu_torch.train.mlp_deform import MlpDeformState
from riggs_tpu_torch.train.optim import AdamState
from riggs_tpu_torch.train.stage1 import Stage1State
from riggs_tpu_torch.train.stage2 import Stage2State
from riggs_tpu_torch.train.static import TrainState


def _t(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


def gaussians_from_numpy(
    params: dict,
    alive,
    max_sh_degree: int,
    isotropic: bool = False,
    with_motion_mask: bool = True,
    shared_scale: bool = False,
    device: str | torch.device | None = None,
) -> Gaussians:
    """``params`` holds the reference's ``Gaussians.params_dict()`` keys:
    xyz, f_dc, f_rest, scaling, rotation, opacity, feature."""
    dev = resolve_device(device)
    return Gaussians(
        xyz=_t(params["xyz"], dev),
        features_dc=_t(params["f_dc"], dev),
        features_rest=_t(params["f_rest"], dev),
        scaling=_t(params["scaling"], dev),
        rotation=_t(params["rotation"], dev),
        opacity=_t(params["opacity"], dev),
        feature=_t(params["feature"], dev),
        alive=_t(alive, dev, torch.bool),
        max_sh_degree=int(max_sh_degree),
        isotropic=bool(isotropic),
        with_motion_mask=bool(with_motion_mask),
        shared_scale=bool(shared_scale),
    )


def _load_linear(lin: torch.nn.Linear, p: dict):
    """Reference weights are (d_in, d_out); nn.Linear keeps (d_out, d_in)."""
    w = np.asarray(p["w"], np.float32).T
    b = np.asarray(p["b"], np.float32)
    if lin.weight.shape != w.shape or lin.bias.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(lin.weight.shape)} vs {w.shape}")
    lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
    lin.bias.copy_(torch.from_numpy(b.copy()))


def _load_mlp(mlp, p: dict):
    if len(p["layers"]) != len(mlp.layers):
        raise ValueError(f"{len(p['layers'])} layers given, the module has {len(mlp.layers)}")
    for lin, lp in zip(mlp.layers, p["layers"]):
        _load_linear(lin, lp)
    for name in ("head", "rotation", "translation"):
        if name in p:
            _load_linear(getattr(mlp, name), p[name])


@torch.no_grad()
def node_warp_from_numpy(
    params: dict,
    net: DeformNetworkDef,
    K: int = 3,
    hyper_dim: int = 2,
    d_rot_as_res: bool = True,
    with_node_weight: bool = True,
    device: str | torch.device | None = None,
) -> NodeWarp:
    """``params`` is the reference's ``NodeWarp.params_dict()``: nodes,
    radius, weight and the DeformNetwork tree under ``mlp`` (trunk layers,
    the heads, the blender timenet)."""
    dev = resolve_device(device)
    warp = NodeWarp(_t(params["nodes"], dev), _t(params["radius"], dev), _t(params["weight"], dev), net,
                    K=K, hyper_dim=hyper_dim, d_rot_as_res=d_rot_as_res, with_node_weight=with_node_weight,
                    generator=torch.Generator(device=dev).manual_seed(0))  # weights overwritten below
    _load_deform_network(warp.mlp, params["mlp"])
    return warp


def _load_deform_network(module, mp: dict):
    """A reference DeformNetwork tree (trunk, heads, blender timenet) into
    the port's ``DeformNetwork``."""
    mods = module.params_dict()
    if set(mp) != set(mods):
        raise ValueError(f"DeformNetwork parameters {sorted(mp)} given, the module has {sorted(mods)}")
    _load_mlp(module.trunk, mp["trunk"])
    for name, p in mp.items():
        if name == "timenet":
            for lin, lp in zip(module.timenet, p):
                _load_linear(lin, lp)
        elif name != "trunk":
            _load_linear(getattr(module, name), p)


@torch.no_grad()
def mlp_deform_from_numpy(params: dict, net: DeformNetworkDef, device: str | torch.device | None = None) -> MlpDeform:
    """``params`` is the reference's ``MlpDeform.params_dict()``: the
    DeformNetwork tree under ``mlp``."""
    dev = resolve_device(device)
    deform = MlpDeform(net, generator=torch.Generator(device=dev).manual_seed(0), device=dev)  # overwritten below
    _load_deform_network(deform.mlp, params["mlp"])
    return deform


@torch.no_grad()
def hash_deform_from_numpy(params: dict, bbox_min, bbox_max, grid: HashGridDef | None = None, t_multires: int = 6,
                           width: int = 64, depth: int = 2,
                           device: str | torch.device | None = None) -> HashDeformNetwork:
    """``params`` is the reference's ``HashDeformNetwork.params_dict()``:
    the (L, T, F) tables, the trunk under ``mlp`` and the three heads under
    ``heads``; ``bbox_min`` / ``bbox_max`` its scalar box."""
    dev = resolve_device(device)
    net = HashDeformNetwork(float(np.asarray(bbox_min)), float(np.asarray(bbox_max)), grid=grid,
                            t_multires=t_multires, width=width, depth=depth,
                            generator=torch.Generator(device=dev).manual_seed(0), device=dev)  # overwritten below
    tables = np.asarray(params["tables"], np.float32)
    if tuple(net.tables.shape) != tables.shape:
        raise ValueError(f"tables {tables.shape} given, the grid has {tuple(net.tables.shape)}")
    net.tables.copy_(torch.from_numpy(tables.copy()))
    _load_mlp(net.mlp, params["mlp"])
    for name, p in params["heads"].items():
        _load_linear(getattr(net, name), p)
    return net


@torch.no_grad()
def skeleton_warp_from_numpy(
    params: dict,
    joints,
    parents,
    K: int = -1,
    use_skinning_mlp: bool = True,
    use_template_offsets: bool = True,
    control_nodes=None,
    device: str | torch.device | None = None,
):
    """``params`` is the reference's ``SkeletonWarp.params_dict()``: radius,
    pose, and skinning_mlp / detail_net when the net uses them;
    ``control_nodes`` its (C, 3) buffer (512 zero rows when not given)."""
    dev = resolve_device(device)
    skel = init_skeleton_warp(
        np.asarray(joints, np.float32), parents,
        node_radius_log=np.asarray(params["radius"], np.float32), K=K,
        use_skinning_mlp=use_skinning_mlp, use_template_offsets=use_template_offsets,
        n_control_nodes=512 if control_nodes is None else len(control_nodes),
        generator=torch.Generator(device=dev).manual_seed(0),  # overwritten below
        device=dev,
    )
    if control_nodes is not None:
        skel.control_nodes.copy_(_t(control_nodes, dev))
    _load_mlp(skel.pose_mlp, params["pose"])
    if use_skinning_mlp:
        _load_mlp(skel.weight_mlp, params["skinning_mlp"])
    if use_template_offsets:
        _load_mlp(skel.detail_mlp, params["detail_net"])
    return skel


def arap_deformer_from_numpy(verts, nn_idx, weight, valid, device: str | torch.device | None = None) -> ArapDeformer:
    """The reference's ``ArapDeformer`` leaves: (N, 3) rest positions, (N, K)
    neighbour indices, edge weights and validity flags."""
    dev = resolve_device(device)
    return ArapDeformer(verts=_t(verts, dev), nn_idx=_t(nn_idx, dev, torch.int32), weight=_t(weight, dev),
                        valid=_t(valid, dev, torch.bool))


def camera_from_numpy(w2c, intrinsics, fid, width: int, height: int,
                      znear: float = 0.01, zfar: float = 100.0,
                      device: str | torch.device | None = None) -> Camera:
    dev = resolve_device(device)
    return Camera(
        w2c=_t(w2c, dev), intrinsics=_t(intrinsics, dev), fid=_t(fid, dev),
        width=int(width), height=int(height), znear=float(znear), zfar=float(zfar),
    )


def frame_from_numpy(w2c, intrinsics, fid, width: int, height: int, image, alpha_mask=None,
                     thinned=None, thinned_mask=None, semantic_seg=None,
                     device: str | torch.device | None = None) -> Frame:
    """A training ``Frame``: the camera and the supervision, (row, col)
    thinned pixels padded with their mask, int32 semantic labels."""
    dev = resolve_device(device)
    opt = lambda a, dtype=torch.float32: None if a is None else _t(a, dev, dtype)
    return Frame(
        cam=camera_from_numpy(w2c, intrinsics, fid, width, height, device=dev),
        image=_t(image, dev), alpha_mask=opt(alpha_mask), thinned=opt(thinned),
        thinned_mask=opt(thinned_mask, torch.bool), semantic_seg=opt(semantic_seg, torch.int32),
    )


def _module_tree(tree, dev):
    """A reference tree of an MLP module's parameters (Adam moments) in the
    port's layout: every linear ``w`` (d_in, d_out) becomes (d_out, d_in)."""
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"}:
            return {"w": _t(np.asarray(tree["w"]).T.copy(), dev), "b": _t(tree["b"], dev)}
        return {k: _module_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_module_tree(v, dev) for v in tree]
    return _t(tree, dev)


def _adam(state: tuple, tree, dev) -> AdamState:
    """An ``AdamState`` from the reference's (mu, nu, count)."""
    mu, nu, count = state
    return AdamState(mu=tree(mu, dev), nu=tree(nu, dev),
                     count=torch.tensor(int(count), dtype=torch.int32, device=dev))


def stage2_state_from_numpy(
    gs_params: dict,
    alive,
    max_sh_degree: int,
    skel_params: dict,
    joints,
    parents,
    opt_gs: tuple,
    opt_skel: tuple,
    stats: tuple,
    proj_loss,
    it: int = 0,
    isotropic: bool = False,
    with_motion_mask: bool = True,
    K: int = -1,
    use_skinning_mlp: bool = True,
    use_template_offsets: bool = True,
    control_nodes=None,
    device: str | torch.device | None = None,
) -> Stage2State:
    """A ``Stage2State`` from the reference's: the Gaussians' and skeleton's
    ``params_dict`` trees, both Adam states as (mu, nu, count) with mu and nu
    in the params' trees, the densification statistics as
    (xyz_gradient_accum, denom, max_radii2d), ``proj_loss``, ``it`` and
    the skeleton's ``control_nodes``."""
    dev = resolve_device(device)
    gs = gaussians_from_numpy(gs_params, alive, max_sh_degree, isotropic, with_motion_mask, device=dev)
    skel = skeleton_warp_from_numpy(skel_params, joints, parents, K=K, use_skinning_mlp=use_skinning_mlp,
                                    use_template_offsets=use_template_offsets, control_nodes=control_nodes,
                                    device=dev)

    return Stage2State(
        gs=gs,
        skel=skel,
        opt_gs=_adam(opt_gs, _module_tree, dev),
        opt_skel=_adam(opt_skel, _module_tree, dev),
        stats_gs=DensifyStats(*(_t(a, dev) for a in stats)),
        proj_loss=_t(proj_loss, dev),
        it=torch.tensor(int(it), dtype=torch.int32, device=dev),
    )


def stage1_state_from_numpy(
    gs: dict,
    node_gs: dict,
    warp_params: dict,
    net: DeformNetworkDef,
    opt_gs: tuple,
    opt_node: tuple,
    opt_warp: tuple,
    stats_gs: tuple,
    stats_node: tuple,
    it: int = 0,
    hyper_dim: int = 2,
    K: int = 3,
    d_rot_as_res: bool = True,
    with_node_weight: bool = True,
    device: str | torch.device | None = None,
) -> Stage1State:
    """A ``Stage1State`` from the reference's. ``gs`` and ``node_gs`` are
    dicts of ``gaussians_from_numpy``'s arguments (``params``, ``alive``,
    ``max_sh_degree`` and the flags); ``warp_params`` the warp's
    ``params_dict`` tree; the Adam states (mu, nu, count) with mu and nu in
    the params' trees; the statistics (xyz_gradient_accum, denom,
    max_radii2d). Any state of the reference's loop converts: after
    densification (the alive masks), with a node count other than
    ``node_num``, with phase A's node Adam state."""
    dev = resolve_device(device)
    return Stage1State(
        gs=gaussians_from_numpy(**gs, device=dev),
        node_gs=gaussians_from_numpy(**node_gs, device=dev),
        warp=node_warp_from_numpy(warp_params, net, K=K, hyper_dim=hyper_dim, d_rot_as_res=d_rot_as_res,
                                  with_node_weight=with_node_weight, device=dev),
        opt_gs=_adam(opt_gs, _module_tree, dev),
        opt_node=_adam(opt_node, _module_tree, dev),
        opt_warp=_adam(opt_warp, _module_tree, dev),
        stats_gs=DensifyStats(*(_t(a, dev) for a in stats_gs)),
        stats_node=DensifyStats(*(_t(a, dev) for a in stats_node)),
        it=torch.tensor(int(it), dtype=torch.int32, device=dev),
    )


def static_state_from_numpy(gs: dict, opt: tuple, stats: tuple,
                            device: str | torch.device | None = None) -> TrainState:
    """The static trainer's ``TrainState`` from the reference's: ``gs`` a
    dict of ``gaussians_from_numpy``'s arguments, the Adam state (mu, nu,
    count) in the params' tree, the statistics (xyz_gradient_accum, denom,
    max_radii2d)."""
    dev = resolve_device(device)
    return TrainState(gs=gaussians_from_numpy(**gs, device=dev), opt=_adam(opt, _module_tree, dev),
                      stats=DensifyStats(*(_t(a, dev) for a in stats)))


def mlp_deform_state_from_numpy(gs: dict, deform_params: dict, net: DeformNetworkDef, opt_gs: tuple,
                                opt_deform: tuple, stats: tuple,
                                device: str | torch.device | None = None) -> MlpDeformState:
    """An ``MlpDeformState`` from the reference's: ``gs`` as for
    ``static_state_from_numpy``, the deform's ``params_dict`` tree and
    both Adam states (mu, nu, count)."""
    dev = resolve_device(device)
    return MlpDeformState(
        gs=gaussians_from_numpy(**gs, device=dev),
        deform=mlp_deform_from_numpy(deform_params, net, device=dev),
        opt_gs=_adam(opt_gs, _module_tree, dev),
        opt_deform=_adam(opt_deform, _module_tree, dev),
        stats=DensifyStats(*(_t(a, dev) for a in stats)),
    )
