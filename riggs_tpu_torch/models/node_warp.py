"""NodeWarp: the node-based deformation field of stage 1.

Port of ``riggs_tpu/models/node_warp.py``. Sparse control
nodes carry a position with hyper coordinates, a radius and a weight; the
DeformNetwork queried at the nodes gives per-node residuals, which are
blended onto the Gaussians with Gaussian-kernel weights over each one's K
nearest nodes (exp(-d^2 / 2 r^2), node-weight modulated, normalized).

  * ``NodeWarp`` is an ``nn.Module`` (the nodes, the log radii, the weight
    logits and the DeformNetwork); ``params_dict`` / ``replace_params``
    give and take its parameters under the reference's tree;
  * ``cal_nn_weight``: straight-through neighbour distances (the value from
    the KNN on detached inputs, the gradient from the K selected pairs);
  * ``warp_forward``: the dense masked blend, an (N, M) distance matrix, an
    exact top-K mask and one (N, M) @ (M, C) product, with the local-frame
    rotation mode and ``d_rot_as_res``;
  * ``arap_loss``: the ARAP regularizer over two sample times near a random
    time. JAX's PRNG streams cannot be reproduced here, so the sample times
    are an argument (``arap_sample_times`` draws them from a
    ``torch.Generator``);
  * ``arap_loss_with_rot``: ``ops/arap.py:arap_deformation_loss`` over the
    node trajectories at 8 uniform times, frame 0 against one drawn frame
    (``arap_rot_draws`` draws both from a ``torch.Generator``), with the
    rotation term when the warp predicts absolute rotations;
  * ``elastic_loss`` and ``acc_loss``: phase A's trajectory regularizers
    (the variance of neighbour edge lengths over 8 times near the frame's,
    and the second finite difference of the node trajectories). Their
    times are arguments too: ``arap_sample_times`` draws elastic's 8
    (delta_t the frame interval), ``sample_time`` acc's centre;
  * the animation path: ``get_trajectory`` (the nodes at uniform times),
    ``p2dR`` (per-node rotations from displaced nodes, a weighted
    Procrustes fit on the rotation-fit kernel) and ``warp_forward_animated``
    (the Gaussians re-bound to dragged nodes by geodesic KNN and carried
    rigidly with them).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from riggs_tpu_torch.device import constant, resolve_device
from riggs_tpu_torch.models.deform_mlp import DeformNetwork, DeformNetworkDef
from riggs_tpu_torch.ops import arap as A
from riggs_tpu_torch.ops.fps import farthest_point_sample
from riggs_tpu_torch.ops.geometry import fit_rotations, safe_norm
from riggs_tpu_torch.ops.knn import _small_k, knn, pairwise_dist2
from riggs_tpu_torch.ops.quaternion import quat_to_rotmat, rotmat_to_quat
from riggs_tpu_torch.train.optim import tree_map

ROT_BIAS = (1.0, 0.0, 0.0, 0.0)

# stage-1 ARAP lambda schedule
LAMBDA_ARAP_LANDMARKS = (1e-4, 1e-4, 1e-5, 1e-5, 0)
LAMBDA_ARAP_STEPS = (0, 5000, 10000, 20000, 20001)


class NodeWarp(nn.Module):
    def __init__(
        self,
        nodes: torch.Tensor,
        node_radius_log: torch.Tensor,
        node_weight_logit: torch.Tensor,
        net: DeformNetworkDef,
        K: int = 3,
        hyper_dim: int = 2,
        d_rot_as_res: bool = True,
        with_node_weight: bool = True,
        generator: torch.Generator | None = None,
        mlp: DeformNetwork | None = None,
    ):
        super().__init__()
        self.nodes = nn.Parameter(nodes.to(torch.float32))  # (M, 3 + hyper_dim)
        self.node_radius_log = nn.Parameter(node_radius_log.to(torch.float32))  # (M,)
        self.node_weight_logit = nn.Parameter(node_weight_logit.to(torch.float32))  # (M, 1)
        # a given DeformNetwork is shared, not copied (the node set's rebuilds)
        self.mlp = DeformNetwork(net, generator=generator, device=nodes.device) if mlp is None else mlp
        self.net = net
        self.K = K
        self.hyper_dim = hyper_dim
        self.d_rot_as_res = d_rot_as_res
        self.with_node_weight = with_node_weight

    @property
    def node_num(self) -> int:
        return self.nodes.shape[0]

    @property
    def node_radius(self) -> torch.Tensor:
        return torch.exp(self.node_radius_log)

    @property
    def node_weight(self) -> torch.Tensor:
        return torch.sigmoid(self.node_weight_logit)

    def params_dict(self) -> dict:
        return {"nodes": self.nodes, "radius": self.node_radius_log, "weight": self.node_weight_logit,
                "mlp": self.mlp.params_dict()}

    def with_nodes(self, nodes: torch.Tensor, node_radius_log: torch.Tensor,
                   node_weight_logit: torch.Tensor) -> "NodeWarp":
        """A warp over another node set with this one's DeformNetwork (the
        module itself) and settings."""
        return NodeWarp(nodes.detach().clone(), node_radius_log.detach().clone(), node_weight_logit.detach().clone(),
                        self.net, K=self.K,
                        hyper_dim=self.hyper_dim, d_rot_as_res=self.d_rot_as_res,
                        with_node_weight=self.with_node_weight, mlp=self.mlp)

    @torch.no_grad()
    def replace_params(self, p: dict) -> "NodeWarp":
        """Write a ``params_dict`` tree into the parameters in place (the
        optimizer's update) and return this module."""
        tree_map(lambda dst, src: dst is src or dst.copy_(src), self.params_dict(), p)
        return self


def init_node_warp(
    init_pcl: np.ndarray,
    node_num: int,
    net: DeformNetworkDef | None = None,
    hyper_dim: int = 2,
    K: int = 3,
    d_rot_as_res: bool = True,
    with_node_weight: bool = True,
    keep_all: bool = False,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> NodeWarp:
    """Nodes by FPS over the point cloud, hyper coords 1e-2, log radius
    log(0.1 * range + 1e-7), weight logits 0, a seeded DeformNetwork
    (``generator`` on ``device``; its draws differ from the reference's)."""
    dev = resolve_device(device)
    net = net or DeformNetworkDef()
    pcl = torch.tensor(np.asarray(init_pcl), dtype=torch.float32, device=dev)
    if keep_all or node_num >= pcl.shape[0]:
        node_xyz = pcl
        node_num = pcl.shape[0]
    else:
        node_xyz = pcl[farthest_point_sample(pcl, node_num).to(torch.int64)]
    nodes = torch.cat([node_xyz, torch.full((node_num, hyper_dim), 1e-2, device=dev)], dim=-1)
    scene_range = torch.max(pcl) - torch.min(pcl)
    radius_log = torch.log(0.1 * scene_range + 1e-7) * torch.ones(node_num, device=dev)
    return NodeWarp(nodes, radius_log, torch.zeros((node_num, 1), device=dev), net, K=K, hyper_dim=hyper_dim,
                    d_rot_as_res=d_rot_as_res, with_node_weight=with_node_weight, generator=generator)


def _query(warp: NodeWarp, x: torch.Tensor, feature: torch.Tensor | None, node_key: torch.Tensor):
    """(query, key): xyz, with the first hyper_dim feature columns and the
    nodes' hyper coords appended when the Gaussians have them."""
    if feature is not None and warp.hyper_dim > 0 and feature.shape[-1] >= warp.hyper_dim:
        return (torch.cat([x, feature[:, : warp.hyper_dim]], dim=-1),
                torch.cat([node_key, warp.nodes[:, 3:]], dim=-1))
    return x, node_key


def cal_nn_weight(
    warp: NodeWarp,
    x: torch.Tensor,
    feature: torch.Tensor | None = None,
    K: int | None = None,
    nodes: torch.Tensor | None = None,
    gs_kernel: bool = True,
    temperature: float = 1.0,
):
    """Gaussian-kernel KNN blending weights (N, K), the distances and the
    int32 indices. The distances' value comes from the KNN on detached
    inputs, their gradient from a recompute over the K selected pairs only
    (it reaches the nodes' hyper coords and the Gaussians' features)."""
    K = warp.K if K is None else K
    node_key = warp.nodes[:, :3].detach() if nodes is None else nodes[:, :3]
    q, node_key = _query(warp, x.detach(), feature, node_key)
    nn_dist2, nn_idx = knn(q.detach(), node_key.detach(), K)
    idx = nn_idx.to(torch.int64)
    d2_re = torch.sum((q[:, None, :] - node_key[idx]) ** 2, dim=-1)
    nn_dist2 = nn_dist2 + (d2_re - d2_re.detach())
    if not gs_kernel:
        return torch.softmax(-nn_dist2 / temperature, dim=-1), nn_dist2, nn_idx
    w = torch.exp(-nn_dist2 / (2.0 * warp.node_radius[idx] ** 2))
    if warp.with_node_weight:
        w = w * warp.node_weight[idx][..., 0]
    w = w + 1e-7
    return w / torch.sum(w, dim=-1, keepdim=True), nn_dist2, nn_idx


def node_deform(warp: NodeWarp, t, detach_node: bool = True, band_mask: torch.Tensor | None = None) -> dict:
    """The DeformNetwork at the node positions. t: a scalar, (M, 1), or
    (M, T, 1) (the nodes broadcast over the time axis)."""
    nodes = warp.nodes[:, :3]
    if detach_node:
        nodes = nodes.detach()
    if not isinstance(t, torch.Tensor):  # a fill on the device, not a host copy
        t = torch.full((), t, dtype=torch.float32, device=nodes.device)
    if t.dim() == 0:
        t = t.reshape(1, 1).expand(warp.node_num, 1)
    if t.dim() == 3:
        nodes = nodes[:, None, :].expand(warp.node_num, t.shape[1], 3)
    return warp.mlp(nodes, t, band_mask)


def warp_forward(
    warp: NodeWarp,
    x: torch.Tensor,
    t,
    feature: torch.Tensor | None,
    motion_mask: torch.Tensor,
    band_mask: torch.Tensor | None = None,
    local_frame: bool = False,
) -> dict:
    """Blend the node residuals onto Gaussians at x: d_xyz, d_rotation,
    d_scaling, d_nodes (the deformed nodes), nn_idx and nn_weight (K-sparse
    views), d_opacity / d_color when the network predicts them.

    The weights live dense over all M nodes with an exact top-K mask (the
    selection detached), equal to cal_nn_weight's up to f32 reassociation;
    every blended channel is one column of an (M, C) table and the blend one
    (N, M) @ (M, C) product."""
    x = x.detach()
    M = warp.node_num
    q, node_key = _query(warp, x, feature, warp.nodes[:, :3].detach())
    d2 = pairwise_dist2(q, node_key)  # (N, M); gradients reach hyper coords and features
    _, nn_idx = _small_k(d2.detach(), warp.K)
    cols = torch.arange(M, device=d2.device)[None, :]
    mask = torch.zeros(d2.shape, dtype=torch.bool, device=d2.device)
    for k in range(warp.K):
        mask = mask | (cols == nn_idx[:, k : k + 1])

    w = torch.exp(-d2 / (2.0 * warp.node_radius[None, :] ** 2))
    if warp.with_node_weight:
        w = w * warp.node_weight[None, :, 0]
    w = torch.where(mask, w + 1e-7, 0.0)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    nn_weight = torch.gather(w, -1, nn_idx.to(torch.int64))

    attrs = node_deform(warp, t, band_mask=band_mask)
    node_trans = attrs["d_xyz"]
    extra = [(name, attrs[name]) for name in ("d_opacity", "d_color") if attrs.get(name) is not None]
    chans = [node_trans, attrs["d_rotation"], attrs["d_scaling"]] + [a for _, a in extra]
    if local_frame:
        Rl = quat_to_rotmat(attrs["local_rotation"] + constant(ROT_BIAS, node_trans))  # (M, 3, 3)
        p = warp.nodes[:, :3].detach()
        # sum_m w_nm [Rl_m (x_n - p_m) + p_m + t_m]
        #   = (sum_m w_nm Rl_m) x_n + sum_m w_nm (p_m - Rl_m p_m + t_m)
        const = p - torch.einsum("mab,mb->ma", Rl, p) + node_trans
        chans += [Rl.reshape(M, 9), const]
    blended = w @ torch.cat(chans, dim=-1)  # (N, C)
    cuts = np.cumsum([0, 3, 4, 3] + [a.shape[-1] for _, a in extra] + ([9, 3] if local_frame else []))
    part = [blended[:, cuts[i] : cuts[i + 1]] for i in range(len(cuts) - 1)]
    b_trans, b_rot, b_scale = part[:3]

    if local_frame:
        WR, Wc = part[-2].reshape(-1, 3, 3), part[-1]
        # sum_m w = 1, so subtracting x leaves the residual translation
        translate = torch.einsum("nab,nb->na", WR, x) + Wc - x
    else:
        translate = b_trans
    rotation = b_rot * motion_mask
    if not warp.d_rot_as_res:
        # the blend of (node_rot + bias) is b_rot + bias since sum_m w = 1
        rotation = rotation + constant(ROT_BIAS, rotation)
    out = {
        "d_xyz": translate * motion_mask,
        "d_rotation": rotation,
        "d_scaling": b_scale * motion_mask,
        "d_nodes": warp.nodes[:, :3] + node_trans,
        "nn_idx": nn_idx,
        "nn_weight": nn_weight,
        "d_opacity": None,
        "d_color": None,
    }
    for i, (name, _) in enumerate(extra):
        out[name] = part[3 + i] * motion_mask
    return out


def get_trajectory(warp: NodeWarp, t_samp_num: int = 8) -> torch.Tensor:
    """(M, T, 3) node trajectory over T uniform times in [0, 1]."""
    ts = torch.linspace(0.0, 1.0, t_samp_num, device=warp.nodes.device)
    return _trajectory(warp, ts)


def p2dR(warp: NodeWarp, p: torch.Tensor, p0: torch.Tensor, K: int = 8) -> torch.Tensor:
    """Per-node rotations (M, 4) taking the node positions p0 (M, 3) to p:
    each node's K nearest nodes in flattened-trajectory space (4 times),
    weighted by a softmax of their distances over the mean, give the edge
    fans whose weighted, normalized correlation is fitted by
    ``fit_rotations`` (the kernel on the card)."""
    traj = get_trajectory(warp, t_samp_num=4).reshape(warp.node_num, -1)
    d2, idx = knn(traj, traj, K + 1)
    d2, idx = d2[:, 1:], idx[:, 1:].to(torch.int64)
    w = torch.softmax(d2 / torch.mean(d2), dim=-1)
    unit = lambda e: e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-5)
    e0 = unit(p0[idx] - p0[:, None])
    e1 = unit(p[idx] - p[:, None])
    cov = torch.einsum("nka,nkb->nab", e1 * w[..., None], e0)
    return rotmat_to_quat(fit_rotations(cov))


def warp_forward_animated(
    warp: NodeWarp,
    x: torch.Tensor,
    t,
    feature: torch.Tensor | None,
    motion_mask: torch.Tensor,
    node_trans_bias: torch.Tensor,
    K: int = 8,
    temperature: float = 1e-3,
) -> dict:
    """The animation path: ``warp_forward`` at t, then the posed nodes moved
    by ``node_trans_bias`` (M, 3) (a drag or an edit), each Gaussian
    re-bound to its K geodesically nearest posed nodes (its nearest node's
    row of ``geodesic_floyd`` over the posed nodes' 4-NN graph, plus the
    distance to it; a softmax at ``temperature``), the nodes' rotation
    deltas from ``p2dR``, and the Gaussians carried rigidly with their
    nodes. Returns ``warp_forward``'s dict with d_xyz, d_nodes (the moved
    nodes) and d_rotation_bias (the blended rotation deltas, to compose
    with the Gaussians' rotations) replaced or added."""
    base = warp_forward(warp, x, t, feature, motion_mask)
    cur_node = (warp.nodes[:, :3] + node_deform(warp, t)["d_xyz"]).detach()
    cur_gs = (x + base["d_xyz"]).detach()

    dist_mat = A.geodesic_floyd(cur_node, K=3)
    d2_g, idx_g = knn(cur_gs, cur_node, 1)
    geo = dist_mat[idx_g[:, 0].to(torch.int64)] + torch.sqrt(torch.clamp(d2_g, min=0.0))  # (N, M)
    # the K smallest, ties to the lower index as lax.top_k orders them (inf included)
    vals, cur_idx = torch.sort(geo, dim=-1, stable=True)
    vals, cur_idx = vals[:, :K], cur_idx[:, :K]
    cur_w = torch.softmax(-vals / temperature, dim=-1)

    nodes_t = cur_node + node_trans_bias
    rot_bias = constant(ROT_BIAS, nodes_t)
    node_rot_bias = p2dR(warp, nodes_t, cur_node, K=8)
    Rb = quat_to_rotmat(node_rot_bias)
    gs_t = nodes_t[cur_idx] + torch.einsum("gkab,gkb->gka", Rb[cur_idx], cur_gs[:, None] - cur_node[cur_idx])
    gs_avg = torch.sum(gs_t * cur_w[..., None], dim=1)
    d_rotation_bias = (torch.sum(node_rot_bias[cur_idx] * cur_w[..., None], dim=1) - rot_bias) * motion_mask + rot_bias

    out = dict(base)
    out["d_xyz"] = (gs_avg - x) * motion_mask
    out["d_rotation_bias"] = d_rotation_bias
    out["d_nodes"] = nodes_t
    return out


def arap_sample_times(
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    delta_t: float = 0.05,
    t_samp_num: int = 2,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """``arap_loss``'s (t_samp_num,) sample times, drawn as the reference
    draws them: a centre t0 uniform in [0, 1) (or within delta_t / 2 of
    ``t``), then times uniform within delta_t / 2 of t0."""
    dev = resolve_device(device) if t is None else t.device
    u = torch.rand(1 + t_samp_num, generator=generator, device=dev)
    t0 = u[0] if t is None else t.reshape(()) + delta_t * (u[0] - 0.5)
    return u[1:] * delta_t + t0 - 0.5 * delta_t


def _trajectory(warp: NodeWarp, ts: torch.Tensor) -> torch.Tensor:
    """The node positions (M, T, 3) at the times ts (T,): the detached
    canonical nodes plus the DeformNetwork's d_xyz."""
    T = ts.shape[0]
    return warp.nodes[:, None, :3].detach() + node_deform(warp, ts[None, :, None].expand(warp.node_num, T, 1))["d_xyz"]


def arap_loss(warp: NodeWarp, t_samp: torch.Tensor) -> torch.Tensor:
    """ARAP energy of the node positions at the sample times ``t_samp``
    (t_samp_num,) against the first, over the KNN graph of the first
    (K = min(10, M - 1))."""
    nodes_t = _trajectory(warp, t_samp)  # (M, T, 3)
    conn = A.connectivity_from_points(nodes_t[:, 0].detach(), K=min(10, warp.node_num - 1))
    return A.arap_error(nodes_t.transpose(0, 1), conn)


def arap_rot_draws(
    generator: torch.Generator | None = None,
    t_samp_num: int = 8,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``arap_loss_with_rot``'s draws as the reference draws them: the
    (t_samp_num,) sample times uniform in [0, 1), then the compared frame
    uniform in [1, t_samp_num) (a () int64 tensor)."""
    dev = resolve_device(device)
    t_samp = torch.rand(t_samp_num, generator=generator, device=dev)
    fid = torch.randint(1, t_samp_num, (), generator=generator, device=dev)
    return t_samp, fid


def arap_loss_with_rot(warp: NodeWarp, t_samp: torch.Tensor, fid: torch.Tensor) -> torch.Tensor:
    """ARAP error plus 100 x the rotation error (``arap_deformation_loss``)
    of the node trajectories at the times ``t_samp`` (T,), frame 0 against
    frame ``fid``; the rotation term only when the warp predicts absolute
    rotations (not ``d_rot_as_res``)."""
    T = t_samp.shape[0]
    d = node_deform(warp, t_samp[None, :, None].expand(warp.node_num, T, 1))
    trajectory = warp.nodes[:, None, :3].detach() + d["d_xyz"]
    traj_rot = None if warp.d_rot_as_res else d["d_rotation"] + constant(ROT_BIAS, d["d_rotation"])
    err, rot_err = A.arap_deformation_loss(trajectory, fid, trajectory_rot=traj_rot)
    return err + rot_err


def sample_time(
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    delta_t: float = 0.005,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """``acc_loss``'s centre time, drawn as the reference draws it: uniform
    in [0, 1), or within delta_t / 2 of ``t``."""
    dev = resolve_device(device) if t is None else t.device
    u = torch.rand((), generator=generator, device=dev)
    return u if t is None else t.reshape(()) + delta_t * (u - 0.5)


def elastic_loss(warp: NodeWarp, t_samp: torch.Tensor, K: int = 2) -> torch.Tensor:
    """Variance (ddof 1) of each node's edge lengths to its K nearest nodes
    (in xyz ++ hyper space, the self column dropped) over the sample times
    ``t_samp`` (t_samp_num,), each variance divided by its detached self
    plus 1e-5, summed with the blend weights and averaged over the nodes."""
    nodes_t = _trajectory(warp, t_samp)
    nn_weight, _, nn_idx = cal_nn_weight(warp, warp.nodes[:, :3].detach(), feature=warp.nodes[:, 3:], K=K + 1)
    nn_weight, nn_idx = nn_weight[:, 1:], nn_idx[:, 1:].to(torch.int64)
    edge_t = safe_norm(nodes_t[nn_idx] - nodes_t[:, None], dim=-1)  # (M, K, T)
    var = torch.var(edge_t, dim=2, correction=1)
    var = var / (var.detach() + 1e-5)
    return torch.mean(torch.sum(var * nn_weight, dim=1))


def acc_loss(warp: NodeWarp, t0: torch.Tensor, delta_t: float = 0.005) -> torch.Tensor:
    """Norm of the node trajectories' second difference at t0 - delta_t,
    t0, t0 + delta_t, each divided by its detached self plus 1e-5, averaged."""
    ts = torch.stack([t0 - delta_t, t0, t0 + delta_t])
    nodes_t = _trajectory(warp, ts)
    acc = safe_norm(nodes_t[:, 0] + nodes_t[:, 2] - 2 * nodes_t[:, 1], dim=-1)
    acc = acc / (acc.detach() + 1e-5)
    return torch.mean(acc)
