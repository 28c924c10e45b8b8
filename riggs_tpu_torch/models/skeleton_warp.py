"""SkeletonWarp: skeleton-driven deformation of the rigged avatar (stage 2).

Port of ``riggs_tpu/models/skeleton_warp.py``:

  * PoseMLP maps time -> per-joint local quaternions (+[1,0,0,0] bias added
    after the head) and a global translation;
  * forward kinematics poses the joints (``ops/fk.py``);
  * Gaussians are skinned densely to every bone by a Gaussian kernel of the
    distance to the bone segment, optionally modulated by the WeightMLP, with
    an exact top-K mask when ``K > 0``;
  * the detail MLP adds per-Gaussian template offsets from (position, pose);
  * ``deform_by_pose_dq`` skins by dual-quaternion blending instead, over the
    gathered weights of ``cal_nn_weight_skeleton``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from riggs_tpu_torch.device import constant, resolve_device, static_index
from riggs_tpu_torch.models.mlp import MLP, embed_dim, linear_params, make_linear, positional_embed
from riggs_tpu_torch.ops.fk import forward_kinematics
from riggs_tpu_torch.ops.geometry import point_segment_dist2
from riggs_tpu_torch.ops.knn import _small_k
from riggs_tpu_torch.ops.quaternion import dq_apply, dq_blend, qt_to_dq, quat_to_rotmat, rotmat_to_quat
from riggs_tpu_torch.train.optim import tree_map

ROT_BIAS = (1.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SkeletonNetDef:
    """Static architecture of the three stage-2 MLPs."""

    n_joints: int
    parents: tuple  # length J; parents[0] == 0 (root)
    K: int = -1  # bones per point; <= 0 = dense (all bones)
    use_skinning_mlp: bool = True
    use_template_offsets: bool = True
    pose_depth: int = 8
    pose_width: int = 256
    pose_multires: int = 8
    weight_depth: int = 8
    weight_width: int = 256
    weight_multires: int = 10
    detail_depth: int = 8
    detail_width: int = 256
    detail_multires_x: int = 4

    @property
    def n_bones(self) -> int:
        return self.n_joints - 1

    @property
    def pose_out(self) -> int:
        return self.n_joints * 4


class PoseMLP(MLP):
    """The pose trunk with its two heads, ``rotation`` and ``translation``."""

    def __init__(self, net: SkeletonNetDef, generator=None, device=None):
        super().__init__(
            embed_dim(1, net.pose_multires), net.pose_width, 0, net.pose_depth,
            skips=(net.pose_depth // 2,), hidden_kind="torch_default",
            generator=generator, device=device,
        )
        self.rotation = make_linear(net.pose_width, net.pose_out, "torch_default", generator=generator, device=device)
        self.translation = make_linear(net.pose_width, 3, "torch_default", generator=generator, device=device)

    def params_dict(self) -> dict:
        p = super().params_dict()
        p["rotation"] = linear_params(self.rotation)
        p["translation"] = linear_params(self.translation)
        return p


class SkeletonWarp(nn.Module):
    """Rest joints (fixed), per-joint log kernel radii and the three MLPs."""

    def __init__(
        self,
        net: SkeletonNetDef,
        joints: torch.Tensor,
        node_radius_log: torch.Tensor,
        generator: torch.Generator | None = None,
        n_control_nodes: int = 512,
    ):
        super().__init__()
        device = joints.device
        self.net = net
        self.register_buffer("joints", joints.to(torch.float32))
        self.node_radius_log = nn.Parameter(node_radius_log.to(torch.float32))
        self.pose_mlp = PoseMLP(net, generator=generator, device=device)
        self.weight_mlp = None
        if net.use_skinning_mlp:
            self.weight_mlp = MLP(
                embed_dim(3, net.weight_multires), net.weight_width, net.n_bones, net.weight_depth,
                skips=(net.weight_depth // 2,), out_kind="torch_default",
                hidden_kind="torch_default", generator=generator, device=device,
            )
        self.detail_mlp = None
        if net.use_template_offsets:
            self.detail_mlp = MLP(
                embed_dim(3, net.detail_multires_x) + net.pose_out, net.detail_width, 3,
                net.detail_depth, skips=(net.detail_depth // 2,), out_kind="normal",
                out_std=1e-5, generator=generator, device=device,
            )
        self.register_buffer("control_nodes", torch.zeros((n_control_nodes, 3), device=device))

    @property
    def node_radius(self) -> torch.Tensor:
        return torch.exp(self.node_radius_log)

    def params_dict(self) -> dict:
        """The trainable parameters under the reference's tree (``radius``,
        ``pose``, and ``skinning_mlp`` / ``detail_net`` where the net has
        them); the leaves are this module's own ``nn.Parameter``s, linear
        weights in ``nn.Linear``'s (d_out, d_in) layout."""
        p = {"radius": self.node_radius_log, "pose": self.pose_mlp.params_dict()}
        if self.net.use_skinning_mlp:
            p["skinning_mlp"] = self.weight_mlp.params_dict()
        if self.net.use_template_offsets:
            p["detail_net"] = self.detail_mlp.params_dict()
        return p

    @torch.no_grad()
    def replace_params(self, p: dict) -> "SkeletonWarp":
        """Write a tree of the ``params_dict`` form into the parameters in
        place (the optimizer's update) and return this module."""
        tree_map(lambda dst, src: dst is src or dst.copy_(src), self.params_dict(), p)
        return self


def init_skeleton_warp(
    joints: np.ndarray,
    parents,
    node_radius_log: np.ndarray | None = None,
    K: int = -1,
    use_skinning_mlp: bool = True,
    use_template_offsets: bool = True,
    n_control_nodes: int = 512,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> SkeletonWarp:
    """Seeded SkeletonWarp at the reference's widths (three 8x256 MLPs).

    ``generator`` must live on ``device``; weights drawn from it differ from
    the reference's JAX PRNG draws (use ``convert.skeleton_warp_from_numpy``
    to carry reference weights across)."""
    dev = resolve_device(device)
    joints = np.asarray(joints, np.float32)
    net = SkeletonNetDef(
        n_joints=joints.shape[0],
        parents=tuple(int(p) for p in parents),
        K=K,
        use_skinning_mlp=use_skinning_mlp,
        use_template_offsets=use_template_offsets,
    )
    if node_radius_log is None:
        rng_span = float(np.ptp(joints))
        node_radius_log = np.log(0.1 * rng_span + 1e-7) * np.ones(net.n_joints, np.float32)
    return SkeletonWarp(
        net,
        torch.tensor(joints, device=dev),
        torch.tensor(np.asarray(node_radius_log, np.float32), device=dev),
        generator=generator,
        n_control_nodes=n_control_nodes,
    )


def pose_at(warp: SkeletonWarp, t: torch.Tensor | float) -> dict:
    """PoseMLP(t) -> local rotations (J, 4) incl. the [1,0,0,0] bias, and the
    global translation (3,)."""
    net = warp.net
    if isinstance(t, torch.Tensor):
        t = t.to(device=warp.joints.device, dtype=torch.float32)
    else:  # a fill on the card, not a blocking host-to-device copy
        t = torch.full((), t, dtype=torch.float32, device=warp.joints.device)
    t_emb = positional_embed(t.reshape(1, 1), net.pose_multires)
    h = warp.pose_mlp.hidden(t_emb)
    rot = warp.pose_mlp.rotation(h).reshape(net.n_joints, 4)
    trans = warp.pose_mlp.translation(h)[0]
    return {"local_rotation": rot + constant(ROT_BIAS, rot), "global_trans": trans}


def skinning_mlp_weights(warp: SkeletonWarp, x: torch.Tensor) -> torch.Tensor:
    """(N, n_bones) sigmoid multiplicative offsets (WeightMLP)."""
    x_emb = positional_embed(x, warp.net.weight_multires)
    return torch.sigmoid(warp.weight_mlp(x_emb))


def detail_offsets(warp: SkeletonWarp, x: torch.Tensor, pose_vec: torch.Tensor) -> torch.Tensor:
    """(N, 3) template offsets from DeformMLP(x, pose)."""
    x_emb = positional_embed(x, warp.net.detail_multires_x)
    pose = pose_vec[None, :].expand(x.shape[0], pose_vec.shape[0])
    return warp.detail_mlp(torch.cat([x_emb, pose], dim=-1))


def bone_dist2(warp: SkeletonWarp, x: torch.Tensor, joints: torch.Tensor | None = None) -> torch.Tensor:
    """Squared distance of each point to each bone segment (N, n_bones).
    Bone j (j = 1..J-1) runs from joints[parents[j]] to joints[j]."""
    joints = warp.joints if joints is None else joints
    parents = static_index(tuple(warp.net.parents[1:]), joints.device)
    return point_segment_dist2(joints[parents], joints[1:], x)


def _flag_in_graph(flag) -> bool:
    """A python ``False`` keeps an optional MLP out of the computation; a
    0/1 tensor keeps it in and weights it (exact no-op at 0)."""
    return not (isinstance(flag, bool) and not flag)


def cal_nn_weight_skeleton(
    warp: SkeletonWarp,
    x: torch.Tensor,
    joints: torch.Tensor | None = None,
    use_skinning_mlp: bool | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gathered skinning weights: the K nearest bones of each point (K > 0;
    ties to the lower bone, as ``lax.top_k``) or all of them (K <= 0).
    Returns (weight (N, K'), dist2 (N, K'), joint_idx (N, K')), joint_idx
    the bone's child joint (bone index + 1)."""
    use_sm = warp.net.use_skinning_mlp if use_skinning_mlp is None else use_skinning_mlp
    if warp.weight_mlp is None:
        use_sm = False
    d2 = bone_dist2(warp, x.detach(), joints)
    if warp.net.K > 0:
        nn_d2, bone_idx = torch.sort(d2, dim=-1, stable=True)
        nn_d2, bone_idx = nn_d2[:, : warp.net.K], bone_idx[:, : warp.net.K]
        offs = torch.gather(skinning_mlp_weights(warp, x), 1, bone_idx) if _flag_in_graph(use_sm) else None
        joint_idx = (bone_idx + 1).to(torch.int32)
    else:
        nn_d2 = d2
        joint_idx = torch.arange(1, warp.net.n_joints, dtype=torch.int32, device=d2.device)[None, :].expand(d2.shape)
        offs = skinning_mlp_weights(warp, x) if _flag_in_graph(use_sm) else None
    radius = warp.node_radius[joint_idx.to(torch.int64)]
    w = torch.exp(-nn_d2 / (2.0 * radius**2))
    if offs is not None:
        w_sm = use_sm.to(torch.float32) if isinstance(use_sm, torch.Tensor) else float(use_sm)
        w = w * (1.0 + w_sm * (offs - 1.0))
    w = w + 1e-7
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, nn_d2, joint_idx


def _dense_skin_weights(
    warp: SkeletonWarp,
    x: torch.Tensor,
    joints: torch.Tensor | None = None,
    use_skinning_mlp: bool | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (N, B) skinning weights over all bones with an exact top-K mask.
    Returns (w_dense, d2, bone_idx (N, K'))."""
    use_sm = warp.net.use_skinning_mlp if use_skinning_mlp is None else use_skinning_mlp
    if warp.weight_mlp is None:
        use_sm = False
    d2 = bone_dist2(warp, x.detach(), joints)
    B = d2.shape[-1]
    if 0 < warp.net.K < B:
        _, bone_idx = _small_k(d2.detach(), warp.net.K)
        cols = torch.arange(B, device=d2.device)[None, :]
        mask = torch.zeros(d2.shape, dtype=torch.bool, device=d2.device)
        for k in range(warp.net.K):
            mask = mask | (cols == bone_idx[:, k : k + 1])
    else:
        bone_idx = torch.arange(B, dtype=torch.int32, device=d2.device)[None, :].expand(d2.shape)
        mask = None
    radius_b = warp.node_radius[1:]  # per-bone child-joint radius
    w = torch.exp(-d2 / (2.0 * radius_b[None, :] ** 2))
    if _flag_in_graph(use_sm):
        offs = skinning_mlp_weights(warp, x)
        w_sm = use_sm.to(torch.float32) if isinstance(use_sm, torch.Tensor) else float(use_sm)
        w = w * (1.0 + w_sm * (offs - 1.0))
    if mask is not None:
        w = torch.where(mask, w + 1e-7, 0.0)
    else:
        w = w + 1e-7
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, d2, bone_idx


def deform_by_pose(
    warp: SkeletonWarp,
    x: torch.Tensor,
    local_rotation: torch.Tensor,
    global_trans: torch.Tensor,
    motion_mask: torch.Tensor,
    enable_template_offsets: bool | torch.Tensor | None = None,
    enable_skinning_mlp: bool | torch.Tensor | None = None,
) -> dict:
    """Pose the skeleton and skin the Gaussians. The enable_* flags take a
    python bool or a 0/1 tensor (the staged unlock of the two optional MLPs)."""
    use_to = warp.net.use_template_offsets if enable_template_offsets is None else enable_template_offsets
    use_sm = warp.net.use_skinning_mlp if enable_skinning_mlp is None else enable_skinning_mlp
    x = x.detach()
    rot_mats = quat_to_rotmat(local_rotation)
    posed_joints, G = forward_kinematics(rot_mats, warp.joints, warp.net.parents)
    Grot = G[:, :3, :3]
    Gtrans = G[:, :3, 3]
    node_rot = rotmat_to_quat(Grot.detach())

    # dense masked skinning: the LBS average and the quaternion blend are
    # (N, B) @ (B, 16) products
    w_dense, _, bone_idx = _dense_skin_weights(warp, x, use_skinning_mlp=use_sm)
    nn_idx = bone_idx + 1
    nn_weight = torch.gather(w_dense, -1, bone_idx.to(torch.int64))
    B = Grot.shape[0] - 1
    table = torch.cat([Grot[1:].reshape(B, 9), Gtrans[1:], node_rot[1:]], dim=-1)  # (B, 16)
    blended = w_dense @ table
    WR = blended[:, :9].reshape(-1, 3, 3)
    Ax_avg = torch.einsum("nab,nb->na", WR, x) + blended[:, 9:12]

    if warp.detail_mlp is not None and _flag_in_graph(use_to):
        pose_vec = local_rotation.detach().reshape(-1)
        w_to = use_to.to(torch.float32) if isinstance(use_to, torch.Tensor) else float(use_to)
        template_offsets = w_to * detail_offsets(warp, x, pose_vec)
    else:
        template_offsets = torch.zeros_like(x)
    Ax_avg = Ax_avg + global_trans + template_offsets

    translate = (Ax_avg - x) * motion_mask
    rotation = blended[:, 12:16] * motion_mask
    return {
        "d_xyz": translate,
        "d_rotation": rotation,
        "d_scaling": torch.zeros_like(x),
        "d_nodes": posed_joints + global_trans,
        "nn_idx": nn_idx,
        "nn_weight": nn_weight,
        "local_rotation": local_rotation,
        "global_trans": global_trans,
        "template_offsets": template_offsets,
        "d_opacity": None,
        "d_color": None,
    }


def skeleton_forward(
    warp: SkeletonWarp,
    x: torch.Tensor,
    t: torch.Tensor | float,
    motion_mask: torch.Tensor,
    enable_template_offsets: bool | torch.Tensor | None = None,
    enable_skinning_mlp: bool | torch.Tensor | None = None,
) -> dict:
    """Full forward: pose_at(t), then deform_by_pose."""
    pose = pose_at(warp, t)
    return deform_by_pose(
        warp, x, pose["local_rotation"], pose["global_trans"], motion_mask,
        enable_template_offsets=enable_template_offsets,
        enable_skinning_mlp=enable_skinning_mlp,
    )


def deform_by_pose_dq(
    warp: SkeletonWarp,
    x: torch.Tensor,
    local_rotation: torch.Tensor,
    global_trans: torch.Tensor,
    motion_mask: torch.Tensor,
) -> dict:
    """Dual-quaternion skinning variant of ``deform_by_pose``: each bone's
    global transform becomes a unit dual quaternion, blended per point with
    ``cal_nn_weight_skeleton``'s weights (no candy-wrapper collapse on
    twisting joints). No template offsets."""
    x = x.detach()
    rot_mats = quat_to_rotmat(local_rotation)
    nn_weight, _, nn_idx = cal_nn_weight_skeleton(warp, x)
    posed_joints, G = forward_kinematics(rot_mats, warp.joints, warp.net.parents)
    q_r, q_d = qt_to_dq(rotmat_to_quat(G[:, :3, :3]), G[:, :3, 3])  # (J, 4) each
    idx = nn_idx.to(torch.int64)
    b_r, b_d = dq_blend(q_r[idx], q_d[idx], nn_weight)  # (N, 4)
    new_x = dq_apply(b_r, b_d, x) + global_trans
    return {
        "d_xyz": (new_x - x) * motion_mask,
        "d_rotation": b_r.detach() * motion_mask,
        "d_scaling": torch.zeros_like(x),
        "d_nodes": posed_joints + global_trans,
        "nn_idx": nn_idx,
        "nn_weight": nn_weight,
        "local_rotation": local_rotation,
        "global_trans": global_trans,
        "template_offsets": torch.zeros_like(x),
        "d_opacity": None,
        "d_color": None,
    }


def node_deformation(warp: SkeletonWarp, local_rotation: torch.Tensor, global_trans: torch.Tensor) -> torch.Tensor:
    """Posed joints only (skeleton-only visualization)."""
    rot_mats = quat_to_rotmat(local_rotation)
    posed, _ = forward_kinematics(rot_mats, warp.joints, warp.net.parents)
    return posed + global_trans
