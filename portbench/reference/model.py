"""The skeleton model in plain PyTorch: the three MLPs, forward kinematics
and dense skinning.

A frozen copy of the port's plain code (``models/mlp.py``,
``models/skeleton_warp.py`` ``pose_at`` / ``deform_by_pose`` with a dense
skinning, ``ops/fk.py``, ``ops/quaternion.py``, ``ops/geometry.py``
``point_segment_dist2``, ``edit/pose_edit.py`` ``rotate_joint``), kept here
so that the reference calls nothing of the program. Parameters are the
harness's trees (``scene.make_skeleton_weights``): linear weights (d_out,
d_in).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-12
ROT_BIAS = (1.0, 0.0, 0.0, 0.0)


def positional_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ...]: per frequency a block of sines,
    then a block of cosines."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, enc], dim=-1)


def trunk(layers: list, x: torch.Tensor) -> torch.Tensor:
    """Relu layers with the skip concat [x, h] after layer depth // 2."""
    skip = len(layers) // 2
    h = x
    for i, p in enumerate(layers):
        h = torch.relu(F.linear(h, p["w"], p["b"]))
        if i == skip:
            h = torch.cat([x, h], dim=-1)
    return h


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.linear(trunk(p["layers"], x), p["head"]["w"], p["head"]["b"])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + EPS * EPS)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, x, y, z = torch.unbind(q, dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
                     2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
                     2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Shepperd's construction: the candidate of largest squared magnitude, w >= 0."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    qw2, qx2 = 1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22
    qy2, qz2 = 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22

    def sq(v):
        return torch.sqrt(torch.clamp(v, min=EPS))

    def div(a, b):
        return a / torch.clamp(b, min=EPS)

    w_w = sq(qw2) * 0.5
    c_w = torch.stack([div(4.0 * w_w * w_w / 2.0, 2.0 * w_w), div(m[..., 2, 1] - m[..., 1, 2], 4.0 * w_w),
                       div(m[..., 0, 2] - m[..., 2, 0], 4.0 * w_w), div(m[..., 1, 0] - m[..., 0, 1], 4.0 * w_w)], -1)
    x_x = sq(qx2) * 0.5
    c_x = torch.stack([div(m[..., 2, 1] - m[..., 1, 2], 4.0 * x_x), x_x,
                       div(m[..., 0, 1] + m[..., 1, 0], 4.0 * x_x), div(m[..., 0, 2] + m[..., 2, 0], 4.0 * x_x)], -1)
    y_y = sq(qy2) * 0.5
    c_y = torch.stack([div(m[..., 0, 2] - m[..., 2, 0], 4.0 * y_y), div(m[..., 0, 1] + m[..., 1, 0], 4.0 * y_y),
                       y_y, div(m[..., 1, 2] + m[..., 2, 1], 4.0 * y_y)], -1)
    z_z = sq(qz2) * 0.5
    c_z = torch.stack([div(m[..., 1, 0] - m[..., 0, 1], 4.0 * z_z), div(m[..., 0, 2] + m[..., 2, 0], 4.0 * z_z),
                       div(m[..., 1, 2] + m[..., 2, 1], 4.0 * z_z), z_z], -1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([c_w, c_x, c_y, c_z], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def forward_kinematics(rot_mats: torch.Tensor, rest: torch.Tensor, parents: tuple) -> tuple:
    """Posed joints (K, 3) and global transforms (K, 4, 4), composed joint
    by joint from the root (each local transform rotates about the rest
    position of the joint's parent)."""
    K = rot_mats.shape[0]
    pivot = rest[torch.tensor((0,) + tuple(parents[1:]), device=rest.device)]
    trans = pivot - torch.einsum("kab,kb->ka", rot_mats, pivot)
    T = torch.zeros((K, 4, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    T[:, :3, :3] = rot_mats
    T[:, :3, 3] = trans
    T[:, 3, 3] = 1.0
    G = [T[0]]
    for j in range(1, K):
        G.append(G[parents[j]] @ T[j])
    G = torch.stack(G)
    posed = torch.einsum("kab,kb->ka", G[:, :3, :3], rest) + G[:, :3, 3]
    return posed, G


def pose_at(skel: dict, t: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """PoseMLP(t): local rotations (J, 4) with the [1, 0, 0, 0] bias, and
    the global translation (3,)."""
    p = skel["pose"]
    J = p["rotation"]["w"].shape[0] // 4
    h = trunk(p["layers"], positional_embed(t.reshape(1, 1), cfg["pose_multires"]))
    rot = F.linear(h, p["rotation"]["w"], p["rotation"]["b"]).reshape(J, 4)
    trans = F.linear(h, p["translation"]["w"], p["translation"]["b"])[0]
    return rot + torch.tensor(ROT_BIAS, device=rot.device), trans


def rotate_joint(rot: torch.Tensor, joint: int, view_axis: np.ndarray, angle: float) -> torch.Tensor:
    """A rotation of ``angle`` radians about ``view_axis`` composed onto ``joint``."""
    axis = np.asarray(view_axis, np.float32)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    dq = np.concatenate([[np.cos(angle / 2.0)], np.sin(angle / 2.0) * axis]).astype(np.float32)
    out = rot.clone()
    out[joint] = quat_normalize(quat_multiply(torch.as_tensor(dq, device=rot.device), rot[joint]))
    return out


def segment_dist2(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared distance of each point (N, 3) to each segment [a_j, b_j]: (N, K)."""
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-6)
    ap = x[:, None, :] - a[None, :, :]
    t = torch.clamp(torch.sum(ap * ab[None], dim=-1) / denom, 0.0, 1.0)
    diff = a[None] + t[..., None] * ab[None] - x[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def deform(skel: dict, joints: torch.Tensor, parents: tuple, x: torch.Tensor, rot: torch.Tensor,
           trans: torch.Tensor, motion_mask: torch.Tensor, cfg: dict, rows: slice | None = None) -> dict:
    """Pose the skeleton and skin the points densely over every bone, the
    WeightMLP modulating the kernel weights and the detail MLP adding the
    template offsets (both on, weight 1). ``rows`` limits the points to a
    block: the skinning of a point reads no other point."""
    x = x.detach()
    if rows is not None:
        x, motion_mask = x[rows], motion_mask[rows]
    G_rot = quat_to_rotmat(rot)
    posed, G = forward_kinematics(G_rot, joints, parents)
    Grot, Gtrans = G[:, :3, :3], G[:, :3, 3]
    node_rot = rotmat_to_quat(Grot.detach())
    pidx = torch.tensor(parents[1:], device=x.device)
    d2 = segment_dist2(joints[pidx], joints[1:], x)
    radius = torch.exp(skel["radius"])[1:]
    w = torch.exp(-d2 / (2.0 * radius[None, :] ** 2))
    offs = torch.sigmoid(mlp(skel["skinning_mlp"], positional_embed(x, cfg["weight_multires"])))
    w = w * (1.0 + 1.0 * (offs - 1.0))
    w = w + 1e-7
    w = w / torch.sum(w, dim=-1, keepdim=True)
    B = Grot.shape[0] - 1
    table = torch.cat([Grot[1:].reshape(B, 9), Gtrans[1:], node_rot[1:]], dim=-1)
    blended = w @ table
    WR = blended[:, :9].reshape(-1, 3, 3)
    moved = torch.einsum("nab,nb->na", WR, x) + blended[:, 9:12]
    pose_vec = rot.detach().reshape(-1)
    xin = torch.cat([positional_embed(x, cfg["detail_multires"]), pose_vec[None, :].expand(x.shape[0], -1)], dim=-1)
    offsets = 1.0 * mlp(skel["detail_net"], xin)
    moved = moved + trans + offsets
    return {"d_xyz": (moved - x) * motion_mask, "d_rotation": blended[:, 12:16] * motion_mask,
            "d_nodes": posed + trans, "template_offsets": offsets, "local_rotation": rot, "global_trans": trans}
