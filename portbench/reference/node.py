"""The stage-1 node model in plain PyTorch: the DeformNetwork on the control
nodes, the dense K-nearest-node blend onto the Gaussians, and the ARAP
energy of the node trajectories with its rotations fitted by an SVD.

A frozen copy of the port's plain code (``models/deform_mlp.py`` on the
blender path, ``models/node_warp.py`` ``warp_forward`` / ``arap_loss``,
``ops/knn.py`` ``pairwise_dist2`` / ``_small_k`` / ``knn``, ``ops/arap.py``
``connectivity_from_points`` / ``arap_error`` / ``estimate_rotations_plain``,
``ops/geometry.py`` ``fit_rotations_plain``, ``train/stage1.py``
``stage1_frame_loss`` on phase B's path past the motion-mask and flow
terms, ``stage1_lr_fns_f32``, ``train/schedule.py``
``landmark_interpolate_f32``), over the harness's parameter trees; it
imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import render as R
from portbench.reference import train as T
from portbench.reference.model import positional_embed, trunk


def deform_network(p: dict, x: torch.Tensor, t: torch.Tensor, cfg: dict) -> dict:
    """The blender DeformNetwork: t's encoding through the two-layer
    timenet, x's encoding beside it into the skip-concat trunk, the warp,
    scaling and rotation heads."""
    t_emb = positional_embed(t, cfg["t_multires"])
    t_emb = F.linear(torch.relu(F.linear(t_emb, p["timenet"][0]["w"], p["timenet"][0]["b"])),
                     p["timenet"][1]["w"], p["timenet"][1]["b"])
    h = trunk(p["trunk"]["layers"], torch.cat([positional_embed(x, cfg["x_multires"]), t_emb], dim=-1))
    lin = lambda name: F.linear(h, p[name]["w"], p[name]["b"])  # noqa: E731
    return {"d_xyz": lin("warp"), "d_rotation": lin("rotation"), "d_scaling": lin("scaling")}


def pairwise_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    return torch.maximum(x2 - 2.0 * (x @ y.t()) + y2.t(), torch.zeros((), device=x.device))


def smallest_k(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row, ascending, the first index on a tie."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def node_deform(warp: dict, t: torch.Tensor, cfg: dict) -> dict:
    """The DeformNetwork at the detached node positions; t (M, 1) or (M, T, 1)."""
    nodes = warp["nodes"][:, :3].detach()
    if t.dim() == 3:
        nodes = nodes[:, None, :].expand(nodes.shape[0], t.shape[1], 3)
    return deform_network(warp["mlp"], nodes, t, cfg)


def warp_forward(warp: dict, x: torch.Tensor, t: torch.Tensor, feature: torch.Tensor, motion_mask: torch.Tensor,
                 cfg: dict) -> dict:
    """The node residuals blended onto the Gaussians at x: each point's K
    nearest nodes in (xyz, hyper coords), weights exp(-d^2 / 2 r^2) times
    the node weight, + 1e-7, normalized; translation, rotation and scaling
    as one (N, M) @ (M, 10) product."""
    x = x.detach()
    hyper = cfg["hyper_dim"]
    q = torch.cat([x, feature[:, :hyper]], dim=-1)
    key = torch.cat([warp["nodes"][:, :3].detach(), warp["nodes"][:, 3:]], dim=-1)
    d2 = pairwise_dist2(q, key)
    _, nn_idx = smallest_k(d2.detach(), cfg["K"])
    mask = torch.zeros(d2.shape, dtype=torch.bool, device=d2.device).scatter_(1, nn_idx, True)
    radius = torch.exp(warp["radius"])
    w = torch.exp(-d2 / (2.0 * radius[None, :] ** 2)) * torch.sigmoid(warp["weight"])[None, :, 0]
    w = torch.where(mask, w + 1e-7, 0.0)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    M = warp["nodes"].shape[0]
    attrs = node_deform(warp, t.reshape(1, 1).expand(M, 1), cfg)
    blended = w @ torch.cat([attrs["d_xyz"], attrs["d_rotation"], attrs["d_scaling"]], dim=-1)
    return {"d_xyz": blended[:, 0:3] * motion_mask, "d_rotation": blended[:, 3:7] * motion_mask,
            "d_scaling": blended[:, 7:10] * motion_mask, "d_nodes": warp["nodes"][:, :3] + attrs["d_xyz"]}


def fit_rotations(cov: torch.Tensor) -> torch.Tensor:
    """R = U diag(1, 1, det(U V^T)) V^T of cov = U S V^T."""
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones_like(det)[..., None].expand(*det.shape, 2), det[..., None]], dim=-1)
    return torch.einsum("...ab,...b,...bc->...ac", u, d, vt)


def connectivity(points: torch.Tensor, K: int, radius: float = 0.1, least_edge_num: int = 3):
    """The KNN graph: the first ``least_edge_num`` edges always, later ones
    within ``radius``; weights exp(-d2 / mean d2), normalized per node."""
    d2, idx = smallest_k(pairwise_dist2(points, points), K + 1)
    d2, idx = d2[:, 1:], idx[:, 1:]
    keep = torch.ones_like(d2, dtype=torch.bool)
    keep[:, least_edge_num:] = d2[:, least_edge_num:] < radius**2
    mean_d2 = torch.sum(torch.where(keep, d2, 0.0)) / torch.clamp(torch.sum(keep), min=1)
    weight = torch.where(keep, torch.exp(-d2 / torch.clamp(mean_d2, min=1e-12)), 0.0)
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-12)
    return idx, weight, keep


def arap_loss(warp: dict, t_samp: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The ARAP stretch energy of the nodes at the sample times against the
    first, over the first's KNN graph (K = min(arap_knn, M - 1)), each
    node's rotation fitted without a gradient."""
    M, n_t = warp["nodes"].shape[0], t_samp.shape[0]
    nodes_t = warp["nodes"][:, None, :3].detach() + node_deform(warp, t_samp[None, :, None].expand(M, n_t, 1),
                                                                cfg)["d_xyz"]
    idx, weight, valid = connectivity(nodes_t[:, 0].detach(), K=min(cfg["arap_knn"], M - 1))
    seq = nodes_t.transpose(0, 1)

    def edges(v):
        return torch.where(valid[..., None], v[:, None, :] - v[idx], 0.0)

    src = edges(seq[0])
    total = torch.zeros((), device=seq.device)
    for tgt in seq[1:]:
        e = edges(tgt)
        cov = torch.einsum("nka,nk,nkb->nab", e.detach(), weight, src.detach())
        R = fit_rotations(cov).detach()
        stretch = e - torch.einsum("nab,nkb->nka", R, src)
        total = total + torch.sum(weight * torch.sum(stretch**2, dim=-1))
    return total


def landmark_f32(landmarks, steps, it) -> float:
    """The log interpolation between schedule landmarks, in float32."""
    f32 = np.float32
    step = f32(it)
    stage = int(sum(step >= f32(s) for s in steps))
    if stage == len(steps):
        return float(f32(max(0.0, float(landmarks[-1]))))
    if stage == 0:
        return 0.0
    l1, l2 = float(landmarks[stage - 1]), float(landmarks[stage])
    if l2 <= 0:
        return 0.0
    ratio = (step - f32(steps[stage - 1])) / f32(steps[stage] - steps[stage - 1])
    return float(np.exp(f32(np.log(max(l1, 1e-30))) * (f32(1) - ratio) + f32(np.log(l2)) * ratio))


def phase_b_loss(gs: dict, warp: dict, alive, frame: dict, arap_t, it: int, cfg: dict):
    """The phase-B loss of one frame: the photometric loss of the render of
    the node-warped Gaussians, the ARAP energy at the schedule's lambda,
    the chamfer of the deformed nodes' projections. Returns (loss, render,
    deformation, ARAP energy, chamfer)."""
    n, o = cfg["nodes"], cfg["riggs"]["opt"]
    mm = torch.sigmoid(gs["feature"][:, -1:])
    d = warp_forward(warp, gs["xyz"], frame["fid"], gs["feature"], mm, n)
    out = R.render(gs, alive, d["d_xyz"], d["d_rotation"], frame["w2c"], frame["intr"], frame["width"],
                   frame["height"], frame["bg"])
    loss = T.photometric(out["image"], frame["image"], o["lambda_dssim"])
    arap = arap_loss(warp, arap_t, n)
    loss = loss + landmark_f32(n["arap_landmarks"], n["arap_steps"], it) * arap
    proj = T.project_rows_cols(frame["w2c"], frame["intr"], d["d_nodes"])
    cd = T.chamfer_l1(proj, frame["thinned"], frame["thinned_mask"])
    loss = loss + o["lambda_deformed_node_prjection"] * 1.0 * cd
    return loss, out, d, arap, cd


def phase_b_lrs(cfg: dict, it: int) -> dict:
    """The learning rates of a phase-B step, as float32 values: the
    Gaussians' as in stage 2, the warp's MLP on its own schedule and its
    nodes, radii and weights at the initial deform rate."""
    o = cfg["riggs"]["opt"]
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    deform_init = o["position_lr_init"] * 5.0 * o["deform_lr_scale"]
    gs = {"xyz": T.expon_lr_f32(o["position_lr_init"], o["position_lr_final"], o["position_lr_delay_mult"],
                                o["position_lr_max_steps"], it),
          "f_dc": f32(o["feature_lr"]), "f_rest": f32(o["feature_lr"] / 20.0), "opacity": f32(o["opacity_lr"]),
          "scaling": f32(o["scaling_lr"]), "rotation": f32(o["rotation_lr"]), "feature": f32(o["feature_lr"])}
    mlp = T.expon_lr_f32(deform_init, o["position_lr_final"] * o["deform_lr_scale"], o["position_lr_delay_mult"],
                         o["deform_lr_max_steps"], it)
    return {"gs": gs, "warp": {"nodes": f32(deform_init), "radius": f32(deform_init), "weight": f32(deform_init),
                               "mlp": mlp}}
