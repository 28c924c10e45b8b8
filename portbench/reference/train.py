"""The stage-2 training step and the viewer's frame in plain PyTorch.

A frozen copy of the port's plain code (``train/stage2.py``
``stage2_frame_loss`` and ``stage2_step`` past the warm-up with every
model part unlocked, ``train/losses.py`` L1 and SSIM, ``ops/knn.py``
``chamfer_distance``, ``camera/camera.py`` ``project_nodes_2d``,
``train/optim.py`` Adam, ``train/schedule.py`` ``expon_lr_f32``), over the
harness's parameter trees. It imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as M
from portbench.reference import render as R


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree, prefix=""):
    """[(path, tensor)] in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


# ---- losses ----------------------------------------------------------------


def abs_jax(x):
    return torch.where(x >= 0, x, -x)


def _band(n: int, device) -> torch.Tensor:
    x = np.arange(11) - 5
    g = np.exp(-(x**2) / (2.0 * 1.5**2))
    g = (g / g.sum()).astype(np.float32)
    T = np.zeros((n, n), np.float32)
    for o in range(-5, 6):
        if abs(o) < n:
            T += np.diag(np.full(n - abs(o), g[o + 5], np.float32), k=o)
    return torch.as_tensor(T, device=device)


def _blur(img, Th, Tw):
    return torch.einsum("wW,bhWc->bhwc", Tw, torch.einsum("hH,bHwc->bhwc", Th, img))


def ssim(img1, img2):
    img1, img2 = img1[None], img2[None]
    Th, Tw = _band(img1.shape[1], img1.device), _band(img1.shape[2], img1.device)
    mu1, mu2 = _blur(img1, Th, Tw), _blur(img2, Th, Tw)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    zero = img1.new_zeros(())
    s1 = torch.maximum(_blur(img1 * img1, Th, Tw) - mu1_sq, zero)
    s2 = torch.maximum(_blur(img2 * img2, Th, Tw) - mu2_sq, zero)
    s12 = _blur(img1 * img2, Th, Tw) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    return torch.mean(((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)))


def photometric(img, gt, lambda_dssim):
    return (1.0 - lambda_dssim) * torch.mean(abs_jax(img - gt)) + lambda_dssim * (1.0 - ssim(img, gt))


def chamfer_l1(x, y, y_mask):
    diff = x[:, None, :] - y[None, :, :]
    d = torch.sum(abs_jax(diff), dim=-1)
    d = torch.where(y_mask[None, :], d, 1e12)
    mean_x = torch.mean(torch.amin(d, dim=1))
    dy = torch.amin(d, dim=0)
    return mean_x + torch.sum(torch.where(y_mask, dy, 0.0)) / torch.clamp(torch.sum(y_mask), min=1)


def project_rows_cols(w2c, intr, pts):
    view = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = torch.maximum(view[..., 2], torch.full((), 1e-6, device=pts.device))
    return torch.stack([intr[1] * view[..., 1] / z + intr[3], intr[0] * view[..., 0] / z + intr[2]], dim=-1)


def bone_samples(joints, parents, n=8):
    a, b = joints[torch.tensor(parents[1:], device=joints.device)], joints[1:]
    t = torch.linspace(0.0, 1.0, n, device=joints.device)[:, None, None]
    return ((1.0 - t) * a[None] + t * b[None]).reshape(-1, 3)


def median(x):
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


# ---- schedule and Adam -----------------------------------------------------


def expon_lr_f32(lr_init, lr_final, lr_delay_mult, max_steps, it):
    f32 = np.float32
    t = np.clip(f32(it) / f32(max_steps), f32(0.0), f32(1.0))
    return float(f32(f32(1.0) * np.exp(f32(np.log(lr_init)) * (f32(1) - t) + f32(np.log(lr_final)) * t)))


def adam(grads, mu, nu, params, lrs, count, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step over matching trees; ``lrs`` a tree prefix (dict of
    floats, or one float). Returns (params, mu, nu)."""
    cnt = torch.tensor(float(count), device=leaves(params)[0][1].device)
    c1, c2 = 1.0 - b1 ** cnt, 1.0 - b2 ** cnt

    def expand(prefix, tree):
        if isinstance(prefix, dict):
            return {k: expand(prefix[k], v) for k, v in tree.items()}
        return tree_map(lambda _: prefix, tree)

    def leaf(g, m, v, p, lr):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + eps), m, v

    out = tree_map(leaf, grads, mu, nu, params, expand(lrs, params))
    return _pick(out, 0), _pick(out, 1), _pick(out, 2)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


# ---- stage 2 ---------------------------------------------------------------


def frame_loss(gs, skel, alive, joints, parents, frame, uid, proj_loss, cfg, template_idx=0):
    """The stage-2 loss of one frame past the warm-up: template offsets,
    the robust 2-D skeleton chamfer, the template-fixed pose loss and the
    photometric loss of the render. Returns (loss, render, deformation,
    chamfer)."""
    o, sk = cfg["riggs"]["opt"], cfg["skeleton"]
    is_t = uid == template_idx
    rot, trans = M.pose_at(skel, frame["fid"], sk)
    mm = torch.sigmoid(gs["feature"][:, -1:])
    d = M.deform(skel, joints, parents, gs["xyz"], rot, trans, mm, sk)
    loss = torch.zeros((), device=rot.device)
    loss = loss + o["lambda_template_offsets"] * (1e3 if is_t else 1.0) * torch.mean(d["template_offsets"] ** 2)
    proj = project_rows_cols(frame["w2c"], frame["intr"], bone_samples(d["d_nodes"], parents))
    cd = chamfer_l1(proj, frame["thinned"], frame["thinned_mask"])
    sigma = median(proj_loss) / 2.0
    w = torch.exp(-proj_loss[uid] ** 2 / (2.0 * sigma**2))
    loss = loss + o["lambda_deformed_node_prjection"] * 1.0 * w * cd
    tf = torch.mean((d["local_rotation"] - torch.tensor(M.ROT_BIAS, device=rot.device)) ** 2)
    loss = loss + (o["lambda_template_fixed"] if is_t else 0.0) * tf
    out = R.render(gs, alive, d["d_xyz"], d["d_rotation"], frame["w2c"], frame["intr"], frame["width"],
                   frame["height"], frame["bg"])
    img = photometric(out["image"], frame["image"], o["lambda_dssim"])
    loss = loss + (1.0 - 0.0) * o["lambda_rendering_image"] * img
    return loss, out, d, cd


def step_lrs(cfg, it):
    o = cfg["riggs"]["opt"]
    gs_lr = {"xyz": expon_lr_f32(o["position_lr_init"], o["position_lr_final"], o["position_lr_delay_mult"],
                                 o["position_lr_max_steps"], it),
             "f_dc": o["feature_lr"], "f_rest": o["feature_lr"] / 20.0, "opacity": o["opacity_lr"],
             "scaling": o["scaling_lr"], "rotation": o["rotation_lr"], "feature": o["feature_lr"]}
    skel_lr = expon_lr_f32(o["deform_mlp_lr_init"], o["deform_mlp_lr_final"], o["deform_mlp_lr_delay_mult"],
                           o["deform_mlp_lr_max_steps"], max(it - o["skeleton_warm_up"], 0))
    return gs_lr, skel_lr
