"""The splat render in plain PyTorch: spherical harmonics, EWA projection,
each 32 x 32 tile's Gaussians in depth order, and front-to-back
compositing, forward and backward.

The projection and the colours are a frozen copy of the port's plain code
(``render/api.py``, ``render/project.py``, ``ops/sh.py``). A Gaussian
belongs to every tile its 3-sigma rectangle touches (the CUDA
rasterizer's ``getRect``); a tile composites its Gaussians in (depth, index)
order as the port's oracle does (``render/oracle.py``):

    P_i = prod_{j<=i} (1 - a_j);  w_i = a_i * P_{i-1} * [P_i >= 1e-4]

with a_i = min(opacity * exp(power), 0.99), 0 where the power is positive
or a_i < 1/255. Tiles are composited in blocks of similar length, each
block under ``torch.utils.checkpoint`` so that the backward recomputes one
block at a time. Nothing here reads the program's windows, ladder or
chunks.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import quat_normalize

TILE = 32
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BLOCK_ELEMENTS = 1 << 25  # (tiles x pixels x Gaussians) of one composited block

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
      1.445305721320277, -0.5900435899266435)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-3 real spherical harmonics: sh (N, 16, 3), dirs (N, 3) unit."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    r = C0 * sh[..., 0, :]
    r = r - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :] - C1 * x * sh[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    r = (r + C2[0] * xy * sh[..., 4, :] + C2[1] * yz * sh[..., 5, :] + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
         + C2[3] * xz * sh[..., 7, :] + C2[4] * (xx - yy) * sh[..., 8, :])
    return (r + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :] + C3[1] * xy * z * sh[..., 10, :]
            + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :] + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
            * sh[..., 12, :] + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :] + C3[5] * z * (xx - yy)
            * sh[..., 14, :] + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])


def cov3d(scales: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Packed upper triangle of R S S^T R^T: (N, 6)."""
    q = quat_normalize(rotations)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00, r01, r02 = 1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)
    r10, r11, r12 = 2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)
    r20, r21, r22 = 2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)
    s0, s1, s2 = scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2
    return torch.stack([r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
                        r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
                        r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
                        r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
                        r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
                        r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2], dim=-1)


def project(w2c, intr, width, height, means3d, cov, alive):
    """EWA projection: (mean2d (N, 2), depth (N,), conic (N, 3), radius (N,), mask (N,))."""
    view = means3d @ w2c[:3, :3].T + w2c[:3, 3]
    tx, ty, tz = view[:, 0], view[:, 1], view[:, 2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    one = torch.ones((), device=tz.device)
    tz_safe = torch.maximum(tz, 1e-6 * one)
    limx, limy = 1.3 * (0.5 * width / fx), 1.3 * (0.5 * height / fy)
    txz = torch.maximum(torch.minimum(tx / tz_safe, limx), -limx) * tz_safe
    tyz = torch.maximum(torch.minimum(ty / tz_safe, limy), -limy) * tz_safe
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    j00, j02, j11, j12 = fx * inv_z, -fx * txz * inv_z2, fy * inv_z, -fy * tyz * inv_z2
    W = w2c[:3, :3]
    t00, t01, t02 = j00 * W[0, 0] + j02 * W[2, 0], j00 * W[0, 1] + j02 * W[2, 1], j00 * W[0, 2] + j02 * W[2, 2]
    t10, t11, t12 = j11 * W[1, 0] + j12 * W[2, 0], j11 * W[1, 1] + j12 * W[2, 1], j11 * W[1, 2] + j12 * W[2, 2]
    s00, s01, s02, s11, s12, s22 = (cov[:, i] for i in range(6))
    u0, u1, u2 = t00 * s00 + t01 * s01 + t02 * s02, t00 * s01 + t01 * s11 + t02 * s12, t00 * s02 + t01 * s12 + t02 * s22
    v0, v1, v2 = t10 * s00 + t11 * s01 + t12 * s02, t10 * s01 + t11 * s11 + t12 * s12, t10 * s02 + t11 * s12 + t12 * s22
    a = u0 * t00 + u1 * t01 + u2 * t02 + 0.3
    b = u0 * t10 + u1 * t11 + u2 * t12
    c = v0 * t10 + v1 * t11 + v2 * t12 + 0.3
    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.maximum(det, 1e-12 * one), 0.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.maximum(mid * mid - det, 0.1 * one))))
    mean2d = torch.stack([fx * tx * inv_z + cx - 0.5, fy * ty * inv_z + cy - 0.5], dim=-1)
    on_screen = ((mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < width)
                 & (mean2d[:, 1] + radius > 0) & (mean2d[:, 1] - radius < height))
    mask = (tz > 0.2) & det_ok & on_screen & alive
    return mean2d, tz, conic, torch.where(mask, radius, 0.0), mask


def colors_of(gs: dict, means3d: torch.Tensor, w2c: torch.Tensor) -> torch.Tensor:
    """Degree-3 SH colours seen from the camera centre, + 0.5, clamped at 0."""
    center = -w2c[:3, :3].T @ w2c[:3, 3]
    dirs = means3d - center
    dirs = dirs / torch.maximum(torch.linalg.norm(dirs, dim=-1, keepdim=True), torch.full((), 1e-8, device=dirs.device))
    feats = torch.cat([gs["f_dc"], gs["f_rest"]], dim=1)
    return torch.maximum(eval_sh(feats, dirs) + 0.5, torch.zeros((), device=dirs.device))


def tile_lists(mean2d, depth, radius, mask, width, height):
    """Each tile's Gaussians in (depth, index) order: (gid (M,) sorted by
    tile then depth, starts (T,), counts (T,), tiles_x). A Gaussian is in
    every tile of its clamped rectangle [floor((m - r) / 32), floor((m + r) / 32)]."""
    tx_n, ty_n = -(-width // TILE), -(-height // TILE)
    T, N, dev = tx_n * ty_n, mean2d.shape[0], mean2d.device

    def ftile(v, n):
        return torch.clamp(torch.floor(v), 0, n - 1).to(torch.int64)

    mx, my = mean2d[:, 0].detach(), mean2d[:, 1].detach()
    lox, hix = ftile((mx - radius) / TILE, tx_n), ftile((mx + radius) / TILE, tx_n)
    loy, hiy = ftile((my - radius) / TILE, ty_n), ftile((my + radius) / TILE, ty_n)
    w, h = hix - lox + 1, hiy - loy + 1
    side = int(torch.maximum(torch.where(mask, w, 1).max(), torch.where(mask, h, 1).max()))
    ks = torch.arange(side * side, device=dev)
    dx, dy = (ks % side)[:, None], (ks // side)[:, None]
    ok = mask[None] & (dx < w[None]) & (dy < h[None])
    tile = ((loy[None] + dy) * tx_n + lox[None] + dx)[ok]
    gid = torch.arange(N, device=dev)[None].expand(side * side, N)[ok]
    order = torch.sort(torch.where(mask, depth.detach(), torch.inf), stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=dev)
    key = torch.sort(tile * N + rank[gid]).values
    counts = torch.bincount(key // N, minlength=T)
    starts = torch.cumsum(counts, 0) - counts
    return order[key % N], starts, counts, tx_n


def _composite(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """One block of tiles: g (B, n, 10) rows [x, y, conic a, b, c, opacity,
    r, g, b, depth] in depth order, px / py (B, 1024) pixel coordinates ->
    (B, 1024, 5) [rgb, depth, alpha]."""
    dx = px[:, :, None] - g[:, None, :, 0]
    dy = py[:, :, None] - g[:, None, :, 1]
    power = -0.5 * (g[:, None, :, 2] * dx * dx + g[:, None, :, 4] * dy * dy) - g[:, None, :, 3] * dx * dy
    alpha = g[:, None, :, 5] * torch.exp(power)
    alpha = torch.where(power > 0.0, 0.0, alpha)
    alpha = torch.clamp(alpha, max=ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
    one_m = 1.0 - alpha
    P = torch.cumprod(one_m, dim=-1)
    wgt = alpha * (P / one_m) * (P >= T_EPS)
    rgbd = torch.einsum("bpn,bnc->bpc", wgt, g[:, :, 6:10])
    return torch.cat([rgbd, wgt.sum(-1, keepdim=True)], dim=-1)


def blocks(counts: torch.Tensor, budget: int = BLOCK_ELEMENTS):
    """Tiles in blocks of similar length: [(tile ids, padded length)], the
    longest first, each block within ``budget`` (tiles x 1024 x length)."""
    c = counts.cpu()
    order = torch.argsort(c, descending=True)
    out, i = [], 0
    while i < len(order):
        n = max(int(c[order[i]]), 1)
        k = max(1, min(len(order) - i, budget // (1024 * n)))
        out.append((order[i:i + k], n))
        i += k
    return out


def render(gs: dict, alive, d_xyz, d_rotation, w2c, intr, width, height, bg, budget=BLOCK_ELEMENTS,
           with_lists=False):
    """The frame of Gaussians ``gs`` (the params tree) moved by d_xyz and
    d_rotation: {"image" (H, W, 3), "depth" (H, W), "alpha" (H, W)};
    differentiable in ``gs``, d_xyz and d_rotation."""
    means3d = gs["xyz"] + d_xyz
    opacity = torch.sigmoid(gs["opacity"])[:, 0]
    scales = torch.exp(gs["scaling"])
    rotations = quat_normalize(gs["rotation"] + d_rotation)
    colors = colors_of(gs, means3d, w2c)
    mean2d, depth, conic, radius, mask = project(w2c, intr, width, height, means3d, cov3d(scales, rotations), alive)
    gid, starts, counts, tx_n = tile_lists(mean2d, depth, radius, mask, width, height)
    packed = torch.cat([mean2d, conic, torch.where(mask, opacity, 0.0)[:, None], colors, depth[:, None]], dim=-1)
    packed = torch.cat([packed, torch.zeros_like(packed[:1])])  # row N: the padding, alpha 0
    N, dev = mean2d.shape[0], mean2d.device
    gid_pad = torch.cat([gid, torch.full((1,), N, device=dev)])
    p = torch.arange(TILE * TILE, device=dev)
    vals, rows = [], []
    for tids, n in blocks(counts, budget):
        tids = tids.to(dev)
        s = torch.arange(n, device=dev)[None]
        pos = torch.clamp(starts[tids][:, None] + s, max=gid.numel())
        g = packed[torch.where(s < counts[tids][:, None], gid_pad[pos], N)]
        px = ((tids % tx_n) * TILE)[:, None] + p % TILE
        py = ((tids // tx_n) * TILE)[:, None] + p // TILE
        pxf, pyf = px.to(torch.float32), py.to(torch.float32)
        out = checkpoint(_composite, g, pxf, pyf, use_reentrant=False) if torch.is_grad_enabled() \
            else _composite(g, pxf, pyf)
        vals.append(out.reshape(-1, 5))
        rows.append((tids[:, None] * (TILE * TILE) + p).reshape(-1))
    T = counts.shape[0]
    full = torch.zeros((T * TILE * TILE, 5), device=dev).index_copy(0, torch.cat(rows), torch.cat(vals))
    ty_n = T // tx_n
    full = full.reshape(ty_n, tx_n, TILE, TILE, 5).permute(0, 2, 1, 3, 4).reshape(ty_n * TILE, tx_n * TILE, 5)
    full = full[:height, :width]
    acc = full[..., 4]
    out = {"image": full[..., :3] + (1.0 - acc)[..., None] * bg, "depth": full[..., 3], "alpha": acc}
    if with_lists:
        out["lists"] = (gid, starts, counts, tx_n, packed.detach())
    return out
