"""The seeded inputs of a ZJU-MoCap cell: a human body's Gaussians and the
train frames of a ring of cameras.

The body is SMPL's 24-joint tree at rest (``scene.REST_JOINTS``) with a
capsule about each of its 23 bones; the Gaussians lie on the capsules'
surfaces, each bone's share by its capsule's area, their scales drawn
about the surface's mean spacing. The capture is ZJU-MoCap's in the
HumanNeRF layout that ``riggs_tpu_torch/data/zju.py`` reads: square frames,
each from one of the ring's train cameras in turn, each camera with a K of
its own (the principal point tens of pixels off the centre at 1024), the
subject's global transform (Rh, Th) of each frame folded into the
extrinsics as the reader folds it, the targets black outside the body's
mask. A target is a smooth seeded colour field over the capsules'
silhouette; its 2-D skeleton points are the projected bones sampled one
pixel apart with a pixel of seeded noise, padded to ``MAX_THINNED``.

The capture (the cameras and each frame's global transform) is one draw
for every seed, as ``scene.make_frames``'s views are; the seed draws the
body's Gaussians, the targets' colours and the points' noise. Nothing here
imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.scene import PARENTS, REST_JOINTS, SH_C0, Frames, generator, host_rng, sh_dim
from portbench.scene import frame_order  # noqa: F401 (training.py's set-up reads it through this module)

MAX_THINNED = 4096  # padded 2-D skeleton points per frame (riggs_tpu_torch/data/zju.py)
CAPTURE_SEED = 377  # the one draw of the capture


# ---------------------------------------------------------------------------
# the body
# ---------------------------------------------------------------------------


def _bones(joints: torch.Tensor, radii) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each bone's parent joint, child joint and capsule radius."""
    parents = torch.tensor(PARENTS[1:], device=joints.device)
    return joints[parents], joints[1:], torch.tensor(radii, dtype=torch.float32, device=joints.device)


def capsule_areas(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A capsule's surface: its cylinder's side and its two hemispheres."""
    return 2 * math.pi * r * torch.linalg.norm(b - a, dim=1) + 4 * math.pi * r * r


def _on_capsules(a, b, r, n: int, g: torch.Generator) -> torch.Tensor:
    """``n`` points uniform on the union of the capsules' surfaces, counted
    per capsule by its area (overlaps at the joints are not removed)."""
    dev = a.device
    area = capsule_areas(a, b, r)
    k = torch.multinomial(area / area.sum(), n, replacement=True, generator=g)
    a, b, r = a[k], b[k], r[k][:, None]
    axis = b - a
    length = torch.linalg.norm(axis, dim=1, keepdim=True)
    axis = axis / length.clamp(min=1e-9)
    helper = torch.where(axis[:, :1].abs() < 0.9, torch.tensor([1.0, 0.0, 0.0], device=dev),
                         torch.tensor([0.0, 1.0, 0.0], device=dev))
    e1 = torch.linalg.cross(axis, helper)
    e1 = e1 / torch.linalg.norm(e1, dim=1, keepdim=True)
    e2 = torch.linalg.cross(axis, e1)
    u = torch.rand((n, 1), generator=g, device=dev)
    theta = 2 * math.pi * torch.rand((n, 1), generator=g, device=dev)
    side = a + u * (b - a) + r * (torch.cos(theta) * e1 + torch.sin(theta) * e2)
    d = torch.randn((n, 3), generator=g, device=dev)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True).clamp(min=1e-9)
    cap = torch.where((d * axis).sum(1, keepdim=True) >= 0, b, a) + r * d
    on_side = torch.rand((n, 1), generator=g, device=dev) * (length + 2 * r) < length  # side: 2 pi r L of the area
    return torch.where(on_side, side, cap)


def make_gaussians(cfg: dict, seed: int, device) -> dict:
    """The Gaussians' parameter tree (``scene.make_gaussians``'s keys) and
    ``alive``: ``n_alive`` of ``capacity`` slots on the capsules, each scale
    U(0.5, 1.5) times the mean spacing sqrt(area / n_alive), random
    rotations; opacity, colours and SH as ``scene.make_gaussians`` draws
    them. Dead slots are zero with identity rotations."""
    a = cfg["avatar"]
    C, N, deg = a["capacity"], a["n_alive"], a["sh_degree"]
    g = generator(seed, 1, device)
    joints = torch.tensor(REST_JOINTS, dtype=torch.float32, device=device)
    joints = joints + 0.01 * torch.randn(joints.shape, generator=g, device=device)
    pa, pb, r = _bones(joints, a["bone_radii"])
    xyz = _on_capsules(pa, pb, r, N, g)
    spacing = math.sqrt(float(capsule_areas(pa, pb, r).sum()) / N)

    def pad(x, fill=0.0):
        out = torch.full((C,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=device)
        out[:N] = x
        return out

    rot = torch.zeros((C, 4), device=device)
    rot[:, 0] = 1.0
    rot[:N] = torch.randn((N, 4), generator=g, device=device)
    rgb = 0.1 + 0.8 * torch.rand((N, 1, 3), generator=g, device=device)
    scale = spacing * (0.5 + torch.rand((N, 3), generator=g, device=device))
    params = {
        "xyz": pad(xyz),
        "f_dc": pad((rgb - 0.5) / SH_C0),
        "f_rest": pad(0.05 * torch.randn((N, sh_dim(deg) - 1, 3), generator=g, device=device)),
        "scaling": pad(torch.log(scale)),
        "rotation": rot,
        "opacity": pad(1.0 + torch.randn((N, 1), generator=g, device=device)),
        "feature": pad(2.0 + torch.randn((N, 1), generator=g, device=device)),  # the motion-mask logit
    }
    alive = torch.arange(C, device=device) < N
    return {"params": params, "alive": alive, "joints": joints}


# ---------------------------------------------------------------------------
# the capture
# ---------------------------------------------------------------------------


def _rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix."""
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def fold_global_transform(E: np.ndarray, Rh: np.ndarray, Th: np.ndarray) -> np.ndarray:
    """The subject's global transform folded into the extrinsics E, as the
    reader folds it: E @ inverse([R(Rh)^T | -R(Rh)^T Th])."""
    G = np.eye(4)
    G[:3, :3] = _rodrigues(np.asarray(Rh, np.float64).reshape(3)).T
    G[:3, 3] = -G[:3, :3] @ np.asarray(Th, np.float64).reshape(3)
    return E @ np.linalg.inv(G)


def ring_camera(cid: int, f: dict, size: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Camera ``cid`` (1-based) of the ring: (world-to-camera (4, 4), K
    (fx, fy, cx, cy)) at ``size``. It stands ``distance`` from the subject at
    the ring's angle, looking at it, image y down; fx = size / 2 / tan(half
    fov), fy = ``fy_ratio`` fx, the principal point offset by U(lo, hi)
    pixels at 1024 (scaled with ``size``) right of and above the centre."""
    angle = 2 * np.pi * (cid - 1) / f["ring"]
    R = np.array([[np.cos(angle), 0.0, -np.sin(angle)], [0.0, -1.0, 0.0], [-np.sin(angle), 0.0, -np.cos(angle)]])
    center = np.array([f["distance"] * np.sin(angle), f["camera_height"], f["distance"] * np.cos(angle)])
    E = np.eye(4)
    E[:3, :3], E[:3, 3] = R, -R @ center
    fx = size / 2 / np.tan(f["half_fov"])
    lo, hi = f["principal_offset_px"]
    off = size / 1024 * rng.uniform(lo, hi, size=2)
    return E, np.array([fx, fx * f["fy_ratio"], size / 2 + off[0], size / 2 - off[1]])


def capture(f: dict, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Every frame's world-to-camera (F, 4, 4) and intrinsics (F, 4), float32:
    frame i from train camera ``cameras[i % len(cameras)]``, its global
    transform Rh ~ N(0, rh_sigma), Th ~ N(0, th_sigma) folded in."""
    rng = host_rng(CAPTURE_SEED, 7)
    cams = [ring_camera(c, f, size, rng) for c in f["cameras"]]
    n = f["n_frames"]
    rh = rng.normal(scale=f["rh_sigma"], size=(n, 3))
    th = rng.normal(scale=f["th_sigma"], size=(n, 3))
    w2c = np.stack([fold_global_transform(cams[i % len(cams)][0], rh[i], th[i]) for i in range(n)])
    intr = np.stack([cams[i % len(cams)][1] for i in range(n)])
    return w2c.astype(np.float32), intr.astype(np.float32)


def _pixels(view: torch.Tensor, intr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points (B, P, 3) -> pixel (x, y) (B, P, 2) and depth (B, P)."""
    z = view[..., 2].clamp(min=1e-6)
    return view[..., :2] / z[..., None] * intr[:, None, :2] + intr[:, None, 2:], z


def make_frames(cfg: dict, seed: int, joints: torch.Tensor, device, block: int = 4) -> Frames:
    """The ``n_frames`` train frames of the ring capture (``capture``): the
    targets and the 2-D skeleton points as the module's docstring says. A
    pixel is in the mask where it lies within a bone's projected capsule:
    the projected bone, its radius in pixels r f / z at each end and
    linear between."""
    f, radii = cfg["frames"], cfg["avatar"]["bone_radii"]
    n, size = f["n_frames"], f["size"]
    w2c_np, intr_np = capture(f, size)
    w2c, intr = torch.tensor(w2c_np, device=device), torch.tensor(intr_np, device=device)
    fid = torch.tensor(np.arange(n) / max(n - 1, 1), dtype=torch.float32, device=device)
    pa3, pb3, r = _bones(joints, radii)
    n_bones = r.shape[0]

    g = generator(seed, 4, device)
    freq = 0.5 + 1.5 * torch.rand((n, 3, 2), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((n, 3), generator=g, device=device)
    steps = int(1.5 * size)  # samples a bone at one pixel apart, at most
    noise = torch.randn((n, n_bones * steps, 2), generator=g, device=device)
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32, device=device),
                            torch.arange(size, dtype=torch.float32, device=device), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2)  # (H*W, 2) (x, y)
    k = torch.arange(steps, dtype=torch.float32, device=device)
    image = torch.empty((n, size, size, 3), device=device)
    alpha = torch.empty((n, size, size), device=device)
    thinned = torch.zeros((n, MAX_THINNED, 2), device=device)
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    for s in range(0, n, block):
        e = min(s + block, n)
        rot, tr = w2c[s:e, None, :3, :3], w2c[s:e, None, :3, 3]
        pa, za = _pixels((rot @ pa3[None, :, :, None])[..., 0] + tr, intr[s:e])  # (B, bones, 2)
        pb, zb = _pixels((rot @ pb3[None, :, :, None])[..., 0] + tr, intr[s:e])
        ra, rb = r * intr[s:e, None, 0] / za, r * intr[s:e, None, 0] / zb  # radii in pixels
        ab = pb - pa
        ap = pix[None, :, None] - pa[:, None]  # (B, HW, bones, 2)
        u = ((ap * ab[:, None]).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-6)[:, None]).clamp(0.0, 1.0)
        d = torch.linalg.norm(ap - u[..., None] * ab[:, None], dim=-1)
        sil = (d < (1.0 - u) * ra[:, None] + u * rb[:, None]).any(-1).to(torch.float32)  # (B, HW)
        arg = 2 * math.pi * (freq[s:e, None, :, 0] * pix[None, :, None, 0] / size
                             + freq[s:e, None, :, 1] * pix[None, :, None, 1] / size) + phase[s:e, None]
        color = 0.5 + 0.35 * torch.sin(arg)  # (B, HW, 3)
        image[s:e] = (sil[..., None] * color).reshape(e - s, size, size, 3)
        alpha[s:e] = sil.reshape(e - s, size, size)
        # the bones one pixel apart, as (row, col) with a pixel of noise, inside the frame
        length = torch.linalg.norm(ab, dim=-1)  # (B, bones)
        t = (k[None, None] / length[..., None].clamp(min=1e-6)).clamp(max=1.0)  # (B, bones, steps)
        xy = (pa[:, :, None] + t[..., None] * ab[:, :, None]).reshape(e - s, -1, 2)
        pts = xy.flip(-1) + noise[s:e]
        keep = (k[None, None] <= length[..., None]).reshape(e - s, -1)
        keep &= ((pts >= 0) & (pts < size)).all(-1)
        pos = torch.cumsum(keep, 1) - 1
        keep &= pos < MAX_THINNED
        row = torch.arange(s, e, device=device)[:, None].expand_as(pos)
        thinned[row[keep], pos[keep]] = pts[keep]
        counts[s:e] = keep.sum(1)
    mask = torch.arange(MAX_THINNED, device=device)[None] < counts[:, None]
    return Frames(w2c=w2c, intrinsics=intr, fid=fid, image=image, alpha=alpha,
                  thinned=thinned, thinned_mask=mask, width=size, height=size)
