"""The seeded inputs of a cell: the avatar's Gaussians, the skeleton's MLP
weights, the train frames and the viewer's requests.

Everything is drawn from ``--seed``: tensors on the device with
``torch.Generator`` in a few large calls, the few host numbers (the frame
order, the requests) with numpy's generator. The same
seed gives the same inputs, which the harness hands to the program under
test and to the reference alike. Nothing here imports the program.

The avatar is SMPL's 24-joint tree at rest, its Gaussians spread along the
bones. A train frame's target is not a render: it is a smooth seeded colour
field over the silhouette of the rest bones seen from the frame's camera,
on a white background; its 2-D skeleton points are the projected bone
samples with a pixel of seeded noise. The kernels' work follows the
Gaussians, not the target's content.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# SMPL's 24-joint tree (the root's parent is itself) and its rest joints in metres
PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
REST_JOINTS = (
    (0.00, 0.00, 0.00), (0.06, -0.09, 0.00), (-0.06, -0.09, 0.00), (0.00, 0.11, 0.00),
    (0.10, -0.47, 0.00), (-0.10, -0.47, 0.00), (0.00, 0.25, 0.00), (0.09, -0.87, -0.04),
    (-0.09, -0.87, -0.04), (0.00, 0.30, 0.02), (0.11, -0.93, 0.08), (-0.11, -0.93, 0.08),
    (0.00, 0.51, -0.01), (0.08, 0.42, 0.00), (-0.08, 0.42, 0.00), (0.00, 0.62, 0.04),
    (0.19, 0.45, -0.01), (-0.19, 0.45, -0.01), (0.45, 0.43, -0.03), (-0.45, 0.43, -0.03),
    (0.71, 0.44, -0.03), (-0.71, 0.44, -0.03), (0.79, 0.43, -0.04), (-0.79, 0.43, -0.04),
)
SH_C0 = 0.28209479177387814
BONE_SAMPLES = 8  # points per bone of the 2-D skeleton, as sample_skeleton_points
THINNED_SLOTS = 256  # padded 2-D skeleton points per frame


def generator(seed: int, stream: int, device) -> torch.Generator:
    """One generator per (seed, stream): streams keep the draws of one input
    independent of how many draws another takes."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1009 + stream) % (2**63))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), stream])


def sh_dim(degree: int) -> int:
    return (degree + 1) ** 2


def embed_dim(d: int, multires: int) -> int:
    return d * (2 * multires + 1)


# ---------------------------------------------------------------------------
# the avatar
# ---------------------------------------------------------------------------


def make_gaussians(cfg: dict, seed: int, device) -> dict:
    """The Gaussians' parameter tree (the program's ``params_dict`` keys)
    and ``alive``: ``n_alive`` of ``capacity`` slots along the bones, dead
    slots zero with identity rotations."""
    a = cfg["avatar"]
    C, N, deg = a["capacity"], a["n_alive"], a["sh_degree"]
    g = generator(seed, 1, device)
    joints = torch.tensor(REST_JOINTS, dtype=torch.float32, device=device)
    joints = joints + 0.01 * torch.randn(joints.shape, generator=g, device=device)
    parents = torch.tensor(PARENTS, device=device)
    bones = torch.arange(1, len(PARENTS), device=device)
    length = torch.linalg.norm(joints[bones] - joints[parents[bones]], dim=1)
    b = bones[torch.multinomial(length / length.sum(), N, replacement=True, generator=g)]
    u = torch.rand((N, 1), generator=g, device=device)
    xyz = joints[parents[b]] + u * (joints[b] - joints[parents[b]])
    xyz = xyz + 0.05 * torch.randn((N, 3), generator=g, device=device)

    def pad(x, fill=0.0):
        out = torch.full((C,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=device)
        out[:N] = x
        return out

    rot = torch.zeros((C, 4), device=device)
    rot[:, 0] = 1.0
    rot[:N] = torch.randn((N, 4), generator=g, device=device)
    rgb = 0.1 + 0.8 * torch.rand((N, 1, 3), generator=g, device=device)
    scale = 0.004 + 0.008 * torch.rand((N, 3), generator=g, device=device)
    params = {
        "xyz": pad(xyz),
        "f_dc": pad((rgb - 0.5) / SH_C0),
        "f_rest": pad(0.05 * torch.randn((N, sh_dim(deg) - 1, 3), generator=g, device=device)),
        "scaling": pad(torch.log(scale)),
        "rotation": rot,
        "opacity": pad(1.0 + torch.randn((N, 1), generator=g, device=device)),
        "feature": pad(2.0 + torch.randn((N, 1), generator=g, device=device)),  # the motion-mask logit
    }
    if a.get("hyper_dim", 0):  # a node model's hyper coordinates come first
        hyper = 0.01 * torch.randn((N, a["hyper_dim"]), generator=g, device=device)
        params["feature"] = torch.cat([pad(hyper), params["feature"]], dim=1)
    alive = torch.arange(C, device=device) < N
    return {"params": params, "alive": alive, "joints": joints}


def _linear(d_in, d_out, kind, g, device, scale=1.0):
    """One layer {"w": (d_out, d_in), "b": (d_out,)}: ``uniform`` is
    PyTorch's default (+-1/sqrt(d_in) for both) times ``scale``, ``normal``
    N(0, 1e-5) weights and a zero bias (the detail head, as the reference
    inits it)."""
    if kind == "normal":
        return {"w": 1e-5 * torch.randn((d_out, d_in), generator=g, device=device),
                "b": torch.zeros(d_out, device=device)}
    bound = scale / math.sqrt(d_in)
    return {"w": (2 * torch.rand((d_out, d_in), generator=g, device=device) - 1) * bound,
            "b": (2 * torch.rand((d_out,), generator=g, device=device) - 1) * bound}


def _trunk(d_in, width, depth, g, device):
    """A skip-concat trunk: layer 0 takes d_in, the layer after the skip
    (depth // 2) takes width + d_in, the others width."""
    skip = depth // 2
    dims = [d_in if i == 0 else width + d_in if i - 1 == skip else width for i in range(depth)]
    return [_linear(d, width, "uniform", g, device) for d in dims]


def make_skeleton_weights(cfg: dict, seed: int, joints: torch.Tensor, device) -> dict:
    """The skeleton's parameter tree (the program's ``SkeletonWarp.params_dict``
    keys): the joints' log kernel radii, the PoseMLP with its rotation and
    translation heads, the WeightMLP and the detail DeformMLP."""
    s = cfg["skeleton"]
    J = len(PARENTS)
    g = generator(seed, 2, device)
    span = float((joints.max() - joints.min()).item())
    radius = math.log(0.1 * span + 1e-7) + 0.1 * torch.randn((J,), generator=g, device=device)
    W, D = s["width"], s["depth"]
    pose = {"layers": _trunk(embed_dim(1, s["pose_multires"]), W, D, g, device),
            "rotation": _linear(W, 4 * J, "uniform", g, device, s["pose_head_scale"]),
            "translation": _linear(W, 3, "uniform", g, device, s["pose_head_scale"])}
    weight_in = embed_dim(3, s["weight_multires"])
    skin = {"layers": _trunk(weight_in, W, D, g, device), "head": _linear(W, J - 1, "uniform", g, device)}
    detail_in = embed_dim(3, s["detail_multires"]) + 4 * J
    detail = {"layers": _trunk(detail_in, W, D, g, device), "head": _linear(W, 3, "normal", g, device)}
    return {"radius": radius, "pose": pose, "skinning_mlp": skin, "detail_net": detail}


def make_node_weights(cfg: dict, seed: int, avatar: dict, device) -> dict:
    """The stage-1 node warp's parameter tree (the program's
    ``NodeWarp.params_dict`` keys): ``node_num`` nodes at seeded alive
    Gaussians with hyper coordinates N(0, 0.01), their log radii log(0.1
    span) + N(0, 0.1) and weight logits N(0, 0.1), and the blender
    DeformNetwork (its timenet, the skip-concat trunk, the warp, scaling
    and rotation heads)."""
    n = cfg["nodes"]
    M, H = n["node_num"], n["hyper_dim"]
    g = generator(seed, 8, device)
    xyz = avatar["params"]["xyz"][: cfg["avatar"]["n_alive"]]
    pick = torch.randperm(xyz.shape[0], generator=g, device=device)[:M]
    nodes = torch.cat([xyz[pick], 0.01 * torch.randn((M, H), generator=g, device=device)], dim=1)
    span = float((xyz.max() - xyz.min()).item())
    W, D = n["width"], n["depth"]
    t_dim = embed_dim(1, n["t_multires"])
    mlp = {"trunk": {"layers": _trunk(embed_dim(3, n["x_multires"]) + n["time_out"], W, D, g, device)},
           "warp": _linear(W, 3, "uniform", g, device, n["head_scale"]),
           "scaling": _linear(W, 3, "uniform", g, device, n["head_scale"]),
           "rotation": _linear(W, 4, "uniform", g, device, n["head_scale"]),
           "timenet": [_linear(t_dim, 256, "uniform", g, device), _linear(256, n["time_out"], "uniform", g, device)]}
    return {"nodes": nodes, "radius": math.log(0.1 * span + 1e-7) + 0.1 * torch.randn((M,), generator=g, device=device),
            "weight": 0.1 * torch.randn((M, 1), generator=g, device=device), "mlp": mlp}


# ---------------------------------------------------------------------------
# cameras and frames
# ---------------------------------------------------------------------------


def orbit_pose(az: float, el: float, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """An orbit camera about the origin looking at it, image y down:
    (camera-to-world R, world-to-camera T), the viewer's own formula."""
    pos = radius * np.array([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)])
    z = -pos / np.linalg.norm(pos)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    x /= max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    return R, -R.T @ pos


def camera_arrays(R: np.ndarray, T: np.ndarray, width: int, height: int, fovx: float, fovy: float):
    """(w2c (4, 4), intrinsics (fx, fy, cx, cy)) as float32 numpy arrays."""
    w2c = np.zeros((4, 4), np.float32)
    w2c[:3, :3] = np.asarray(R, np.float32).T
    w2c[:3, 3] = np.asarray(T, np.float32)
    w2c[3, 3] = 1.0
    fx = width / (2.0 * math.tan(fovx / 2.0))
    fy = height / (2.0 * math.tan(fovy / 2.0))
    return w2c, np.array([fx, fy, width / 2.0, height / 2.0], np.float32)


@dataclass
class Frames:
    """The train frames, stacked on the device."""

    w2c: torch.Tensor  # (F, 4, 4)
    intrinsics: torch.Tensor  # (F, 4)
    fid: torch.Tensor  # (F,) frame times in [0, 1]
    image: torch.Tensor  # (F, H, W, 3)
    alpha: torch.Tensor  # (F, H, W)
    thinned: torch.Tensor  # (F, THINNED_SLOTS, 2) (row, col)
    thinned_mask: torch.Tensor  # (F, THINNED_SLOTS)
    width: int
    height: int


def make_frames(cfg: dict, seed: int, joints: torch.Tensor, device, block: int = 8) -> Frames:
    """The ``n_frames`` train frames of a D-NeRF-like capture: cameras on
    an orbit of ``radius`` about the avatar, the targets and the 2-D
    skeleton points as the module's docstring says."""
    f = cfg["frames"]
    n, size, fov = f["n_frames"], f["size"], f["camera_angle_x"]
    # one set of views for every seed (azimuths evenly spaced, elevations
    # on a golden-ratio sequence), so that a seed changes the work's order
    # and not its size
    az = 2 * np.pi * np.arange(n) / n
    el = f["elevation"][0] + (f["elevation"][1] - f["elevation"][0]) * ((np.arange(n) * 0.6180339887498949) % 1.0)
    cams = [camera_arrays(*orbit_pose(a, e, f["radius"]), size, size, fov, fov) for a, e in zip(az, el)]
    w2c = torch.tensor(np.stack([c[0] for c in cams]), device=device)
    intr = torch.tensor(np.stack([c[1] for c in cams]), device=device)
    fid = torch.tensor(np.arange(n) / max(n - 1, 1), dtype=torch.float32, device=device)

    g = generator(seed, 4, device)
    parents = torch.tensor(PARENTS[1:], device=device)
    a3, b3 = joints[parents], joints[1:]
    t = torch.linspace(0.0, 1.0, BONE_SAMPLES, device=device)[:, None, None]
    samples = ((1.0 - t) * a3[None] + t * b3[None]).reshape(-1, 3)  # (P, 3)
    P = samples.shape[0]
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32, device=device),
                            torch.arange(size, dtype=torch.float32, device=device), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2)  # (H*W, 2) (x, y)
    freq = 0.5 + 1.5 * torch.rand((n, 3, 2), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((n, 3), generator=g, device=device)
    noise = torch.randn((n, P, 2), generator=g, device=device)
    images, alphas, thinned = [], [], []
    for s in range(0, n, block):
        e = min(s + block, n)
        view = joints[None] @ w2c[s:e, :3, :3].transpose(1, 2) + w2c[s:e, None, :3, 3]  # (B, J, 3)
        z = view[..., 2:3].clamp(min=1e-6)
        j2 = view[..., :2] / z * intr[s:e, None, :2] + intr[s:e, None, 2:]  # (B, J, 2) pixel (x, y)
        pa, pb = j2[:, PARENTS[1:]], j2[:, 1:]
        ab = pb - pa
        ap = pix[None, :, None] - pa[:, None]  # (B, HW, bones, 2)
        u = ((ap * ab[:, None]).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-6)[:, None]).clamp(0.0, 1.0)
        d = torch.linalg.norm(ap - u[..., None] * ab[:, None], dim=-1).amin(-1)  # (B, HW)
        thick = f["bone_thickness"] * intr[s:e, 0:1] / z.mean(dim=1)  # pixels
        sil = (d < thick).to(torch.float32)
        arg = 2 * math.pi * (freq[s:e, None, :, 0] * pix[None, :, None, 0] / size
                             + freq[s:e, None, :, 1] * pix[None, :, None, 1] / size) + phase[s:e, None]
        color = 0.5 + 0.35 * torch.sin(arg)  # (B, HW, 3)
        images.append((sil[..., None] * color + (1.0 - sil[..., None])).reshape(e - s, size, size, 3))
        alphas.append(sil.reshape(e - s, size, size))
        sview = samples[None] @ w2c[s:e, :3, :3].transpose(1, 2) + w2c[s:e, None, :3, 3]
        sz = sview[..., 2].clamp(min=1e-6)
        row = intr[s:e, None, 1] * sview[..., 1] / sz + intr[s:e, None, 3]
        col = intr[s:e, None, 0] * sview[..., 0] / sz + intr[s:e, None, 2]
        thinned.append(torch.stack([row, col], -1) + noise[s:e])
    th = torch.zeros((n, THINNED_SLOTS, 2), device=device)
    th[:, :P] = torch.cat(thinned)
    mask = (torch.arange(THINNED_SLOTS, device=device) < P)[None].expand(n, THINNED_SLOTS).contiguous()
    return Frames(w2c=w2c, intrinsics=intr, fid=fid, image=torch.cat(images), alpha=torch.cat(alphas),
                  thinned=th, thinned_mask=mask, width=size, height=size)


def frame_order(seed: int, n_frames: int, n_steps: int) -> np.ndarray:
    """The train frame of each step: a seeded permutation of the frames per
    epoch, as a loop's sampler walks them."""
    rng = host_rng(seed, 5)
    epochs = -(-n_steps // n_frames)
    return np.concatenate([rng.permutation(n_frames) for _ in range(epochs)])[:n_steps]


# ---------------------------------------------------------------------------
# the viewer's requests
# ---------------------------------------------------------------------------


def view_requests(traffic: dict, seed: int, n: int, n_joints: int) -> list[dict]:
    """``n`` requests of one client orbiting the avatar: the azimuth
    advances ``az_step_deg`` a request from a seeded start, ``t`` walks
    [0, 1] in ``t_period`` requests, and one request in ``edit_every``
    rotates a seeded joint by a seeded angle in +-``edit_max_deg``."""
    rng = host_rng(seed, 6)
    az0 = rng.uniform(0.0, 2 * np.pi)
    out = []
    for i in range(n):
        req = {"az": float(az0 + np.deg2rad(traffic["az_step_deg"]) * i), "el": float(traffic["elevation"]),
               "r": float(traffic["radius"]), "t": float((i % traffic["t_period"]) / (traffic["t_period"] - 1)),
               "joint": -1, "angle": 0.0}
        joint, angle = int(rng.integers(1, n_joints)), float(rng.uniform(-1.0, 1.0) * traffic["edit_max_deg"])
        if i % traffic["edit_every"] == traffic["edit_every"] - 1:
            req["joint"], req["angle"] = joint, angle
        out.append(req)
    return out
