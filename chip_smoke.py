#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed as it runs:
  1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc;
  2. build: the blend kernels from riggs_tpu_torch/csrc/ with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the windows
     the full-width scene really bins (plain windows and every ladder
     bucket), max |delta| and CUDA-event times (plain, kernel, kernel, plain)
     per frame beside the bound; then the tiled renderer against the exact
     oracle on a small scene;
  4. slice: the rigged avatar at full stage-2 width (131072-slot capacity,
     100000 alive Gaussians, SH degree 3, motion mask, a seeded 24-joint
     tree, three 8x256 MLPs, dense skinning, 800x800): eval_image at several
     times, one random-motion pose, the ladder probe and fit, the laddered
     renders, with the kernels' launch counters zeroed just before and read
     just after; then ladder vs plain windows and kernel vs plain-version
     renders, and per-frame times of both paths;
  5. profile: for each path, the host-clock split between skeleton_forward
     and render, the device's busy time by kernel (torch.profiler) and its
     idle share.
Then a ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without CUDA
it exits 2 and prints no result. Imports nothing of JAX or riggs_tpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

# SMPL-style 24-joint tree (root's parent is itself) and rest joints in metres
PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
REST_JOINTS = np.array([
    [0.00, 0.00, 0.00], [0.06, -0.09, 0.00], [-0.06, -0.09, 0.00], [0.00, 0.11, 0.00],
    [0.10, -0.47, 0.00], [-0.10, -0.47, 0.00], [0.00, 0.25, 0.00], [0.09, -0.87, -0.04],
    [-0.09, -0.87, -0.04], [0.00, 0.30, 0.02], [0.11, -0.93, 0.08], [-0.11, -0.93, 0.08],
    [0.00, 0.51, -0.01], [0.08, 0.42, 0.00], [-0.08, 0.42, 0.00], [0.00, 0.62, 0.04],
    [0.19, 0.45, -0.01], [-0.19, 0.45, -0.01], [0.45, 0.43, -0.03], [-0.45, 0.43, -0.03],
    [0.71, 0.44, -0.03], [-0.71, 0.44, -0.03], [0.79, 0.43, -0.04], [-0.79, 0.43, -0.04],
], np.float32)

CAPACITY, N_ALIVE, SIZE, SH_DEGREE = 131072, 100000, 800, 3
DEVICE = "cuda"
FRAME_TIMES = (0.0, 0.3, 0.6, 0.9)
PROBE_TIMES = tuple(i / 8 for i in range(8)) + FRAME_TIMES
# kernel vs plain version on the card: same expf/log1pf and operation order,
# sums in another order (a running sum vs a batched matmul)
KERNEL_TOL = {"rgb_acc": 2e-5, "depth": 2e-4, "tentry": 1e-5}
# ladder vs plain windows, and kernel path vs plain-version path (the
# reference's own bounds, tests/test_pallas_blend.py:88-91)
PATH_TOL = {"image": 2e-5, "alpha": 2e-5, "depth": 2e-4}
# the card's peaks for the bound (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 and SFU operations of the blend: every (Gaussian, pixel) pair of an
# active chunk needs the EWA power and the alpha test (2 sub, 9 mul/add,
# exp, 4 compare/min); a pair whose alpha reaches 1/255 also needs the
# transmittance update and the accumulation (log1p, add, exp, mul, compare,
# sub, div, mul, 5 multiply-adds)
OPS_PER_PAIR = 16
OPS_PER_HIT = 17


def build_avatar(seed: int, n_alive: int, capacity: int, size: int, device: str):
    """The seeded full-width avatar: Gaussians along the bones of the 24-joint
    tree, a SkeletonWarp with random 8x256 MLPs, and an 800x800 camera."""
    import torch

    from riggs_tpu_torch.camera import make_camera
    from riggs_tpu_torch.convert import gaussians_from_numpy
    from riggs_tpu_torch.models.skeleton_warp import init_skeleton_warp
    from riggs_tpu_torch.ops.sh import rgb_to_sh_dc, sh_dim

    rng = np.random.default_rng(seed)
    joints = REST_JOINTS + rng.normal(scale=0.01, size=REST_JOINTS.shape).astype(np.float32)
    parents = np.array(PARENTS)
    bones = np.arange(1, len(PARENTS))
    length = np.linalg.norm(joints[bones] - joints[parents[bones]], axis=1)
    b = rng.choice(bones, size=n_alive, p=length / length.sum())
    u = rng.uniform(size=(n_alive, 1))
    xyz = joints[parents[b]] + u * (joints[b] - joints[parents[b]])
    xyz += rng.normal(scale=0.05, size=xyz.shape)

    def pad(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:n_alive] = a
        return out

    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n_alive] = rng.normal(size=(n_alive, 4))
    params = {
        "xyz": pad(xyz),
        "f_dc": pad(rgb_to_sh_dc(rng.uniform(0.1, 0.9, size=(n_alive, 1, 3)))),
        "f_rest": pad(rng.normal(scale=0.05, size=(n_alive, sh_dim(SH_DEGREE) - 1, 3))),
        "scaling": pad(np.log(rng.uniform(0.004, 0.012, size=(n_alive, 3)))),
        "rotation": rot,
        "opacity": pad(rng.normal(1.0, 1.0, size=(n_alive, 1))),
        "feature": pad(rng.normal(2.0, 1.0, size=(n_alive, 1))),
    }
    alive = np.arange(capacity) < n_alive
    gs = gaussians_from_numpy(params, alive, SH_DEGREE, isotropic=False, with_motion_mask=True, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    skel = init_skeleton_warp(joints, PARENTS, K=-1, use_skinning_mlp=True,
                              use_template_offsets=True, generator=gen, device=device)
    R = np.diag([1.0, -1.0, -1.0])  # camera-to-world: look along -z, image y down
    cam = make_camera(R, np.array([0.0, 0.15, 2.6]), size, size, fovx=0.8, fovy=0.8, device=device)
    bg = torch.zeros(3, device=device)
    return gs, skel, cam, bg


def frame(gs, skel, cam, bg, t=None, pose=None, **kw):
    """One serving frame through the port's entry points: skeleton_forward
    (or deform_by_pose for an explicit pose), then render."""
    import torch

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render.api import render

    with torch.no_grad():
        if pose is None:
            d = SW.skeleton_forward(skel, gs.xyz, t, gs.motion_mask)
        else:
            d = SW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
        return render(cam, gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=torch.zeros_like(d["d_scaling"]),
                      active_sh_degree=gs.max_sh_degree, **kw)


class _Capture:
    """Record the blend wrappers' arguments while a frame renders."""

    def __init__(self, blend):
        self.blend = blend
        self.calls = {"blend_cm": [], "blend_permuted_gm": []}

    def __enter__(self):
        self.orig = {k: getattr(self.blend, k) for k in self.calls}
        for k, fn in self.orig.items():
            def rec(*args, _k=k, _fn=fn):
                self.calls[_k].append(args)
                return _fn(*args)
            setattr(self.blend, k, rec)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.blend, k, fn)


class _PlainBlend:
    """Route the renderer's blends to the plain PyTorch versions (on CUDA
    tensors too) for the kernel-path vs plain-path comparison."""

    def __init__(self, blend):
        self.blend = blend

    def __enter__(self):
        self.orig = (self.blend.blend_cm, self.blend.blend_permuted_gm)
        self.blend.blend_cm = self.blend.blend_cm_plain
        self.blend.blend_permuted_gm = self.blend.blend_permuted_gm_plain
        return self

    def __exit__(self, *exc):
        self.blend.blend_cm, self.blend.blend_permuted_gm = self.orig


def _event_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _work(name, calls, outs):
    """Bytes and operations the blend calls of one frame need on this data.
    Pairs are the (Gaussian, pixel) pairs of active chunks (the chunk starts
    before the tile's count and some pixel enters it with T >= 1e-4), rows
    before the count; hits are the pairs whose alpha reaches 1/255. The g
    rows of active chunks are read once, counts (and tids) read once, out
    and tentry written once."""
    import torch

    pairs = hits = nbytes = 0
    for args, (out, tentry) in zip(calls, outs):
        g, counts, tiles_x = args[0], args[1].to(torch.int64), args[-1]
        if name == "blend_cm":
            g = g[:, :10].transpose(1, 2)  # (T, MAX, 10) view
            tids = torch.arange(g.shape[0], device=g.device)
        else:
            tids = args[2].to(torch.int64)
        p = torch.arange(1024, device=g.device)
        r = torch.arange(128, device=g.device)
        for c in range(tentry.shape[1]):
            act = torch.nonzero((c * 128 < counts) & (tentry[:, c].amax(dim=1) >= 1e-4))[:, 0]
            if act.numel() == 0:
                continue
            rows = (c * 128 + r)[None, :] < counts[act][:, None]  # (A, 128)
            gc = g[act, c * 128:(c + 1) * 128]  # (A, 128, 10)
            t = tids[act]
            dx = (((t % tiles_x) * 32)[:, None] + p % 32).float()[:, None, :] - gc[..., 0:1]
            dy = (((t // tiles_x) * 32)[:, None] + p // 32).float()[:, None, :] - gc[..., 1:2]
            power = -0.5 * (gc[..., 2:3] * dx * dx + gc[..., 4:5] * dy * dy) - gc[..., 3:4] * dx * dy
            alpha = torch.clamp(gc[..., 5:6] * torch.exp(power), max=0.99)
            hit = (power <= 0) & (alpha >= 1.0 / 255.0) & rows[..., None]
            n_rows = int(rows.sum())
            pairs += n_rows * 1024
            hits += int(hit.sum())
            nbytes += n_rows * 10 * 4
        nbytes += counts.numel() * 4 * (2 if name == "blend_permuted_gm" else 1)
        nbytes += out.numel() * 4 + tentry.numel() * 4
    ops = pairs * OPS_PER_PAIR + hits * OPS_PER_HIT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"pairs": pairs, "hits": hits, "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernels(blend, captured):
    """Phase 3: each kernel against its plain version on the captured
    full-width inputs; times in turns plain, kernel, kernel, plain."""
    import torch

    kern = {"blend_cm": blend.blend_cm, "blend_permuted_gm": blend.blend_permuted_gm}
    plain = {"blend_cm": blend.blend_cm_plain, "blend_permuted_gm": blend.blend_permuted_gm_plain}
    results = {}
    for name, calls in captured.items():
        if not calls:
            raise RuntimeError(f"the scene produced no {name} call")
        outs, err = [], {"rgb_acc": 0.0, "depth": 0.0, "tentry": 0.0}
        for args in calls:
            ko, kt = kern[name](*args)
            po, pt = plain[name](*args)
            torch.cuda.synchronize()
            err["rgb_acc"] = max(err["rgb_acc"], float((ko[:, [0, 1, 2, 4]] - po[:, [0, 1, 2, 4]]).abs().max()))
            err["depth"] = max(err["depth"], float((ko[:, 3] - po[:, 3]).abs().max()))
            err["tentry"] = max(err["tentry"], float((kt - pt).abs().max()))
            if not (torch.isfinite(ko).all() and torch.isfinite(kt).all()):
                raise RuntimeError(f"{name}: non-finite kernel output")
            if torch.any(ko[:, 5:] != 0):
                raise RuntimeError(f"{name}: padding rows of out are not zero")
            outs.append((ko, kt))
        shapes = [tuple(a[0].shape) for a in calls]
        print(f"[kernels] {name}: {len(calls)} launch(es) per frame, shapes {shapes}, "
              f"max|d| rgb/acc {err['rgb_acc']:.3e} depth {err['depth']:.3e} tentry {err['tentry']:.3e}")
        for k, tol in KERNEL_TOL.items():
            if not err[k] <= tol:
                raise RuntimeError(f"{name}: max |kernel - plain| {k} {err[k]:.3e} > {tol}")

        def run(fns):
            return lambda: [fns[name](*a) for a in calls]

        for fn in (run(kern), run(plain)):  # warm up
            fn()
        torch.cuda.synchronize()
        p1 = _event_ms(run(plain), 3)
        k1 = _event_ms(run(kern), 20)
        k2 = _event_ms(run(kern), 20)
        p2 = _event_ms(run(plain), 3)
        work = _work(name, calls, outs)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"[kernels] {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms per frame; "
              f"{work['pairs']} (Gaussian, pixel) pairs ({work['hits']} with alpha >= 1/255), "
              f"{work['ops']} operations, {work['bytes']} bytes, "
              f"bound {work['bound_ms']:.4f} ms by {work['bound_by']}")
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms, launches_per_frame=len(calls), **work)
    return results


def check_oracle(device):
    """Phase 3, last: the tiled renderer (through the blend kernel) against the exact
    O(N * pixels) oracle on a small seeded scene on the card, at the CPU
    tests' bounds (image and alpha 3e-5, depth 2e-4)."""
    import torch

    from riggs_tpu_torch.camera import make_camera
    from riggs_tpu_torch.render.oracle import rasterize_oracle
    from riggs_tpu_torch.render.tiles import rasterize_tiled

    rng = np.random.default_rng(10)
    n = 300
    q = rng.normal(size=(n, 4))
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
        rng.normal(size=(n, 3)) * 0.5, rng.uniform(size=(n, 3)), rng.uniform(0.2, 0.95, size=n),
        np.exp(rng.uniform(-3.5, -2.0, size=(n, 3))), q / np.linalg.norm(q, axis=1, keepdims=True),
        [0.2, 0.1, 0.4])]
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 96, 96, fovx=1.0, fovy=1.0, device=device)
    a = rasterize_tiled(cam, *args, max_per_tile=256)
    b = rasterize_oracle(cam, *args)
    errs = {k: float((a[k] - b[k]).abs().max()) for k in ("image", "alpha", "depth")}
    print(f"[oracle] tiled (kernel) vs oracle, {n} Gaussians at 96x96: max|d| image {errs['image']:.3e} "
          f"alpha {errs['alpha']:.3e} depth {errs['depth']:.3e}; max tile count {int(a['max_count'])}")
    for k, tol in (("image", 3e-5), ("alpha", 3e-5), ("depth", 2e-4)):
        if not errs[k] <= tol:
            raise RuntimeError(f"tiled vs oracle: max |d| {k} {errs[k]:.3e} > {tol}")
    if int(a["overflow"]) or float(a["alpha"].max()) <= 0.5:
        raise RuntimeError("oracle scene: overflow or nothing in view")


def _compare(a, b, what):
    errs = {k: float((a[k2] - b[k2]).abs().max()) for k, k2 in
            (("image", "render"), ("alpha", "alpha"), ("depth", "depth"))}
    print(f"[slice] {what}: max|d| image {errs['image']:.3e} alpha {errs['alpha']:.3e} depth {errs['depth']:.3e}")
    for k, tol in PATH_TOL.items():
        if not errs[k] <= tol:
            raise RuntimeError(f"{what}: max |d| {k} {errs[k]:.3e} > {tol}")


def _check_frame(out, size, what):
    import torch

    img = out["render"] if isinstance(out, dict) else out
    if tuple(img.shape) != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"{what}: bad image {tuple(img.shape)}")
    if isinstance(out, dict):
        if int(out["overflow_tiles"]) or int(out["overflow_rect"]):
            raise RuntimeError(f"{what}: overflow tiles {int(out['overflow_tiles'])} rect {int(out['overflow_rect'])}")
        if float(out["alpha"].max()) <= 0.5:
            raise RuntimeError(f"{what}: the avatar is not in view")


def profile_frames(gs, skel, cam, bg, cap, kw, label, frame_ms, n=5):
    """Phase 5: where a frame's time goes. The host clock splits
    skeleton_forward from render (each ended by a synchronize); the
    profiler's device time per kernel name, summed over the frames, gives
    the device's busy time, and beside the unprofiled frame time its idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render.api import render
    from riggs_tpu_torch.train.stage2 import _eval_image

    split = {"skeleton_forward": 0.0, "render": 0.0}
    with torch.no_grad():
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = SW.skeleton_forward(skel, gs.xyz, i / n, gs.motion_mask)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            render(cam, gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                   d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=gs.max_sh_degree,
                   max_per_tile=cap, **kw)
            torch.cuda.synchronize()
            split["skeleton_forward"] += (t1 - t0) * 1e3 / n
            split["render"] += (time.perf_counter() - t1) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            _eval_image(gs, skel, cam, i / n, bg, max_per_tile=cap, **kw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    groups = {}
    for e in kernels:
        name = e.key
        g = ("gemm" if "gemm" in name else "blend kernel" if "blend_fwd" in name
             else "sort" if "Sort" in name or "sort" in name else "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # the MLPs' matrix products: 2 * d_in * d_out per row and layer, one row
    # for the PoseMLP, one per capacity slot for the skinning and detail MLPs
    rows = {"pose_mlp": 1, "weight_mlp": gs.capacity, "detail_mlp": gs.capacity}
    gemm_flop = sum(2 * lin.in_features * lin.out_features * rows[name.split(".")[0]]
                    for name, lin in skel.named_modules() if isinstance(lin, torch.nn.Linear))
    print(f"[profile] {label}: host clock skeleton_forward {split['skeleton_forward']:.2f} ms, render "
          f"{split['render']:.2f} ms; device busy {busy:.2f} ms of {frame_ms:.2f} ms per frame "
          f"(idle share {1 - busy / frame_ms:.3f}), {sum(e.count for e in kernels) // n} kernel launches "
          f"per frame; MLP products {gemm_flop / 1e9:.1f} GFLOP per frame, "
          f"{gemm_flop / groups.get('gemm', float('nan')) / 1e9:.1f} TFLOP/s in the GEMM kernels; "
          "device ms per frame by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms  {e.count // n:4d} launches  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from riggs_tpu_torch.eval.synthesis import random_motion_poses, render_rigged
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.render.ladder import ladder_rows, make_tile_ladder
    from riggs_tpu_torch.train.stage2 import _eval_image, eval_image

    # 1. device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([blend._nvcc(), "--version"], capture_output=True, text=True, check=True).stdout
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvcc: {[l for l in nvcc.splitlines() if 'release' in l][0].strip()}")

    # 2. build
    t0 = time.perf_counter()
    blend.load_library()
    print(f"[build] blend kernels (sm_90a) built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in blend.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")

    # scene, window cap and ladder (set-up: probes over the frame times and
    # the random-motion pose run before the counted window)
    t0 = time.perf_counter()
    gs, skel, cam, bg = build_avatar(0, N_ALIVE, CAPACITY, SIZE, DEVICE)
    pose = {k: torch.as_tensor(v, device=DEVICE) for k, v in random_motion_poses(len(PARENTS), seed=0, pose_num=8)[4].items()}
    probe = [frame(gs, skel, cam, bg, t=t, max_per_tile=8192) for t in PROBE_TIMES]
    probe.append(frame(gs, skel, cam, bg, pose=pose, max_per_tile=8192))
    counts = np.stack([p["tile_counts"].cpu().numpy() for p in probe])
    cap = int(-(-counts.max() // 128) * 128)
    ladder = make_tile_ladder(counts)
    torch.cuda.synchronize()
    print(f"[scene] {int(gs.num_alive)} alive of {gs.capacity}, {len(PARENTS)} joints, {SIZE}x{SIZE}; "
          f"max tile count {int(counts.max())} -> window {cap}; ladder {ladder} "
          f"({ladder_rows(ladder)} rows vs {counts.shape[1] * cap}); {time.perf_counter() - t0:.1f} s")

    # 3. kernels against plain versions on the scene's real windows
    with _Capture(blend) as cap_plain:
        frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap)
    with _Capture(blend) as cap_ladder:
        frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap, tile_ladder=ladder)
    kres = check_kernels(blend, {"blend_cm": cap_plain.calls["blend_cm"],
                                 "blend_permuted_gm": cap_ladder.calls["blend_permuted_gm"]})
    check_oracle(DEVICE)

    # 4. the slice: the main path, launch counters zeroed just before
    torch.cuda.synchronize()
    blend.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plain_imgs = [eval_image(gs, skel, cam, t, bg) for t in FRAME_TIMES]
    for w in caught:
        if "capacity limits" in str(w.message):
            raise RuntimeError(f"eval_image truncated a frame: {w.message}")
    posed = render_rigged(gs, skel, cam, pose=pose, bg=bg, max_per_tile=cap)
    probe_counts = np.stack([render_rigged(gs, skel, cam, t=t, bg=bg, max_per_tile=cap)["tile_counts"].cpu().numpy()
                             for t in PROBE_TIMES] + [posed["tile_counts"].cpu().numpy()])
    ladder_fit = make_tile_ladder(probe_counts)
    ladder_imgs = []
    for t in FRAME_TIMES:
        img, of_t, of_r, _ = _eval_image(gs, skel, cam, t, bg, max_per_tile=cap, tile_ladder=ladder_fit)
        if int(of_t) or int(of_r):
            raise RuntimeError(f"ladder frame t={t}: overflow tiles {int(of_t)} rect {int(of_r)}")
        ladder_imgs.append(img)
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    print(f"[slice] launch counters over the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    if ladder_fit != ladder:
        raise RuntimeError(f"the refit ladder {ladder_fit} differs from the probe's {ladder}")
    for t, img in zip(FRAME_TIMES, plain_imgs + ladder_imgs):
        _check_frame(img, SIZE, f"frame t={t}")
    _check_frame(posed, SIZE, "random-motion pose")
    print(f"[slice] {len(FRAME_TIMES)} eval_image frames, 1 random-motion pose, "
          f"{len(PROBE_TIMES)} probe frames, {len(FRAME_TIMES)} laddered frames: finite, no overflow")

    # ladder vs plain windows, and kernel path vs plain-version path
    for t in (0.3, 0.9):
        a = frame(gs, skel, cam, bg, t=t, max_per_tile=cap)
        _check_frame(a, SIZE, f"plain t={t}")
        b = frame(gs, skel, cam, bg, t=t, max_per_tile=cap, tile_ladder=ladder)
        _check_frame(b, SIZE, f"ladder t={t}")
        _compare(a, b, f"ladder vs plain windows, t={t}")
    with _PlainBlend(blend):
        pa = frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap)
        pb = frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap, tile_ladder=ladder)
    _compare(frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap), pa, "kernel vs plain-version path, plain windows")
    _compare(frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap, tile_ladder=ladder), pb,
             "kernel vs plain-version path, ladder")

    # per-frame times of both paths (host clock around synchronized frames)
    frame_ms = {}
    for label, kw in (("plain windows", {}), ("ladder", {"tile_ladder": ladder})):
        _eval_image(gs, skel, cam, 0.5, bg, max_per_tile=cap, **kw)
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for i in range(n):
            _eval_image(gs, skel, cam, i / n, bg, max_per_tile=cap, **kw)
        torch.cuda.synchronize()
        frame_ms[label] = ms = (time.perf_counter() - t0) / n * 1e3
        print(f"[slice] {label}: {ms:.2f} ms per frame = {1e3 / ms:.1f} FPS (skeleton_forward + render, {SIZE}x{SIZE})")
    for label, kw in (("plain windows", {}), ("ladder", {"tile_ladder": ladder})):
        profile_frames(gs, skel, cam, bg, cap, kw, label, frame_ms[label])

    rows = []
    for name, replaces in (("blend_cm", "riggs_tpu/render/pallas_blend.py:179"),
                           ("blend_permuted_gm", "riggs_tpu/render/pallas_blend.py:602")):
        r = kres[name]
        rows.append({
            "name": name, "route": "cuda", "source": "riggs_tpu_torch/csrc/blend.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"].values()), "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "launches_per_frame": r["launches_per_frame"], "ms_per_launch": r["ms"] / r["launches_per_frame"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
