#!/usr/bin/env python3
"""Differentiable-rasterizer forward + backward throughput at 800x800 on the
PyTorch port (the twin of bench.py, with its flags; ``--device`` in place
of ``--platform``, and no ``--blend``: on the card the blend is the hand
kernels of ``csrc/blend.cu``, on the CPU their plain versions).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}, last.

The workload is bench.py's: one render of its seeded scene of 100 000
Gaussians (``build_scene``, bitwise its numpy arrays) from a camera at
(0, 0, 2.5) with a field of view of 0.9, forward and the full backward to
means, colours, opacity, scales and rotations, of the loss
``mean(image) + mean(depth) * 0`` (the depth backward runs). The default
configuration is bench.py's too: the tiered enumeration
(``max_tiles_per_gaussian=4, mid_cap=8192, mid_side=4``) and a tile ladder
fitted to one plain-window probe (6 buckets, margin 1.0, no minimum cap),
windows of 640 rows, both asserted not to truncate the scene;
``--no-ladder`` and ``--no-tiers`` give the fallbacks. After a warm-up,
``--iters`` steps are timed by the host clock up to one synchronize; the
loop reads nothing from the card before it. ``vs_baseline`` divides the
pixels a second by bench.py's A100 estimate of 64e6.

Before the JSON line it prints the card's name and power limit (on the
card), the ladder, and the blend kernels' launches over the timed steps.

    python scripts/torch_bench.py                       # on the card
    python scripts/torch_bench.py --no-ladder
    python scripts/torch_bench.py --device cpu --size 64 --gaussians 2000 --iters 1
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

A100_CUDA_PIXELS_PER_S = 64e6  # bench.py's baseline constant (BASELINE.md)


def build_scene(n, seed=0):
    """bench.py's scene as float32 numpy arrays, bit for bit:
    (means, colors, opacity, scales, rots)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    scales = np.exp(rng.uniform(-5.5, -4.0, size=(n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    rots = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return means, colors, opacity, scales, rots


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=20)
    # bench.py: 640 covers the scene's post-cull largest tile (619)
    ap.add_argument("--max-per-tile", type=int, default=640)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--no-ladder", action="store_true",
                    help="disable the count-adaptive per-tile window ladder (A/B fallback)")
    ap.add_argument("--no-tiers", action="store_true",
                    help="disable tiered bbox enumeration (single 4x4 window + giant pass)")
    ap.add_argument("--ladder-buckets", type=int, default=6)
    ap.add_argument("--ladder-margin", type=float, default=1.0)
    return ap.parse_args(argv)


def setup(args, device):
    """(camera, the five input tensors requiring gradients, background,
    rasterize_tiled's keyword arguments): the window, the tiers unless
    ``--no-tiers``, and unless ``--no-ladder`` the ladder fitted to one
    plain-window probe's tile counts."""
    import torch

    from riggs_tpu_torch.camera.camera import make_camera
    from riggs_tpu_torch.render.ladder import make_tile_ladder
    from riggs_tpu_torch.render.tiles import rasterize_tiled

    cam = make_camera(np.eye(3), np.array([0, 0, 2.5]), args.size, args.size, fovx=0.9, fovy=0.9, device=device)
    inputs = tuple(torch.from_numpy(a).to(device).requires_grad_() for a in build_scene(args.gaussians))
    bg = torch.zeros(3, device=device)
    extra = dict(max_per_tile=args.max_per_tile)
    if not args.no_tiers:
        extra.update(max_tiles_per_gaussian=4, mid_cap=8192, mid_side=4)
    if not args.no_ladder:
        with torch.no_grad():
            probe = rasterize_tiled(cam, *inputs, bg, **extra)
        extra["tile_ladder"] = make_tile_ladder(probe["tile_counts"].cpu().numpy(), n_buckets=args.ladder_buckets,
                                                margin=args.ladder_margin, min_cap=0)
    return cam, inputs, bg, extra


def grad_step(cam, inputs, bg, extra):
    """The gradients of bench.py's loss to the five inputs."""
    import torch

    from riggs_tpu_torch.render.tiles import rasterize_tiled

    out = rasterize_tiled(cam, *inputs, bg, **extra)
    loss = torch.mean(out["image"]) + torch.mean(out["depth"]) * 0.0
    return torch.autograd.grad(loss, inputs)


def main(argv=None):
    import torch

    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.render.ladder import ladder_rows
    from riggs_tpu_torch.render.tiles import rasterize_tiled

    args = parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"card: {card}")
    cam, inputs, bg, extra = setup(args, dev)
    if "tile_ladder" in extra:
        ladder = extra["tile_ladder"]
        print(f"ladder: {ladder} ({ladder_rows(ladder)} rows)")

    # honesty check: the configured caps must not truncate this scene
    with torch.no_grad():
        chk = rasterize_tiled(cam, *inputs, bg, **extra)
    assert int(chk["overflow"]) == 0, f"bench caps truncate: {int(chk['overflow'])}"

    g = grad_step(cam, inputs, bg, extra)  # warm-up
    sync()
    blend.reset_launches()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        g = grad_step(cam, inputs, bg, extra)
    sync()
    dt = time.perf_counter() - t0
    del g
    print(f"launches: {json.dumps({k: n for k, n in blend.launches.items() if n})}")

    pixels_per_s = args.size * args.size * args.iters / dt
    print(json.dumps({
        "metric": "rasterizer_fwd_bwd_pixels_per_s_per_chip",
        "value": round(pixels_per_s, 1),
        "unit": "pixels/s",
        "vs_baseline": round(pixels_per_s / A100_CUDA_PIXELS_PER_S, 4),
    }))


if __name__ == "__main__":
    main()
