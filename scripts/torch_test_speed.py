#!/usr/bin/env python3
"""Rendering throughput on the PyTorch port: N forward renders -> FPS (the
twin of scripts/test_speed.py, with the same flags; ``--device`` in place of
``--platform``).

    python scripts/torch_test_speed.py --model_path out/          # a trained rig, on the card
    python scripts/torch_test_speed.py --synthetic                # the built-in tiny scene
    python scripts/torch_test_speed.py --model_path out/ --ladder # count-adaptive tile windows

A frame is ``skeleton_forward`` then ``render`` at an orbit camera (radius
3, looking along +z) of ``--size`` squared, the time swept over [0, 1).
A rig loads as scripts/test_speed.py loads it: the latest
rig/point_cloud/ PLY and the skeleton tree with fresh nets (seed 0).
``--synthetic`` is scripts/torch_scaling_bench.py's tiny scene. ``--ladder``
renders 8 poses first and fits the tile ladder to their counts. Without it
the frames render on plain windows of ``render``'s default 1024 rows, the
reference's; where the first frame overflows them, the window grows by
``eval_image``'s rule (``train/stage2.py:grow_window``) to hold the largest
tile of the timed poses, rendered once before the timed loop, and the
window is printed. The timed loop reads nothing from the card until its
final synchronize, then prints the reference's line; the first frame's
overflow counters are printed before it, and after it the timed frames'
overflow summed on the card (a warning if it is not 0) and the blend
kernels' launches over the run.
"""
import argparse
import json
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def load_model(model_path, device):
    """(gs, skel) of a rig directory: the latest stage-2 PLY and fresh nets."""
    import torch

    from riggs_tpu_torch.io.checkpoint import load_skeleton_tree
    from riggs_tpu_torch.io.ply import load_gaussians_ply
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.train.config import Config

    mp = Path(model_path)
    cfg = Config.load(mp / "cfg.json")
    joints, parents, _, _ = load_skeleton_tree(mp)
    gs = load_gaussians_ply(sorted((mp / "rig" / "point_cloud").glob("iteration_*/point_cloud.ply"))[-1],
                            capacity=cfg.model.capacity, max_sh_degree=cfg.model.sh_degree,
                            with_motion_mask=cfg.model.gs_with_motion_mask, device=device)
    skel = SW.init_skeleton_warp(joints, parents, generator=torch.Generator(device=device).manual_seed(0),
                                 device=device)
    return gs, skel


def main(argv=None):
    import numpy as np
    import torch

    from riggs_tpu_torch.camera.orbit import OrbitCamera
    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.render.api import render
    from riggs_tpu_torch.render.binning import TILE
    from riggs_tpu_torch.render.ladder import make_tile_ladder
    from riggs_tpu_torch.train.stage2 import grow_window

    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--renders", type=int, default=500)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--ladder", action="store_true",
                    help="probe 8 poses, fit count-adaptive tile windows (render/ladder.py)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.model_path:
        gs, skel = load_model(args.model_path, dev)
    else:
        from scripts.torch_scaling_bench import build_tiny_scene

        state = build_tiny_scene(width=64, height=64, device=dev)[1]
        gs, skel = state.gs, state.skel
    cam = OrbitCamera(width=args.size, height=args.size).to_camera(device=dev)
    bg = torch.zeros(3, device=dev)

    @torch.no_grad()
    def frame(t, **extra):
        d = SW.skeleton_forward(skel, gs.xyz, t, gs.motion_mask)
        return render(cam, gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"], active_sh_degree=gs.max_sh_degree,
                      **extra)

    extra = {}
    if args.ladder:
        # the tile counts vary as the skeleton animates: fit the ladder to
        # the rank envelope of a few poses
        counts = np.stack([frame(t / 8)["tile_counts"].cpu().numpy() for t in range(8)])
        extra["tile_ladder"] = make_tile_ladder(counts)
        print(f"ladder: {extra['tile_ladder']}")

    first = frame(0.0, **extra)
    print(f"first frame: overflow_tiles {int(first['overflow_tiles'])}, overflow_rect {int(first['overflow_rect'])}")
    if not args.ladder and int(first["overflow_tiles"]):
        # the timed poses' largest tile, gathered on the card and read once:
        # the first frame's alone leaves other poses truncated
        peak = first["max_count"]
        for i in range(args.renders):
            peak = torch.maximum(peak, frame(i / args.renders, **extra)["max_count"])
        extra["max_per_tile"] = grow_window(1024, peak, dev, -(-args.size // TILE) ** 2)
        first = frame(0.0, **extra)
        print(f"plain window {extra['max_per_tile']} (the timed poses' largest tile {int(peak)}): "
              f"overflow_tiles {int(first['overflow_tiles'])}, overflow_rect {int(first['overflow_rect'])}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(args.renders):
        overflow += frame(i / args.renders, **extra)["overflow"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    fps = args.renders / dt
    print(f"{args.renders} renders at {args.size}x{args.size}: {dt:.2f}s = {fps:.1f} FPS "
          f"({args.size * args.size * fps / 1e6:.1f} Mpix/s)")
    print(f"timed frames: overflow {int(overflow)}")
    if int(overflow):
        warnings.warn(f"the timed frames truncated {int(overflow)} Gaussians")
    print(f"launches: {json.dumps({k: n for k, n in blend.launches.items() if n})}")


if __name__ == "__main__":
    main()
