#!/usr/bin/env python3
"""The reference operating point on the PyTorch port (the twin of
scripts/run_refpoint.py, with the same flags and defaults, ``--device`` in
place of ``--platform``).

    python scripts/torch_run_refpoint.py                 # the default prefix, on the card
    python scripts/torch_run_refpoint.py --resume        # stage 2 again from the saved stage-1 state
    python scripts/torch_run_refpoint.py --full          # the whole reference budget
    python scripts/torch_run_refpoint.py --device cpu --size 64 --capacity 2048 --frames 4 \\
        --s1a 8 --s1b 12 --s2 12 --test_every 6 --out /tmp/rp   # a tiny CPU run

The reference trains 800x800 scenes with clouds of over 100k Gaussians for
10k node-rendering and 80k full stage-1 iterations and 100k stage-2
iterations, densifying from 5k to 70k. This script runs those shapes (800²,
capacity 131072, 512 nodes, the real densification cadences) for a prefix
of the budget (or ``--full``) and reports:

  - steady-state ms/iter of stage 1's phase B and of stage 2 (the median
    interval between step callbacks; phase A's median on the stage-1 line);
  - the full budget's wall-clock extrapolated from those two rates;
  - the memory the port holds on the card after each stage
    (``torch.cuda.memory_allocated``; the peak, ``max_memory_allocated``,
    on a line of its own);
  - the alive Gaussians after stage 1, the joints, and the held-out
    PSNR / SSIM / MS-SSIM after stage 2.

The synthetic biped scene is built once and cached as an ``.npz`` under
``--out``'s parent (``.scene_cache/``); the stage-1 end state is saved to
``--out`` as the port's ``.npz`` (``io/checkpoint.py``), so a later
invocation with ``--resume`` times stage 2 in its own process; stage-2
checkpoints land under ``--out`` through ``train_stage2(model_path=...,
resume=True)``. The last line of standard output is the report's JSON,
also written to ``--out``/report.json; a ``PARTIAL`` line follows stage 1.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

# reference budgets (scripts/run_refpoint.py:50-54)
REF_S1_NODE = 10_000
REF_S1_FULL = 80_000
REF_S2 = 100_000
REF_DENSIFY_FROM = 5_000
REF_DENSIFY_UNTIL = 70_000


class StepTimer:
    """Per-step host clock from a loop's step callback; the median interval
    is the steady state (builds and events are outliers the median drops).
    ``train_stage1`` calls back in both phases with the phase, the reference
    in phase B only: each phase keeps its own clock."""

    def __init__(self):
        self.ts = {}

    def __call__(self, state, it, phase="B"):
        self.ts.setdefault(phase, []).append(time.perf_counter())

    def ms_per_iter(self, phase="B"):
        d = np.diff(np.asarray(self.ts.get(phase, [])))
        return float(np.median(d) * 1e3) if len(d) > 8 else float("nan")


def mem_gb(device, peak=False):
    """Bytes the port holds on the card (PyTorch's allocator), in GB; None
    off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return round((torch.cuda.max_memory_allocated() if peak else torch.cuda.memory_allocated()) / 2**30, 2)


def _frame_arrays(prefix, f, out):
    c = f.cam
    out[prefix + "w2c"] = c.w2c.cpu().numpy()
    out[prefix + "intrinsics"] = c.intrinsics.cpu().numpy()
    out[prefix + "fid"] = c.fid.cpu().numpy()
    out[prefix + "size"] = np.array([c.width, c.height])
    for name in ("image", "alpha_mask", "thinned", "thinned_mask"):
        out[prefix + name] = getattr(f, name).cpu().numpy()


def save_scene(path: Path, scene):
    """The scene's frames, cloud and flags in one ``.npz``."""
    out = {"init_points": scene.init_points, "init_colors": scene.init_colors,
           "flags": np.array([scene.cameras_extent, scene.is_blender, scene.white_background], np.float64),
           "counts": np.array([len(scene.train_frames), len(scene.test_frames)])}
    for i, f in enumerate(scene.train_frames):
        _frame_arrays(f"train{i}_", f, out)
    for i, f in enumerate(scene.test_frames):
        _frame_arrays(f"test{i}_", f, out)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)


def load_scene(path: Path, device):
    from riggs_tpu_torch.convert import frame_from_numpy
    from riggs_tpu_torch.data.dataset import SceneData

    with np.load(path) as d:
        def frames(split, n):
            return [frame_from_numpy(d[f"{split}{i}_w2c"], d[f"{split}{i}_intrinsics"], d[f"{split}{i}_fid"],
                                     *(int(v) for v in d[f"{split}{i}_size"]), d[f"{split}{i}_image"],
                                     alpha_mask=d[f"{split}{i}_alpha_mask"], thinned=d[f"{split}{i}_thinned"],
                                     thinned_mask=d[f"{split}{i}_thinned_mask"], device=device)
                    for i in range(n)]

        n_train, n_test = (int(v) for v in d["counts"])
        extent, is_blender, white = d["flags"]
        return SceneData(init_points=d["init_points"], init_colors=d["init_colors"], is_blender=bool(is_blender),
                         train_frames=frames("train", n_train), test_frames=frames("test", n_test),
                         cameras_extent=float(extent), white_background=bool(white))


def get_scene(args, cache_dir: Path):
    """Build or load the synthetic biped scene (its ground truth is rendered
    by the exact oracle: built once, then read from the cache)."""
    from riggs_tpu_torch.data.synthetic import make_scene_data

    n_init = min(60_000, args.capacity // 2)
    # the cloud's size is part of the key: it follows the capacity
    p = cache_dir / f"torch_refpoint_s{args.size}_f{args.frames}_p{n_init}.npz"
    if p.exists():
        t0 = time.time()
        scene = load_scene(p, args.device)
        print(f"scene loaded from cache in {time.time() - t0:.0f}s ({p})")
        return scene
    t0 = time.time()
    pps = 400 if args.size >= 400 else 60  # keep the CPU smoke tiny
    _, scene = make_scene_data(
        n_train=args.frames, n_test=max(args.frames // 8, 2), width=args.size, height=args.size, figure="biped",
        points_per_seg=pps, n_init_points=n_init, max_thinned=1024, device=args.device,
    )
    print(f"scene built in {time.time() - t0:.0f}s ({len(scene.train_frames)} train frames at {args.size}^2)")
    save_scene(p, scene)
    print(f"scene cached to {p}")
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--capacity", type=int, default=131_072)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--s1a", type=int, default=800, help="stage-1 node-rendering prefix iters")
    ap.add_argument("--s1b", type=int, default=3000, help="stage-1 full prefix iters")
    ap.add_argument("--s2", type=int, default=3000, help="stage-2 prefix iters")
    ap.add_argument("--full", action="store_true", help="run the whole reference budget")
    ap.add_argument("--resume", action="store_true", help="reuse finished stages from --out")
    ap.add_argument("--out", type=str, default=str(Path(__file__).resolve().parent.parent / ".refpoint"))
    ap.add_argument("--test_every", type=int, default=5000, help="stage-2 held-out eval + checkpoint cadence")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.full:
        args.s1a, args.s1b, args.s2 = REF_S1_NODE, REF_S1_FULL, REF_S2

    import torch

    from riggs_tpu_torch.device import resolve_device
    from riggs_tpu_torch.io.checkpoint import load_state_npz, save_state_npz, stage1_template
    from riggs_tpu_torch.models.skeleton_warp import skeleton_forward
    from riggs_tpu_torch.render.api import render, tier_kwargs
    from riggs_tpu_torch.render.ladder import make_tile_ladder
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage1 import train_stage1
    from riggs_tpu_torch.train.stage2 import evaluate_stage2, train_stage2

    dev = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    scene = get_scene(args, out.parent / ".scene_cache")

    cfg = Config()
    cfg.model.capacity = args.capacity
    cfg.model.node_num = 512  # the reference's run_demo.py
    cfg.pipe.max_per_tile = 768
    o = cfg.opt
    o.iterations_node_rendering = args.s1a
    o.iterations_node_sampling = int(args.s1a * 0.75)  # node sampling scales with the node-rendering prefix
    o.iterations = args.s1b
    o.iterations_stage2 = args.s2
    # the real cadences: a prefix sees the full run's densification pressure per iteration
    o.densify_from_iter = min(REF_DENSIFY_FROM, max(args.s1b // 6, 200))
    o.densify_until_iter = REF_DENSIFY_UNTIL
    o.gs_densification_iterations = min(REF_DENSIFY_FROM, max(args.s2 // 6, 200))
    o.skeleton_warm_up = min(1_000, max(args.s2 // 10, 50))
    o.optimize_template_offsets_iters = min(15_000, max(args.s2 // 3, 100))

    report = {"size": args.size, "capacity": args.capacity, "frames": args.frames}
    s1_ckpt = out / "stage1_state.npz"
    s1_json = out / "stage1_report.json"

    if args.resume and s1_ckpt.exists():
        t0 = time.time()
        s1 = load_state_npz(s1_ckpt, stage1_template(scene, cfg, s1_ckpt, dev))
        report.update(json.loads(s1_json.read_text()))
        print(f"stage-1 state resumed in {time.time() - t0:.0f}s ({report.get('s1_alive_gaussians')} alive gaussians)")
    else:
        t1 = StepTimer()
        t0 = time.time()
        s1, _ = train_stage1(scene, cfg, log_every=500, step_callback=t1, device=dev)
        s1_wall = time.time() - t0
        s1_part = {
            "s1_prefix_iters": args.s1a + args.s1b,
            "s1_wall_s": round(s1_wall, 1),
            "s1_ms_per_iter": round(t1.ms_per_iter("B"), 2),
            "mem_live_gb_after_s1": mem_gb(dev),
            "s1_alive_gaussians": int(s1.gs.num_alive),
        }
        report.update(s1_part)
        print(f"stage 1 prefix: {s1_wall:.0f}s, {report['s1_ms_per_iter']} ms/iter steady (phase B; phase A "
              f"{t1.ms_per_iter('A'):.2f}), {report['s1_alive_gaussians']} alive gaussians, "
              f"live {report['mem_live_gb_after_s1']} GB")
        print("PARTIAL " + json.dumps(report))  # survives a cut in stage 2
        save_state_npz(s1_ckpt, s1)
        s1_json.write_text(json.dumps(s1_part))
        print(f"stage-1 state checkpointed to {s1_ckpt}")

    t2 = StepTimer()
    t0 = time.time()
    events = []
    s2, info, _ = train_stage2(s1, scene, cfg, log_every=500, step_callback=t2, test_every=args.test_every,
                               model_path=str(out), resume=args.resume, events=events, device=dev)
    s2_wall = time.time() - t0
    for e in events:
        if e["event"] in ("resume", "no resume"):
            print(f"stage-2 {e['event']} at iteration {e['it']}" + (f": {e['reason']}" if "reason" in e else ""))
    report["s2_prefix_iters"] = args.s2
    report["s2_wall_s"] = round(s2_wall, 1)
    report["s2_ms_per_iter"] = round(t2.ms_per_iter(), 2)
    report["mem_live_gb_after_s2"] = mem_gb(dev)
    report["joints"] = int(len(info.joints))

    # an eval ladder fitted from one plain-window render's true tile counts
    pipe = cfg.pipe
    tiers = (pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side)
    f0 = scene.test_frames[0]
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        d0 = skeleton_forward(s2.skel, s2.gs.xyz, f0.fid, s2.gs.motion_mask)
        probe = render(f0.cam, s2.gs, bg, d_xyz=d0["d_xyz"], d_rotation=d0["d_rotation"],
                       active_sh_degree=s2.gs.max_sh_degree, max_per_tile=pipe.max_per_tile, **tier_kwargs(tiers))
    eval_ladder = make_tile_ladder(probe["tile_counts"].cpu().numpy(), margin=1.5, quantize="pow2")
    ev = evaluate_stage2(s2, scene.test_frames, bg, tile_ladder=eval_ladder)
    report["test"] = {k: round(float(v), 3) for k, v in ev.items()}
    print(f"stage 2 prefix: {s2_wall:.0f}s, {report['s2_ms_per_iter']} ms/iter, J={report['joints']}, "
          f"test={report['test']}")
    print(f"peak memory allocated: {mem_gb(dev, peak=True)} GB")
    if dev.type == "cuda":
        from riggs_tpu_torch.ops import geometry
        from riggs_tpu_torch.render import blend

        print("kernel launches: " + json.dumps(dict(blend.launches, **geometry.launches)))

    # the full budget at the steady-state rates (phase B's for all of stage 1, as the reference does)
    full_s = ((REF_S1_NODE + REF_S1_FULL) * report["s1_ms_per_iter"] + REF_S2 * report["s2_ms_per_iter"]) / 1e3
    report["extrapolated_full_budget_hours"] = round(full_s / 3600, 2)
    (out / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)  # a run cut by its time limit still leaves every line
    main()
