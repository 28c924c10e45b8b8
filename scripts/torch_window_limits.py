#!/usr/bin/env python3
"""Two measurements of the port's capacity limits on the card (ROADMAP C6
and C7).

    python3 scripts/torch_window_limits.py eval [twin flags]   # C6: the refpoint twin's default prefix
    python3 scripts/torch_window_limits.py rect   # C7: chip_smoke.py's [zju] stage 1, two rect caps
    python3 scripts/torch_window_limits.py rect --scale 5 --seed 1   # a schedule 5x as long, another seed

``eval`` runs ``scripts/torch_run_refpoint.py`` at its default prefix
(output under ``.refpoint/limits``) with every held-out evaluation done
twice on the same state: by ``eval_image`` as it is (its window grows past
8192 rows as far as free memory allows) and with the window held at 8192,
as the reference's ``eval_image`` holds it (``window_ceiling`` patched to
8192). It prints each evaluation's PSNR both ways and the frames truncated,
then the twin's report.

``rect`` writes chip_smoke.py's 12-frame 1024x1024 ZJU-MoCap subject and
runs its ``train_stage1`` from one initial state three times: with the
training tiers of the configuration (``max_tiles_per_gaussian`` 4, the mid
tier at 8192, the giant tier's default 256), with the rect cap raised
(``max_tiles_per_gaussian`` 16, no mid tier), and with the default tiers
and the giant tier's cap raised to ``GIANT_CAP`` (the training steps'
``tier_kwargs`` patched: the configuration has no field for it). For each
it prints the steps whose rect overflowed and by how much,
the loss and PSNR at the ends of each phase, the held-out PSNR of the two
test views (``render_test_set_stage1``) and the ms per phase-B step.
``--scale N`` multiplies every count of ``[zju]``'s schedule (40 + 40
steps) by N; ``--seed S`` seeds the initial state and the loop (0 unless
given).
"""
import argparse
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GIANT_CAP = 4096


def eval_both_ways(argv):
    import scripts.torch_run_refpoint as refpoint
    from riggs_tpu_torch.train import stage2 as S2

    orig_eval, orig_ceiling = S2.evaluate_stage2, S2.window_ceiling

    def evaluate(state, frames, bg, tile_ladder=None):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            grown = orig_eval(state, frames, bg, tile_ladder=tile_ladder)
        grown_cut = sum("capacity limits" in str(w.message) for w in caught)
        S2.window_ceiling = lambda device, n_tiles: S2.MAX_PER_TILE_LIMIT
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                held = orig_eval(state, frames, bg, tile_ladder=tile_ladder)
        finally:
            S2.window_ceiling = orig_ceiling
        held_cut = sum("capacity limits" in str(w.message) for w in caught)
        print(f"[eval] it={int(state.it)}: psnr {grown['psnr']:.4f} with the window grown ({grown_cut} of "
              f"{len(frames)} frames truncated), {held['psnr']:.4f} with it held at {S2.MAX_PER_TILE_LIMIT} "
              f"({held_cut} truncated); ssim {grown['ssim']:.4f} / {held['ssim']:.4f}", flush=True)
        return grown

    S2.evaluate_stage2 = evaluate
    return refpoint.main(["--out", str(ROOT / ".refpoint" / "limits"), *argv])


def rect_caps(argv=()):
    import copy
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as smoke
    from riggs_tpu_torch import cuda_build
    from riggs_tpu_torch.data.scene import load_scene
    from riggs_tpu_torch.eval.render_stage1 import render_test_set_stage1
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.ops import geometry
    from riggs_tpu_torch.render.api import render, tier_kwargs
    from riggs_tpu_torch.train import stage1 as S1

    ap = argparse.ArgumentParser(prog="torch_window_limits.py rect")
    ap.add_argument("--scale", type=int, default=1, help="[zju]'s schedule, every count times this")
    ap.add_argument("--seed", type=int, default=0, help="the seed of the initial state and of the loop")
    args = ap.parse_args(argv)
    schedule = {k: v * args.scale for k, v in smoke.ZJU_SCHEDULE.items()}
    cuda_build.build_all({blend.LIB_STEM: blend.CSRC, geometry.LIB_STEM: geometry.CSRC})
    gs, skel, _, _ = smoke.build_avatar(0, smoke.N_ALIVE, smoke.CAPACITY, smoke.SIZE, smoke.DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        scene = load_scene(smoke.write_zju_subject(Path(tmp), gs, skel), device=smoke.DEVICE)
    del gs, skel
    cfg = smoke._zju_config(1024)
    for k, v in schedule.items():
        setattr(cfg.pipe if k == "ladder_check_every" else cfg.opt, k, v)
    print(f"[rect] schedule {schedule}, seed {args.seed}", flush=True)
    state0 = S1.init_stage1(scene, cfg, generator=torch.Generator(device=smoke.DEVICE).manual_seed(args.seed),
                            device=smoke.DEVICE)
    with torch.no_grad():
        counts = [int(render(f.cam, state0.gs, torch.zeros(3, device=smoke.DEVICE), max_per_tile=16384)["max_count"])
                  for f in scene.train_frames[::4]]
    cfg.pipe.max_per_tile = int(-(-max(1024, 4 * max(counts)) // 128) * 128)
    bg = torch.zeros(3, device=smoke.DEVICE)
    runs = (("default tiers (4, 8192, 4), giant cap 256", None, None),
            ("rect cap raised (16, no mid tier)", (16, 0), None),
            (f"default tiers, giant cap {GIANT_CAP}", None, GIANT_CAP))
    for label, tiers, giant_cap in runs:
        c = dataclasses.replace(cfg, pipe=dataclasses.replace(cfg.pipe))
        if tiers is not None:
            c.pipe.max_tiles_per_gaussian, c.pipe.mid_cap = tiers
        S1.tier_kwargs = tier_kwargs if giant_cap is None else (lambda t: dict(tier_kwargs(t), giant_cap=giant_cap))
        events, ts = [], {}

        def clock(state, it, phase="B"):
            ts.setdefault(phase, []).append(time.perf_counter())

        t0 = time.perf_counter()
        state, hist = S1.train_stage1(scene, c, seed=args.seed, log_every=schedule["iterations"] - 1,
                                      state=copy.deepcopy(state0), events=events, step_callback=clock,
                                      device=smoke.DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rect = [(e["it"], e["rect"]) for e in events if e["event"] == "overflow" and e["rect"]]
        tiles = [(e["it"], e["tiles"]) for e in events if e["event"] == "overflow" and e["tiles"]]
        _, means, _ = render_test_set_stage1(state.gs, state.warp, scene.test_frames, bg=bg,
                                             max_per_tile=c.pipe.max_per_tile)
        ms_b = float(np.median(np.diff(ts["B"])) * 1e3)
        print(f"[rect] {label}: {wall:.1f} s; overflow_rect on {len(rect)} phase-B steps, max "
              f"{max((r for _, r in rect), default=0)}, total {sum(r for _, r in rect)}; overflow_tiles on "
              f"{len(tiles)} steps; {int(state.gs.num_alive)} alive; {ms_b:.2f} ms per phase-B step (median)")
        for p, it, m in hist:
            print(f"[rect]   {p} it={it}: " + " ".join(f"{k} {v:.5f}" for k, v in m.items()
                                                      if k in ("loss", "psnr", "ref_loss")))
        print(f"[rect]   test views: " + " ".join(f"{k} {v:.4f}" for k, v in means.items()), flush=True)
        del state


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "eval":
        sys.exit(eval_both_ways(sys.argv[2:]))
    if what == "rect":
        sys.exit(rect_caps(sys.argv[2:]))
    sys.exit("usage: torch_window_limits.py eval [twin flags] | rect [--scale N] [--seed S]")
