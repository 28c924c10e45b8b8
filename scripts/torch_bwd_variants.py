#!/usr/bin/env python3
"""Time the port's backward blend kernels (riggs_tpu_torch/csrc/blend.cu)
against variants of the same source on one CUDA card, on the inputs of one
full-width stage-2 training step.

    python3 scripts/torch_bwd_variants.py     # from the repository root, one card

Variants, each the shipped source with exact text substitutions (each must
match once), built in parallel into .torch_ext/variants/:
  shipped  the source as it is;
  no-cut   without the per-Gaussian power cut (no staged cut, no test);
  gm-256   the gaussian-major layout at 256 threads of 4 pixels, two blocks
           per SM (the other layouts' shape), instead of 512 of 2;
  all-512  every layout at 512 threads of 2 pixels (the gaussian-major
           shape).
Inputs: chip_smoke.py's avatar (seed 0, 800x800, 100 000 Gaussians) and its
training frame; the backward calls of one make_stage2_auto step at
it = 15001 on plain windows (blend_cm_bwd) and on the probe-fitted ladder
(blend_permuted_gm_bwd, one call per bucket). For each call, CUDA-event ms
per call over 10 calls, variants in turns (forward order, then backward);
each variant's dg against the shipped one's (max |delta|, and whether the
bits are equal). Prints the card as nvidia-smi names it. Imports nothing of
JAX or riggs_tpu.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {
    "shipped": (),
    "no-cut": (
        ("  if (!(pmax >= cut[j])) return false;\n", ""),
        ("  for (int j = threadIdx.x; j < G; j += BT) cut[j] = logf(ALPHA_MIN / sg[5][j]) - CUT;\n", ""),
    ),
    "gm-256": (
        ("static constexpr int NT = L == kGM ? 512 : 256;", "static constexpr int NT = 256;"),
        ("static constexpr int MIN_BLOCKS = L == kGM ? 1 : 2;", "static constexpr int MIN_BLOCKS = 2;"),
    ),
    "all-512": (
        ("static constexpr int NT = L == kGM ? 512 : 256;", "static constexpr int NT = 512;"),
        ("static constexpr int MIN_BLOCKS = L == kGM ? 1 : 2;", "static constexpr int MIN_BLOCKS = 1;"),
    ),
}
REPS = 10


def build_variants(B):
    """Every variant's source and library under .torch_ext/variants/, built
    in parallel; returns {name: bound ctypes library}."""
    src = B.CSRC.read_text()
    out = B.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old.strip()!r} matches {text.count(old)} times in blend.cu")
            text = text.replace(old, new)
        path = out / f"blend_{name}.cu"
        path.write_text(text)
        jobs[name] = (path, out / f"libblend_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(B.build, s, lib) for s, lib in jobs.values()]:
            f.result()
    libs = {}
    for name, (_, lib) in jobs.items():
        regs = [l.split("Used")[1].split(",")[0].strip() for l in lib.with_suffix(".log").read_text().splitlines()
                if "Used" in l and "registers" in l]
        print(f"[build] {name}: registers per kernel {regs}")
        libs[name] = B.bind(ctypes.CDLL(str(lib)))
    return libs


def capture_step_calls(B, smoke):
    """The backward calls of one make_stage2_auto step at it = 15001 on
    plain windows and on the ladder, as chip_smoke.py's [train] makes them."""
    import torch

    from riggs_tpu_torch.render.ladder import make_tile_ladder
    from riggs_tpu_torch.train.stage2 import make_stage2_auto

    gs, skel, cam, bg = smoke.build_avatar(0, smoke.N_ALIVE, smoke.CAPACITY, smoke.SIZE, "cuda")
    probe = [smoke.frame(gs, skel, cam, bg, t=t, max_per_tile=8192) for t in smoke.PROBE_TIMES]
    counts = np.stack([p["tile_counts"].cpu().numpy() for p in probe])
    cap = int(-(-counts.max() // 128) * 128)
    ladder = make_tile_ladder(counts)
    fr, pre_d_xyz, pre_d_joints, cfg = smoke.build_training(gs, skel, cam, bg, "cuda")
    step = make_stage2_auto(cfg, template_idx=0)
    calls = {}
    for name, kw in (("blend_cm_bwd", dict(max_per_tile=cap)),
                     ("blend_permuted_gm_bwd", dict(max_per_tile=cap, tile_ladder=ladder))):
        with smoke._Capture(B, (name,)) as c:
            step(smoke.fresh_state(gs, skel, smoke.TRAIN_ITS[-1], "cuda"), fr, smoke.UID, bg, pre_d_xyz,
                 pre_d_joints, **kw)
        calls[name] = c.calls[name]
    torch.cuda.synchronize()
    print(f"[inputs] window {cap}, ladder {ladder}; calls "
          + "; ".join(f"{k}: {[tuple(a[0].shape) for a in v]}" for k, v in calls.items()))
    return calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from riggs_tpu_torch.render import blend as B

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    libs = build_variants(B)
    calls = capture_step_calls(B, smoke)
    kern = {"blend_cm_bwd": B.blend_cm_bwd, "blend_permuted_gm_bwd": B.blend_permuted_gm_bwd}
    shipped_lib = B.load_library
    order = list(libs) + list(libs)[::-1]
    try:
        with torch.no_grad():
            for name, cs in calls.items():
                totals = {v: 0.0 for v in libs}
                for a in cs:
                    dg, ms = {}, {v: [] for v in libs}
                    for v in libs:
                        B.load_library = lambda lib=libs[v]: lib
                        dg[v] = kern[name](*a)
                        kern[name](*a)  # warm-up
                    for v in order:
                        B.load_library = lambda lib=libs[v]: lib
                        ms[v].append(smoke._event_ms(lambda a=a: kern[name](*a), REPS))
                    line = []
                    for v in libs:
                        m = sum(ms[v]) / len(ms[v])
                        totals[v] += m
                        d = float((dg[v] - dg["shipped"]).abs().max())
                        same = torch.equal(dg[v].view(torch.int32), dg["shipped"].view(torch.int32))
                        line.append(f"{v} {ms[v][0]:.4f}/{ms[v][1]:.4f} ms (max|d| {d:.2e}{', same bits' if same else ''})")
                    print(f"[variants] {name} call {tuple(a[0].shape)}: " + "; ".join(line))
                print(f"[variants] {name} per step ({len(cs)} calls): "
                      + "; ".join(f"{v} {t:.4f} ms" for v, t in totals.items()))
    finally:
        B.load_library = shipped_lib
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
