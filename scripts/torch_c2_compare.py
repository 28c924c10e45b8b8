#!/usr/bin/env python3
"""Host reads and host-clock times of three workloads on one card, for
each repository tree given, in the order given, each in its own process:
the serving frame (``_eval_image`` at 800x800, plain windows), the stage-2
step (``make_stage2_auto`` at it = 15001) and the stage-1 phase-B step
(``make_phase_b_auto`` at it = 5000 with the chamfer and the motion-mask
loss), plain windows. Each is timed by host clock around 20 synchronized
calls after a warm-up, profiled over 5 calls (busy time and idle share) and
its synchronizing operations counted by source line. One JSON line per
tree, then the card's name and power limit.

    python3 scripts/torch_c2_compare.py .before . . .before   # parent, change, change, parent

The workloads are this checkout's chip_smoke.py builders (``build_avatar``,
``build_training``, ``stage1_setup``) and its ``count_syncs``; the package
measured is each tree's own riggs_tpu_torch.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

SCRIPT = Path(__file__).resolve()


def _it(step, it):
    """The host iteration for an auto step; a tree from before the host
    reads were removed (ROADMAP C2) reads it from ``state.it`` instead."""
    return {"it": it} if "it" in inspect.signature(step).parameters else {}


def worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT.parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.train.stage1 import make_phase_b_auto
    from riggs_tpu_torch.train.stage2 import _eval_image, make_stage2_auto

    def measure(fn):
        fn()
        fn()
        ms = smoke._host_ms(fn, 20)
        busy = smoke._profile_busy(fn, 5)
        sites = smoke.count_syncs(fn)[0]
        return {"ms": ms, "busy_ms": busy, "idle_share": 1 - busy / ms, "syncs": sum(sites.values()),
                "sync_sites": sites}

    blend.load_library()
    dev = smoke.DEVICE
    gs, skel, cam, bg = smoke.build_avatar(0, smoke.N_ALIVE, smoke.CAPACITY, smoke.SIZE, dev)
    counts = np.stack([smoke.frame(gs, skel, cam, bg, t=t, max_per_tile=8192)["tile_counts"].cpu().numpy()
                       for t in smoke.PROBE_TIMES])
    cap = int(-(-counts.max() // 128) * 128)
    out = {"tree": str(tree), "serving": measure(lambda: _eval_image(gs, skel, cam, 0.5, bg, max_per_tile=cap))}

    fr, pre_d_xyz, pre_d_joints, cfg = smoke.build_training(gs, skel, cam, bg, dev)
    step2 = make_stage2_auto(cfg, template_idx=0)
    st2 = smoke.fresh_state(gs, skel, 15001, dev)

    def one2():
        nonlocal st2
        st2, _ = step2(st2, fr, smoke.UID, bg, pre_d_xyz, pre_d_joints, max_per_tile=cap, **_it(step2, 15001))

    out["stage2"] = measure(one2)
    del st2

    cfg1, st1, cap1, _, _ = smoke.stage1_setup(gs, bg, fr)
    st1 = dataclasses.replace(st1, it=torch.tensor(5000, dtype=torch.int32, device=dev))
    step1 = make_phase_b_auto(cfg1)
    gen = torch.Generator(device=dev).manual_seed(3)

    def one1():
        nonlocal st1
        st1, _ = step1(st1, fr, bg, NW.arap_sample_times(gen, device=dev), use_chamfer=True, use_motion_loss=True,
                       max_per_tile=cap1, **_it(step1, 5000))

    out["stage1"] = measure(one1)
    out["windows"] = {"serving": cap, "stage1": cap1}
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_c2_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for tree in sys.argv[1:]:
        res = subprocess.run([sys.executable, str(SCRIPT), "--worker", tree], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
