"""scripts/torch_run_refpoint.py, the twin of scripts/run_refpoint.py, on the
CPU at 64 x 64 (capacity 2048, 4 frames, a few iterations of each stage):
its report carries every key of the reference's report, its stage-1 state
and scene cache are the port's own files, and ``--resume`` reads the
stage-1 state and resumes stage 2 from its checkpoint past the warm-up.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from scripts import torch_run_refpoint as RP

REPO = Path(__file__).resolve().parent.parent
# 54 stage-2 steps: the skeleton warm-up is at least 50, and the test
# evaluation at 52 checkpoints past it, so the resume continues from there
ARGS = ["--device", "cpu", "--size", "64", "--capacity", "2048", "--frames", "4", "--s1a", "4", "--s1b", "10",
        "--s2", "54", "--test_every", "52"]


def _reference_keys():
    """The keys scripts/run_refpoint.py writes into its report."""
    src = (REPO / "scripts" / "run_refpoint.py").read_text()
    keys = set(re.findall(r'report\["(\w+)"\]\s*=', src))
    keys |= set(re.findall(r'"(\w+)":', src[src.index("report = {"):src.index("s1_ckpt =")]))
    keys |= set(re.findall(r'"(\w+)":', src[src.index("s1_part = {"):src.index("report.update(s1_part)")]))
    return keys


def _run(out, *extra):
    # two intra-op threads: the suite's parallel workers share the cores, and
    # torch's default of one thread per core oversubscribes them
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_run_refpoint.py"), *ARGS, "--out", str(out),
                          *extra], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()


def test_refpoint_twin_runs_and_resumes(tmp_path):
    out = tmp_path / "rp"
    lines = _run(out)
    report = json.loads(lines[-1])
    keys = _reference_keys()
    assert {"s1_ms_per_iter", "s2_ms_per_iter", "extrapolated_full_budget_hours", "test", "joints"} <= keys
    assert set(report) == keys
    assert json.loads((out / "report.json").read_text()) == report
    partial = [l for l in lines if l.startswith("PARTIAL ")]
    assert len(partial) == 1 and json.loads(partial[0][8:])["s1_alive_gaussians"] == report["s1_alive_gaussians"]
    assert report["size"] == 64 and report["s1_prefix_iters"] == 14 and report["s2_prefix_iters"] == 54
    for k in ("s1_ms_per_iter", "s2_ms_per_iter", "extrapolated_full_budget_hours"):
        assert np.isfinite(report[k]) and report[k] > 0, k
    assert report["joints"] >= 2 and set(report["test"]) == {"psnr", "ssim", "ms_ssim"}
    assert report["mem_live_gb_after_s1"] is None  # no card: no device memory to report
    assert (out / "stage1_state.npz").exists() and (out / "checkpoints" / "iteration_52" / "state.npz").exists()
    assert list((tmp_path / ".scene_cache").glob("torch_refpoint_s64_f4_p1024.npz"))

    lines = _run(out, "--resume")
    assert any(l.startswith("scene loaded from cache") for l in lines)
    assert any(l.startswith("stage-1 state resumed") for l in lines)
    assert "stage-2 resume at iteration 52" in lines
    resumed = json.loads(lines[-1])
    assert set(resumed) == keys and resumed["s1_alive_gaussians"] == report["s1_alive_gaussians"]
    assert not any(l.startswith("PARTIAL") for l in lines)


def test_scene_cache_round_trips(tmp_path):
    from riggs_tpu_torch.data.synthetic import make_scene_data

    _, scene = make_scene_data(n_train=2, n_test=1, width=32, height=32, n_init_points=50, device="cpu")
    RP.save_scene(tmp_path / "s.npz", scene)
    back = RP.load_scene(tmp_path / "s.npz", "cpu")
    assert np.array_equal(back.init_points, scene.init_points) and back.cameras_extent == scene.cameras_extent
    assert (back.is_blender, back.white_background) == (scene.is_blender, scene.white_background)
    for a, b in zip(scene.train_frames + scene.test_frames, back.train_frames + back.test_frames):
        for name in ("image", "alpha_mask", "thinned", "thinned_mask"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for name in ("w2c", "intrinsics", "fid"):
            assert torch.equal(getattr(a.cam, name), getattr(b.cam, name)), name
        assert (a.cam.width, a.cam.height) == (b.cam.width, b.cam.height)
