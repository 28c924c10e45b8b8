"""The CLI twins of riggs_tpu_torch (scripts/torch_*.py) on the CPU, at a
small size: torch_run_pipeline.py --synthetic on a cut schedule (1024
slots, 24 nodes, 6 + 8 stage-1 steps, 8 stage-2 steps, a test evaluation at
6) writes what scripts/run_pipeline.py writes; torch_render_rig.py loads its
whole rig checkpoint and reproduces its numerical_res.txt; torch_render_stage1.py
loads its stage-1 checkpoint; torch_metrics.py scores a renders/gt folder as
riggs_tpu's evaluate_image does (psnr 1e-4 dB, ssim 1e-5);
torch_resume_stage2.py resumes the pipeline's stage-1 checkpoint into 2 more
stage-2 steps and writes the rig, tree, OBJ and table; torch_run_pipeline.py
--dp 2 starts two gloo ranks and writes the same files from rank 0;
torch_run_zju.py runs the pipeline (6 reference-point steps at 1024 slots,
so past C5's M = 200) and the render twin on a ZJU-MoCap subject of
tests/test_torch_zju.py, its two scripts called in this process with the
flags it builds; the viewer, SIBR and anomaly flags each run a cut pipeline
to its end.
The render and resume twins rebuild the 16-frame 128 x 128 synthetic scene
that the pipeline trained on; it is built once here and handed to each.
"""
import inspect
import json
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from riggs_tpu.eval import metrics as JMet
from riggs_tpu_torch.data import synthetic as TSyn
from scripts import (torch_metrics, torch_render_rig, torch_render_stage1, torch_resume_stage2, torch_run_pipeline,
                     torch_run_zju)

from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_zju import write_zju_subject

SMALL = ["--device", "cpu", "--capacity", "1024", "--node_num", "24", "--hyper_dim", "2", "--sh_degree", "1",
         "--iterations_node_rendering", "6", "--node_warm_up", "2", "--iterations_node_sampling", "20",
         "--iterations", "8", "--densify_from_iter", "3", "--densification_interval", "3",
         "--skeleton_warm_up", "3", "--optimize_template_offsets_iters", "5", "--gs_densification_iterations", "4",
         "--skeleton_max_candidates", "16"]


def test_cli_twins_run_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "run"
    real, sig, built, calls = TSyn.make_scene_data, inspect.signature(TSyn.make_scene_data), {}, []

    def cached(**kw):
        bound = sig.bind(**kw)
        bound.apply_defaults()
        key = tuple(sorted((k, str(v)) for k, v in bound.arguments.items()))
        calls.append(key)
        if key not in built:
            built[key] = real(**kw)
        return built[key]

    with mock.patch.object(TSyn, "make_scene_data", cached):
        _pipeline_and_render(out, capsys)
        _resume(out, capsys)
    assert len(calls) == 7 and len(built) == 1
    _metrics(tmp_path)


def _pipeline_and_render(out, capsys):
    torch_run_pipeline.main(["--synthetic", "--synthetic_frames", "16", "--synthetic_size", "128",
                             "--model_path", str(out), "--test_every", "6"] + SMALL)
    for f in ("cfg.json", "skeleton_tree.npz", "skeleton.obj", "numerical_res.txt", "checkpoints/iteration_8/state.npz",
              "point_cloud/iteration_8/point_cloud.ply", "rig/checkpoints/iteration_6/state.npz",
              "rig/checkpoints/iteration_8/state.npz", "rig/point_cloud/iteration_8/point_cloud.ply", "rig/cfg.json"):
        assert (out / f).exists(), f
    res = (out / "numerical_res.txt").read_text().splitlines()
    assert len(res) == 1 + 4 + 1 and all(np.isfinite(float(x)) for line in res[1:] for x in line.split("\t")[1:])
    torch_render_rig.main(["--model_path", str(out), "--synthetic", "--device", "cpu"])
    assert "loaded full checkpoint at iteration 8" in capsys.readouterr().out
    assert (out / "synthesis" / "render" / "numerical_res.txt").read_text() == (out / "numerical_res.txt").read_text()
    torch_render_rig.main(["--model_path", str(out), "--synthetic", "--device", "cpu", "--mode", "time",
                           "--n_frames", "2"])
    torch_render_stage1.main(["--model_path", str(out), "--synthetic", "--device", "cpu"])
    assert "loaded stage-1 checkpoint at iteration 8" in capsys.readouterr().out
    assert (out / "synthesis_stage1" / "render" / "nodes.obj").exists()
    torch_render_stage1.main(["--model_path", str(out), "--synthetic", "--device", "cpu", "--mode", "all",
                              "--n_frames", "2"])
    for d in ("synthesis/render", "synthesis/time", "synthesis_stage1/render", "synthesis_stage1/all"):
        assert list((out / d).glob("video.*")), d


def _resume(out, capsys):
    for f in ("skeleton_tree.npz", "skeleton.obj", "numerical_res.txt"):
        (out / f).unlink()
    torch_resume_stage2.main(["--model_path", str(out), "--iterations", "10", "--test_every", "6", "--synthetic_size",
                              "128", "--synthetic_frames", "16", "--synthetic_figure", "chain", "--synthetic_points",
                              "120", "--synthetic_init_points", "300", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "restored stage-1 state from iteration 8" in text and "FINAL test:" in text
    for f in ("skeleton_tree.npz", "skeleton.obj", "numerical_res.txt", "rig/checkpoints/iteration_10/state.npz",
              "rig/point_cloud/iteration_10/point_cloud.ply"):
        assert (out / f).exists(), f
    from riggs_tpu_torch.train.config import Config

    cfg = Config.load(out / "cfg.json")
    _, it = torch_render_rig.load_rig(out, cfg, TSyn.make_scene_data(n_train=16, n_test=4, width=128, height=128,
                                                                     device="cpu")[1], "cpu")
    assert it == 10


def test_zju_twin_runs_on_the_cpu(tmp_path):
    write_zju_subject(tmp_path / "data" / "377")
    scripts = {"torch_run_pipeline.py": torch_run_pipeline.main, "torch_render_rig.py": torch_render_rig.main}
    ran = []

    def run(cmd, check):
        assert check and cmd[0] == sys.executable
        ran.append(Path(cmd[1]).name)
        scripts[Path(cmd[1]).name](cmd[2:])

    with mock.patch.object(torch_run_zju.subprocess, "run", run):
        torch_run_zju.main(["--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path / "out"),
                            "--subjects", "377", "386", "--device", "cpu", "--extra"] + SMALL[2:])
    assert ran == ["torch_run_pipeline.py", "torch_render_rig.py"]
    out = tmp_path / "out" / "377"
    cfg = json.loads((out / "cfg.json").read_text())
    assert cfg["model"]["use_skinning_weight_mlp"] and cfg["model"]["node_num"] == 24
    for f in ("skeleton_tree.npz", "skeleton.obj", "numerical_res.txt", "checkpoints/iteration_8/state.npz",
              "rig/checkpoints/iteration_8/state.npz", "synthesis/render/numerical_res.txt"):
        assert (out / f).exists(), f
    res = (out / "numerical_res.txt").read_text().splitlines()
    assert len(res) == 1 + 2 + 1 and all(np.isfinite(float(x)) for line in res[1:] for x in line.split("\t")[1:])


def _metrics(tmp_path):
    rng = np.random.default_rng(0)
    folder = tmp_path / "m" / "test" / "ours_8"
    for sub in ("renders", "gt"):
        (folder / sub).mkdir(parents=True)
    imgs = {}
    for i in range(2):
        for sub in ("renders", "gt"):
            a = (rng.uniform(size=(24, 24, 3)) * 255).astype(np.uint8)
            Image.fromarray(a).save(folder / sub / f"{i:05d}.png")
            imgs[sub, i] = a.astype(np.float32) / 255.0
    torch_metrics.main(["-m", str(tmp_path / "m"), "--device", "cpu"])
    per_view = json.loads((tmp_path / "m" / "per_view.json").read_text())["ours_8"]
    for i in range(2):
        ref = JMet.evaluate_image(jnp.asarray(imgs["renders", i]), jnp.asarray(imgs["gt", i]))
        got = per_view[f"{i:05d}.png"]
        assert abs(got["psnr"] - ref["psnr"]) <= 1e-4 and abs(got["ssim"] - ref["ssim"]) <= 1e-5
    assert set(json.loads((tmp_path / "m" / "results.json").read_text())) == {"ours_8"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fetch(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, r.read()


@pytest.mark.parametrize("flag", [["--viewer_port", "8000"], ["--gui_port", "6009"], ["--detect_anomaly"]])
def test_cli_flags_of_later_items_raise(flag, tmp_path, monkeypatch, capsys):
    """The viewer and debugging flags of the pipeline twin (ported in
    ROADMAP A10; they raised before) each run the cut pipeline of
    test_cli_twins_run_on_the_cpu to its end, on a 4-frame 64 x 64 scene:
    --viewer_port serves /render while each stage trains (stage 2's frame the
    PNG of a viewer of the step's own state), --gui_port answers a SIBR
    client's request from a step callback, --detect_anomaly trains under
    torch's anomaly mode."""
    import functools
    import io
    import threading

    import torch
    from PIL import Image

    from riggs_tpu_torch.train import stage1 as TS1
    from riggs_tpu_torch.train import stage2 as TS2
    from riggs_tpu_torch.viz import sibr as TSi
    from riggs_tpu_torch.viz import web_viewer as TV

    port = _free_port()
    argv = ["--synthetic", "--synthetic_frames", "4", "--synthetic_size", "64", "--model_path", str(tmp_path / "run"),
            "--test_every", "6"] + SMALL
    argv += [flag[0], str(port)] if flag[0] != "--detect_anomaly" else flag
    seen = {}
    if flag[0] == "--viewer_port":
        # the frames of this test: 64 x 64, not the default 512
        monkeypatch.setattr(TV, "ViewerServer", functools.partial(TV.ViewerServer, width=64, height=64))

        def wrap(real, stage):
            def run(*a, step_callback=None, **kw):
                def cb(state, it, *phase):
                    step_callback(state, it, *phase)
                    if stage not in seen:
                        status, body = _fetch(port, "/render?t=0.5&r=2.5")
                        seen[stage] = status
                        if stage == "stage 2":
                            want = TV.ViewerServer(state.gs, skel=state.skel, device="cpu").render_frame(
                                0.0, 0.3, 2.5, 0.5)  # 64 x 64
                            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), TSi.quantize(want))
                return real(*a, step_callback=cb, **kw)
            return run

        monkeypatch.setattr(TS1, "train_stage1", wrap(TS1.train_stage1, "stage 1"))
        monkeypatch.setattr(TS2, "train_stage2", wrap(TS2.train_stage2, "stage 2"))
    elif flag[0] == "--gui_port":
        def client():
            for _ in range(600):
                try:
                    c = TSi.SibrClient("127.0.0.1", port)
                    break
                except ConnectionRefusedError:
                    threading.Event().wait(0.1)
            view = np.eye(4, dtype=np.float32)
            view[3, 2] = -2.5  # the client's form of a camera 2.5 in front of the origin
            seen["img"], seen["verify"] = c.request(24, 16, view, train=True)
            c.close()

        t = threading.Thread(target=client, daemon=True)
        t.start()
    try:
        torch_run_pipeline.main(argv)
        anomaly = torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert anomaly == (flag[0] == "--detect_anomaly")
    if flag[0] == "--viewer_port":
        assert seen == {"stage 1": 200, "stage 2": 200}
    if flag[0] == "--gui_port":
        t.join(timeout=60)
        assert seen["img"].shape == (16, 24, 3) and seen["verify"] == str(tmp_path / "run")
        assert f"SIBR network_gui listening on 127.0.0.1:{port}" in capsys.readouterr().out
    res = (tmp_path / "run" / "numerical_res.txt").read_text().splitlines()
    assert len(res) == 1 + 1 + 1 and all(np.isfinite(float(x)) for line in res[1:] for x in line.split("\t")[1:])


def test_pipeline_twin_trains_frame_parallel_on_two_ranks(tmp_path, capfd, monkeypatch):
    """torch_run_pipeline.py --dp 2 with no launcher environment starts its
    two gloo ranks itself: train_stage1_dp, then train_stage2_dp at 2 x 1,
    on the schedule of test_cli_twins_run_on_the_cpu. Only rank 0 writes
    (exactly the files of a one-process run), prints (each line once) and
    serves the live viewer and SIBR ports, and the rig reloads as
    torch_render_rig.py loads it."""
    from riggs_tpu_torch.train.config import Config

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name in ("RANK", "WORLD_SIZE", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    out = tmp_path / "run"
    # the viewer and SIBR ports on rank 0 alone: a second rank binding them would fail
    torch_run_pipeline.main(["--synthetic", "--synthetic_frames", "16", "--synthetic_size", "128", "--model_path",
                             str(out), "--test_every", "6", "--dp", "2", "--viewer_port", str(_free_port()),
                             "--gui_port", str(_free_port())] + SMALL)
    files = sorted(p.relative_to(out).as_posix() for p in out.rglob("*") if p.is_file())
    assert files == ["cfg.json", "checkpoints/iteration_8/state.npz", "numerical_res.txt",
                     "point_cloud/iteration_8/point_cloud.ply", "rig/cfg.json", "rig/checkpoints/iteration_6/state.npz",
                     "rig/checkpoints/iteration_8/state.npz", "rig/point_cloud/iteration_6/point_cloud.ply",
                     "rig/point_cloud/iteration_8/point_cloud.ply", "skeleton.obj", "skeleton_tree.npz"]
    text = capfd.readouterr().out
    for line in ("scene: 16 train / 4 test frames", "stage 1 done", "stage 2 done", "test metrics:", "viewer at",
                 "SIBR network_gui listening"):
        assert text.count(line) == 1, (line, text)
    res = (out / "numerical_res.txt").read_text().splitlines()
    assert len(res) == 1 + 4 + 1 and all(np.isfinite(float(x)) for line in res[1:] for x in line.split("\t")[1:])
    cfg = Config.load(out / "cfg.json")
    _, it = torch_render_rig.load_rig(out, cfg, TSyn.make_scene_data(n_train=16, n_test=4, width=128, height=128,
                                                                     device="cpu")[1], "cpu")
    assert it == 8
