"""The last one-function ports and script twins of riggs_tpu_torch against
riggs_tpu: ops/knn.py:ball_query, camera/camera.py:depth2normal,
train/losses.py:kl_divergence and ops/sh.py:sh_dc_to_rgb on seeded inputs,
then scripts/torch_process_data.py (thin, semseg, zju-cams, smpl-prior),
scripts/torch_capture_tools.py (frames, colmap2nerf, masks) and
scripts/torch_run_synthesis.py on tmp_path layouts, each against the
reference script's own output on a copy of the same layout.

Tolerances: ball_query's indices and inf pattern exactly, its distances
1e-6 (the KNN's expansion differs in the last bit); depth2normal 1e-5;
kl_divergence and its gradient 1e-6; sh_dc_to_rgb 1e-7; the scripts' files
exactly (transforms_train.json's matrices 1e-12).
"""
import json
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from riggs_tpu.camera.camera import depth2normal as j_depth2normal
from riggs_tpu.camera.camera import make_camera as j_make_camera
from riggs_tpu.ops.knn import ball_query as j_ball_query
from riggs_tpu.ops.sh import sh_dc_to_rgb as j_sh_dc_to_rgb
from riggs_tpu.train.losses import kl_divergence as j_kl
from riggs_tpu_torch.camera.camera import depth2normal, make_camera
from riggs_tpu_torch.ops.knn import ball_query
from riggs_tpu_torch.ops.sh import sh_dc_to_rgb
from riggs_tpu_torch.train.losses import kl_divergence
from scripts import capture_tools, process_data, run_synthesis
from scripts import torch_capture_tools, torch_process_data, torch_run_pipeline, torch_run_synthesis
from tests.test_torch_readers import _write_colmap
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)


def test_ball_query_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.normal(size=(70, 3)).astype(np.float32)
    jd, ji = j_ball_query(jnp.asarray(x), jnp.asarray(y), 0.6, 5)
    td, ti = ball_query(torch.tensor(x), torch.tensor(y), 0.6, 5)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert ti.dtype == torch.int32 and 0 < int((ti == -1).sum()) < ti.numel()
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(np.isinf(td.numpy()), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=0, atol=1e-6)


def test_depth2normal_matches():
    """A smooth seeded depth map under an off-centre camera: the one-sided
    differences of the edges (torch.gradient's edge_order 1) and the
    central ones inside."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:24, :32].astype(np.float32)
    depth = (2.0 + 0.3 * np.sin(xx / 5) * np.cos(yy / 7) + 0.01 * rng.normal(size=(24, 32))).astype(np.float32)
    K = np.array([[30.0, 0, 14.5], [0, 28.0, 13.0], [0, 0, 1]])
    jc = j_make_camera(np.eye(3), np.zeros(3), 32, 24, K=K)
    tc = make_camera(np.eye(3), np.zeros(3), 32, 24, K=K, device="cpu")
    a = np.asarray(j_depth2normal(jc, jnp.asarray(depth)))
    b = depth2normal(tc, torch.tensor(depth)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-5)


def test_kl_divergence_and_sh_dc_to_rgb_match():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(50, 8)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda z: j_kl(0.05, z))(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    tv = kl_divergence(0.05, t)
    (tg,) = torch.autograd.grad(tv, t)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    dc = rng.normal(size=(30, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(sh_dc_to_rgb(torch.tensor(dc)).numpy(), np.asarray(j_sh_dc_to_rgb(jnp.asarray(dc))),
                               rtol=0, atol=1e-7)


def _run_reference(monkeypatch, module, argv):
    """A reference script's main() on ``argv`` (it reads sys.argv)."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    module.main()


def _same_tree(a: Path, b: Path, rel: list[str]):
    """The files ``rel`` under a and b hold the same data: PNGs the same
    pixels, .npy the same arrays, .pkl the same pickled dicts of arrays."""
    for r in rel:
        fa, fb = a / r, b / r
        if r.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(fb)), np.asarray(Image.open(fa)), err_msg=r)
        elif r.endswith(".npy"):
            x, y = np.load(fa), np.load(fb)
            assert x.dtype == y.dtype, r
            np.testing.assert_array_equal(y, x, err_msg=r)
        else:
            with open(fa, "rb") as f, open(fb, "rb") as g:
                x, y = pickle.load(f), pickle.load(g)
            assert list(x) == list(y), r
            for k in x:
                for kk in x[k]:
                    np.testing.assert_array_equal(np.asarray(y[k][kk]), np.asarray(x[k][kk]), err_msg=f"{r}:{k}")


@pytest.fixture()
def data_layout(tmp_path):
    """A scene folder for process_data: RGBA frames with a blob each in
    train/, three ZJU views' cameras, posed-vertex files."""
    rng = np.random.default_rng(3)
    root = tmp_path / "scene"
    (root / "train").mkdir(parents=True)
    yy, xx = np.mgrid[:40, :48]
    for i in range(3):
        rgb = (rng.uniform(size=(40, 48, 3)) * 255).astype(np.uint8)
        a = (((yy - 20) / 14) ** 2 + ((xx - 22 - 2 * i) / 9) ** 2 < 1) * 255
        a[18:22, 5:44] = 255  # an arm: a skeleton with branches
        Image.fromarray(np.dstack([rgb, a.astype(np.uint8)])).save(root / "train" / f"r_{i:03d}.png")
    for v in range(3):
        (root / "views" / f"view_{v}").mkdir(parents=True)
        cams = {f"frame_{j:06d}": {"K": rng.normal(size=(3, 3)), "R": rng.normal(size=(3, 3)),
                                   "T": rng.normal(size=(3, 1))} for j in range(4)}
        with open(root / "views" / f"view_{v}" / "cameras.pkl", "wb") as f:
            pickle.dump(cams, f)
    verts = tmp_path / "verts"
    verts.mkdir()
    np.save(verts / "000000.npy", rng.normal(size=(20, 3)))
    np.savez(verts / "000001.npz", vertices=rng.normal(size=(20, 3)))
    return root, verts


def test_process_data_twin_matches(data_layout, monkeypatch, capsys):
    """Every subcommand of the twin on one copy of the layout, the
    reference's on another: the same files with the same data."""
    root, verts = data_layout
    ref = root.parent / "ref"
    shutil.copytree(root, ref)
    for cmd in (["thin"], ["semseg", "--parts", "3"], ["zju-cams", "--frames", "7"],
                ["smpl-prior", "--vertices", str(verts)]):
        torch_process_data.main([cmd[0], "--path", str(root)] + cmd[1:])
        _run_reference(monkeypatch, process_data, [cmd[0], "--path", str(ref)] + cmd[1:])
    names = [f"r_{i:03d}" for i in range(3)]
    _same_tree(ref, root, [f"train_thinned/{n}_thinned.png" for n in names]
               + [f"semantic_seg/{n}_seg.npy" for n in names]
               + ["train/cameras.pkl", "SMPL_prior/000000.npy", "SMPL_prior/000001.npy"])
    assert np.asarray(Image.open(root / "train_thinned" / "r_000_thinned.png")).max() == 255
    assert len(np.unique(np.load(root / "semantic_seg" / "r_001_seg.npy"))) == 4
    out = capsys.readouterr().out
    assert out.count("wrote 7 interleaved cameras from 3 views") == 2


def test_capture_tools_twin_matches(tmp_path, monkeypatch):
    """frames from an animated GIF (OpenCV in the twin, imageio in the
    reference: the same pixels), colmap2nerf on a binary and a text model,
    masks: the same files."""
    rng = np.random.default_rng(4)
    frames = [(rng.uniform(size=(24, 32, 3)) * 255).astype(np.uint8) for _ in range(5)]
    Image.fromarray(frames[0]).save(tmp_path / "clip.gif", save_all=True,
                                    append_images=[Image.fromarray(f) for f in frames[1:]])
    torch_capture_tools.main(["frames", "--video", str(tmp_path / "clip.gif"), "--out", str(tmp_path / "t"),
                              "--every", "2"])
    _run_reference(monkeypatch, capture_tools, ["frames", "--video", str(tmp_path / "clip.gif"), "--out",
                                                str(tmp_path / "r"), "--every", "2"])
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [f"frame_0000{i}.png" for i in range(3)]
    _same_tree(tmp_path / "r", tmp_path / "t", [f"frame_0000{i}.png" for i in range(3)])
    gif = Image.open(tmp_path / "clip.gif")
    gif.seek(2)  # the GIF's palette colours of the third frame, as PIL decodes them
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "frame_00001.png")),
                                  np.asarray(gif.convert("RGB")))
    for binary in (True, False):
        root = tmp_path / f"colmap_{binary}"
        _write_colmap(root, binary, np.random.default_rng(5))
        ref = tmp_path / f"colmap_{binary}_ref"
        shutil.copytree(root, ref)
        for module, path in ((torch_capture_tools, root), (capture_tools, ref)):
            argv = ["colmap2nerf", "--path", str(path)]
            module.main(argv) if module is torch_capture_tools else _run_reference(monkeypatch, module, argv)
        a = json.loads((ref / "transforms_train.json").read_text())
        b = json.loads((root / "transforms_train.json").read_text())
        assert a["camera_angle_x"] == b["camera_angle_x"] and len(b["frames"]) == 4
        for fa, fb in zip(a["frames"], b["frames"]):
            assert (fa["file_path"], fa["time"]) == (fb["file_path"], fb["time"])
            np.testing.assert_allclose(fb["transform_matrix"], fa["transform_matrix"], rtol=0, atol=1e-12)
        torch_capture_tools.main(["masks", "--path", str(root), "--threshold", "0.9"])
        _run_reference(monkeypatch, capture_tools, ["masks", "--path", str(ref), "--threshold", "0.9"])
        _same_tree(ref, root, [f"masks/{p.name}" for p in sorted((root / "images").glob("*.png"))])


def test_run_synthesis_twin_builds_the_reference_commands(tmp_path, monkeypatch, capsys):
    """The batch over two scenes of which one exists: the reference's four
    commands with the port's twins and --device, the missing scene skipped;
    the pipeline command parses in the pipeline twin."""
    (tmp_path / "data" / "trex").mkdir(parents=True)
    ran = {"ref": [], "port": []}
    argv = ["--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path / "out"), "--scenes", "trex", "hook"]
    extra = ["--extra", "--iterations", "20"]
    for name in ("port", "ref"):  # both scripts call the one subprocess module's run
        monkeypatch.setattr(run_synthesis.subprocess, "run", lambda cmd, check, name=name: ran[name].append(cmd))
        if name == "port":
            torch_run_synthesis.main(argv + ["--device", "cpu"] + extra)
        else:
            _run_reference(monkeypatch, run_synthesis, argv + extra)
    assert capsys.readouterr().out.count("skip hook") == 2
    assert len(ran["port"]) == len(ran["ref"]) == 4

    def without_device(cmd):
        i = cmd.index("--device")
        assert cmd[i + 1] == "cpu"
        return cmd[2:i] + cmd[i + 2:]

    for r, p in zip(ran["ref"], ran["port"]):
        assert Path(p[1]).name == "torch_" + Path(r[1]).name
        assert without_device(p) == r[2:]
    args = torch_run_pipeline.parse_args(ran["port"][0][2:])
    assert (args.node_num, args.iterations, args.device) == (512, 20, "cpu")
    assert args.use_isotropic_gs and args.gs_with_motion_mask and args.use_template_offsets
