"""The serving slice end to end: skeleton_forward -> render in riggs_tpu and
in riggs_tpu_torch, from the same weights (built by riggs_tpu's own init
functions and carried across with riggs_tpu_torch.convert).

Tolerances: deformation outputs 1e-5 absolute; image and alpha 3e-5, depth
2e-4 (tests/test_pallas_blend.py's bounds); overflow counters exact.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import make_camera as jmake_camera
from riggs_tpu.eval import synthesis as JS
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import skeleton_warp as JSW
from riggs_tpu.render.api import render as j_render, tier_kwargs
from riggs_tpu_torch import convert
from riggs_tpu_torch.eval import synthesis as TS
from riggs_tpu_torch.models import skeleton_warp as TSW
from riggs_tpu_torch.render.api import render as t_render
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.train import stage2 as TS2

REPO = Path(__file__).resolve().parent.parent

JOINTS = np.array(
    [[0, 0, 0], [0, 0.35, 0], [0, 0.7, 0.05], [0.3, 0.55, 0], [0.55, 0.45, 0.1]], np.float32
)
PARENTS = (0, 0, 1, 1, 3)
N, CAP, W, H = 300, 320, 128, 128


def _jax_avatar(K=-1, seed=0):
    """Gaussians around the bones and a SkeletonWarp, by riggs_tpu's inits,
    with SH, rotations, opacities and motion masks randomized."""
    rng = np.random.default_rng(seed)
    b = rng.integers(1, len(PARENTS), N)
    u = rng.uniform(size=(N, 1))
    a_, c_ = JOINTS[np.array(PARENTS)[b]], JOINTS[b]
    pts = (a_ + u * (c_ - a_) + rng.normal(scale=0.06, size=(N, 3))).astype(np.float32)
    center = pts.mean(0)
    pts -= center
    gs = JG.create_from_pcd(pts, rng.uniform(size=(N, 3)).astype(np.float32), CAP, max_sh_degree=3)
    p = jax.tree.map(np.asarray, gs.params_dict())
    p = dict(p)
    p["f_rest"] = np.where(np.asarray(gs.alive)[:, None, None], rng.normal(scale=0.1, size=p["f_rest"].shape), 0).astype(np.float32)
    p["rotation"] = rng.normal(size=p["rotation"].shape).astype(np.float32)
    p["opacity"] = rng.normal(0.5, 1.0, size=p["opacity"].shape).astype(np.float32)
    p["scaling"] = (p["scaling"] + rng.uniform(-0.3, 0.5, size=p["scaling"].shape)).astype(np.float32)
    p["feature"] = rng.normal(size=p["feature"].shape).astype(np.float32)
    gs = gs.replace_params(jax.tree.map(jnp.asarray, p))
    skel = JSW.init_skeleton_warp(jax.random.PRNGKey(seed), JOINTS - center, PARENTS, K=K)
    return gs, skel


def _port(gs, skel, K=-1):
    tgs = convert.gaussians_from_numpy(
        jax.tree.map(np.asarray, gs.params_dict()), np.asarray(gs.alive), gs.max_sh_degree,
        gs.isotropic, gs.with_motion_mask, device="cpu",
    )
    tsk = convert.skeleton_warp_from_numpy(
        jax.tree.map(np.asarray, skel.params_dict()), np.asarray(skel.joints), PARENTS, K=K, device="cpu"
    )
    return tgs, tsk


def _cams():
    jc = jmake_camera(np.eye(3), np.array([0, 0, 2.2]), W, H, fovx=0.9, fovy=0.9)
    tc = convert.camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), 0.0, W, H, device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def avatar():
    gs, skel = _jax_avatar()
    tgs, tsk = _port(gs, skel)
    jc, tc = _cams()
    return gs, skel, tgs, tsk, jc, tc


def _close(a, b, atol, name=""):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("K", [-1, 2])
def test_skeleton_forward_matches(K):
    gs, skel = _jax_avatar(K=K, seed=1)
    tgs, tsk = _port(gs, skel, K)
    for t in (0.0, 0.63):
        a = JSW.skeleton_forward(skel, gs.xyz, jnp.asarray(t), gs.motion_mask)
        with torch.no_grad():
            b = TSW.skeleton_forward(tsk, tgs.xyz, t, tgs.motion_mask)
        for k in ("d_xyz", "d_rotation", "d_nodes", "nn_weight", "local_rotation", "global_trans", "template_offsets"):
            _close(a[k], b[k], 1e-5, k)
        np.testing.assert_array_equal(b["nn_idx"].numpy(), np.asarray(a["nn_idx"]))
        assert float(np.abs(np.asarray(a["d_xyz"])).max()) > 1e-3  # the pose moves the cloud
        _close(JSW.node_deformation(skel, a["local_rotation"], a["global_trans"]),
               TSW.node_deformation(tsk, b["local_rotation"], b["global_trans"]), 1e-5, "node_deformation")


def _j_frame(gs, skel, jc, t=None, pose=None, **kw):
    """riggs_tpu's skeleton_forward (or deform_by_pose) then render, as
    render_rigged and _eval_image chain them; ``kw`` goes to render (no kw:
    deformation only)."""
    if pose is None:
        d = JSW.skeleton_forward(skel, gs.xyz, jnp.asarray(t), gs.motion_mask)
    else:
        d = JSW.deform_by_pose(skel, gs.xyz, jnp.asarray(pose["local_rotation"]), jnp.asarray(pose["global_trans"]), gs.motion_mask)
    if not kw:
        return d, None
    out = j_render(jc, gs, jnp.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                   d_scaling=jnp.zeros_like(d["d_scaling"]), active_sh_degree=3, **kw)
    return d, out


def _t_frame(tgs, tsk, tc, t=None, pose=None, **kw):
    """The port's skeleton_forward (or deform_by_pose) then render."""
    with torch.no_grad():
        if pose is None:
            d = TSW.skeleton_forward(tsk, tgs.xyz, t, tgs.motion_mask)
        else:
            d = TSW.deform_by_pose(tsk, tgs.xyz, torch.as_tensor(pose["local_rotation"]),
                                   torch.as_tensor(pose["global_trans"]), tgs.motion_mask)
        out = t_render(tc, tgs, torch.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                       d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=3, **kw)
    return dict(out, d=d)


def _assert_frame(d, out, res):
    _close(d["d_xyz"], res["d"]["d_xyz"], 1e-5, "d_xyz")
    _close(d["d_rotation"], res["d"]["d_rotation"], 1e-5, "d_rotation")
    _close(out["render"], res["render"], 3e-5, "image")
    _close(out["alpha"], res["alpha"], 3e-5, "alpha")
    _close(out["depth"], res["depth"], 2e-4, "depth")
    for k in ("overflow_tiles", "overflow_rect"):
        assert int(res[k]) == int(out[k]), k


def test_slice_plain_windows_matches(avatar):
    gs, skel, tgs, tsk, jc, tc = avatar
    pose = TS.random_motion_poses(len(PARENTS), seed=3, pose_num=4)[2]
    for t, p in ((0.25, None), (0.8, None), (None, pose)):
        d, out = _j_frame(gs, skel, jc, t, p, max_per_tile=512, blend="pallas")
        tp = None if p is None else {k: torch.as_tensor(v) for k, v in p.items()}
        res = TS.render_rigged(tgs, tsk, tc, t=t, pose=tp, max_per_tile=512)
        _assert_frame(d, out, res)
        assert int(res["overflow_tiles"]) == 0 and float(res["alpha"].max()) > 0.5


def test_slice_ladder_matches(avatar):
    """A ladder fitted to probe frames renders each frame as the reference's
    laddered render does, and as the port's plain windows do."""
    gs, skel, tgs, tsk, jc, tc = avatar
    pose = TS.random_motion_poses(len(PARENTS), seed=3, pose_num=4)[1]
    frames = ((0.5, None), (0.9, None), (None, pose))
    counts = np.stack([_t_frame(tgs, tsk, tc, t, p, max_per_tile=512)["tile_counts"].numpy() for t, p in frames])
    ladder = make_tile_ladder(counts, n_buckets=3)
    assert len(ladder) >= 2  # tiles in more than one window size
    for t, p in frames:
        d, out = _j_frame(gs, skel, jc, t, p, max_per_tile=512, blend="pallas", tile_ladder=ladder)
        res = _t_frame(tgs, tsk, tc, t, p, max_per_tile=512, tile_ladder=ladder)
        _assert_frame(d, out, res)
        assert int(res["overflow_tiles"]) == 0
        plain = _t_frame(tgs, tsk, tc, t, p, max_per_tile=512)
        _close(plain["render"], res["render"], 2e-5, "ladder vs plain image")
        _close(plain["alpha"], res["alpha"], 2e-5, "ladder vs plain alpha")
        _close(plain["depth"], res["depth"], 2e-4, "ladder vs plain depth")
    img = TS2.eval_image(tgs, tsk, tc, 0.5, torch.zeros(3), max_per_tile=512, tile_ladder=ladder)
    assert torch.equal(img, _t_frame(tgs, tsk, tc, 0.5, max_per_tile=512, tile_ladder=ladder)["render"])


def test_eval_image_drops_tiers_on_persistent_rect_overflow(avatar):
    """With tiers set, the reference's eval_image never leaves its loop on a
    persistent overflow_rect (the tiers override the escalated rect cap). The
    port drops the tiers and ends with an untruncated image."""
    gs, skel, tgs, tsk, jc, tc = avatar
    tiers = (1, 1, 2)  # pass-1 window 1x1, one mid slot: most splats truncated
    # the reference's _eval_image renders with tier_kwargs(tiers) whatever rect
    # cap its loop escalated to, so this overflow never changes there
    d, _ = _j_frame(gs, skel, jc, 0.4)
    out = j_render(jc, gs, jnp.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                   active_sh_degree=3, max_per_tile=512, blend="jnp", **tier_kwargs(tiers))
    assert int(out["overflow_rect"]) > 0
    _, _, of_r, _ = TS2._eval_image(tgs, tsk, tc, 0.4, torch.zeros(3), max_per_tile=512, tiers=tiers)
    assert int(of_r) == int(out["overflow_rect"])
    img = TS2.eval_image(tgs, tsk, tc, 0.4, torch.zeros(3), max_per_tile=512, tiers=tiers)
    ref = TS2.eval_image(tgs, tsk, tc, 0.4, torch.zeros(3), max_per_tile=512)
    assert torch.equal(img, ref)


def test_eval_image_escalates_max_per_tile(avatar):
    gs, skel, tgs, tsk, jc, tc = avatar
    img, of_t, _, max_count = TS2._eval_image(tgs, tsk, tc, 0.1, torch.zeros(3), max_per_tile=128)
    assert int(of_t) > 0
    full = TS2.eval_image(tgs, tsk, tc, 0.1, torch.zeros(3), max_per_tile=128)
    ref, of_t, _, _ = TS2._eval_image(tgs, tsk, tc, 0.1, torch.zeros(3), max_per_tile=-(-int(max_count) // 128) * 128)
    assert int(of_t) == 0 and torch.equal(full, ref)


def test_random_motion_quats_match():
    a = JS.continuous_random_quats(np.random.default_rng(5), 7)
    b = TS.continuous_random_quats(np.random.default_rng(5), 7)
    np.testing.assert_array_equal(a, b)
    poses = TS.random_motion_poses(24, seed=0, pose_num=5)
    assert len(poses) == 5 and poses[0]["local_rotation"].shape == (24, 4)
    changed = np.any(poses[0]["local_rotation"] != np.array([1, 0, 0, 0], np.float32), axis=1)
    assert changed.sum() == int(0.3 * 24) and not changed[:5].any()


def test_deferred_render_arguments_raise(avatar):
    """Tile sharding composes with the plain-window blend only: with a
    ladder or the runs binner it raises, and on a 1 x 1 mesh (one gloo
    rank in this process) it renders today's frame bit for bit; the
    compact binner (A9) renders the sort binner's frame. with_skinning_vis is ported: a second render in the
    skinning colours beside an unchanged main render. detach_xyz and
    mean2d_bias are ported: detach_xyz stops the image's gradient to gs.xyz
    (at SH degree 0 the colours do not see the view direction), and a zero
    mean2d_bias leaves the image as it is and receives the screen-space
    gradient."""
    _, _, tgs, tsk, _, tc = avatar
    from tests.test_torch_tileshard import one_rank_mesh

    for kw in (dict(binning="runs"), dict(tile_ladder=((16, 512),))):
        with pytest.raises(ValueError, match="plain-window"):
            t_render(tc, tgs, torch.zeros(3), tile_shard_mesh=object(), **kw)
    with one_rank_mesh() as mesh:
        assert torch.equal(t_render(tc, tgs, torch.zeros(3), tile_shard_mesh=mesh)["render"],
                           t_render(tc, tgs, torch.zeros(3))["render"])
    np.testing.assert_allclose(t_render(tc, tgs, torch.zeros(3), binning="compact")["render"].numpy(),
                               t_render(tc, tgs, torch.zeros(3))["render"].numpy(), rtol=0, atol=2e-5)
    vis = TS.render_rigged(tgs, tsk, tc, t=0.0, with_skinning_vis=True)
    assert torch.equal(vis["render"], TS.render_rigged(tgs, tsk, tc, t=0.0)["render"])
    assert vis["skinning_render"].shape == vis["render"].shape and not torch.equal(vis["skinning_render"], vis["render"])
    xyz = tgs.xyz.detach().requires_grad_(True)
    gs = dataclasses.replace(tgs, xyz=xyz, opacity=tgs.opacity.detach().requires_grad_(True))
    img = t_render(tc, gs, torch.zeros(3), detach_xyz=True)["render"]
    g, g_op = torch.autograd.grad(img.sum(), (xyz, gs.opacity), allow_unused=True)
    assert (g is None or not bool(g.any())) and bool(g_op.any())
    (g,) = torch.autograd.grad(t_render(tc, gs, torch.zeros(3))["render"].sum(), xyz)
    assert bool(g.any())  # without detach_xyz the image does reach xyz
    bias = torch.zeros(CAP, 2, requires_grad=True)
    out = t_render(tc, gs, torch.zeros(3), mean2d_bias=bias)
    with torch.no_grad():
        assert torch.equal(out["render"], t_render(tc, gs, torch.zeros(3))["render"])
    (gb,) = torch.autograd.grad(out["render"].sum(), bias)
    assert float(gb.abs().max()) > 0


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA, an entry point called without device= raises; it does
    not fall back to the CPU."""
    from riggs_tpu_torch.camera import make_camera

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_camera(np.eye(3), np.zeros(3), 32, 32, fovx=1.0, fovy=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSW.init_skeleton_warp(JOINTS, PARENTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.camera_from_numpy(np.eye(4), np.ones(4), 0.0, 32, 32)
    assert make_camera(np.eye(3), np.zeros(3), 32, 32, fovx=1.0, fovy=1.0, device="cpu").w2c.device.type == "cpu"


CLI_TWINS = ("torch_run_pipeline", "torch_render_rig", "torch_metrics", "torch_render_stage1", "torch_run_zju",
             "torch_resume_stage2", "torch_run_refpoint", "torch_scaling_bench", "torch_multihost_smoke",
             "torch_viewer", "torch_test_speed", "torch_run_synthesis", "torch_process_data", "torch_capture_tools",
             "torch_bench")
# the one source that may name cv2: the capture twin decodes video with
# OpenCV inside its frames command, as the card has no imageio
CV2_SOURCES = ("torch_capture_tools.py",)


def test_port_imports_no_jax():
    """In a fresh interpreter, importing the whole port and its CLI twins
    leaves jax, riggs_tpu and cv2 out of sys.modules; no source file of
    the port, of scripts/torch_*.py or of chip_smoke.py imports them (but
    the capture twin's frames command, cv2 alone)."""
    code = (
        "import importlib, pkgutil, sys, riggs_tpu_torch\n"
        "for m in pkgutil.walk_packages(riggs_tpu_torch.__path__, 'riggs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import contextlib, io\n"
        f"for name in {CLI_TWINS!r}:\n"  # main's imports run before its flags are read
        "    with contextlib.redirect_stdout(io.StringIO()), contextlib.suppress(SystemExit):\n"
        "        importlib.import_module('scripts.' + name).main(['--help'])\n"
        "assert 'riggs_tpu_torch.io.checkpoint' in sys.modules and 'PIL.Image' in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'riggs_tpu', 'cv2')]\n"
        "assert not bad, bad\n"
        "assert 'riggs_tpu_torch.render.tiles' in sys.modules\n"
        "for m in ('models.hash_encoding', 'models.simple_deform', 'ops.se3', 'train.mlp_deform', 'train.static',\n"
        "          'parallel.train', 'parallel.stage1_dp', 'parallel.multihost', 'skeleton.interpolation',\n"
        "          'edit.arap_deform', 'edit.keypoints', 'edit.pose_edit', 'edit.session', 'camera.orbit',\n"
        "          'viz.overlay', 'viz.sibr', 'viz.web_viewer'):\n"
        "    assert 'riggs_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))  # the twins and the port's other scripts
    assert {f"{name}.py" for name in CLI_TWINS} <= {f.name for f in scripts}
    for f in list((REPO / "riggs_tpu_torch").rglob("*.py")) + scripts + [REPO / "chip_smoke.py"]:
        src = f.read_text()
        for bad in ("import jax", "from jax", "from riggs_tpu.", "import riggs_tpu\n", "from riggs_tpu import",
                    "import cv2", "from cv2"):
            if "cv2" in bad and f.name in CV2_SOURCES:
                continue
            assert bad not in src, (f, bad)
