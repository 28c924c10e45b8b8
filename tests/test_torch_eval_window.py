"""eval_image past the reference's 8192-row window (ROADMAP C6).

A held-out frame whose densest tile holds more instances than 8192: the
reference's eval_image stops escalating its window there, so its frame at
that window is truncated (with the rect cap below 1024 its loop does not
even return: it re-renders the same truncated frame forever). The port's
window grows to the observed max count, up to a ceiling sized from the
device's free memory, and its frame equals the dense oracle's. Where
nothing truncates, the port's escalation is unchanged.

Tolerances: image against the oracle and against the reference 3e-5 (the
slice's, tests/test_torch_slice.py).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import make_camera as jmake_camera
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import skeleton_warp as JSW
from riggs_tpu.train import stage2 as JS2
from riggs_tpu_torch import convert
from riggs_tpu_torch.models import skeleton_warp as TSW
from riggs_tpu_torch.render.api import render as t_render
from riggs_tpu_torch.train import stage2 as TS2

from tests.test_torch_slice import JOINTS, PARENTS
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

SIZE, T_EVAL = 64, 0.4


def _dense_scene(n, seed=0):
    """``n`` faint 0.004-scale splats in a 0.3 x 0.3 x 0.6 box that the
    64 x 64 camera sees inside its first tile, with motion masks ~0 (the
    skeleton leaves them in place); both packages' Gaussians, skeleton and
    camera."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.42, -0.12, n), rng.uniform(-0.42, -0.12, n), rng.uniform(-0.3, 0.3, n)], 1)
    gs = JG.create_from_pcd(pts.astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32),
                            -(-n // 128) * 128, max_sh_degree=1)
    p = dict(jax.tree.map(np.asarray, gs.params_dict()))
    p["scaling"] = np.full_like(p["scaling"], np.log(0.004))
    p["opacity"] = np.full_like(p["opacity"], -3.5)
    p["feature"] = np.full_like(p["feature"], -30.0)
    gs = gs.replace_params(jax.tree.map(jnp.asarray, p))
    skel = JSW.init_skeleton_warp(jax.random.PRNGKey(seed), JOINTS, PARENTS)
    jc = jmake_camera(np.eye(3), np.array([0, 0, 2.2]), SIZE, SIZE, fovx=0.9, fovy=0.9)
    tgs = convert.gaussians_from_numpy(jax.tree.map(np.asarray, gs.params_dict()), np.asarray(gs.alive),
                                       gs.max_sh_degree, gs.isotropic, gs.with_motion_mask, device="cpu")
    tsk = convert.skeleton_warp_from_numpy(jax.tree.map(np.asarray, skel.params_dict()), np.asarray(skel.joints),
                                           PARENTS, device="cpu")
    tc = convert.camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), 0.0, SIZE, SIZE, device="cpu")
    return gs, skel, jc, tgs, tsk, tc


def _oracle(tgs, tsk, tc):
    with torch.no_grad():
        d = TSW.skeleton_forward(tsk, tgs.xyz, T_EVAL, tgs.motion_mask)
        return t_render(tc, tgs, torch.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                        d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=tgs.max_sh_degree,
                        rasterizer="oracle")["render"]


def test_eval_image_passes_the_8192_window():
    gs, skel, jc, tgs, tsk, tc = _dense_scene(9000)
    _, of_t, _, max_count = TS2._eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3))
    assert int(max_count) == 9000 and int(of_t) > 0  # every splat in one tile
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no truncation warning
        img = TS2.eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3))
    # the window the escalation reached: the max count rounded up to 128
    at_count, of_t, _, _ = TS2._eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3), max_per_tile=9088)
    assert int(of_t) == 0 and torch.equal(img, at_count)
    orc = _oracle(tgs, tsk, tc)
    np.testing.assert_allclose(img.numpy(), orc.numpy(), rtol=0, atol=3e-5)
    # the reference at its limit drops the 808 back-most instances of the tile
    jimg, j_of_t, _, _ = JS2._eval_image(gs, skel, jc, jnp.float32(T_EVAL), jnp.zeros(3), max_per_tile=8192)
    assert int(j_of_t) == 9000 - 8192
    assert float(np.abs(np.asarray(jimg) - orc.numpy()).max()) > 1e-3
    # the ceiling sized from free memory lies past the observed count here
    assert TS2.window_ceiling(torch.device("cpu"), 4) >= 9088


def test_eval_image_under_the_limit_is_unchanged():
    """Under 8192 the escalation is the reference's (512 -> the max count,
    at least doubled): the frame is bitwise the port's render at that
    window, and within the slice's tolerance of the reference's
    eval_image."""
    gs, skel, jc, tgs, tsk, tc = _dense_scene(3000, seed=1)
    img = TS2.eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3))
    want, of_t, _, _ = TS2._eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3), max_per_tile=3072)
    assert int(of_t) == 0 and torch.equal(img, want)
    jimg = JS2.eval_image(gs, skel, jc, jnp.float32(T_EVAL), jnp.zeros(3))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0, atol=3e-5)


def test_window_ceiling_caps_the_escalation(monkeypatch):
    """Past the ceiling the port still returns the truncated frame, with a
    warning."""
    _, _, _, tgs, tsk, tc = _dense_scene(9000)
    monkeypatch.setattr(TS2, "window_ceiling", lambda device, n_tiles: 8704)
    with pytest.warns(UserWarning, match="capacity limits"):
        img = TS2.eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3))
    capped, of_t, _, _ = TS2._eval_image(tgs, tsk, tc, T_EVAL, torch.zeros(3), max_per_tile=8704)
    assert int(of_t) == 9000 - 8704 and torch.equal(img, capped)
