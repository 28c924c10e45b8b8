"""The port's serving entry points against riggs_tpu on the same weights:
render()'s colour and scale options, render_auto's escalation, and the
synthesis sweeps generate_random_motion and interpolate_time.

Tolerances: images and alpha 3e-5, depth 2e-4 (tests/test_pallas_blend.py's
bounds); poses and overflow counters exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.eval import synthesis as JS
from riggs_tpu.models import skeleton_warp as JSW
from riggs_tpu.render.api import render as j_render, render_auto as j_render_auto
from riggs_tpu_torch.eval import synthesis as TS
from riggs_tpu_torch.render.api import render as t_render, render_auto as t_render_auto
from tests.test_torch_slice import _cams, _close, _jax_avatar, _port


@pytest.fixture(scope="module")
def posed():
    """The slice's avatar with one skeleton_forward residual, handed to both
    renderers as the same numpy arrays."""
    gs, skel = _jax_avatar(seed=2)
    tgs, tsk = _port(gs, skel)
    jc, tc = _cams()
    d = JSW.skeleton_forward(skel, gs.xyz, jnp.asarray(0.3), gs.motion_mask)
    res = {k: np.asarray(d[k]) for k in ("d_xyz", "d_rotation")}
    return gs, skel, tgs, tsk, jc, tc, res


def _assert_render(a, b):
    _close(a["render"], b["render"], 3e-5, "image")
    _close(a["alpha"], b["alpha"], 3e-5, "alpha")
    _close(a["depth"], b["depth"], 2e-4, "depth")
    for k in ("overflow_tiles", "overflow_rect", "max_count"):
        assert int(a[k]) == int(b[k]), k


RENDER_OPTIONS = {
    "override_color": lambda n: dict(override_color=np.random.default_rng(9).uniform(size=(n, 3)).astype(np.float32)),
    "scale_const": lambda n: dict(scale_const=0.02),
    "scaling_modifier": lambda n: dict(scaling_modifier=0.7),
    "render_motion": lambda n: dict(render_motion=True),
    "d_rotation_bias": lambda n: dict(d_rotation_bias=np.array([0.9, 0.1, -0.2, 0.3], np.float32)),
}


@pytest.mark.parametrize("option", sorted(RENDER_OPTIONS))
def test_render_options_match(posed, option):
    gs, _, tgs, _, jc, tc, res = posed
    kw = RENDER_OPTIONS[option](gs.capacity)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    a = j_render(jc, gs, jnp.asarray(bg), d_xyz=jnp.asarray(res["d_xyz"]), d_rotation=jnp.asarray(res["d_rotation"]),
                 active_sh_degree=2, max_per_tile=512, blend="pallas",
                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    with torch.no_grad():
        b = t_render(tc, tgs, torch.as_tensor(bg), d_xyz=torch.tensor(res["d_xyz"]),
                     d_rotation=torch.tensor(res["d_rotation"]), active_sh_degree=2, max_per_tile=512,
                     **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    _assert_render(a, b)
    np.testing.assert_array_equal(b["radii"].numpy(), np.asarray(a["radii"]))
    assert float(b["alpha"].max()) > 0.5


def test_render_auto_escalates_like_the_reference(posed):
    """From a 128-slot window the escalation doubles max_per_tile until no
    tile is truncated; both packages end with the same untruncated render."""
    gs, _, tgs, _, jc, tc, res = posed
    kw = dict(active_sh_degree=3, max_per_tile=128)
    a = j_render_auto(jc, gs, jnp.zeros(3), d_xyz=jnp.asarray(res["d_xyz"]), blend="pallas", **kw)
    with torch.no_grad():
        b = t_render_auto(tc, tgs, torch.zeros(3), d_xyz=torch.tensor(res["d_xyz"]), **kw)
        first = t_render(tc, tgs, torch.zeros(3), d_xyz=torch.tensor(res["d_xyz"]), **kw)
    assert int(first["overflow_tiles"]) > 0
    _assert_render(a, b)
    assert int(b["overflow_tiles"]) == 0


def test_generate_random_motion_matches(posed):
    gs, skel, tgs, tsk, jc, tc, _ = posed
    kw = dict(seed=4, pose_num=2, change_ratio=0.5, min_joint=1, max_per_tile=512)
    ja, jp = JS.generate_random_motion(gs, skel, jc, **kw)
    ta, tp = TS.generate_random_motion(tgs, tsk, tc, **kw)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b["local_rotation"], a["local_rotation"])
        np.testing.assert_array_equal(b["global_trans"], a["global_trans"])
    assert any((p["local_rotation"] != np.array([1, 0, 0, 0], np.float32)).any() for p in tp)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b, a, atol=3e-5, rtol=0)


def test_interpolate_time_matches(posed):
    gs, skel, tgs, tsk, jc, tc, _ = posed
    ja = JS.interpolate_time(gs, skel, jc, n_frames=2, max_per_tile=512)
    ta = TS.interpolate_time(tgs, tsk, tc, n_frames=2, max_per_tile=512)
    assert len(ta) == len(ja) == 2
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b, np.asarray(a), atol=3e-5, rtol=0)
