"""The training modules of the port against riggs_tpu on the same numpy
inputs: losses (values and image gradients), Adam, the schedules, the
chamfer distance, node projection, densification statistics, skeleton
sampling, the configuration, and the render's gradients on both window
paths.

Tolerances: losses 1e-5 and their image gradients 1e-7 (per-pixel gradients
of means are ~1e-5); Adam 1e-6; schedules 1e-7 relative; chamfer, projection
and statistics 1e-5. Render gradients: atol 1e-4, rtol 1e-3
(tests/test_pallas_blend.py:44) on each argument's gradient divided by its
largest |reference| value (the loss is a sum over pixels, not a mean).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import make_camera as jmake_camera
from riggs_tpu.camera.camera import project_nodes_2d as j_project_nodes_2d
from riggs_tpu.models import gaussians as JG
from riggs_tpu.ops.knn import chamfer_distance as j_chamfer
from riggs_tpu.render.tiles import rasterize_tiled as j_rasterize
from riggs_tpu.train import losses as JL
from riggs_tpu.train import optim as JO
from riggs_tpu.train import schedule as JS
from riggs_tpu.train import stage2 as JS2
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.camera.camera import project_nodes_2d as t_project_nodes_2d
from riggs_tpu_torch.device import constant
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.ops.knn import chamfer_distance as t_chamfer
from riggs_tpu_torch.render import blend as B
from riggs_tpu_torch.render.api import render as t_render
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.render.tiles import rasterize_tiled as t_rasterize
from riggs_tpu_torch.train import losses as TL
from riggs_tpu_torch.train import optim as TO
from riggs_tpu_torch.train import schedule as TS
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config as TConfig

from tests.test_torch_slice import PARENTS


def _images(seed=0, h=40, w=48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.2, size=a.shape), 0, 1).astype(np.float32)
    a[:14, :16] = 0.0  # a flat block in both: the SSIM variance clamp meets its tie at 0
    b[:14, :16] = 0.0
    a[20:24, 30:34] = 4.0  # an HDR transient
    return a, b


@pytest.mark.parametrize("name", ["ssim", "photometric_loss", "psnr", "l1_loss", "l2_loss"])
def test_losses_and_image_gradients_match(name):
    a, b = _images()
    jfn, tfn = getattr(JL, name), getattr(TL, name)
    jv, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    tv = tfn(x, torch.as_tensor(b))
    (tg,) = torch.autograd.grad(tv, x)
    np.testing.assert_allclose(tv.item(), float(jv), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-4)
    assert float(np.abs(np.asarray(jg)).max()) > 0


def test_adam_update_matches_with_group_lrs_and_mask():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "grp": {"x": [(5,), (2, 2)], "y": (6,)}}
    mk = lambda s: jax.tree.map(lambda sh: rng.normal(size=sh).astype(np.float32), s,
                                is_leaf=lambda v: isinstance(v, tuple))
    p, g, mu = mk(shapes), mk(shapes), mk(shapes)
    nu = jax.tree.map(np.abs, mk(shapes))
    lrs = {"a": 0.01, "grp": {"x": 0.02, "y": 0.003}}
    mask = {"a": True, "grp": {"x": False, "y": True}}
    jp, js = JO.adam_update(jax.tree.map(jnp.asarray, g), JO.AdamState(mu=jax.tree.map(jnp.asarray, mu),
                            nu=jax.tree.map(jnp.asarray, nu), count=jnp.int32(5)),
                            jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.float32, lrs), update_mask=mask)
    tt = lambda tree: TO.tree_map(torch.as_tensor, tree)
    tp, ts = TO.adam_update(tt(g), TO.AdamState(mu=tt(mu), nu=tt(nu), count=torch.tensor(5, dtype=torch.int32)),
                            tt(p), lrs, update_mask=mask)
    for ref, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for r, t in zip(jax.tree.leaves(ref), TO.tree_leaves(got)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    assert int(ts.count) == int(js.count) == 6
    # the masked group kept its parameters and moments
    assert np.array_equal(tp["grp"]["x"][0].numpy(), p["grp"]["x"][0])
    assert np.array_equal(ts.mu["grp"]["x"][1].numpy(), mu["grp"]["x"][1])


def test_schedules_match():
    kw = dict(lr_delay_steps=500, lr_delay_mult=0.01, max_steps=30_000)
    for step in (0, 1, 250, 499, 500, 15_000, 29_999, 30_000, 45_000):
        np.testing.assert_allclose(TS.expon_lr(1.6e-4, 1.6e-6, **kw)(step), JS.expon_lr(1.6e-4, 1.6e-6, **kw)(step), rtol=1e-12)
        np.testing.assert_allclose(TS.linear_lr(1.0, 0.1, **kw)(step), JS.linear_lr(1.0, 0.1, **kw)(step), rtol=1e-12)
        jit = float(JS.expon_lr_jit(1e-4, 1e-5, lr_delay_mult=0.01, max_steps=60_000)(jnp.int32(step)))
        np.testing.assert_allclose(TS.expon_lr_f32(1e-4, 1e-5, lr_delay_mult=0.01, max_steps=60_000)(step), jit, rtol=1e-6)
    assert TS.landmark_interpolate((1e-1, 1e-1, 1e-3, 0), (0, 15_000, 25_000, 25_001), 20_000) == pytest.approx(
        JS.landmark_interpolate((1e-1, 1e-1, 1e-3, 0), (0, 15_000, 25_000, 25_001), 20_000))


@pytest.mark.parametrize("norm", [1, 2])
def test_chamfer_distance_masked_matches(norm):
    rng = np.random.default_rng(norm)
    x = rng.normal(size=(30, 2)).astype(np.float32) * 10
    y = rng.normal(size=(40, 2)).astype(np.float32) * 10
    y[5] = y[4]  # a duplicate neighbour: the min's gradient tie splits evenly in both
    xm, ym = np.arange(30) < 24, np.arange(40) < 33
    for masks in ((None, None), (None, ym), (xm, ym)):
        jm = [None if m is None else jnp.asarray(m) for m in masks]
        tm = [None if m is None else torch.as_tensor(m) for m in masks]
        jv, jg = jax.value_and_grad(lambda a, b: j_chamfer(a, b, *jm, norm=norm), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
        xt, yt = torch.tensor(x, requires_grad=True), torch.tensor(y, requires_grad=True)
        tv = t_chamfer(xt, yt, *tm, norm=norm)
        tg = torch.autograd.grad(tv, (xt, yt))
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


def test_project_nodes_sample_points_and_stats_match():
    rng = np.random.default_rng(3)
    jc = jmake_camera(np.eye(3), np.array([0, 0, 2.5]), 96, 80, fovx=0.9, fovy=0.8, fid=0.4)
    tc = convert.camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), 0.4, 96, 80, device="cpu")
    joints = rng.normal(scale=0.4, size=(len(PARENTS), 3)).astype(np.float32)
    jp = JS2.sample_skeleton_points(jnp.asarray(joints), PARENTS)
    tp = TS2.sample_skeleton_points(torch.as_tensor(joints), PARENTS)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(t_project_nodes_2d(tc, tp).numpy(), np.asarray(j_project_nodes_2d(jc, jp)), atol=1e-4, rtol=1e-6)

    cap = 64
    grad = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 9, cap).astype(np.float32)
    vis = radii > 0
    s0 = [rng.uniform(size=cap).astype(np.float32) for _ in range(3)]
    js = JG.add_densification_stats(JG.DensifyStats(*map(jnp.asarray, s0)), jnp.asarray(grad), jnp.asarray(radii),
                                    jnp.asarray(vis), 96, 80)
    ts = TG.add_densification_stats(TG.DensifyStats(*map(torch.as_tensor, s0)), torch.as_tensor(grad),
                                    torch.as_tensor(radii), torch.as_tensor(vis), 96, 80)
    for f in dataclasses.fields(js):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), atol=1e-6, rtol=1e-6)
    z = TG.init_densify_stats(cap, device="cpu")
    assert all(torch.equal(getattr(z, f.name), torch.zeros(cap)) for f in dataclasses.fields(z))


def test_median_averages_the_middle_pair():
    x = torch.tensor([5.0, 1.0, 9.0, 3.0])
    assert TS2._median(x).item() == float(jnp.median(jnp.asarray(x.numpy()))) == 4.0
    assert TS2._median(x[:3]).item() == 5.0


def test_constant_is_made_once_per_value_dtype_and_device():
    """device.constant: the operand the render and loss paths give
    torch.maximum, made once and shared instead of copied on every call."""
    x = torch.zeros(3)
    a = constant(1e-6, x)
    assert a is constant(1e-6, x)
    assert a.dim() == 0 and a.dtype == torch.float32 and float(a) == float(np.float32(1e-6))
    assert constant(1e-6, x.double()).dtype == torch.float64
    with torch.inference_mode():
        b = constant(0.25, x)
    assert not b.is_inference()
    v = torch.ones(3, requires_grad=True)
    torch.maximum(v, b).sum().backward()  # usable by autograd where it was made under inference_mode
    assert torch.equal(v.grad, torch.ones(3))
    assert torch.equal(constant((0.5, 2.0), x), torch.tensor([0.5, 2.0]))


def test_config_json_round_trips_between_packages():
    jc = JConfig()
    jc.opt.skeleton_warm_up = 7
    jc.pipe.mid_cap = 123
    tc = TConfig.from_json(jc.to_json())
    assert tc.opt.skeleton_warm_up == 7 and tc.pipe.mid_cap == 123
    back = JConfig.from_json(tc.to_json())
    diff = [f for f in ("model", "pipe", "opt") if dataclasses.asdict(getattr(back, f)) != dataclasses.asdict(getattr(jc, f))]
    assert diff == []
    assert dataclasses.asdict(TConfig().opt) == dataclasses.asdict(JConfig().opt)


# --- render gradients ------------------------------------------------------

W = H = 128
ARGS = ("means3d", "colors", "opacity", "scales", "rotations", "mean2d_bias")


def _scene(seed=0, n=300):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return dict(
        means3d=(rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        colors=rng.uniform(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(0.2, 0.95, size=n).astype(np.float32),
        scales=np.exp(rng.uniform(-3.5, -2.0, size=(n, 3))).astype(np.float32),
        rotations=(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
        mean2d_bias=np.zeros((n, 2), np.float32),
    )


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(H, W, 3)).astype(np.float32), rng.normal(size=(H, W)).astype(np.float32),
            rng.normal(size=(H, W)).astype(np.float32))


def _loss(out, w, mod):
    return mod.sum(out["image"] * w[0]) + mod.sum(out["alpha"] * w[1]) + 0.1 * mod.sum(out["depth"] * w[2])


@pytest.fixture(scope="module")
def render_case():
    jc = jmake_camera(np.eye(3), np.array([0, 0, 3.0]), W, H, fovx=1.0, fovy=1.0)
    tc = convert.camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), 0.0, W, H, device="cpu")
    sc = _scene()
    with torch.no_grad():
        counts = t_rasterize(tc, *(torch.as_tensor(sc[k]) for k in ARGS[:5]), torch.zeros(3),
                             max_per_tile=512)["tile_counts"].numpy()
    return jc, tc, sc, make_tile_ladder(counts, n_buckets=3)


@pytest.mark.parametrize("path", ["plain", "ladder"])
def test_render_gradients_match(render_case, path):
    jc, tc, sc, ladder = render_case
    kw = dict(max_per_tile=512, tile_ladder=ladder if path == "ladder" else None)
    w = _weights()

    def jloss(*args):
        m, c, o, s, r, b = args
        return _loss(j_rasterize(jc, m, c, o, s, r, jnp.zeros(3), mean2d_bias=b, **kw), w, jnp)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(sc[k]) for k in ARGS))
    targs = [torch.tensor(sc[k], requires_grad=True) for k in ARGS]
    out = t_rasterize(tc, *targs[:5], torch.zeros(3), mean2d_bias=targs[5], **kw)
    assert int(out["overflow"]) == 0
    tg = torch.autograd.grad(_loss(out, [torch.as_tensor(x) for x in w], torch), targs)
    for name, a, b in zip(ARGS, tg, jg):
        ref = np.asarray(b)
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy() / scale, ref / scale, atol=1e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("path", ["plain", "ladder"])
def test_render_gradient_runs_the_blend_backward(render_case, path):
    """The image's gradient reaches the Gaussians through the blend's
    autograd Function: on the CPU its backward runs the plain version once
    per blend call and launches no kernel."""
    _, tc, sc, ladder = render_case
    n = sc["means3d"].shape[0]
    gs = TG.Gaussians(
        xyz=torch.tensor(sc["means3d"], requires_grad=True), features_dc=torch.zeros((n, 1, 3)),
        features_rest=torch.zeros((n, 0, 3)), scaling=torch.log(torch.as_tensor(sc["scales"])),
        rotation=torch.as_tensor(sc["rotations"]), opacity=torch.zeros((n, 1)), feature=torch.zeros((n, 0)),
        alive=torch.ones(n, dtype=torch.bool), max_sh_degree=0, isotropic=False, with_motion_mask=False,
    )
    B.reset_launches()
    out = t_render(tc, gs, torch.zeros(3), max_per_tile=512, tile_ladder=ladder if path == "ladder" else None)
    (g,) = torch.autograd.grad(out["render"].sum(), gs.xyz)
    assert float(g.abs().max()) > 0
    name = "blend_permuted_gm_bwd" if path == "ladder" else "blend_cm_bwd"
    expected = sum(1 for _, cap in ladder if cap > 0) if path == "ladder" else 1
    assert B.plain_bwd_calls[name] == expected
    assert all(v == 0 for v in B.launches.values())
