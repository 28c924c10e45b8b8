"""The stage-1 phase-B training step in riggs_tpu and in riggs_tpu_torch, from
the same state (riggs_tpu's init_stage1, the warp's weights and the Adam
moments perturbed from a seed, carried across with riggs_tpu_torch.convert).

The frame's target is a render of the Gaussians under another deformation,
its alpha mask that render's alpha, its thinned skeleton points the nodes
projected, jittered and padded with a mask. The ARAP sample times are the
reference's own draws from its key.

Tolerances: loss and aux 1e-5; gradients atol 1e-4, rtol 1e-3 (the blend
backward's bound, tests/test_pallas_blend.py:44) on each leaf scaled by its
largest |reference| value, or by a hundredth of its tree's largest where
that is more (a leaf the loss cannot move, such as the d_xyz head's bias
under ARAP alone, holds only cancellation noise); parameters and Adam moments after a step 1e-5;
integer outputs exact. The moments start at count 5, so a step is no
first-step sign(g) update that would magnify the gradients' rounding.

The flow step's frame carries a smooth flow field to a partner at t = 0.55
and a seeded validity mask. Its loss masks the pixels whose flow render's
alpha exceeds 0.9, a hard threshold on a rendered value on which the
packages agree to ~1e-7: the case checks that no alpha of its flow render
lies within 1e-5 of 0.9, so that both packages mask the same pixels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import make_camera
from riggs_tpu.camera.camera import project_nodes_2d as j_project_nodes_2d
from riggs_tpu.data.dataset import Frame as JFrame, SceneData as JScene
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import node_warp as JNW
from riggs_tpu.render.api import render as j_render
from riggs_tpu.train import optim as JO
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef as TNetDef
from riggs_tpu_torch.render.api import render as t_render, render_flow as t_render_flow
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config as TConfig
from riggs_tpu_torch.train.optim import grad_tree

from tests.test_torch_stage1_modules import _reference_arap_t
from tests.test_torch_stage2_step import _assert_tree, _moments, _np, _second_moments, _skel_ref_layout

N, CAP, NODES, SIZE, N_THIN = 300, 320, 32, 96, 48
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
KEY = jax.random.PRNGKey(3)


def _cfgs():
    jcfg, tcfg = JConfig(), TConfig()
    for c in (jcfg, tcfg):
        c.model.capacity, c.model.node_num, c.model.gs_with_motion_mask = CAP, NODES, True
    return jcfg, tcfg


def _gs_args(gs):
    return dict(params=_np(gs.params_dict()), alive=np.asarray(gs.alive), max_sh_degree=gs.max_sh_degree,
                isotropic=gs.isotropic, with_motion_mask=gs.with_motion_mask, shared_scale=gs.shared_scale)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(N, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    cols = rng.uniform(size=(N, 3)).astype(np.float32)
    jcfg, _ = _cfgs()
    js = JS1.init_stage1(jax.random.PRNGKey(0), JScene([], [], pts, cols, 1.0), jcfg)
    gp = js.gs.params_dict()
    gp = dict(gp, f_rest=jnp.asarray(rng.normal(scale=0.05, size=gp["f_rest"].shape), jnp.float32),
              feature=gp["feature"] + jnp.asarray(rng.normal(scale=0.3, size=gp["feature"].shape), jnp.float32),
              opacity=gp["opacity"] + 2.0,
              # anisotropic: equal axes make the covariance blind to the rotation
              scaling=gp["scaling"] + jnp.asarray(rng.normal(scale=0.3, size=gp["scaling"].shape), jnp.float32),
              rotation=gp["rotation"] + jnp.asarray(rng.normal(scale=0.3, size=gp["rotation"].shape), jnp.float32))
    wp = js.warp.params_dict()
    # heads large enough that the warp moves the Gaussians visibly
    mlp = jax.tree.map(lambda a: a + jnp.asarray(rng.normal(scale=2e-2, size=a.shape), jnp.float32), wp["mlp"])
    wp = dict(wp, mlp=mlp, weight=jnp.asarray(rng.normal(size=wp["weight"].shape), jnp.float32))
    js = dataclasses.replace(js, gs=js.gs.replace_params(gp), warp=js.warp.replace_params(wp))
    gp, wp = js.gs.params_dict(), js.warp.params_dict()
    js = dataclasses.replace(
        js,
        opt_gs=JO.AdamState(mu=_moments(rng, gp, 1e-2), nu=_second_moments(rng, gp), count=jnp.int32(5)),
        opt_warp=JO.AdamState(mu=_moments(rng, wp, 1e-2), nu=_second_moments(rng, wp), count=jnp.int32(5)),
        stats_gs=JG.DensifyStats(*(jnp.asarray(rng.uniform(0, 1, CAP), jnp.float32) for _ in range(3))),
    )
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), SIZE, SIZE, fovx=0.9, fovy=0.9)
    # target: the Gaussians under the warp at t = 0.8, seen from the frame's camera
    d_t = JNW.warp_forward(js.warp, js.gs.xyz, jnp.float32(0.8), js.gs.feature, js.gs.motion_mask)
    tgt = j_render(cam, js.gs, jnp.zeros(3), d_xyz=d_t["d_xyz"], d_rotation=d_t["d_rotation"],
                   active_sh_degree=3, max_per_tile=512)
    thin = np.asarray(j_project_nodes_2d(cam, d_t["d_nodes"])) + rng.normal(scale=1.5, size=(NODES, 2))
    thinned = np.zeros((N_THIN, 2), np.float32)
    thinned[:NODES] = thin
    jf = JFrame(cam=dataclasses.replace(cam, fid=jnp.float32(0.3)), image=tgt["render"],
                alpha_mask=(tgt["alpha"] > 0.5).astype(jnp.float32), thinned=jnp.asarray(thinned),
                thinned_mask=jnp.asarray(np.arange(N_THIN) < NODES))
    assert float(tgt["alpha"].max()) > 0.5
    return dict(jstate=js, jframe=jf)


def _port_state(js, it=0):
    """A fresh port state (a step updates the warp's module in place)."""
    net = TNetDef(**{f: getattr(js.warp.net, f) for f in js.warp.net.__dataclass_fields__})
    adam = lambda o: (_np(o.mu), _np(o.nu), int(o.count))
    stats = lambda s: tuple(np.asarray(a) for a in (s.xyz_gradient_accum, s.denom, s.max_radii2d))
    return convert.stage1_state_from_numpy(
        _gs_args(js.gs), _gs_args(js.node_gs), _np(js.warp.params_dict()), net,
        adam(js.opt_gs), adam(js.opt_node), adam(js.opt_warp), stats(js.stats_gs), stats(js.stats_node),
        it=it, hyper_dim=js.warp.hyper_dim, K=js.warp.K, d_rot_as_res=js.warp.d_rot_as_res, device="cpu",
    )


def _port_frame(jf):
    c = jf.cam
    return convert.frame_from_numpy(np.asarray(c.w2c), np.asarray(c.intrinsics), float(c.fid), c.width, c.height,
                                    np.asarray(jf.image), alpha_mask=np.asarray(jf.alpha_mask),
                                    thinned=np.asarray(jf.thinned), thinned_mask=np.asarray(jf.thinned_mask),
                                    device="cpu")


def _assert_grads(ref, port, name):
    """Leaf by leaf, each scaled by its largest |reference| value or a
    hundredth of the tree's largest, whichever is more."""
    ref_l = jax.tree_util.tree_flatten_with_path(_np(ref))[0]
    port_l = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert len(ref_l) == len(port_l), (name, len(ref_l), len(port_l))
    tree_max = max(float(np.abs(a).max()) for _, a in ref_l)
    for path, a in ref_l:
        s = max(float(np.abs(a).max()), 1e-2 * tree_max, 1e-30)
        np.testing.assert_allclose(port_l[path] / s, a / s, err_msg=f"{name}{jax.tree_util.keystr(path)}", **GRAD_TOL)


FLAGS = {
    "warm": dict(warm=True, active_sh=0, use_chamfer=False, use_motion_loss=False),
    "chamfer_on": dict(warm=False, active_sh=1, use_chamfer=True, use_motion_loss=False),
    "motion_loss_on": dict(warm=False, active_sh=3, use_chamfer=True, use_motion_loss=True),
}


@pytest.mark.parametrize("setting", list(FLAGS))
def test_frame_loss_value_aux_and_grads_match(setup, setting):
    flags = FLAGS[setting]
    js, jf = setup["jstate"], setup["jframe"]
    lam = dict(lambda_arap=1e-4, lambda_motion=0.1)

    def jloss(params, m2b):
        return JS1.stage1_frame_loss(params, js, jf, jnp.zeros(3), m2b, KEY, jnp.float32(lam["lambda_arap"]),
                                     jnp.float32(lam["lambda_motion"]), max_per_tile=512, **flags)

    jparams = {"gs": js.gs.params_dict(), "warp": js.warp.params_dict()}
    (jl, (jout, jaux)), (jg, jg_m2b) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.zeros((CAP, 2)))

    ts, tf = _port_state(js), _port_frame(jf)
    gs_p = {k: v.detach().requires_grad_(True) for k, v in ts.gs.params_dict().items()}
    params = {"gs": gs_p, "warp": ts.warp.params_dict()}
    m2b = torch.zeros((CAP, 2), requires_grad=True)
    tl, (tout, taux) = TS1.stage1_frame_loss(params, ts, tf, torch.zeros(3), m2b, torch.as_tensor(_reference_arap_t(KEY)),
                                             max_per_tile=512, **lam, **flags)
    tg, tg_m2b = grad_tree(tl, (params, m2b))

    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tout["render"].detach().numpy(), np.asarray(jout["render"]), atol=3e-5, rtol=0)
    _assert_grads(jg["gs"], {k: v.numpy() for k, v in tg["gs"].items()}, "d gs")
    _assert_grads(jg["warp"], _skel_ref_layout(tg["warp"]), "d warp")
    np.testing.assert_allclose(tg_m2b.numpy(), np.asarray(jg_m2b), err_msg="d mean2d_bias", **GRAD_TOL)
    # warm-up: no gradient reaches the warp through the blend
    blend_leaves = [tg["warp"][k] for k in ("radius", "weight")] + [tg["gs"]["feature"]]
    assert all(bool(v.any()) != flags["warm"] for v in blend_leaves)
    assert bool(tg["warp"]["nodes"].any()) == (not flags["warm"])
    assert float(taux["arap"]) > 0


def _ladder(ts, tf):
    with torch.no_grad():
        counts = t_render(tf.cam, ts.gs, torch.zeros(3), max_per_tile=512)["tile_counts"].numpy()
    return make_tile_ladder(counts[None], n_buckets=2, margin=1.5)


def _assert_step(jnew, jm, tnew, tm):
    _assert_tree(jnew.gs.params_dict(), {k: v.numpy() for k, v in tnew.gs.params_dict().items()}, "gs", atol=1e-5, rtol=0)
    _assert_tree(jnew.warp.params_dict(), _skel_ref_layout(tnew.warp.params_dict()), "warp", atol=1e-5, rtol=0)
    for name in ("opt_gs", "opt_warp"):
        a, b = getattr(jnew, name), getattr(tnew, name)
        conv = (lambda t: {k: v.numpy() for k, v in t.items()}) if name == "opt_gs" else _skel_ref_layout
        _assert_tree(a.mu, conv(b.mu), f"{name}.mu", atol=1e-5, rtol=0)
        _assert_tree(a.nu, conv(b.nu), f"{name}.nu", atol=1e-5, rtol=0)
        assert int(a.count) == int(b.count) == 6, name
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tnew.stats_gs, k).numpy(), np.asarray(getattr(jnew.stats_gs, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    for k, v in jm.items():
        if k == "tile_counts":
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(v))
        elif k in ("overflow_tiles", "n_gs"):
            assert int(tm[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(tm[k]), float(v), atol=1e-5, rtol=1e-5, err_msg=k)
    assert int(tm["overflow_rect"]) == 0  # surfaced by the port, not by the reference


def test_phase_b_step_matches(setup):
    """One phase_b_step with chamfer and the motion loss on, laddered windows."""
    js, jf = setup["jstate"], setup["jframe"]
    ts, tf = _port_state(js), _port_frame(jf)
    tl = _ladder(ts, tf)
    lrs_gs = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05, "scaling": 1e-3,
              "rotation": 1e-3, "feature": 2.5e-3}
    lrs_warp = {"mlp": 8e-4, "nodes": 8e-4, "radius": 8e-4, "weight": 8e-4}
    kw = dict(lambda_chamfer=1e-3, warm=False, active_sh=3, use_chamfer=True, use_motion_loss=True,
              max_per_tile=512, tile_ladder=tl)
    jnew, jm = JS1.phase_b_step(js, jf, jnp.zeros(3), jax.tree.map(jnp.float32, lrs_gs),
                                jax.tree.map(jnp.float32, lrs_warp), KEY, jnp.float32(1e-4), jnp.float32(0.1), **kw)
    tnew, tm = TS1.phase_b_step(ts, tf, torch.zeros(3), lrs_gs, lrs_warp, torch.as_tensor(_reference_arap_t(KEY)),
                                1e-4, 0.1, **kw)
    _assert_step(jnew, jm, tnew, tm)


@pytest.mark.parametrize("it", [0, 5000], ids=["warm", "main"])
def test_phase_b_auto_step_matches(setup, it):
    """make_phase_b_auto's step at it = 0 (warm-up: d_xyz detached, SH 0)
    and at it = 5000 (past warm-up, SH 3, the ARAP and motion lambdas
    between their landmarks), chamfer and the motion loss on; then its
    step with the optical-flow loss on a flow frame, at it = 0 on plain
    windows, at it = 5000 with the main render on a ladder (the flow
    render on plain windows)."""
    js, jf = setup["jstate"], setup["jframe"]
    js = dataclasses.replace(js, it=jnp.int32(it))
    jcfg, tcfg = _cfgs()
    kw = dict(use_chamfer=True, use_motion_loss=True, max_per_tile=512)
    jnew, jm = JS1.make_phase_b_auto(jcfg)(js, jf, jnp.zeros(3), KEY, **kw)
    ts = _port_state(js, it=it)
    tnew, tm = TS1.make_phase_b_auto(tcfg)(ts, _port_frame(jf), torch.zeros(3), torch.as_tensor(_reference_arap_t(KEY)),
                                           it=it, **kw)
    _assert_step(jnew, jm, tnew, tm)
    assert int(tnew.it) == int(jnew.it) == it + 1
    flags = TS1.phase_b_flags(tcfg, it)
    assert flags["warm"] == (it < jcfg.opt.warm_up) and flags["lambda_motion"] > 0 and flags["lambda_arap"] > 0
    assert_flow_step(setup, it, ladder=it == 5000)


def flow_frames(jf, partner_fid=0.55, seed=11):
    """The reference frame and the port's with a flow to a partner at
    ``partner_fid``: a smooth field of a few pixels and a seeded validity
    mask (about 70% valid)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE].astype(np.float32) / SIZE
    flow = np.stack([3.0 * np.sin(3.0 * xx + 1.0) * np.cos(2.0 * yy), -2.0 * np.cos(4.0 * yy) + xx], -1)
    valid = (rng.uniform(size=(SIZE, SIZE)) < 0.7).astype(np.float32)
    jff = dataclasses.replace(jf, flow=jnp.asarray(flow, jnp.float32), flow_mask=jnp.asarray(valid),
                              flow_partner_fid=jnp.float32(partner_fid))
    tff = dataclasses.replace(_port_frame(jf), flow=torch.tensor(flow, dtype=torch.float32),
                              flow_mask=torch.tensor(valid), flow_partner_fid=torch.tensor(partner_fid))
    return jff, tff


def assert_flow_step(setup, it, ladder=False):
    """make_phase_b_auto with the optical-flow loss at ``it`` on the flow
    frame, chamfer and the motion loss on, plain windows or (``ladder``)
    the main render on a fitted ladder; the flow term nonzero, its render
    not truncated, no flow-render alpha within 1e-5 of the 0.9 threshold."""
    js, jf = setup["jstate"], setup["jframe"]
    js = dataclasses.replace(js, it=jnp.int32(it))
    jcfg, tcfg = _cfgs()
    jff, tff = flow_frames(jf)
    ts = _port_state(js, it=it)
    kw = dict(use_chamfer=True, use_motion_loss=True, max_per_tile=512)
    if ladder:
        kw["tile_ladder"] = _ladder(ts, tff)
    with torch.no_grad():
        d = TNW.warp_forward(ts.warp, ts.gs.xyz, tff.fid, ts.gs.feature, ts.gs.motion_mask,
                             local_frame=ts.warp.net.local_frame)
        alpha = t_render_flow(tff.cam, tff.cam, ts.gs, d["d_xyz"], d["d_xyz"], d["d_rotation"],
                              max_per_tile=512)["alpha"]
    assert float((alpha - 0.9).abs().min()) > 1e-5 and bool((alpha > 0.9).any())
    jnew, jm = JS1.make_phase_b_auto(jcfg)(js, jff, jnp.zeros(3), KEY, use_flow_loss=True, **kw)
    tnew, tm = TS1.make_phase_b_auto(tcfg)(ts, tff, torch.zeros(3), torch.as_tensor(_reference_arap_t(KEY)), it=it,
                                           use_flow_loss=True, **kw)
    _assert_step(jnew, jm, tnew, tm)
    assert float(jm["flow"]) > 0 and "flow" in tm
    assert int(tm["flow_overflow_tiles"]) == int(tm["flow_overflow_rect"]) == 0
