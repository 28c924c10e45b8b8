"""The stage-2 training step in riggs_tpu and in riggs_tpu_torch, from the
same state (built by riggs_tpu's inits, moments filled from a seed, carried
across with riggs_tpu_torch.convert).

The frame's image is a render of the avatar at another time; its thinned
skeleton points are that pose's bone samples, projected, jittered and padded
with a mask; proj_loss holds four frames.

Tolerances: loss and aux 1e-5; gradients atol 1e-4, rtol 1e-3 (the blend
backward's bound, tests/test_pallas_blend.py:44); parameters and Adam
moments after a step 1e-5; integer outputs exact. The moments start at
count 5, so a step is no first-step sign(g) update that would magnify the
gradients' rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera.camera import project_nodes_2d as j_project_nodes_2d
from riggs_tpu.data.dataset import Frame as JFrame
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import skeleton_warp as JSW
from riggs_tpu.render.api import render as j_render
from riggs_tpu.train import optim as JO
from riggs_tpu.train import stage2 as JS2
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.render.ladder import make_tile_ladder
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config as TConfig
from riggs_tpu_torch.train.optim import grad_tree, tree_leaves

from tests.test_torch_slice import CAP, PARENTS, _cams, _jax_avatar

N_FRAMES, UID, N_THIN = 4, 2, 48
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moments(rng, tree, scale):
    return jax.tree.map(lambda a: jnp.asarray(rng.normal(scale=scale, size=a.shape), jnp.float32), tree)


def _second_moments(rng, tree):
    return jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape) * 1e-2, jnp.float32), tree)


@pytest.fixture(scope="module")
def setup():
    """Reference state and frame, and the port's, from one seed."""
    rng = np.random.default_rng(7)
    gs, skel = _jax_avatar(seed=3)
    jc, _ = _cams()
    # target: the avatar at t = 0.7, seen from the frame's camera
    d_t = JSW.skeleton_forward(skel, gs.xyz, jnp.asarray(0.7), gs.motion_mask)
    target = j_render(jc, gs, jnp.zeros(3), d_xyz=d_t["d_xyz"], d_rotation=d_t["d_rotation"],
                      active_sh_degree=3, max_per_tile=512)["render"]
    pts = JS2.sample_skeleton_points(d_t["d_nodes"], PARENTS)
    thin = np.asarray(j_project_nodes_2d(jc, pts))
    thin = thin + rng.normal(scale=1.5, size=thin.shape)
    thinned = np.zeros((N_THIN, 2), np.float32)
    thinned[: thin.shape[0]] = thin
    mask = np.arange(N_THIN) < thin.shape[0]
    jframe = JFrame(cam=dataclasses.replace(jc, fid=jnp.float32(0.3)), image=target,
                    thinned=jnp.asarray(thinned), thinned_mask=jnp.asarray(mask))
    pre_d_xyz = rng.normal(scale=0.02, size=(N_FRAMES, CAP, 3)).astype(np.float32)
    pre_d_joints = rng.normal(scale=0.02, size=(N_FRAMES, len(PARENTS), 3)).astype(np.float32)
    gp, sp = gs.params_dict(), skel.params_dict()
    opt_gs = JO.AdamState(mu=_moments(rng, gp, 1e-2), nu=_second_moments(rng, gp), count=jnp.int32(5))
    opt_skel = JO.AdamState(mu=_moments(rng, sp, 1e-2), nu=_second_moments(rng, sp), count=jnp.int32(5))
    stats = JG.DensifyStats(*(jnp.asarray(rng.uniform(0, 1, CAP), jnp.float32) for _ in range(3)))
    proj_loss = jnp.asarray([1.0e5, 12.0, 30.0, 7.5], jnp.float32)
    jstate = JS2.Stage2State(gs=gs, skel=skel, opt_gs=opt_gs, opt_skel=opt_skel, stats_gs=stats,
                             proj_loss=proj_loss, it=jnp.int32(0))
    return dict(jstate=jstate, jframe=jframe, pre_d_xyz=pre_d_xyz, pre_d_joints=pre_d_joints)


def _port_state(js, it=0):
    """A fresh port state from the reference state (the skeleton's module is
    updated in place by a step, so each test builds its own)."""
    gs, skel = js.gs, js.skel
    return convert.stage2_state_from_numpy(
        _np(gs.params_dict()), np.asarray(gs.alive), gs.max_sh_degree,
        _np(skel.params_dict()), np.asarray(skel.joints), PARENTS,
        (_np(js.opt_gs.mu), _np(js.opt_gs.nu), int(js.opt_gs.count)),
        (_np(js.opt_skel.mu), _np(js.opt_skel.nu), int(js.opt_skel.count)),
        tuple(np.asarray(a) for a in (js.stats_gs.xyz_gradient_accum, js.stats_gs.denom, js.stats_gs.max_radii2d)),
        np.asarray(js.proj_loss), it=it, isotropic=gs.isotropic, with_motion_mask=gs.with_motion_mask,
        device="cpu",
    )


def _port_frame(jf):
    c = jf.cam
    return convert.frame_from_numpy(np.asarray(c.w2c), np.asarray(c.intrinsics), float(c.fid), c.width,
                                    c.height, np.asarray(jf.image), thinned=np.asarray(jf.thinned),
                                    thinned_mask=np.asarray(jf.thinned_mask), device="cpu")


def _skel_ref_layout(tree):
    """The port's skeleton tree in the reference's layout (w transposed)."""
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"}:
            return {"w": tree["w"].detach().numpy().T, "b": tree["b"].detach().numpy()}
        return {k: _skel_ref_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skel_ref_layout(v) for v in tree]
    return tree.detach().numpy()


def _assert_tree(ref, port, name, **tol):
    """Leaf by leaf, over the reference's keys."""
    ref_l = jax.tree_util.tree_flatten_with_path(_np(ref))[0]
    port_l = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert len(ref_l) == len(port_l), (name, len(ref_l), len(port_l))
    for path, a in ref_l:
        np.testing.assert_allclose(port_l[path], a, err_msg=f"{name}{jax.tree_util.keystr(path)}", **tol)


FLAGS = {
    "warm": dict(warm=True, active_sh=0, enable_to=False, enable_sm=False),
    "main_mlps_off": dict(warm=False, active_sh=1, enable_to=False, enable_sm=False),
    "all_on": dict(warm=False, active_sh=3, enable_to=True, enable_sm=True),
}


@pytest.mark.parametrize("setting", list(FLAGS))
def test_frame_loss_value_aux_and_grads_match(setup, setting):
    flags = FLAGS[setting]
    js, jf = setup["jstate"], setup["jframe"]
    lam = dict(lambda_template_offsets=1e3, lambda_template_fixed=100.0)

    def jloss(params, m2b):
        return JS2.stage2_frame_loss(
            params, js, jf, jnp.int32(UID), jnp.zeros(3), m2b,
            jnp.asarray(setup["pre_d_xyz"][UID]), jnp.asarray(setup["pre_d_joints"][UID]),
            jnp.float32(lam["lambda_template_offsets"]), jnp.float32(lam["lambda_template_fixed"]),
            max_per_tile=512, **flags,
        )

    jparams = {"gs": js.gs.params_dict(), "skel": js.skel.params_dict()}
    (jl, (jout, jaux, _)), (jg, jg_m2b) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.zeros((CAP, 2))
    )

    ts = _port_state(js)
    tf = _port_frame(jf)
    gs_p = {k: v.detach().requires_grad_(True) for k, v in ts.gs.params_dict().items()}
    params = {"gs": gs_p, "skel": ts.skel.params_dict()}
    m2b = torch.zeros((CAP, 2), requires_grad=True)
    tl, (tout, taux, _) = TS2.stage2_frame_loss(
        params, ts, tf, UID, torch.zeros(3), m2b,
        torch.as_tensor(setup["pre_d_xyz"][UID]), torch.as_tensor(setup["pre_d_joints"][UID]),
        max_per_tile=512, **lam, **flags,
    )
    tg, tg_m2b = grad_tree(tl, (params, m2b))

    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(tout["render"].detach().numpy(), np.asarray(jout["render"]), atol=3e-5, rtol=0)
    _assert_tree(jg["gs"], {k: v.numpy() for k, v in tg["gs"].items()}, "d gs", **GRAD_TOL)
    _assert_tree(jg["skel"], _skel_ref_layout(tg["skel"]), "d skel", **GRAD_TOL)
    np.testing.assert_allclose(tg_m2b.numpy(), np.asarray(jg_m2b), err_msg="d mean2d_bias", **GRAD_TOL)
    # the photometric term reaches the Gaussians outside warmup only
    img_grad = float(np.abs(np.asarray(jg["gs"]["f_dc"])).max())
    assert (img_grad == 0.0) == flags["warm"]
    assert float(np.abs(np.asarray(jg_m2b)).max()) > 0 or flags["warm"]


def _ladder(setup):
    ts = _port_state(setup["jstate"])
    tf = _port_frame(setup["jframe"])
    from riggs_tpu_torch.models import skeleton_warp as TSW
    from riggs_tpu_torch.render.api import render as t_render

    counts = []
    with torch.no_grad():
        for t in (0.0, 0.3, 0.6, 0.9):
            d = TSW.skeleton_forward(ts.skel, ts.gs.xyz, t, ts.gs.motion_mask)
            counts.append(t_render(tf.cam, ts.gs, torch.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                                   active_sh_degree=3, max_per_tile=512, max_tiles_per_gaussian=4,
                                   mid_cap=8192, mid_side=4)["tile_counts"].numpy())
    return make_tile_ladder(np.stack(counts), n_buckets=3)


def _assert_step(jnew, jm, tnew, tm, warm):
    _assert_tree(jnew.gs.params_dict(), {k: v.numpy() for k, v in tnew.gs.params_dict().items()}, "gs", atol=1e-5, rtol=0)
    _assert_tree(jnew.skel.params_dict(), _skel_ref_layout(tnew.skel.params_dict()), "skel", atol=1e-5, rtol=0)
    for name, a, b in (("opt_gs", jnew.opt_gs, tnew.opt_gs), ("opt_skel", jnew.opt_skel, tnew.opt_skel)):
        conv = (lambda t: {k: v.numpy() for k, v in t.items()}) if name == "opt_gs" else _skel_ref_layout
        _assert_tree(a.mu, conv(b.mu), f"{name}.mu", atol=1e-5, rtol=0)
        _assert_tree(a.nu, conv(b.nu), f"{name}.nu", atol=1e-5, rtol=0)
        assert int(a.count) == int(b.count), name
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tnew.stats_gs, k).numpy(), np.asarray(getattr(jnew.stats_gs, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tnew.proj_loss.numpy(), np.asarray(jnew.proj_loss), atol=1e-5, rtol=0)
    assert int(tnew.it) == int(jnew.it)
    for k, v in jm.items():
        if k == "tile_counts":
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(v))
        elif k in ("overflow_tiles", "overflow_rect", "n_gs"):
            assert int(tm[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(tm[k]), float(v), atol=1e-5, rtol=1e-6, err_msg=k)
    assert int(jnew.opt_gs.count) == 5 + (0 if warm else 1)


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "ladder"])
def test_stage2_step_matches(setup, ladder):
    """One stage2_step outside warmup, everything on."""
    js, jf = setup["jstate"], setup["jframe"]
    tl = _ladder(setup) if ladder else None
    lrs_gs = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05, "scaling": 1e-3,
              "rotation": 1e-3, "feature": 2.5e-3}
    kw = dict(lambda_chamfer=1e-3, warm=False, active_sh=3, enable_to=True, enable_sm=True,
              max_per_tile=512, tile_ladder=tl)
    jnew, jm = JS2.stage2_step(
        js, jf, jnp.int32(UID), jnp.zeros(3), jax.tree.map(jnp.float32, lrs_gs), jnp.float32(1e-4),
        jnp.asarray(setup["pre_d_xyz"][UID]), jnp.asarray(setup["pre_d_joints"][UID]),
        jnp.float32(1.0), jnp.float32(0.0), **kw,
    )
    ts = _port_state(js)
    tnew, tm = TS2.stage2_step(
        ts, _port_frame(jf), UID, torch.zeros(3), lrs_gs, 1e-4,
        torch.as_tensor(setup["pre_d_xyz"][UID]), torch.as_tensor(setup["pre_d_joints"][UID]), 1.0, 0.0, **kw,
    )
    _assert_step(jnew, jm, tnew, tm, warm=False)


@pytest.mark.parametrize("it,ladder", [(0, False), (15001, True)], ids=["warm_plain", "main_ladder"])
def test_stage2_auto_step_matches(setup, it, ladder):
    """make_stage2_auto's step: at it = 0 (warmup: the Gaussians and their
    moments stay) and at it = 15001 (template offsets, skinning MLP, chamfer
    and SH 3 on), the uid being the template frame."""
    js, jf = setup["jstate"], setup["jframe"]
    js = dataclasses.replace(js, it=jnp.int32(it))
    jcfg, tcfg = JConfig(), TConfig()
    for c in (jcfg, tcfg):
        c.model.use_template_offsets = c.model.use_skinning_weight_mlp = True
    tl = _ladder(setup) if ladder else None
    jstep = JS2.make_stage2_auto(jcfg, template_idx=UID)
    tstep = TS2.make_stage2_auto(tcfg, template_idx=UID)
    pdx, pdj = setup["pre_d_xyz"], setup["pre_d_joints"]
    jnew, jm = jstep(js, jf, jnp.int32(UID), jnp.zeros(3), jnp.asarray(pdx), jnp.asarray(pdj),
                     max_per_tile=512, tile_ladder=tl)
    ts = _port_state(js, it=it)
    tnew, tm = tstep(ts, _port_frame(jf), UID, torch.zeros(3), torch.as_tensor(pdx), torch.as_tensor(pdj),
                     it=it, max_per_tile=512, tile_ladder=tl)
    _assert_step(jnew, jm, tnew, tm, warm=it == 0)
    if it == 0:
        for k, v in ts.gs.params_dict().items():
            assert torch.equal(tnew.gs.params_dict()[k], v), k
        # the step returns its own buffers: the moments are kept by value
        for a, b in zip(tree_leaves((tnew.opt_gs.mu, tnew.opt_gs.nu, tnew.opt_gs.count)),
                        tree_leaves((ts.opt_gs.mu, ts.opt_gs.nu, ts.opt_gs.count))):
            assert torch.equal(a, b)


@pytest.mark.parametrize(
    "it,uid,mlps",
    [(0, UID, True), (3000, 0, True), (15000, UID, True), (15001, UID, True), (20000, 0, False)],
    ids=["warm_template", "main_other_frame", "offsets_unlock", "skinning_unlock", "mlps_absent"],
)
def test_stage2_flags_follow_the_reference_derivation(it, uid, mlps):
    """stage2_flags, which make_stage2_auto and chip_smoke.py share, against
    the reference step's own derivation (riggs_tpu/train/stage2.py:411-437)
    from the reference's configuration: the warmup boundary, the unlocks
    gated by the model's optional MLPs, the SH degree, the template-frame
    lambdas and the tiers."""
    jcfg, tcfg = JConfig(), TConfig()
    for c in (jcfg, tcfg):
        c.model.use_template_offsets = c.model.use_skinning_weight_mlp = mlps
    o, m, pipe = jcfg.opt, jcfg.model, jcfg.pipe
    is_t = uid == UID
    want = dict(
        lambda_template_offsets=o.lambda_template_offsets * (1e3 if is_t else 1.0),
        lambda_template_fixed=o.lambda_template_fixed if is_t else 0.0,
        lambda_chamfer=o.lambda_deformed_node_prjection,
        lambda_rendering=o.lambda_rendering_image,
        warm=it < o.skeleton_warm_up,
        active_sh=min(it // o.oneupSHdegree_step, m.sh_degree),
        enable_to=mlps and it >= o.optimize_template_offsets_iters,
        enable_sm=mlps and it > o.optimize_template_offsets_iters,
        tiers=(pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side),
    )
    assert TS2.stage2_flags(tcfg, it, uid, UID) == want
