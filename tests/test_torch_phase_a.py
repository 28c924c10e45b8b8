"""Stage-1 phase A in riggs_tpu and in riggs_tpu_torch, from the same state:
the trajectory regularizers elastic_loss and acc_loss, phase_a_step under
the four toggle patterns the loop visits, and make_phase_a_auto at
iterations on both sides of the node warm-up and of node sampling.

The state is riggs_tpu's init_stage1 with the node Gaussians moved off the
nodes, coloured and made opaque enough to show, the warp's weights and both
Adam states perturbed from a seed, carried across with riggs_tpu_torch.convert.
The regularizers' sample times are the reference's own draws from its key.

Tolerances (measured max |d| in parentheses): losses 1e-5 relative (7.5e-8
elastic, 6e-8 acc, 0 the step's loss); gradients atol 1e-4, rtol 1e-3 on
each leaf scaled by its largest |reference| value or a hundredth of its
tree's, as tests/test_torch_stage1_step.py (scaled 4.6e-5 elastic, 9.7e-5
acc: acc_loss divides a second difference of the node trajectories at
cancellation level by its own detached norm); parameters and Adam moments
after a step 1e-5 (2.4e-7), statistics 1e-5 + 1e-4 relative (1.2e-7), PSNR
1e-5 relative (1.9e-6 dB); integer outputs exact.
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
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config as TConfig
from riggs_tpu_torch.train.optim import grad_tree

from tests.test_torch_stage1_modules import NETS, _reference_arap_t, _warps
from tests.test_torch_stage1_step import _assert_grads, _port_frame, _port_state
from tests.test_torch_stage2_step import _assert_tree, _moments, _second_moments, _skel_ref_layout

N, CAP, NODES, SIZE, N_THIN = 200, 256, 64, 64, 96
TI = 1.0 / 8  # the frame interval of an 8-frame scene
KEY = jax.random.PRNGKey(5)
STEP_TOL = dict(atol=1e-5, rtol=0)


def _reference_acc_t(key, t, delta_t):
    """The centre time riggs_tpu's acc_loss draws from ``key`` (node_warp.py:412)."""
    return np.asarray(jnp.squeeze(t) + delta_t * (jax.random.uniform(key, ()) - 0.5))


def reference_reg_t(key, fid, ti):
    """phase_a_step's three regularizer draws from its step key
    (stage1.py:353, 383-385): elastic (8,), acc () and ARAP (2,) times."""
    kr1, kr2, kr3 = jax.random.split(key, 3)
    return {"elastic": torch.as_tensor(_reference_arap_t(kr1, t=fid, delta_t=ti, t_samp_num=8)),
            "acc": torch.as_tensor(_reference_acc_t(kr2, fid, 3 * ti)),
            "arap": torch.as_tensor(_reference_arap_t(kr3))}


def _cfgs():
    jcfg, tcfg = JConfig(), TConfig()
    for c in (jcfg, tcfg):
        c.model.capacity, c.model.node_num, c.model.gs_with_motion_mask = CAP, NODES, True
    return jcfg, tcfg


def _warp_grads(tw, loss):
    """The port's gradient of ``loss`` in every warp leaf, in the reference's layout."""
    p = tw.params_dict()
    return _skel_ref_layout(grad_tree(loss, p))


@pytest.mark.parametrize("hyper_dim", [2, 8])
def test_elastic_loss_matches_given_the_reference_draws(hyper_dim):
    jw, tw, _ = _warps(NETS["blender"], node_num=32, hyper_dim=hyper_dim)
    key, fid = jax.random.PRNGKey(9), jnp.float32(0.4)
    jl, jg = jax.value_and_grad(lambda p: JNW.elastic_loss(jw.replace_params(p), key, t=fid, delta_t=TI))(
        jw.params_dict())
    # elastic_loss splits its key into t0's and the samples' as arap_loss does
    t_samp = torch.as_tensor(_reference_arap_t(key, t=fid, delta_t=TI, t_samp_num=8))
    tl = TNW.elastic_loss(tw, t_samp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(jl) > 0
    _assert_grads(jg, _warp_grads(tw, tl), "d elastic")


def test_acc_loss_matches_given_the_reference_draws():
    jw, tw, _ = _warps(NETS["blender"], node_num=32, hyper_dim=8)
    key, fid = jax.random.PRNGKey(10), jnp.float32(0.7)
    jl, jg = jax.value_and_grad(lambda p: JNW.acc_loss(jw.replace_params(p), key, t=fid, delta_t=3 * TI))(
        jw.params_dict())
    tl = TNW.acc_loss(tw, torch.as_tensor(_reference_acc_t(key, fid, 3 * TI)), delta_t=3 * TI)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert float(jl) > 0
    _assert_grads(jg, _warp_grads(tw, tl), "d acc")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    pts = (rng.normal(size=(N, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    cols = rng.uniform(size=(N, 3)).astype(np.float32)
    jcfg, _ = _cfgs()
    js = JS1.init_stage1(jax.random.PRNGKey(0), JScene([], [], pts, cols, 1.0), jcfg)
    ng = js.node_gs
    n_alive = int(ng.num_alive)
    npar = ng.params_dict()
    xyz = np.asarray(npar["xyz"]).copy()
    xyz[:n_alive] += rng.normal(scale=0.03, size=(n_alive, 3))
    npar = dict(npar, xyz=jnp.asarray(xyz, jnp.float32),
                f_dc=jnp.asarray(rng.normal(scale=0.5, size=npar["f_dc"].shape), jnp.float32),
                opacity=npar["opacity"] + 2.5, scaling=jnp.full_like(npar["scaling"], np.log(0.05)))
    wp = js.warp.params_dict()
    mlp = jax.tree.map(lambda a: a + jnp.asarray(rng.normal(scale=2e-2, size=a.shape), jnp.float32), wp["mlp"])
    wp = dict(wp, mlp=mlp, weight=jnp.asarray(rng.normal(size=wp["weight"].shape), jnp.float32),
              nodes=wp["nodes"] + jnp.asarray(rng.normal(scale=0.01, size=wp["nodes"].shape), jnp.float32))
    js = dataclasses.replace(js, node_gs=ng.replace_params(npar), warp=js.warp.replace_params(wp))
    npar, wp = js.node_gs.params_dict(), js.warp.params_dict()
    node_cap = js.node_gs.capacity
    js = dataclasses.replace(
        js,
        opt_node=JO.AdamState(mu=_moments(rng, npar, 1e-2), nu=_second_moments(rng, npar), count=jnp.int32(5)),
        opt_warp=JO.AdamState(mu=_moments(rng, wp, 1e-2), nu=_second_moments(rng, wp), count=jnp.int32(5)),
        stats_node=JG.DensifyStats(*(jnp.asarray(rng.uniform(0, 1, node_cap), jnp.float32) for _ in range(3))),
    )
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), SIZE, SIZE, fovx=0.9, fovy=0.9)
    tgt = j_render(cam, js.gs, jnp.zeros(3), active_sh_degree=0, max_per_tile=512)
    thin = np.asarray(j_project_nodes_2d(cam, js.warp.nodes[:, :3])) + rng.normal(scale=1.5, size=(NODES, 2))
    thinned = np.zeros((N_THIN, 2), np.float32)
    thinned[:NODES] = thin
    jf = JFrame(cam=dataclasses.replace(cam, fid=jnp.float32(0.3)), image=tgt["render"],
                alpha_mask=(tgt["alpha"] > 0.5).astype(jnp.float32), thinned=jnp.asarray(thinned), thinned_mask=jnp.asarray(np.arange(N_THIN) < NODES))
    node_out = j_render(cam, js.node_gs, jnp.zeros(3), max_per_tile=512)
    assert float(node_out["alpha"].max()) > 0.3  # the nodes show
    return dict(jstate=js, jframe=jf)


def _assert_phase_a(jnew, jm, tnew, tm):
    _assert_tree(jnew.node_gs.params_dict(), {k: v.numpy() for k, v in tnew.node_gs.params_dict().items()},
                 "node_gs", **STEP_TOL)
    _assert_tree(jnew.warp.params_dict(), _skel_ref_layout(tnew.warp.params_dict()), "warp", **STEP_TOL)
    for name in ("opt_node", "opt_warp"):
        a, b = getattr(jnew, name), getattr(tnew, name)
        conv = (lambda t: {k: v.numpy() for k, v in t.items()}) if name == "opt_node" else _skel_ref_layout
        _assert_tree(a.mu, conv(b.mu), f"{name}.mu", **STEP_TOL)
        _assert_tree(a.nu, conv(b.nu), f"{name}.nu", **STEP_TOL)
        assert int(a.count) == int(b.count) == 6, name
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tnew.stats_node, k).numpy(), np.asarray(getattr(jnew.stats_node, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm["psnr"].item(), float(jm["psnr"]), rtol=1e-5)
    assert int(tm["n_node_gs"]) == int(jm["n_node_gs"])
    # surfaced by the port, not by the reference
    assert int(tm["overflow_tiles"]) == 0 and int(tm["overflow_rect"]) == 0
    np.testing.assert_array_equal(tnew.node_gs.alive.numpy(), np.asarray(jnew.node_gs.alive))


TOGGLES = {  # (detach_dxyz, use_chamfer, use_reg) as the loop visits them
    "warm_up": (True, False, False),
    "reg": (False, False, True),
    "chamfer_reg": (False, True, True),
    "no_arap": (False, True, False),
}
LRS_NODE = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05, "scaling": 1e-3, "rotation": 1e-3,
            "feature": 2.5e-3}
LRS_WARP = {"mlp": 8e-4, "nodes": 8e-4, "radius": 8e-4, "weight": 8e-4}


@pytest.mark.parametrize("toggles", list(TOGGLES))
def test_phase_a_step_matches(setup, toggles):
    detach, chamfer, reg = TOGGLES[toggles]
    js, jf = setup["jstate"], setup["jframe"]
    kw = dict(lambda_chamfer=1e-3, detach_dxyz=detach, use_chamfer=chamfer, use_reg=reg, max_per_tile=512)
    jnew, jm = JS1.phase_a_step(js, jf, jnp.zeros(3), jax.tree.map(jnp.float32, LRS_NODE),
                                jax.tree.map(jnp.float32, LRS_WARP), KEY, TI, **kw)
    ts = _port_state(js)
    tnew, tm = TS1.phase_a_step(ts, _port_frame(jf), torch.zeros(3), LRS_NODE, LRS_WARP,
                                reference_reg_t(KEY, jf.fid, TI), TI, **kw)
    _assert_phase_a(jnew, jm, tnew, tm)


@pytest.mark.parametrize("it", [0, 2001, 7501])
def test_phase_a_auto_step_matches(setup, it):
    """make_phase_a_auto at it = 0 (node warm-up: d_xyz detached, no
    regularizers), 2001 (the regularizers on) and 7501 (the chamfer too,
    past node sampling), with the tiers and learning rates of the
    configuration; the port's iteration comes from the caller."""
    js, jf = setup["jstate"], setup["jframe"]
    js = dataclasses.replace(js, it=jnp.int32(it))
    jcfg, tcfg = _cfgs()
    jnew, jm = JS1.make_phase_a_auto(jcfg, TI)(js, jf, jnp.zeros(3), KEY, max_per_tile=512)
    ts = _port_state(js, it=it)
    tnew, tm = TS1.make_phase_a_auto(tcfg, TI)(ts, _port_frame(jf), torch.zeros(3), reference_reg_t(KEY, jf.fid, TI),
                                               it=it, max_per_tile=512)
    _assert_phase_a(jnew, jm, tnew, tm)
    assert int(tnew.it) == int(jnew.it) == it + 1
    flags = TS1.phase_a_flags(tcfg, it)
    o = jcfg.opt
    assert (flags["detach_dxyz"], flags["use_chamfer"], flags["use_reg"]) == (
        it < o.node_warm_up, it > o.iterations_node_sampling, it > o.node_warm_up)
    assert flags["tiers"] == (jcfg.pipe.max_tiles_per_gaussian, jcfg.pipe.mid_cap, jcfg.pipe.mid_side)
    jg, jw = JS1.stage1_lr_fns_jit(jcfg)
    tg, tw = TS1.stage1_lr_fns_f32(tcfg)
    for ref, port in ((jg(jnp.int32(it)), tg(it)), (jw(jnp.int32(it)), tw(it))):
        assert set(ref) == set(port)
        for k in ref:
            assert np.float32(port[k]) == np.asarray(ref[k]), k
