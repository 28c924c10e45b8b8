"""Densification in riggs_tpu and in riggs_tpu_torch on the same numpy
inputs: the Gaussians' free-slot map, clone, split, prunes and opacity
reset, zero_rows, densify_step, and the node-set events of stage 1
(downsample_nodes, node_densify_prune, finalize_nodes).

The split noise is the reference's own draw from its key. The Gaussians'
statistics are seeded so that each selection holds rows well away from its
thresholds.

Tolerances: alive masks, destinations, node counts and selections exactly
equal; parameters and moments 1e-6 (the split's rotation of the noise and
the FPS trajectories are the only arithmetic; measured max |d| 2.4e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.data.dataset import SceneData as JScene
from riggs_tpu.models import gaussians as JG
from riggs_tpu.train import optim as JO
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train import static as JST
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.train import optim as TO
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train import static as TST
from riggs_tpu_torch.train.config import Config as TConfig

from tests.test_torch_stage1_step import _port_state
from tests.test_torch_stage2_step import _assert_tree, _moments, _np, _second_moments, _skel_ref_layout

TOL = dict(atol=1e-6, rtol=0)
C, N = 96, 60
THR, EXTENT = 2e-4, 2.0


def reference_split_noise(key, capacity, n_split=2):
    """densify_split's draws from its key (gaussians.py:252-254): (n_split, C, 3)."""
    out = []
    for _ in range(n_split):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (capacity, 3))))
    return torch.as_tensor(np.stack(out))


def _gaussians(seed, isotropic=False, n=N, cap=C):
    """A seeded reference cloud: scales on both sides of percent_dense *
    extent, random rotations and opacities; and the port's copy."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.4, size=(n, 3)).astype(np.float32)
    g = JG.create_from_pcd(pts, rng.uniform(size=(n, 3)), capacity=cap, max_sh_degree=1, isotropic=isotropic,
                           fea_dim=2, with_motion_mask=True)
    p = g.params_dict()
    s_dim = 1 if isotropic else 3
    scaling = np.log(rng.choice([0.005, 0.05], size=(cap, 1)) * rng.uniform(0.8, 1.2, size=(cap, s_dim)))
    p = dict(p, scaling=jnp.asarray(scaling, jnp.float32),
             rotation=jnp.asarray(rng.normal(size=(cap, 4)), jnp.float32),
             opacity=jnp.asarray(rng.normal(scale=3.0, size=(cap, 1)), jnp.float32),
             f_rest=jnp.asarray(rng.normal(size=p["f_rest"].shape), jnp.float32))
    g = g.replace_params(p)
    t = convert.gaussians_from_numpy(_np(g.params_dict()), np.asarray(g.alive), g.max_sh_degree, isotropic=isotropic,
                                     with_motion_mask=True, device="cpu")
    grad = np.where(rng.uniform(size=cap) < 0.5, 5 * THR, 0.2 * THR).astype(np.float32)
    return g, t, grad


def _assert_gs(jg, tg, what):
    np.testing.assert_array_equal(tg.alive.numpy(), np.asarray(jg.alive), err_msg=f"{what} alive")
    _assert_tree(jg.params_dict(), {k: v.numpy() for k, v in tg.params_dict().items()}, what, **TOL)


def test_free_slot_map_with_more_selected_than_free():
    rng = np.random.default_rng(1)
    alive = rng.uniform(size=40) < 0.8
    selected = alive & (rng.uniform(size=40) < 0.9)
    assert selected.sum() > (~alive).sum()  # not every selected row finds a slot
    jd, jok = JG._free_slot_map(jnp.asarray(alive), jnp.asarray(selected))
    td, tok = TG._free_slot_map(torch.as_tensor(alive), torch.as_tensor(selected))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert (td.numpy() == 40).sum() == selected.sum() - (~alive).sum() + (~selected).sum()


@pytest.mark.parametrize("isotropic", [False, True], ids=["anisotropic", "isotropic"])
def test_clone_and_split_match(isotropic):
    jg, tg, grad = _gaussians(2 + isotropic, isotropic)
    key = jax.random.PRNGKey(4)
    jc, jdc = JG.densify_clone(jg, jnp.asarray(grad), THR, EXTENT)
    tc, tdc = TG.densify_clone(tg, torch.as_tensor(grad), THR, EXTENT)
    np.testing.assert_array_equal(tdc.numpy(), np.asarray(jdc))
    _assert_gs(jc, tc, "clone")
    js, jds = JG.densify_split(jc, jnp.asarray(grad), THR, EXTENT, key)
    ts, tds = TG.densify_split(tc, torch.as_tensor(grad), THR, EXTENT, reference_split_noise(key, C))
    np.testing.assert_array_equal(tds.numpy(), np.asarray(jds))
    _assert_gs(js, ts, "split")
    # both selections were live, and the free slots ran out for the children
    assert (np.asarray(jdc) < C).any() and (np.asarray(jds) < C).any() and (np.asarray(jds) == C).any()
    assert int(ts.num_alive) != int(tc.num_alive)


@pytest.mark.parametrize("screen", [0.0, 6.0], ids=["opacity_only", "max_screen_size"])
def test_prune_by_opacity_matches(screen):
    jg, tg, _ = _gaussians(5)
    radii = np.random.default_rng(6).uniform(0, 10, size=C).astype(np.float32)
    j = JG.prune_by_opacity(jg, 0.3, jnp.asarray(radii), max_screen_size=screen, scene_extent=0.5)
    t = TG.prune_by_opacity(tg, 0.3, torch.as_tensor(radii), max_screen_size=screen, scene_extent=0.5)
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    assert 0 < int(t.num_alive) < N


def test_reset_opacity_and_sampling_and_prune_match():
    jg, tg, _ = _gaussians(7)
    np.testing.assert_allclose(TG.reset_opacity(tg).opacity.numpy(), np.asarray(JG.reset_opacity(jg).opacity), **TOL)
    np.testing.assert_array_equal(TG.sampling_and_prune(tg, 20).alive.numpy(),
                                  np.asarray(JG.sampling_and_prune(jg, 20).alive))


def test_zero_rows_drops_out_of_range_rows():
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(10, 3)).astype(np.float32), "b": rng.normal(size=(10,)).astype(np.float32)}
    js = JO.AdamState(mu=jax.tree.map(jnp.asarray, tree), nu=jax.tree.map(lambda a: jnp.asarray(a) ** 2, tree),
                      count=jnp.int32(3))
    ts = TO.AdamState(mu={k: torch.as_tensor(v) for k, v in tree.items()},
                      nu={k: torch.as_tensor(v) ** 2 for k, v in tree.items()}, count=torch.tensor(3, dtype=torch.int32))
    dest = np.array([2, 10, 7, 10, 13, 0])
    j = JO.zero_rows(js, jnp.asarray(dest))
    t = TO.zero_rows(ts, torch.as_tensor(dest))
    for name in ("mu", "nu"):
        _assert_tree(getattr(j, name), {k: v.numpy() for k, v in getattr(t, name).items()}, name, atol=0, rtol=0)
    assert int(t.count) == 3 and (t.mu["a"][[0, 2, 7]] == 0).all() and (t.mu["a"][1] != 0).all()


def test_densify_step_matches():
    jg, tg, grad = _gaussians(9)
    rng = np.random.default_rng(10)
    p = jg.params_dict()
    jopt = JO.AdamState(mu=_moments(rng, p, 1e-2), nu=_second_moments(rng, p), count=jnp.int32(7))
    denom = rng.integers(0, 4, size=C).astype(np.float32)
    stats = (grad * denom, denom, rng.uniform(0, 10, size=C).astype(np.float32))
    jstate = JST.TrainState(gs=jg, opt=jopt, stats=JG.DensifyStats(*map(jnp.asarray, stats)))
    key = jax.random.PRNGKey(11)
    jnew = JST.densify_step(jstate, key, THR, EXTENT, max_screen_size=6.0)
    tstate = TST.TrainState(gs=tg, opt=TO.AdamState(mu={k: torch.as_tensor(np.asarray(v)) for k, v in jopt.mu.items()},
                                                    nu={k: torch.as_tensor(np.asarray(v)) for k, v in jopt.nu.items()},
                                                    count=torch.tensor(7, dtype=torch.int32)),
                            stats=TG.DensifyStats(*map(torch.as_tensor, stats)))
    tnew = TST.densify_step(tstate, reference_split_noise(key, C), THR, EXTENT, max_screen_size=6.0)
    _assert_gs(jnew.gs, tnew.gs, "densify_step")
    for name in ("mu", "nu"):
        _assert_tree(getattr(jnew.opt, name), {k: v.numpy() for k, v in getattr(tnew.opt, name).items()}, name, **TOL)
    assert float(tnew.stats.denom.abs().sum()) == 0 and int(tnew.opt.count) == 7
    # opacity reset with fresh opacity moments
    jr, tr = JST.reset_opacity_step(jnew), TST.reset_opacity_step(tnew)
    np.testing.assert_allclose(tr.gs.opacity.numpy(), np.asarray(jr.gs.opacity), **TOL)
    assert float(tr.opt.mu["opacity"].abs().sum()) == 0 and float(tr.opt.nu["xyz"].abs().sum()) > 0


def _stage1(seed, node_num=16, cap=160, n=120):
    """A small reference Stage1State: the node Gaussians moved off the nodes
    with a third of them dead, the warp and its moments perturbed; and the
    port's copy."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.4, size=(n, 3)).astype(np.float32)
    jcfg, tcfg = JConfig(), TConfig()
    for c in (jcfg, tcfg):
        c.model.capacity, c.model.node_num, c.model.gs_with_motion_mask = cap, node_num, True
        c.opt.node_max_num_ratio_during_init = 4
    js = JS1.init_stage1(jax.random.PRNGKey(seed), JScene([], [], pts, rng.uniform(size=(n, 3)), 1.0), jcfg)
    ng = js.node_gs
    xyz = np.asarray(ng.xyz).copy()
    xyz += rng.normal(scale=0.2, size=xyz.shape)
    alive = rng.uniform(size=ng.capacity) < 0.6
    wp = js.warp.params_dict()
    wp = dict(wp, mlp=jax.tree.map(lambda a: a + jnp.asarray(rng.normal(scale=2e-2, size=a.shape), jnp.float32),
                                   wp["mlp"]))
    js = dataclasses.replace(js, node_gs=dataclasses.replace(ng, xyz=jnp.asarray(xyz, jnp.float32),
                                                             alive=jnp.asarray(alive)),
                             warp=js.warp.replace_params(wp))
    wp = js.warp.params_dict()
    js = dataclasses.replace(js, opt_warp=JO.AdamState(mu=_moments(rng, wp, 1e-2), nu=_second_moments(rng, wp),
                                                       count=jnp.int32(9)))
    return js, jcfg, tcfg


def _assert_warp(jw, tw, what):
    assert tw.node_num == jw.node_num, what
    _assert_tree(jw.params_dict(), _skel_ref_layout(tw.params_dict()), what, **TOL)


def test_downsample_and_finalize_nodes_match():
    js, jcfg, tcfg = _stage1(12)
    jd = JS1.downsample_nodes(js, jcfg)
    td = TS1.downsample_nodes(_port_state(js), tcfg)
    np.testing.assert_array_equal(td.node_gs.alive.numpy(), np.asarray(jd.node_gs.alive))
    assert int(td.node_gs.num_alive) == jcfg.model.node_num
    _assert_warp(jd.warp, td.warp, "downsampled warp")
    for name in ("opt_warp", "opt_node"):
        assert int(getattr(td, name).count) == 0
        assert all(float(v.abs().sum()) == 0 for v in jax.tree_util.tree_leaves(getattr(td, name).mu))
    jf, tf = JS1.finalize_nodes(jd), TS1.finalize_nodes(td)
    _assert_warp(jf.warp, tf.warp, "finalized warp")
    assert not np.allclose(np.asarray(jf.warp.nodes), np.asarray(jd.warp.nodes))


def _with_gs_stats(js, rng, hot):
    """The Gaussians' statistics: mean screen gradients ``hot`` times the
    threshold on a fifth of them, zero elsewhere."""
    C = js.gs.capacity
    g = np.where(rng.uniform(size=C) < 0.2, hot * THR, 0.0).astype(np.float32)
    denom = np.full(C, 2.0, np.float32)
    return dataclasses.replace(js, stats_gs=JG.DensifyStats(jnp.asarray(g * denom), jnp.asarray(denom),
                                                            jnp.zeros(C)))


@pytest.mark.parametrize("case", ["add", "remove", "noop"])
def test_node_densify_prune_matches(case):
    js, jcfg, tcfg = _stage1(13)
    rng = np.random.default_rng(14)
    js = _with_gs_stats(js, rng, hot=50.0 if case == "add" else 0.0)
    if case == "remove":  # a node no Gaussian reaches
        nodes = np.asarray(js.warp.nodes).copy()
        nodes[3, :3] = 50.0
        js = dataclasses.replace(js, warp=js.warp.replace_params(dict(js.warp.params_dict(), nodes=jnp.asarray(nodes))))
    jn = JS1.node_densify_prune(js, jcfg, THR)
    ts = _port_state(js)
    tn = TS1.node_densify_prune(ts, tcfg, THR)
    M = js.warp.node_num
    if case == "noop":
        assert jn is js and tn is ts
        return
    assert tn.warp.node_num == jn.warp.node_num != M
    assert (tn.warp.node_num > M) == (case == "add")
    _assert_warp(jn.warp, tn.warp, f"{case} warp")
    # the kept nodes' moments carried, the added ones' zero, the mlp's untouched
    for name in ("mu", "nu"):
        _assert_tree(getattr(jn.opt_warp, name), _skel_ref_layout(getattr(tn.opt_warp, name)), name, **TOL)
    assert tn.warp.mlp is ts.warp.mlp and int(tn.opt_warp.count) == 9
