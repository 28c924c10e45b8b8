"""From a stage-1 state to the stage-2 state in riggs_tpu and in
riggs_tpu_torch: precompute_deformations (the stage-1 deformation of every
train frame, the nodes' semantic labels through project_nodes_2d, the
template frame, skeleton extraction) and init_stage2 (the FPS subset of the
Gaussians, the template bake, the joints' radii, fresh optimizer state).

One untrained stage-1 state of the reference (init_stage1 on
make_scene_data(n_train=6, 64 x 64), its DeformNetwork's weights perturbed
so that the nodes move) goes to the port through convert.py; the frames
carry a planted semantic_seg (the alpha mask cut into three column bands).
The extraction runs with 16 candidates of the 24 nodes, so its FPS runs too.

Tolerances: d_xyz and d_joints 1e-5; template_idx, parents,
joint_node_indices, the alive mask and the skeleton's tree exactly equal;
the baked means and the joints' node_radius_log 1e-6. The joints are
positions of the deformed nodes of the template frame, which the two
packages compute to f32 rounding apart, so they are held exactly equal to
the reference's extraction run on the port's own node trajectories, and
within 1e-6 of the reference's. Extraction is discontinuous in its inputs,
so the test prints the smallest margin of its decisions (the distance
thresholds of simplification, Prim's choices, the template's candidates)
beside the measured max |d d_nodes|.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.data import synthetic as JSyn
from riggs_tpu.models import node_warp as JNW
from riggs_tpu.skeleton import extract as JX
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train import stage2 as JS2
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.data.dataset import SceneData as TScene
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.train import stage2 as TS2
from riggs_tpu_torch.train.config import Config as TConfig

from tests.test_torch_stage1_step import _port_state
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

SEED = 3


def planted_seg(alpha):
    """Part labels: 0 off the mask, 1-3 by column band on it."""
    a = np.asarray(alpha) > 0.5
    band = np.arange(a.shape[1])[None, :] * 3 // a.shape[1]
    return (a * (1 + band)).astype(np.int32)


def base_cfg(cls):
    cfg = cls()
    m, o = cfg.model, cfg.opt
    m.capacity, m.node_num, m.sh_degree, m.hyper_dim = 512, 24, 1, 2
    o.skeleton_max_candidates, o.skeleton_leaf_prune_hops, o.skeleton_simplify_dist_thres = 16, 2, 0.3
    o.num_gs_sample = 150
    return cfg


def port_frame(f):
    c = f.cam
    opt = lambda a: None if a is None else np.asarray(a)
    return convert.frame_from_numpy(np.asarray(c.w2c), np.asarray(c.intrinsics), float(c.fid), c.width, c.height,
                                    np.asarray(f.image), alpha_mask=opt(f.alpha_mask), thinned=opt(f.thinned),
                                    thinned_mask=opt(f.thinned_mask), semantic_seg=opt(f.semantic_seg), device="cpu")


def port_scene(js):
    return TScene(js.init_points, js.init_colors, is_blender=js.is_blender,
                  train_frames=[port_frame(f) for f in js.train_frames],
                  test_frames=[port_frame(f) for f in js.test_frames], cameras_extent=js.cameras_extent,
                  white_background=js.white_background)


def stage1_fixture(cfg_fn=base_cfg, n_test=1):
    """(reference scene with planted labels, reference config, reference
    stage-1 state): init_stage1 with the DeformNetwork's weights moved by a
    seeded N(0, 2e-2), no training."""
    _, js = JSyn.make_scene_data(n_train=6, n_test=n_test, width=64, height=64, max_thinned=128,
                                 n_init_points=200)
    js = dataclasses.replace(js, train_frames=[dataclasses.replace(f, semantic_seg=jnp.asarray(planted_seg(f.alpha_mask)))
                                               for f in js.train_frames])
    jcfg = cfg_fn(JConfig)
    j1 = JS1.init_stage1(jax.random.PRNGKey(SEED), js, jcfg)
    rng = np.random.default_rng(11)
    wp = j1.warp.params_dict()
    mlp = jax.tree.map(lambda a: a + jnp.asarray(rng.normal(scale=2e-2, size=a.shape), jnp.float32), wp["mlp"])
    return js, jcfg, dataclasses.replace(j1, warp=j1.warp.replace_params(dict(wp, mlp=mlp)))


@pytest.fixture(scope="module")
def runs():
    js, jcfg, j1 = stage1_fixture()
    ts, t1 = port_scene(js), _port_state(j1)
    out = dict(js=js, jcfg=jcfg, j1=j1, ts=ts, t1=t1)
    out["jinfo"], out["jframes"] = JS2.precompute_deformations(j1, js, jcfg)
    out["tinfo"], out["tframes"] = TS2.precompute_deformations(t1, ts, base_cfg(TConfig))
    return out


def test_precompute_deformations_matches(runs):
    ji, ti = runs["jinfo"], runs["tinfo"]
    assert [float(f.fid) for f in runs["tframes"]] == [float(f.fid) for f in runs["jframes"]]
    assert ti.template_idx == ji.template_idx
    np.testing.assert_array_equal(ti.parents, ji.parents)
    np.testing.assert_array_equal(ti.joint_node_indices, ji.joint_node_indices)
    assert len(ji.joints) >= 4
    np.testing.assert_allclose(ti.d_xyz.numpy(), ji.d_xyz, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ti.d_joints.numpy(), ji.d_joints, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ti.joints, ji.joints, atol=1e-6, rtol=0)


def _node_trajectories(state, frames, warp_forward):
    g = state.gs
    return np.stack([np.asarray(warp_forward(state.warp, g.xyz, f.fid, g.feature, g.motion_mask)["d_nodes"])
                     for f in frames])


def _labels(state, frames, warp_forward, project):
    """The median semantic label of each node, as precompute_deformations takes it."""
    rows = []
    for f in frames:
        proj = np.asarray(project(f.cam, warp_forward(state.warp, state.gs.xyz, f.fid, state.gs.feature,
                                                      state.gs.motion_mask)["d_nodes"])).astype(np.int64)
        seg = np.asarray(f.semantic_seg)
        rows.append(seg[np.clip(proj[:, 0], 0, seg.shape[0] - 1), np.clip(proj[:, 1], 0, seg.shape[1] - 1)])
    return np.median(np.stack(rows), axis=0).astype(np.int64)


def _prim_margin(cost):
    """The smallest gap between Prim's chosen key and the next candidate's,
    and between an updated key and the edge that would have replaced it."""
    cost = np.asarray(cost, np.float32)
    K = cost.shape[0]
    key, in_tree, gaps = np.full(K, np.inf), np.zeros(K, bool), []
    key[min(2, K - 1)] = 0.0
    for _ in range(K):
        masked = np.sort(np.where(in_tree, np.inf, key))
        if np.isfinite(masked[1]):
            gaps.append(masked[1] - masked[0])
        u = int(np.argmin(np.where(in_tree, np.inf, key)))
        in_tree[u] = True
        row, live = cost[u], (~in_tree) & (cost[u] > 0) & np.isfinite(key)
        gaps.extend(np.abs(row[live] - key[live]).tolist())
        better = (~in_tree) & (row > 0) & (row < key)
        key[better] = row[better]
    return float(min(gaps))


def _threshold_margin(d_nodes, info, labels, cfg):
    """The reference's extraction on ``d_nodes``, recording |deviation -
    threshold| at every distance-threshold decision of compute_insert_points
    (and its feasibility repair) and dissolve_degree2_joints."""
    thres, margins = [], []
    real_seg = JX._segment_dist

    def seg(a, b, pts):
        out = real_seg(a, b, pts)
        if thres:
            margins.append(abs(float(out.mean(0).max()) - thres[-1]))
        return out

    def with_threshold(fn, pos):
        def run(*a, **k):
            thres.append(a[pos])
            try:
                return fn(*a, **k)
            finally:
                thres.pop()
        return run

    o = cfg.opt
    with mock.patch.object(JX, "_segment_dist", seg), \
            mock.patch.object(JX, "compute_insert_points", with_threshold(JX.compute_insert_points, 2)), \
            mock.patch.object(JX, "dissolve_degree2_joints", with_threshold(JX.dissolve_degree2_joints, 3)):
        JX.obtain_skeleton_tree(d_nodes[info.template_idx], d_nodes, labels, max_candidates=o.skeleton_max_candidates,
                                leaf_prune_hops=o.skeleton_leaf_prune_hops,
                                junction_merge_hops=o.skeleton_junction_merge_hops,
                                simplify_dist_thres=o.skeleton_simplify_dist_thres,
                                simplify_max_edges=o.skeleton_simplify_max_edges)
    return min(margins)


def test_extraction_is_exact_on_the_ports_trajectories(runs):
    """The port's joints are the reference's extraction of the port's own
    node trajectories, bit for bit; prints the decisions' margins against
    the two packages' |d d_nodes|."""
    from riggs_tpu.camera.camera import project_nodes_2d as j_project
    from riggs_tpu_torch.camera.camera import project_nodes_2d as t_project

    ti, cfg = runs["tinfo"], runs["jcfg"]
    with torch.no_grad():
        t_nodes = _node_trajectories(runs["t1"], runs["tframes"], TNW.warp_forward)
        t_labels = _labels(runs["t1"], runs["tframes"], TNW.warp_forward, t_project)
    j_nodes = _node_trajectories(runs["j1"], runs["jframes"], JNW.warp_forward)
    np.testing.assert_array_equal(t_labels, _labels(runs["j1"], runs["jframes"], JNW.warp_forward, j_project))
    o = cfg.opt
    joints, parents, idx = JX.obtain_skeleton_tree(
        t_nodes[ti.template_idx], t_nodes, t_labels, max_candidates=o.skeleton_max_candidates,
        leaf_prune_hops=o.skeleton_leaf_prune_hops, junction_merge_hops=o.skeleton_junction_merge_hops,
        simplify_dist_thres=o.skeleton_simplify_dist_thres, simplify_max_edges=o.skeleton_simplify_max_edges)
    np.testing.assert_array_equal(ti.joints, joints)
    np.testing.assert_array_equal(ti.parents, parents)
    np.testing.assert_array_equal(ti.joint_node_indices, idx)
    d = float(np.abs(t_nodes - j_nodes).max())
    mean_dev = np.sort(np.linalg.norm(j_nodes - j_nodes.mean(0, keepdims=True), axis=-1).mean(-1))
    cost = np.linalg.norm(j_nodes[:, :, None] - j_nodes[:, None], axis=-1).mean(0)
    margins = {"distance thresholds": _threshold_margin(j_nodes, runs["jinfo"], t_labels, cfg),
               "Prim (all nodes)": _prim_margin(cost), "template candidates": float(np.diff(mean_dev[4:6])[0])}
    print(f"max |d d_nodes| {d:.3e}; {len(ti.joints)} joints; smallest decision margins "
          + ", ".join(f"{k} {v:.3e} ({v / max(d, 1e-30):.1f}x)" for k, v in margins.items()))
    assert d <= 1e-5


def test_init_stage2_matches(runs):
    js, jcfg, j1, ts, t1 = (runs[k] for k in ("js", "jcfg", "j1", "ts", "t1"))
    jstate, jinfo, jframes = JS2.init_stage2(jax.random.PRNGKey(1), j1, js, jcfg)
    tstate, tinfo, tframes = TS2.init_stage2(t1, ts, base_cfg(TConfig), generator=torch.Generator().manual_seed(1),
                                             device="cpu")
    assert int(tstate.gs.num_alive) == jcfg.opt.num_gs_sample
    np.testing.assert_array_equal(tstate.gs.alive.numpy(), np.asarray(jstate.gs.alive))
    np.testing.assert_allclose(tstate.gs.xyz.numpy(), np.asarray(jstate.gs.xyz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tinfo.d_xyz.numpy(), jinfo.d_xyz, atol=1e-5, rtol=0)
    assert float(np.abs(tinfo.d_xyz[tinfo.template_idx].numpy()).max()) == 0.0  # the template frame is the rest pose
    sk, jsk = tstate.skel, jstate.skel
    assert sk.net.parents == jsk.net.parents and sk.net.n_joints == jsk.net.n_joints
    assert (sk.net.K, sk.net.use_skinning_mlp, sk.net.use_template_offsets) == (jsk.net.K, jsk.net.use_skinning_mlp,
                                                                              jsk.net.use_template_offsets)
    np.testing.assert_allclose(sk.node_radius_log.detach().numpy(), np.asarray(jsk.node_radius_log), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sk.joints.numpy(), np.asarray(jsk.joints), atol=1e-6, rtol=0)
    assert sk.control_nodes.shape == jsk.control_nodes.shape and not sk.control_nodes.any()
    np.testing.assert_array_equal(tstate.proj_loss.numpy(), np.asarray(jstate.proj_loss))
    assert int(tstate.it) == 0 and int(tstate.opt_gs.count) == 0 and int(tstate.opt_skel.count) == 0
    for m in (tstate.opt_gs.mu, tstate.opt_gs.nu):
        assert not any(v.any() for v in m.values())
    assert not tstate.stats_gs.denom.any()
    # the reference's initial state converts for train_stage2's state=
    assert set(tstate.skel.params_dict()) == set(jsk.params_dict())
