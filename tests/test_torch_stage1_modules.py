"""The stage-1 modules of riggs_tpu_torch against riggs_tpu on the same numpy
inputs: the nearest-neighbour searches, FPS, the ARAP graph and energy, the
DeformNetwork, the node warp (cal_nn_weight, warp_forward, arap_loss),
create_from_pcd and init_stage1.

Random weights cross over with riggs_tpu_torch.convert; the ARAP sample
times are the reference's own draws from its key. The point sets are seeded
away from near ties, so that a last-bit difference in the x.y products
cannot flip a neighbour; one test plants exact ties.

Tolerances: integer outputs (indices, masks) exactly equal; distances and
values 1e-5 relative (atol 1e-6); gradients atol 1e-5, rtol 1e-4 (f32 sums
in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.data.dataset import SceneData as JScene
from riggs_tpu.models import deform_mlp as JD
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import node_warp as JNW
from riggs_tpu.ops import arap as JA
from riggs_tpu.ops import fps as JF
from riggs_tpu.ops import geometry as JGeo
from riggs_tpu.ops.knn import _row_k as j_row_k, knn as j_knn, mean_knn_dist2 as j_mean_knn_dist2
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch import convert
from riggs_tpu_torch.data.dataset import SceneData as TScene
from riggs_tpu_torch.models import deform_mlp as TD
from riggs_tpu_torch.models import gaussians as TG
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.models.mlp import positional_embed_masked, progressive_band_mask
from riggs_tpu_torch.ops import arap as TA
from riggs_tpu_torch.ops import fps as TF
from riggs_tpu_torch.ops import geometry as TGeo
from riggs_tpu_torch.ops import knn as TK
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config as TConfig

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


@pytest.mark.parametrize("k", [3, 12])
def test_knn_matches(k):
    """Both selection paths (k passes of argmin; the sort for k > 8), with
    exact ties planted: duplicated y rows must come lower index first."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = rng.normal(size=(64, 5)).astype(np.float32)
    y[[20, 41, 63]] = y[[3, 7, 7]]
    jd, ji = j_knn(jnp.asarray(x), jnp.asarray(y), k, chunk=128)
    tx, ty = _t(x, True), _t(y, True)
    td, ti = TK.knn(tx, ty, k, chunk=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), **VAL)
    # gradients through the selected distances
    wts = rng.normal(size=(300, k)).astype(np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(j_knn(a, b, k, chunk=128)[0] * wts), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tg = torch.autograd.grad(torch.sum(td * torch.as_tensor(wts)), (tx, ty))
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD)


def test_mean_knn_dist2_and_row_k_ties():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_allclose(TK.mean_knn_dist2(_t(pts), chunk=128).numpy(),
                               np.asarray(j_mean_knn_dist2(jnp.asarray(pts), chunk=128)), **VAL)
    d2 = np.tile(np.array([[3.0, 1.0, 1.0, 2.0, 1.0, 0.5, 2.0, 1.0, 4.0, 1.0, 0.5]], np.float32), (2, 1))
    for k in (4, 9):
        jv, ji = j_row_k(jnp.asarray(d2), k)
        tv, ti = TK._row_k(torch.as_tensor(d2), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_farthest_point_sample_matches():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    mask = rng.uniform(size=400) < 0.8
    for kw in (dict(), dict(init_idx=17), dict(mask=mask, init_idx=int(np.flatnonzero(~mask)[0]))):
        jk = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tk = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        ji = np.asarray(JF.farthest_point_sample(jnp.asarray(pts), 64, **jk))
        ti = TF.farthest_point_sample(_t(pts), 64, **tk)
        np.testing.assert_array_equal(ti.numpy(), ji)
        if "mask" in kw:
            assert mask[ti.numpy()].all()
    assert len(set(ti.tolist())) == 64


def test_fit_rotations_and_safe_norm_match():
    rng = np.random.default_rng(3)
    cov = rng.normal(size=(50, 3, 3)).astype(np.float32)
    R = TGeo.fit_rotations(_t(cov)).numpy()
    np.testing.assert_allclose(R, np.asarray(JGeo.fit_rotations(jnp.asarray(cov))), atol=2e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    x[0] = 0.0
    tx = _t(x, True)
    n = TGeo.safe_norm(tx)
    (g,) = torch.autograd.grad(n.sum(), tx)
    jg = jax.grad(lambda a: JGeo.safe_norm(a).sum())(jnp.asarray(x))
    np.testing.assert_allclose(n.detach().numpy(), np.asarray(JGeo.safe_norm(jnp.asarray(x))), **VAL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)
    assert np.isfinite(g.numpy()).all()


def test_connectivity_and_arap_error_match():
    rng = np.random.default_rng(4)
    pts = rng.normal(scale=0.1, size=(40, 3)).astype(np.float32)
    seq = np.stack([pts, pts + rng.normal(scale=0.01, size=pts.shape)]).astype(np.float32)
    jc = JA.connectivity_from_points(jnp.asarray(pts), K=10)
    tc = TA.connectivity_from_points(_t(pts), K=10)
    np.testing.assert_array_equal(tc.nn_idx.numpy(), np.asarray(jc.nn_idx))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert not tc.valid.all() and tc.valid[:, :3].all()  # the radius cut beyond the first 3 edges
    np.testing.assert_allclose(tc.weight.numpy(), np.asarray(jc.weight), **VAL)
    np.testing.assert_allclose(TA.edge_matrix(_t(pts), tc).numpy(), np.asarray(JA.edge_matrix(jnp.asarray(pts), jc)), **VAL)
    np.testing.assert_allclose(TA.estimate_rotations(_t(seq[0]), _t(seq[1]), tc).numpy(),
                               np.asarray(JA.estimate_rotations(jnp.asarray(seq[0]), jnp.asarray(seq[1]), jc)), atol=2e-5)
    ts = _t(seq, True)
    e = TA.arap_error(ts, tc)
    (g,) = torch.autograd.grad(e, ts)
    je, jg = jax.value_and_grad(lambda s: JA.arap_error(s, jc))(jnp.asarray(seq))
    np.testing.assert_allclose(e.item(), float(je), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-6)


NETS = {
    "blender": JD.DeformNetworkDef(),
    "real_local_frame_heads": JD.DeformNetworkDef(is_blender=False, local_frame=True, pred_opacity=True,
                                                  pred_color=True, max_d_scale=1.5),
    "progressive_band": JD.DeformNetworkDef(is_blender=True, progressive_band_time=True),
}


def _tnet(jnet):
    return TD.DeformNetworkDef(**{f: getattr(jnet, f) for f in jnet.__dataclass_fields__})


def _warps(jnet, node_num=24, hyper_dim=2, seed=5, **kw):
    """The reference's init_node_warp on a seeded cloud, and the port's warp
    from its parameters; the nodes, radii and weights perturbed off init."""
    rng = np.random.default_rng(seed)
    pcl = rng.normal(scale=0.3, size=(200, 3)).astype(np.float32)
    jw = JNW.init_node_warp(jax.random.PRNGKey(seed), pcl, node_num, net=jnet, hyper_dim=hyper_dim, **kw)
    jw = jw.replace_params(dict(
        jw.params_dict(),
        nodes=jw.nodes + jnp.asarray(rng.normal(scale=0.02, size=jw.nodes.shape), jnp.float32),
        radius=jw.node_radius_log + jnp.asarray(rng.normal(scale=0.1, size=jw.node_radius_log.shape), jnp.float32),
        weight=jnp.asarray(rng.normal(size=jw.node_weight_logit.shape), jnp.float32),
        mlp=jax.tree.map(lambda a: a + jnp.asarray(rng.normal(scale=1e-2, size=a.shape), jnp.float32),
                         jw.mlp),
    ))
    tw = convert.node_warp_from_numpy(_np(jw.params_dict()), _tnet(jnet), K=jw.K, hyper_dim=hyper_dim,
                                      d_rot_as_res=jw.d_rot_as_res, device="cpu")
    return jw, tw, pcl


@pytest.mark.parametrize("name", list(NETS))
def test_deform_network_matches(name):
    jnet = NETS[name]
    jw, tw, pcl = _warps(jnet)
    assert set(TD.DeformNetwork(_tnet(jnet)).params_dict()) == set(jw.mlp)
    rng = np.random.default_rng(6)
    x = rng.normal(scale=0.3, size=(7, 5, 3)).astype(np.float32)
    t = rng.uniform(size=(7, 5, 1)).astype(np.float32)
    band = progressive_band_mask(jnet.t_multires, 300, 1000)
    jo = JD.apply_deform_network(jw.mlp, jnet, jnp.asarray(x), jnp.asarray(t), band_mask=jnp.asarray(band))
    to = tw.mlp(_t(x), _t(t), band_mask=torch.as_tensor(band))
    assert set(k for k, v in to.items() if v is not None) == set(k for k, v in jo.items() if v is not None)
    for k, v in jo.items():
        if v is not None:
            np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)
    from riggs_tpu.models.mlp import positional_embed_masked as j_pem
    nf = jnet.t_multires
    np.testing.assert_allclose(positional_embed_masked(_t(t), nf, torch.as_tensor(band)).numpy(),
                               np.asarray(j_pem(jnp.asarray(t), nf, jnp.asarray(band))), **VAL)


def _feature(rng, n, hyper_dim):
    return rng.normal(scale=0.05, size=(n, hyper_dim + 1)).astype(np.float32)


@pytest.mark.parametrize("name,d_rot_as_res", [("blender", True), ("real_local_frame_heads", False)])
def test_warp_forward_matches(name, d_rot_as_res):
    jnet = NETS[name]
    jw, tw, pcl = _warps(jnet, hyper_dim=2, d_rot_as_res=d_rot_as_res)
    rng = np.random.default_rng(7)
    x = pcl[:150] + rng.normal(scale=0.01, size=(150, 3)).astype(np.float32)
    feat = _feature(rng, 150, 2)
    mm = rng.uniform(size=(150, 1)).astype(np.float32)
    cot = {k: rng.normal(size=s).astype(np.float32) for k, s in
           (("d_xyz", (150, 3)), ("d_rotation", (150, 4)), ("d_scaling", (150, 3)), ("d_nodes", (24, 3)))}

    def jloss(p, f):
        d = JNW.warp_forward(jw.replace_params(p), jnp.asarray(x), jnp.float32(0.4), f, jnp.asarray(mm),
                             local_frame=jnet.local_frame)
        return sum(jnp.sum(d[k] * cot[k]) for k in cot), d

    (jl, jd), (jgp, jgf) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jw.params_dict(), jnp.asarray(feat))
    tf = _t(feat, True)
    td = TNW.warp_forward(tw, _t(x), torch.tensor(0.4), tf, _t(mm), local_frame=jnet.local_frame)
    tl = sum(torch.sum(td[k] * torch.as_tensor(cot[k])) for k in cot)
    tp = tw.params_dict()
    leaves = [tp["nodes"], tp["radius"], tp["weight"], tf]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_array_equal(td["nn_idx"].numpy(), np.asarray(jd["nn_idx"]))
    for k in ("d_xyz", "d_rotation", "d_scaling", "d_nodes", "nn_weight", "d_opacity", "d_color"):
        if jd[k] is None:
            assert td[k] is None
        else:
            np.testing.assert_allclose(td[k].detach().numpy(), np.asarray(jd[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for a, b, name in zip((jgp["nodes"], jgp["radius"], jgp["weight"], jgf), tg, ("nodes", "radius", "weight", "feature")):
        scale = max(float(np.abs(np.asarray(a)).max()), 1e-12)
        np.testing.assert_allclose(b.numpy() / scale, np.asarray(a) / scale, rtol=1e-3, atol=1e-5, err_msg=name)
        assert float(np.abs(np.asarray(a)).max()) > 0, name


def test_cal_nn_weight_matches():
    jw, tw, pcl = _warps(NETS["blender"], hyper_dim=2)
    rng = np.random.default_rng(8)
    x = pcl[:100]
    feat = _feature(rng, 100, 2)

    def jf(p, f):
        w, d2, idx = JNW.cal_nn_weight(jw.replace_params(p), jnp.asarray(x), f)
        return jnp.sum(w * jnp.arange(3.0)) + 1e-2 * jnp.sum(d2), (w, d2, idx)

    (_, (jwt, jd2, jidx)), (jgp, jgf) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jw.params_dict(), jnp.asarray(feat))
    tf = _t(feat, True)
    w, d2, idx = TNW.cal_nn_weight(tw, _t(x), tf)
    tg = torch.autograd.grad(torch.sum(w * torch.arange(3.0)) + 1e-2 * torch.sum(d2), (tw.nodes, tw.node_radius_log, tf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jwt), **VAL)
    np.testing.assert_allclose(d2.detach().numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)
    for a, b in zip((jgp["nodes"], jgp["radius"], jgf), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5)


def _reference_arap_t(key, t=None, delta_t=0.05, t_samp_num=2):
    """The sample times riggs_tpu's arap_loss draws from ``key``
    (node_warp.py:368-370)."""
    k1, k2 = jax.random.split(key)
    t0 = jax.random.uniform(k1, ()) if t is None else jnp.squeeze(t) + delta_t * (jax.random.uniform(k1, ()) - 0.5)
    return np.asarray(jax.random.uniform(k2, (t_samp_num,)) * delta_t + t0 - 0.5 * delta_t)


def test_arap_loss_matches_given_the_reference_draws():
    jw, tw, _ = _warps(NETS["blender"], node_num=32)
    key = jax.random.PRNGKey(9)
    jl, jg = jax.value_and_grad(lambda p: JNW.arap_loss(jw.replace_params(p), key))(jw.params_dict())
    tl = TNW.arap_loss(tw, torch.as_tensor(_reference_arap_t(key)))
    leaves = jax.tree_util.tree_leaves(jg["mlp"])
    tleaves = [p for p in jax.tree_util.tree_leaves(tw.params_dict()["mlp"])]
    tg = [torch.zeros_like(p) if g is None else g for p, g in
          zip(tleaves, torch.autograd.grad(tl, tleaves, allow_unused=True))]  # the heads other than d_xyz
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    assert float(jl) > 0
    # scaled by the largest gradient: the heads' biases get ~1e-9 of
    # cancellation noise (ARAP is blind to a common translation)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in leaves)
    for a, b in zip(leaves, tg):
        b = b.numpy().T if b.dim() == 2 else b.numpy()
        np.testing.assert_allclose(b / scale, np.asarray(a) / scale, rtol=1e-3, atol=1e-4)
    # the port's own draws: the reference's distribution
    gen = torch.Generator().manual_seed(0)
    ts = torch.stack([TNW.arap_sample_times(gen, device="cpu") for _ in range(200)])
    assert float((ts.max(1).values - ts.min(1).values).max()) <= 0.05
    assert -0.025 <= float(ts.min()) and float(ts.max()) <= 1.025
    near = TNW.arap_sample_times(gen, t=torch.tensor(0.5))
    assert float((near - 0.5).abs().max()) <= 0.05


@pytest.mark.parametrize("iso,motion", [(False, True), (True, False)])
def test_create_from_pcd_matches(iso, motion):
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(150, 3)).astype(np.float32)
    cols = rng.uniform(size=(150, 3)).astype(np.float32)
    kw = dict(capacity=200, max_sh_degree=2, isotropic=iso, fea_dim=3, with_motion_mask=motion)
    jgs = JG.create_from_pcd(pts, cols, **kw)
    tgs = TG.create_from_pcd(pts, cols, device="cpu", **kw)
    for k, v in jgs.params_dict().items():
        np.testing.assert_allclose(tgs.params_dict()[k].numpy(), np.asarray(v), **VAL, err_msg=k)
    np.testing.assert_array_equal(tgs.alive.numpy(), np.asarray(jgs.alive))
    assert (tgs.isotropic, tgs.with_motion_mask, tgs.max_sh_degree) == (iso, motion, 2)
    assert torch.all(tgs.rotation[150:, 0] == 1)


def test_init_stage1_matches():
    """Everything but the DeformNetwork's random weights (drawn from a
    torch.Generator, not the reference's key), whose shapes must agree."""
    rng = np.random.default_rng(11)
    pts = rng.normal(scale=0.3, size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    jcfg, tcfg = JConfig(), TConfig()
    for c in (jcfg, tcfg):
        c.model.capacity, c.model.node_num, c.model.gs_with_motion_mask = 384, 48, True
    js = JS1.init_stage1(jax.random.PRNGKey(0), JScene([], [], pts, cols, 1.0), jcfg)
    ts = TS1.init_stage1(TScene(pts, cols), tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for name in ("gs", "node_gs"):
        a, b = getattr(js, name), getattr(ts, name)
        for k, v in a.params_dict().items():
            np.testing.assert_allclose(b.params_dict()[k].numpy(), np.asarray(v), **VAL, err_msg=f"{name}.{k}")
        np.testing.assert_array_equal(b.alive.numpy(), np.asarray(a.alive))
        assert (b.isotropic, b.shared_scale, b.with_motion_mask) == (a.isotropic, a.shared_scale, a.with_motion_mask)
    jp, tp = js.warp.params_dict(), ts.warp.params_dict()
    for k in ("nodes", "radius", "weight"):
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), **VAL, err_msg=k)
    jshapes = [tuple(np.asarray(a).shape) for a in jax.tree_util.tree_leaves(jp["mlp"])]
    tshapes = [tuple(a.shape)[::-1] if a.dim() == 2 else tuple(a.shape) for a in jax.tree_util.tree_leaves(tp["mlp"])]
    assert jshapes == tshapes
    for name in ("opt_gs", "opt_node", "opt_warp"):
        assert int(getattr(ts, name).count) == 0
    assert ts.stats_node.denom.shape == (48 * jcfg.opt.node_max_num_ratio_during_init,)
    assert int(ts.it) == 0 and ts.warp.K == js.warp.K and ts.warp.hyper_dim == js.warp.hyper_dim
