"""The side-path models of riggs_tpu_torch against riggs_tpu on the same numpy
inputs: the SO(3)/SE(3) maps (with their small-angle branches), the
trajectory ARAP loss with rotations (``arap_deformation_loss``,
``arap_loss_with_rot``, the reference's draws passed in), the hash-grid
encoding and hash deform network, and the per-Gaussian MLP deform.

Tolerances: values 1e-5 relative (atol 1e-6) for the closed-form maps and
1e-4 relative (atol 1e-5) through an MLP; gradients atol 1e-5, rtol 1e-4
(f32 sums in another order). The ARAP losses sum over a KNN graph and a
rotation fit: rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.models import hash_encoding as JH
from riggs_tpu.models import node_warp as JNW
from riggs_tpu.models import simple_deform as JSD
from riggs_tpu.models.deform_mlp import DeformNetworkDef as JNetDef
from riggs_tpu.ops import arap as JA
from riggs_tpu.ops import geometry as JGeo
from riggs_tpu.ops import se3 as JSE3
from riggs_tpu_torch import convert
from riggs_tpu_torch.models import hash_encoding as TH
from riggs_tpu_torch.models import node_warp as TNW
from riggs_tpu_torch.models import simple_deform as TSD
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef as TNetDef
from riggs_tpu_torch.ops import arap as TA
from riggs_tpu_torch.ops import geometry as TGeo
from riggs_tpu_torch.ops import se3 as TSE3
from tests.test_torch_stage1_modules import _warps

VAL = dict(rtol=1e-5, atol=1e-6)
MLP_VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _twists(rng):
    """Twists (w, v) with |w| from 0 through the 1e-6 Taylor switch to pi."""
    w = rng.normal(size=(9, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w *= np.array([0.0, 1e-9, 5e-7, 2e-6, 1e-3, 0.3, 1.0, 2.5, np.pi])[:, None]
    return np.concatenate([w, rng.normal(size=(9, 3))], -1).astype(np.float32)


def test_se3_maps_match():
    rng = np.random.default_rng(0)
    S = _twists(rng)
    cot = rng.normal(size=(9, 4, 4)).astype(np.float32)
    jT, jvjp = jax.vjp(JSE3.exp_se3, jnp.asarray(S))
    tS = _t(S, grad=True)
    tT = TSE3.exp_se3(tS)
    np.testing.assert_allclose(tT.detach().numpy(), np.asarray(jT), **VAL)
    # a pure translation maps to itself
    np.testing.assert_array_equal(tT[0, :3, 3].detach().numpy(), S[0, 3:])
    (g,) = torch.autograd.grad(tT, tS, torch.as_tensor(cot))
    jg = np.asarray(jvjp(jnp.asarray(cot))[0])
    # at w = 0 exactly the reference's norm has a NaN derivative; the port's
    # torch.linalg.norm gives its subgradient 0 and stays finite
    assert np.isnan(jg[0, :3]).all() and np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy()[1:], jg[1:], **GRAD)
    np.testing.assert_allclose(g.numpy()[0, 3:], jg[0, 3:], **GRAD)

    w = S[3:, :3]  # |w| > 0: the axis normalization is defined
    np.testing.assert_allclose(TSE3.exp_so3(_t(w)).numpy(), np.asarray(JSE3.exp_so3(jnp.asarray(w))), **VAL)
    theta = np.linalg.norm(w, axis=-1).astype(np.float32)
    axis = (w / theta[:, None]).astype(np.float32)
    np.testing.assert_allclose(TSE3.exp_so3(_t(axis), _t(theta)).numpy(),
                               np.asarray(JSE3.exp_so3(jnp.asarray(axis), jnp.asarray(theta))), **VAL)
    np.testing.assert_allclose(TSE3.skew(_t(w)).numpy(), np.asarray(JSE3.skew(jnp.asarray(w))), **VAL)

    # log_so3 through its sin guard (angle 0 and pi) and the trace's clip tie
    R = np.array(JSE3.exp_so3(jnp.asarray(S[:, :3])))
    R[1] = np.eye(3, dtype=np.float32)
    cot3 = rng.normal(size=(9, 3)).astype(np.float32)
    jw, jvjp = jax.vjp(JSE3.log_so3, jnp.asarray(R))
    tR = _t(R, grad=True)
    tw = TSE3.log_so3(tR)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)
    (g,) = torch.autograd.grad(tw, tR, torch.as_tensor(cot3))
    jg = np.asarray(jvjp(jnp.asarray(cot3))[0])
    # arccos' derivative at +-1 is infinite: at angles 0 and pi the
    # reference's gradient is not finite (at pi its clip's mask times -inf is
    # NaN, where torch.maximum routes the -inf to the constant); the rows the
    # reference differentiates finitely must agree
    fin = np.isfinite(jg).all(axis=(1, 2))
    assert fin[4:8].all()
    np.testing.assert_allclose(g.numpy()[fin], jg[fin], rtol=1e-3, atol=1e-3)

    x = rng.normal(size=(5, 3)).astype(np.float32)
    h = np.array(JGeo.to_homogeneous(jnp.asarray(x)))
    np.testing.assert_array_equal(TGeo.to_homogeneous(_t(x)).numpy(), h)
    h[:, 3] = 2.0
    np.testing.assert_array_equal(TGeo.from_homogeneous(_t(h)).numpy(), np.asarray(JGeo.from_homogeneous(jnp.asarray(h))))
    assert TSE3.to_homogeneous is TGeo.to_homogeneous


@pytest.mark.parametrize("with_rot", [False, True])
def test_arap_deformation_loss_matches(with_rot):
    """A 40-node trajectory over 6 frames, the compared frame the
    reference's own draw; gradients of both terms in the trajectory."""
    rng = np.random.default_rng(1)
    base = rng.normal(scale=0.3, size=(40, 1, 3))
    traj = (base + rng.normal(scale=0.02, size=(40, 6, 3))).astype(np.float32)
    rot = rng.normal(size=(40, 6, 4)).astype(np.float32) if with_rot else None
    key = jax.random.PRNGKey(3)
    fid = int(jax.random.randint(key, (), 1, 6))

    def jloss(tr, ro):
        e, r = JA.arap_deformation_loss(tr, key, trajectory_rot=ro, K=12)
        return e + r, (e, r)

    (jl, (je, jr)), jg = jax.value_and_grad(jloss, argnums=(0, 1) if with_rot else 0, has_aux=True)(
        jnp.asarray(traj), None if rot is None else jnp.asarray(rot))
    tt = _t(traj, grad=True)
    tro = None if rot is None else _t(rot, grad=True)
    te, tr = TA.arap_deformation_loss(tt, torch.tensor(fid), trajectory_rot=tro, K=12)
    np.testing.assert_allclose(te.item(), float(je), rtol=1e-4)
    np.testing.assert_allclose(tr.item(), float(jr), rtol=1e-4)
    assert (tr.item() == 0.0) == (not with_rot)
    grads = torch.autograd.grad(te + tr, [tt] + ([tro] if with_rot else []))
    jg = jg if with_rot else (jg,)
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("d_rot_as_res", [True, False])
def test_arap_loss_with_rot_matches(d_rot_as_res):
    """The reference's loss from its key against the port's from the same
    draws (t_samp and fid from the key's two halves), value and gradient
    in the DeformNetwork; the rotation term only without d_rot_as_res."""
    jw, tw, _ = _warps(JNetDef(depth=4, width=64), d_rot_as_res=d_rot_as_res)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    t_samp = np.asarray(jax.random.uniform(k1, (8,)))
    fid = int(jax.random.randint(k2, (), 1, 8))
    jl, jg = jax.value_and_grad(lambda p: JNW.arap_loss_with_rot(jw.replace_params(p), key))(jw.params_dict())
    tl = TNW.arap_loss_with_rot(tw, torch.as_tensor(t_samp), torch.tensor(fid))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    params = tw.params_dict()
    leaves = [params["mlp"]["trunk"]["layers"][0]["w"], params["mlp"]["warp"]["w"], params["mlp"]["rotation"]["w"]]
    g = torch.autograd.grad(tl, leaves, allow_unused=True)
    jm = jg["mlp"]
    for a, b in zip(g, (jm["trunk"]["layers"][0]["w"], jm["warp"]["w"], jm["rotation"]["w"])):
        a, b = (np.zeros(np.asarray(b).T.shape, np.float32) if a is None else a.numpy()), np.asarray(b).T
        # f32 sums through the trunk in another order: 1e-4 of the leaf's largest entry
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * np.abs(b).max())
    # the draws helper keeps the reference's ranges
    ts, f = TNW.arap_rot_draws(torch.Generator().manual_seed(0), device="cpu")
    assert ts.shape == (8,) and 1 <= int(f) < 8 and bool((ts >= 0).all() and (ts < 1).all())


GRID = dict(n_levels=4, log2_table=9, features=2, base_res=4, max_res=40)


def _hash_nets(seed=0, **grid):
    jgrid = JH.HashGridDef(**{**GRID, **grid})
    jn = JH.init_hash_deform(jax.random.PRNGKey(seed), bbox_min=-1.0, bbox_max=1.0, grid=jgrid, width=16, depth=2)
    rng = np.random.default_rng(seed)
    # the heads' tiny inits perturbed, so every gradient is well above rounding
    jn = jn.replace_params(dict(jn.params_dict(), heads=jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(scale=0.1, size=a.shape), jnp.float32), jn.heads)))
    tgrid = TH.HashGridDef(**{**GRID, **grid})
    tn = convert.hash_deform_from_numpy(_np(jn.params_dict()), jn.bbox_min, jn.bbox_max, grid=tgrid, width=16,
                                        depth=2, device="cpu")
    return jn, tn


def test_hash_encode_matches():
    """Points inside the box, on its faces and outside it (the clip's tie),
    levels masked; the features and their gradients in the tables and x."""
    jn, tn = _hash_nets()
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    x[:4] = [[1.0, 0.2, -1.0], [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5]]
    mask = JH.progressive_level_mask(4, 600, start_level=2, steps_per_level=500)
    assert np.array_equal(mask, TH.progressive_level_mask(4, 600, start_level=2, steps_per_level=500))
    cot = rng.normal(size=(64, 8)).astype(np.float32)
    jenc, jvjp = jax.vjp(lambda tb, xx: JH.hash_encode(tb, jn.grid, xx, -1.0, 1.0, jnp.asarray(mask)),
                         jn.tables, jnp.asarray(x))
    tx = _t(x, grad=True)
    tenc = TH.hash_encode(tn.tables, tn.grid, tx, -1.0, 1.0, torch.as_tensor(mask))
    np.testing.assert_allclose(tenc.detach().numpy(), np.asarray(jenc), **VAL)
    g_tab, g_x = torch.autograd.grad(tenc, (tn.tables, tx), torch.as_tensor(cot))
    j_tab, j_x = jvjp(jnp.asarray(cot))
    np.testing.assert_allclose(g_tab.numpy(), np.asarray(j_tab), **GRAD)
    np.testing.assert_allclose(g_x.numpy(), np.asarray(j_x), **GRAD)
    # the uint32 hash: identical table rows hit for every corner
    assert tn.grid.table_size == jn.grid.table_size and tn.grid.resolution(3) == int(
        np.floor(jn.grid.base_res * jn.grid.growth**3))


def test_apply_hash_deform_matches():
    jn, tn = _hash_nets(seed=1, log2_table=8)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(48, 3)).astype(np.float32)
    cot = {k: rng.normal(size=(48, d)).astype(np.float32) for k, d in (("d_xyz", 3), ("d_rotation", 4), ("d_scaling", 3))}

    def jloss(p):
        o = JH.apply_hash_deform(jn.replace_params(p), jnp.asarray(x), 0.35)
        return sum(jnp.sum(o[k] * cot[k]) for k in cot), o

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jn.params_dict())
    to = TH.apply_hash_deform(tn, _t(x), 0.35)
    for k in cot:
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]), **MLP_VAL, err_msg=k)
    loss = sum(torch.sum(to[k] * torch.as_tensor(cot[k])) for k in cot)
    tp = tn.params_dict()
    leaves = [tp["tables"], tp["mlp"]["layers"][0]["w"], tp["heads"]["rotation"]["w"]]
    g = torch.autograd.grad(loss, leaves)
    for a, b in zip(g, (jg["tables"], jg["mlp"]["layers"][0]["w"].T, jg["heads"]["rotation"]["w"].T)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    assert set(tp) == set(jn.params_dict()) and set(tp["heads"]) == set(jn.heads)


def test_mlp_deform_forward_matches():
    """The port's MlpDeform from the reference's parameters: the heads at
    every Gaussian with the motion mask, x detached, t a scalar; the
    static type's zeros."""
    jnet = JNetDef(depth=3, width=32)
    jd = JSD.init_mlp_deform(jax.random.PRNGKey(4), jnet)
    td = convert.mlp_deform_from_numpy(_np(jd.params_dict()), TNetDef(depth=3, width=32), device="cpu")
    assert set(td.params_dict()["mlp"]) == set(jd.mlp)
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.3, size=(30, 3)).astype(np.float32)
    mm = rng.uniform(size=(30, 1)).astype(np.float32)
    jo = JSD.mlp_deform_forward(jd, jnp.asarray(x), jnp.float32(0.6), jnp.asarray(mm))
    tx = _t(x, grad=True)
    to = TSD.mlp_deform_forward(td, tx, torch.tensor(0.6), torch.as_tensor(mm))
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]), **MLP_VAL, err_msg=k)
    assert not to["d_xyz"].requires_grad or torch.autograd.grad(to["d_xyz"].sum(), tx, allow_unused=True)[0] is None
    js, ts = JSD.static_forward(jnp.asarray(x)), TSD.static_forward(_t(x))
    for k in ("d_xyz", "d_rotation", "d_scaling"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
