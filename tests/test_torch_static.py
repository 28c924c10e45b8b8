"""The static and MLP-deform trainers of riggs_tpu_torch against riggs_tpu at
64 x 64: one ``train_step`` and one ``mlp_deform_step`` from the same state,
the warm-up freeze of the deform network bit for bit, and a few steps of
``train_static`` and ``train_mlp_deform`` with their densifications (the
frame picks from the same numpy generator, the split noise replayed from
the reference's keys).

Tolerances: a step's loss 1e-5 relative; parameters, Adam moments and the
densification statistics after one step from moments at count 5 (so no
first-step sign(g) update magnifies the gradients' rounding) 1e-5
absolute, the statistics 1e-4 relative; the loops' per-step losses and
PSNR 1e-4 relative and their alive counts exactly. A loop starts from
fresh moments, whose first Adam step is lr * sign(g): its parameters are
compared where the reference's gradient history is well above rounding
(|exp_avg| > 1e-6), within 1e-4 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.data import synthetic as JSyn
from riggs_tpu.models import gaussians as JG
from riggs_tpu.models import simple_deform as JSD
from riggs_tpu.models.deform_mlp import DeformNetworkDef as JNetDef
from riggs_tpu.train import mlp_deform as JMD
from riggs_tpu.train import optim as JO
from riggs_tpu.train import static as JST
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu.train.stage1 import stage1_lr_fns as j_stage1_lr_fns
from riggs_tpu_torch import convert
from riggs_tpu_torch.data.dataset import SceneData as TScene
from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef as TNetDef
from riggs_tpu_torch.train import mlp_deform as TMD
from riggs_tpu_torch.train import static as TST
from riggs_tpu_torch.train.config import Config as TConfig
from tests.test_torch_densify import reference_split_noise
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (module fixture)
from tests.test_torch_stage1_step import _gs_args, _port_frame
from tests.test_torch_stage2_step import _np, _skel_ref_layout

SEED = 5
NET = dict(depth=4, width=32)


@pytest.fixture(scope="module")
def scene():
    _, js = JSyn.make_scene_data(n_train=4, n_test=1, width=64, height=64, max_thinned=64, n_init_points=200)
    ts = TScene(js.init_points, js.init_colors, is_blender=js.is_blender,
                train_frames=[_port_frame(f) for f in js.train_frames], cameras_extent=js.cameras_extent,
                white_background=js.white_background)
    return js, ts


def _cfg(cls):
    cfg = cls()
    m, o, p = cfg.model, cfg.opt, cfg.pipe
    m.capacity, m.sh_degree = 512, 1
    p.max_per_tile = 256
    o.iterations, o.warm_up, o.oneupSHdegree_step = 8, 3, 4
    o.densify_from_iter, o.densification_interval, o.densify_until_iter = 2, 3, 8
    o.opacity_reset_interval = 5
    # thresholds the first steps' gradients reach
    o.densify_grad_threshold, o.percent_dense = 1e-7, 0.02
    return cfg


class JaxDraws:
    """The split noise of the reference's loops: PRNGKey(seed), one split per
    densification (static.py:176-177), after the deform's init split in the
    MLP-deform loop (mlp_deform.py:117, 149)."""

    def __init__(self, seed, init_split=False):
        self.key = jax.random.PRNGKey(seed)
        if init_split:
            self.key, _ = jax.random.split(self.key)

    def split_noise(self, capacity):
        self.key, sk = jax.random.split(self.key)
        return reference_split_noise(sk, capacity)


def _adam_np(o):
    return _np(o.mu), _np(o.nu), int(o.count)


def _stats_np(s):
    return tuple(np.asarray(a) for a in (s.xyz_gradient_accum, s.denom, s.max_radii2d))


def _perturbed_adam(opt, rng, count=5):
    """Seeded moments at ``count`` (nu positive)."""
    mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(scale=1e-3, size=a.shape), jnp.float32), opt.mu)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.uniform(1e-7, 1e-5, size=a.shape), jnp.float32), opt.nu)
    return JO.AdamState(mu=mu, nu=nu, count=jnp.asarray(count, jnp.int32))


def _gs_tree(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def _assert_tree(ref, port, name, **tol):
    ref_l = jax.tree_util.tree_flatten_with_path(_np(ref))[0]
    port_l = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert len(ref_l) == len(port_l), name
    for path, a in ref_l:
        np.testing.assert_allclose(port_l[path], a, err_msg=f"{name}{jax.tree_util.keystr(path)}", **tol)


def _reference_gs(js, cfg):
    m = cfg.model
    return JG.create_from_pcd(js.init_points, js.init_colors, capacity=m.capacity, max_sh_degree=m.sh_degree,
                              isotropic=m.use_isotropic_gs, with_motion_mask=m.gs_with_motion_mask)


def test_train_step_matches(scene):
    js, ts = scene
    jcfg = _cfg(JConfig)
    rng = np.random.default_rng(0)
    jst = JST.init_state(_reference_gs(js, jcfg))
    jst = dataclasses.replace(jst, opt=_perturbed_adam(jst.opt, rng))
    tst = convert.static_state_from_numpy(_gs_args(jst.gs), _adam_np(jst.opt), _stats_np(jst.stats), device="cpu")
    lr_fns = JST.make_lr_schedules(jcfg)
    lrs = {k: jnp.asarray(fn(100), jnp.float32) for k, fn in lr_fns.items()}
    jf, tf = js.train_frames[1], ts.train_frames[1]
    jnew, jm = JST.train_step(jst, jf.cam, jf.image, jnp.zeros(3), lrs, active_sh=1, max_per_tile=256)
    tnew, tm = TST.train_step(tst, tf.cam, tf.image, torch.zeros(3), TST.f32_lrs(TST.make_lr_schedules(_cfg(TConfig)), 100),
                              active_sh=1, max_per_tile=256)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
    assert int(tm["num_alive"]) == int(jm["num_alive"]) and int(tm["overflow"]) == int(jm["overflow"]) == 0
    _assert_tree(jnew.gs.params_dict(), _gs_tree(tnew.gs.params_dict()), "gs", atol=1e-5, rtol=0)
    _assert_tree(jnew.opt.mu, _gs_tree(tnew.opt.mu), "mu", atol=1e-5, rtol=0)
    _assert_tree(jnew.opt.nu, _gs_tree(tnew.opt.nu), "nu", atol=1e-5, rtol=0)
    for k, a in zip(("xyz_gradient_accum", "denom", "max_radii2d"), _stats_np(jnew.stats)):
        np.testing.assert_allclose(getattr(tnew.stats, k).numpy(), a, rtol=1e-4, atol=1e-5, err_msg=k)
    assert int(tnew.opt.count) == 6


def _mlp_states(js, jcfg, rng, count=5):
    """The reference's initial MLP-deform state (its train loop's keys) with
    seeded moments, and the port's from it."""
    key, dk = jax.random.split(jax.random.PRNGKey(SEED))
    m = jcfg.model
    gs = JG.create_from_pcd(js.init_points, js.init_colors, capacity=m.capacity, max_sh_degree=m.sh_degree,
                            isotropic=m.use_isotropic_gs, fea_dim=m.hyper_dim, with_motion_mask=m.gs_with_motion_mask)
    deform = JSD.init_mlp_deform(dk, JNetDef(**NET))
    jst = JMD.MlpDeformState(gs=gs, deform=deform, opt_gs=JO.adam_init(gs.params_dict()),
                             opt_deform=JO.adam_init(deform.params_dict()), stats=JG.init_densify_stats(gs.capacity))
    if count:
        jst = dataclasses.replace(jst, opt_gs=_perturbed_adam(jst.opt_gs, rng, count),
                                  opt_deform=_perturbed_adam(jst.opt_deform, rng, count))
    return jst, _port_mlp_state(jst)


def _port_mlp_state(jst):
    return convert.mlp_deform_state_from_numpy(_gs_args(jst.gs), _np(jst.deform.params_dict()), TNetDef(**NET),
                                               _adam_np(jst.opt_gs), _adam_np(jst.opt_deform), _stats_np(jst.stats),
                                               device="cpu")


def _deform_leaves(st):
    return [t.detach().clone() for t in jax.tree_util.tree_leaves(
        (st.deform.params_dict(), st.opt_deform.mu, st.opt_deform.nu, st.opt_deform.count))]


@pytest.mark.parametrize("warm", [True, False])
def test_mlp_deform_step_matches_and_freezes(scene, warm):
    """A step inside the warm-up leaves the deform's weights and its Adam
    state bitwise as they were (and the reference's too); one past it moves
    them as the reference's does."""
    js, ts = scene
    jcfg = _cfg(JConfig)
    jst, tst = _mlp_states(js, jcfg, np.random.default_rng(1))
    before = _deform_leaves(tst)
    jg, jd = j_stage1_lr_fns(jcfg)
    tg, td = TMD.stage1_lr_fns(_cfg(TConfig))
    jf, tf = js.train_frames[2], ts.train_frames[2]
    jnew, jm = JMD.mlp_deform_step(jst, jf, jnp.zeros(3), jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), jg(50)),
                                   jnp.asarray(jd(50)["mlp"], jnp.float32), warm=warm, active_sh=1, max_per_tile=256)
    tnew, tm = TMD.mlp_deform_step(tst, tf, torch.zeros(3), tg(50), td(50), warm=warm, active_sh=1, max_per_tile=256)
    assert tg(50) == {k: float(np.float32(v)) for k, v in jg(50).items()} and td(50) == float(np.float32(jd(50)["mlp"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_tree(jnew.gs.params_dict(), _gs_tree(tnew.gs.params_dict()), "gs", atol=1e-5, rtol=0)
    _assert_tree(jnew.opt_gs.mu, _gs_tree(tnew.opt_gs.mu), "mu", atol=1e-5, rtol=0)
    _assert_tree(jnew.deform.params_dict(), _skel_ref_layout(tnew.deform.params_dict()), "deform", atol=1e-5, rtol=0)
    _assert_tree(jnew.opt_deform.mu, _skel_ref_layout(tnew.opt_deform.mu), "deform mu", atol=1e-5, rtol=0)
    after = _deform_leaves(tnew)
    same = [torch.equal(a, b) for a, b in zip(before, after)]
    if warm:
        assert all(same)
        jsame = jax.tree.map(lambda a, b: bool(jnp.array_equal(a, b)), (jst.deform.params_dict(), jst.opt_deform),
                             (jnew.deform.params_dict(), jnew.opt_deform))
        assert all(jax.tree_util.tree_leaves(jsame))
    else:
        assert not any(same[:-1]) and int(tnew.opt_deform.count) == 6


def _assert_loop(jhist, thist, jstate, tstate, gs_of):
    assert [it for it, _ in thist] == [it for it, _ in jhist]
    for (it, a), (_, b) in zip(jhist, thist):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=f"{k} at {it}")
    jgs, tgs = gs_of(jstate), gs_of(tstate)
    np.testing.assert_array_equal(tgs.alive.numpy(), np.asarray(jgs.alive))
    return jgs, tgs


def _assert_settled(jp, tp, jmu, name):
    """Parameters where the reference's first moment is well above rounding."""
    for k, a in _np(jp).items():
        keep = np.abs(np.asarray(jmu[k])) > 1e-6
        np.testing.assert_allclose(tp[k].detach().numpy()[keep], a[keep], rtol=0, atol=1e-4, err_msg=f"{name}.{k}")


def test_train_static_matches(scene, capsys):
    js, ts = scene
    data_j = [(f.cam, np.asarray(f.image)) for f in js.train_frames]
    data_t = [(f.cam, f.image) for f in ts.train_frames]
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    jstate, jhist = JST.train_static(data_j, jcfg, 8, js.init_points, js.init_colors, seed=SEED, log_every=1)
    calls = []
    tstate, thist = TST.train_static(data_t, tcfg, 8, ts.init_points, ts.init_colors, seed=SEED, log_every=1,
                                     draws=JaxDraws(SEED), step_callback=lambda st, it: calls.append(it), device="cpu")
    assert calls == list(range(8))
    jgs, tgs = _assert_loop(jhist, thist, jstate, tstate, lambda s: s.gs)
    assert int(tgs.num_alive) != 200  # the densifications placed or pruned
    _assert_settled(jgs.params_dict(), tgs.params_dict(), jstate.opt.mu, "gs")
    out = capsys.readouterr().out
    assert out.count("] loss=") == 16


def test_train_mlp_deform_matches(scene):
    js, ts = scene
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    jst, tst = _mlp_states(js, jcfg, None, count=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMD, "init_mlp_deform", lambda key, net: jst.deform)
        jstate, jhist = JMD.train_mlp_deform(js, jcfg, seed=SEED, log_every=1)
    frozen = _deform_leaves(tst)
    seen = {}

    def watch(st, it):
        if it == jcfg.opt.warm_up - 1:
            seen["warm"] = all(torch.equal(a, b) for a, b in zip(frozen, _deform_leaves(st)))

    tstate, thist = TMD.train_mlp_deform(ts, tcfg, seed=SEED, log_every=1, state=tst, draws=JaxDraws(SEED, True),
                                         step_callback=watch, device="cpu")
    assert seen["warm"]
    jgs, tgs = _assert_loop(jhist, thist, jstate, tstate, lambda s: s.gs)
    _assert_settled(jgs.params_dict(), tgs.params_dict(), jstate.opt_gs.mu, "gs")
    assert int(tstate.opt_deform.count) == int(jstate.opt_deform.count) == jcfg.opt.iterations - jcfg.opt.warm_up
