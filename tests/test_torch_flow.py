"""The optical-flow branch of stage 1 in riggs_tpu and in riggs_tpu_torch:
FlowStore, render_flow, a flow-scene step that drew no partner, and
train_stage1 on a scene with RAFT flow files, whose phase B runs
make_phase_b_auto with the flow loss on every step (the single flow step,
plain windows and on a ladder, is tests/test_torch_stage1_step.py's).

Tolerances: FlowStore's draws, flows, validity masks and partner times
bitwise (the same numpy arithmetic on the same generator); render_flow's
colours and alpha 2e-5, depth 2e-4, radii exact, gradients atol 1e-4,
rtol 1e-3 on each leaf scaled by its largest |reference| value (the blend
backward's bound, tests/test_pallas_blend.py:44). The loop: frame picks, flow
partners and partner count exactly equal; per-step losses and the flow
term within 1e-4 relative, the parameters after the loop within 1e-4
(absolute) of the reference's. The loop starts from Adam moments at count
5, as the step tests do, so its first steps are no sign(g) updates that
would magnify the packages' last-bit differences.
"""
import contextlib
import dataclasses
import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from riggs_tpu.camera import make_camera as j_make_camera
from riggs_tpu.data import flow as JFlow
from riggs_tpu.data import synthetic as JSyn
from riggs_tpu.models import gaussians as JG
from riggs_tpu.render.api import render_flow as j_render_flow
from riggs_tpu.train import optim as JO
from riggs_tpu.train import sampling as JSampling
from riggs_tpu.train import stage1 as JS1
from riggs_tpu.train.config import Config as JConfig
from riggs_tpu_torch.convert import camera_from_numpy, frame_from_numpy, gaussians_from_numpy
from riggs_tpu_torch.data import flow as TFlow
from riggs_tpu_torch.data.dataset import SceneData as TScene
from riggs_tpu_torch.render.api import render_flow as t_render_flow
from riggs_tpu_torch.train import sampling as TSampling
from riggs_tpu_torch.train import stage1 as TS1
from riggs_tpu_torch.train.config import Config as TConfig
from riggs_tpu_torch.train.optim import grad_tree

from tests.test_torch_stage1_loop import SEED, JaxDraws, _port_scene, one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_stage1_step import _gs_args, _port_state, _skel_ref_layout
from tests.test_torch_stage2_step import _moments, _np, _second_moments

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def write_flow_files(root, names, size, seed=0, unknown=True):
    """raft_neighbouring/<name>.flow_<partner>.npy from each frame to its
    neighbours (a smooth field of a few pixels at ``size``), and their
    raft_masks/: RGB masks (cycle-consistency and occlusion channels, one of
    them missing for every third file), a greyscale mask, or none; one file
    names a partner no frame has."""
    rng = np.random.default_rng(seed)
    (root / "raft_neighbouring").mkdir(parents=True, exist_ok=True)
    (root / "raft_masks").mkdir(exist_ok=True)
    h, w = size
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    k = 0
    for i, name in enumerate(names):
        for j in (i - 1, i + 1):
            if not 0 <= j < len(names):
                continue
            a = rng.uniform(-3, 3, size=4).astype(np.float32)
            flow = np.stack([a[0] * np.sin(xx / w * 3 + a[1]), a[2] * np.cos(yy / h * 2 + a[3])], -1)
            fname = f"{name}.flow_{names[j]}"
            np.save(root / "raft_neighbouring" / f"{fname}.npy", flow.astype(np.float32))
            if k % 4 == 3:
                pass  # no mask: valid everywhere
            elif k % 4 == 2:
                Image.fromarray(((rng.uniform(size=(h, w)) < 0.6) * 255).astype(np.uint8)).save(
                    root / "raft_masks" / f"{fname}.png")
            else:
                m = (rng.uniform(size=(h, w, 3)) < 0.5).astype(np.uint8) * 255
                if k % 3 == 0:
                    m[..., 1] = 0
                Image.fromarray(m).save(root / "raft_masks" / f"{fname}.png")
            k += 1
    if unknown:
        np.save(root / "raft_neighbouring" / f"{names[0]}.flow_zzz.npy", np.zeros((h, w, 2), np.float32))


def test_flow_store_draws_and_arrays_match(tmp_path):
    """Both stores on one scan, drawing from generators of one seed: the
    same candidates, partners and draws; flows resized from 24x20 to 32x40
    and validity masks bitwise; the generators in the same state after."""
    names = ["r_000", "r_001", "r_002", "r_003"]
    fids = [0.0, 1 / 3, 2 / 3, 1.0]
    write_flow_files(tmp_path, names, (24, 20))
    (tmp_path / "raft_neighbouring" / "zzz.flow_r_000.npy").write_bytes(b"")  # no frame's file
    js = JFlow.FlowStore(tmp_path, names, fids)
    ts = TFlow.FlowStore(tmp_path, names, fids, [(32, 40)] * 4, device="cpu")
    assert [[p.name for p in c] for c in ts.candidates] == [[p.name for p in c] for c in js.candidates]
    assert all(ts.has_flow(i) == js.has_flow(i) for i in range(4))
    assert [ts.partner_name(p) for c in ts.candidates for p in c] == [js.partner_name(p) for c in js.candidates
                                                                      for p in c]
    jr, tr = np.random.default_rng(4), np.random.default_rng(4)
    seen = set()
    for i in [0, 1, 2, 3] * 8:
        a, b = js.sample(i, jr, 32, 40), ts.sample(i, tr)
        assert (a is None) == (b is None), i
        if a is None:
            seen.add("unknown")
            continue
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        seen.add(float(a[2]))
    assert jr.integers(1 << 30) == tr.integers(1 << 30)
    assert seen == {"unknown", *(float(np.float32(f)) for f in fids)}
    fl, fm, pfid = ts.no_partner(_Frame(32, 40, torch.tensor(0.25)))
    assert not fl.any() and not fm.any() and fl.shape == (32, 40, 2) and float(pfid) == 0.25


@dataclasses.dataclass
class _Cam:
    height: int
    width: int


class _Frame:
    def __init__(self, h, w, fid):
        self.cam, self.fid = _Cam(h, w), fid


def test_render_flow_matches():
    """The flow of 300 anisotropic, opaque Gaussians with a motion mask,
    offset to two times and seen by two cameras (the second off-centre),
    and the gradients of a weighted sum of its colours and alpha in every
    Gaussian parameter and both offsets."""
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(300, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    gs = JG.create_from_pcd(pts, rng.uniform(size=(300, 3)).astype(np.float32), capacity=320, max_sh_degree=1,
                            fea_dim=2, with_motion_mask=True)
    gp = gs.params_dict()
    noise = lambda a, scale: a + jnp.asarray(rng.normal(scale=scale, size=a.shape), jnp.float32)
    gs = gs.replace_params(dict(gp, opacity=gp["opacity"] + 2.0, scaling=noise(gp["scaling"], 0.3),
                                rotation=noise(gp["rotation"], 0.3), feature=noise(gp["feature"], 0.5)))
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), 96, 96, fovx=0.9, fovy=0.9)
    jc2 = dataclasses.replace(jc, intrinsics=jc.intrinsics + jnp.asarray([4.0, -3.0, 9.0, -7.0]))
    d1 = jnp.asarray(rng.normal(scale=0.03, size=(gs.capacity, 3)), jnp.float32)
    d2 = jnp.asarray(rng.normal(scale=0.03, size=(gs.capacity, 3)), jnp.float32)
    dr = jnp.asarray(rng.normal(scale=0.05, size=(gs.capacity, 4)), jnp.float32)
    wr = jnp.asarray(rng.normal(size=(jc.height, jc.width, 3)), jnp.float32)
    wa = jnp.asarray(rng.normal(size=(jc.height, jc.width)), jnp.float32)

    @jax.jit
    def jfn(params, d1, d2):
        out = j_render_flow(jc, jc2, gs.replace_params(params), d1, d2, dr, max_per_tile=512)
        return jnp.sum(out["render"] * wr) + jnp.sum(out["alpha"] * wa), out

    (_, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(gs.params_dict(), d1, d2)

    cam = lambda c: camera_from_numpy(np.asarray(c.w2c), np.asarray(c.intrinsics), float(c.fid), c.width, c.height,
                                      device="cpu")
    tgs = gaussians_from_numpy(**_gs_args(gs), device="cpu")
    params = {k: v.detach().requires_grad_(True) for k, v in tgs.params_dict().items()}
    td1, td2 = (torch.tensor(np.asarray(a), requires_grad=True) for a in (d1, d2))
    tout = t_render_flow(cam(jc), cam(jc2), tgs.replace_params(params), td1, td2, torch.tensor(np.asarray(dr)),
                         max_per_tile=512)
    loss = (tout["render"] * torch.tensor(np.asarray(wr))).sum() + (tout["alpha"] * torch.tensor(np.asarray(wa))).sum()
    tg = grad_tree(loss, (params, td1, td2))

    for k, tol in (("render", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tout["radii"].detach().numpy(), np.asarray(jout["radii"]))
    assert int(tout["overflow_tiles"]) == int(tout["overflow_rect"]) == 0
    flow = np.asarray(jout["render"])[..., :2]
    assert (flow > 1e-3).any() and (flow < -1e-3).any()  # signed colours
    for name, a, b in [(f"d {k}", jg[0][k], tg[0][k]) for k in jg[0]] + [("d d_xyz1", jg[1], tg[1]),
                                                                         ("d d_xyz2", jg[2], tg[2])]:
        a = np.asarray(a)
        s = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b.numpy() / s, a / s, err_msg=name, **GRAD_TOL)
    assert float(np.abs(np.asarray(jg[2])).max()) > 0 and float(np.abs(np.asarray(jg[0]["xyz"])).max()) > 0


def test_flow_step_without_a_partner_equals_the_step_without_flow(tmp_path):
    """A flow-scene step that drew no partner (zero flow and validity) takes
    the step that has no flow term, bit for bit: the one signature of a
    flow run costs a render, never a change of the result."""
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(300, 3)) * [0.25, 0.4, 0.1]).astype(np.float32)
    tcfg = TConfig()
    tcfg.model.capacity, tcfg.model.node_num, tcfg.model.hyper_dim, tcfg.model.gs_with_motion_mask = 320, 24, 2, True
    scene = TScene(pts, rng.uniform(size=(300, 3)).astype(np.float32))
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, 2.0]), 64, 64, fovx=0.9, fovy=0.9)
    tf = frame_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), 0.3, 64, 64,
                          rng.uniform(size=(64, 64, 3)).astype(np.float32),
                          alpha_mask=(rng.uniform(size=(64, 64)) < 0.5).astype(np.float32), device="cpu")
    store = TFlow.FlowStore(tmp_path, ["none"], [0.0], [(64, 64)], device="cpu")
    fl, fm, pfid = store.no_partner(tf)
    kw = dict(it=5000, use_motion_loss=True, max_per_tile=512)
    arap_t = torch.tensor([0.2, 0.7])
    state = lambda: TS1.init_stage1(scene, tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    a, ma = TS1.make_phase_b_auto(tcfg)(state(), tf, torch.zeros(3), arap_t, **kw)
    b, mb = TS1.make_phase_b_auto(tcfg)(state(), dataclasses.replace(tf, flow=fl, flow_mask=fm, flow_partner_fid=pfid),
                                        torch.zeros(3), arap_t, use_flow_loss=True, **kw)
    assert float(mb["flow"]) == 0.0 and float(ma["loss"]) == float(mb["loss"])
    for k, v in a.gs.params_dict().items():
        assert torch.equal(v, b.gs.params_dict()[k]), k
    for x, y in zip(jax.tree_util.tree_leaves(_skel_ref_layout(a.warp.params_dict())),
                    jax.tree_util.tree_leaves(_skel_ref_layout(b.warp.params_dict()))):
        np.testing.assert_array_equal(x, y)


def _flow_cfg(cls):
    """Phase B alone (no phase-A step), 8 steps on plain windows: the flow
    term from the warm-up's end (it 2), chamfer and the motion loss on, no
    densification, node event or opacity reset."""
    cfg = cls()
    m, o, p = cfg.model, cfg.opt, cfg.pipe
    m.capacity, m.node_num, m.sh_degree, m.hyper_dim = 512, 24, 1, 2
    p.max_per_tile = 256
    o.iterations_node_rendering, o.iterations, o.warm_up = 0, 8, 2
    o.densify_from_iter, o.node_force_densify_prune_step, o.opacity_reset_interval = 100, 100, 100
    return cfg


def _flow_init(init):
    """``init`` with the Gaussians' opacity raised from 0.1 to about 0.94, so
    that the flow render is solid (alpha > 0.9) where they overlap, and Adam
    moments at count 5 (seeded) for the Gaussians and the warp."""
    def wrapped(*a, **k):
        st = init(*a, **k)
        gs = st.gs.replace_params(dict(st.gs.params_dict(), opacity=st.gs.opacity + 5.0))
        rng = np.random.default_rng(9)
        opt = lambda p: JO.AdamState(mu=_moments(rng, p, 1e-3), nu=_second_moments(rng, p), count=jnp.int32(5))
        return dataclasses.replace(st, gs=gs, opt_gs=opt(gs.params_dict()), opt_warp=opt(st.warp.params_dict()))
    return wrapped


def _recording(cls, name, log, convert):
    real = getattr(cls, name)

    def rec(self, i, *a, **k):
        out = real(self, i, *a, **k)
        log.append((i, convert(out)))
        return out
    return mock.patch.object(cls, name, rec)


@pytest.fixture(scope="module")
def flow_loops(tmp_path_factory):
    root = tmp_path_factory.mktemp("flow_scene")
    _, jscene = JSyn.make_scene_data(n_train=6, n_test=1, width=64, height=64, max_thinned=128, n_init_points=200)
    names = [f"r_{i:03d}" for i in range(6)]
    jscene = dataclasses.replace(jscene, white_background=True, train_image_names=names)
    write_flow_files(root, names, (32, 32), seed=1)
    key = jax.random.PRNGKey(SEED)
    key, ik = jax.random.split(key)
    init = _flow_init(JS1.init_stage1)
    j0 = init(ik, jscene, _flow_cfg(JConfig))
    out = {"partners": {}, "picks": {}}
    pfid = lambda r: None if r is None else float(r[2])
    for who in ("j", "t"):
        picks, partners = [], []
        samp = JSampling.FrameSampler if who == "j" else TSampling.FrameSampler
        store = JFlow.FlowStore if who == "j" else TFlow.FlowStore
        with _recording(samp, "sample", picks, lambda x: x), _recording(store, "sample", partners, pfid):
            if who == "j":
                with contextlib.redirect_stdout(io.StringIO()), mock.patch.object(JS1, "init_stage1", init):
                    out["jstate"], out["jhist"] = JS1.train_stage1(jscene, _flow_cfg(JConfig), seed=SEED, log_every=1,
                                                                   source_path=str(root))
            else:
                tscene = dataclasses.replace(_port_scene(jscene), train_image_names=names)
                events = []
                out["tstate"], out["thist"] = TS1.train_stage1(
                    tscene, _flow_cfg(TConfig), seed=SEED, log_every=1, source_path=str(root),
                    state=_port_state(j0), draws=JaxDraws(key), events=events, device="cpu")
                out["events"] = events
        out["picks"][who], out["partners"][who] = picks, partners
    return out


def test_train_stage1_flow_picks_and_partners_match(flow_loops):
    """The same frame picks and flow partners: the flow draws share the
    frame sampler's generator, one draw per flow step after the frame's."""
    r = flow_loops
    assert r["picks"]["t"] == r["picks"]["j"] and len(r["picks"]["t"]) == 8
    assert r["partners"]["t"] == r["partners"]["j"] and len(r["partners"]["t"]) == 6  # it 2..7
    drew = sum(p is not None for _, p in r["partners"]["t"])
    assert drew >= 3
    assert [e for e in r["events"] if e["event"] == "flow"] == [dict(phase="B", it=8, event="flow", partners=drew)]
    assert not [e for e in r["events"] if "overflow" in e["event"]]


def test_train_stage1_flow_losses_and_parameters_match(flow_loops):
    r = flow_loops
    jh, th = r["jhist"], r["thist"]
    assert [(p, it) for p, it, _ in th] == [(p, it) for p, it, _ in jh] == [("B", i) for i in range(8)]
    for (_, it, jm), (_, _, tm) in zip(jh, th):
        assert set(jm) <= set(tm) and "flow" in jm
        for k in ("loss", "flow", "psnr", "arap", "chamfer"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=f"{k} at it {it}")
    assert max(m["flow"] for _, it, m in jh if it >= 2) > 0
    js, ts = r["jstate"], r["tstate"]
    np.testing.assert_array_equal(ts.gs.alive.numpy(), np.asarray(js.gs.alive))
    for k, v in js.gs.params_dict().items():
        np.testing.assert_allclose(ts.gs.params_dict()[k].numpy(), np.asarray(v), atol=1e-4, rtol=0, err_msg=k)
    port = dict(jax.tree_util.tree_flatten_with_path(_skel_ref_layout(ts.warp.params_dict()))[0])
    for path, a in jax.tree_util.tree_flatten_with_path(_np(js.warp.params_dict()))[0]:
        np.testing.assert_allclose(port[path], a, atol=1e-4, rtol=0, err_msg=jax.tree_util.keystr(path))
