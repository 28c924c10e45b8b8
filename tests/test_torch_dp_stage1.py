"""The frame-parallel stage-1 and static paths of the port
(riggs_tpu_torch/parallel/train.py: make_dp_stage1_step,
make_dp_static_step; riggs_tpu_torch/parallel/stage1_dp.py:
train_stage1_dp) on two gloo ranks on the CPU, against riggs_tpu's.

One job of two spawned processes (gloo, a file store in a temporary
directory) runs every two-rank case once on a 2 x 1 mesh and saves each
rank's results, started as soon as its inputs are there, while this process
computes the reference's steps and a third process the reference's loops:
  * make_dp_stage1_step, three steps of B = 2 on the phase-B scene of
    tests/test_torch_stage1_step.py (four frames at t = 0, 0.6, 0.3, 0.9,
    chamfer and the motion-mask loss on, laddered windows off), without
    and with the optical-flow term (the t = 0.3 frame carries a flow to a
    partner at t = 0.55 and weighs it 0.5; the others zero flow, weight
    0), the ARAP sample times each frame's draw from the reference's keys;
  * make_dp_static_step, three steps of B = 2 (the frame and its image
    flipped upside down);
  * train_stage1_dp from riggs_tpu's init_stage1 on make_scene_data (six
    64 x 64 frames, white background), 20 iterations (ten steps of B = 2)
    under which every event fires: the forced node densify/prune (it 4),
    the ladder fit after LadderPolicy's probe (cut to N_PROBE steps in
    both packages), a Gaussian densification (12) and an opacity reset
    (8, 16); its draws replay the reference's key chain (a split a step,
    split again over the batch for the frames' ARAP draws, a split a
    densification).

Tolerances: a dp step's parameters and Adam moments after the three steps
1e-5, the statistics 1e-5 / rtol 1e-4, the losses and PSNRs 1e-5 / rtol
1e-5, the tile counts exactly, as tests/test_torch_stage1_step.py holds the
single-device step. The loop: frame picks, alive masks, node counts and
the ladder exactly equal; each parameter leaf and the loss and PSNR
histories within three times the reference's own spread plus 1e-6, as
tests/test_torch_stage1_loop.py measures it (the reference's loop twice
more with its DeformNetwork's weights changed in the last bit). Both ranks'
states bitwise equal (a hash of every leaf); the 2 x 1 state within 1e-6 of
each leaf's largest |value| of three B = 2 steps on a one-rank 1 x 1 mesh
(the same two per-frame gradients, summed over ranks or accumulated by
autograd in one process; bitwise on the card, chip_smoke.py [dp1]).
"""
import copy
import dataclasses
import datetime
import time
from concurrent.futures import ProcessPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from riggs_tpu_torch.parallel.mesh import make_mesh
from riggs_tpu_torch.parallel.stage1_dp import train_stage1_dp
from riggs_tpu_torch.parallel.train import make_dp_stage1_step, make_dp_static_step, stack_frames, stage1_flags
from riggs_tpu_torch.train.static import TrainState
from tests.test_torch_tileshard import N_PROBE, few_probes, leaves_hash, one_rank_mesh, one_torch_thread  # noqa: F401

LRS_GS = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05, "scaling": 1e-3, "rotation": 1e-3,
          "feature": 2.5e-3}
LRS_WARP = {"mlp": 8e-4, "nodes": 8e-4, "radius": 8e-4, "weight": 8e-4}
LAMBDAS = (1e-4, 0.1)  # ARAP, motion mask
LAMBDA_FLOW = 0.5
FLOW_UID = 2  # the frame that carries a flow
BATCHES = ((2, 1), (0, 3), (1, 2))  # the dp steps' frames
STATIC_LR = 1e-3
LOOP_ITERS = 20  # train_stage1_dp's iterations: ten steps of B = 2
SEED = 3
STEP_TOL = dict(atol=1e-5, rtol=0)


def stage1_leaves(state) -> dict:
    """Every tensor of a Stage1State by path (the warp's in its
    ``params_dict`` layout), as numpy."""
    out = {}

    def put(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(f"{prefix}.{k}", v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                put(f"{prefix}[{i}]", v)
        else:
            out[prefix] = tree.detach().cpu().numpy().copy()

    for name in ("gs", "node_gs"):
        put(name, getattr(state, name).params_dict())
        put(f"{name}.alive", getattr(state, name).alive)
    put("warp", state.warp.params_dict())
    for name in ("opt_gs", "opt_node", "opt_warp"):
        opt = getattr(state, name)
        put(f"{name}.mu", opt.mu)
        put(f"{name}.nu", opt.nu)
        put(f"{name}.count", opt.count)
    put("stats_gs", list(dataclasses.astuple(state.stats_gs)))
    put("it", state.it)
    return out


def static_leaves(state: TrainState) -> dict:
    out = {f"gs.{k}": v.detach().numpy().copy() for k, v in state.gs.params_dict().items()}
    out.update({f"opt.{m}.{k}": v.numpy().copy() for m in ("mu", "nu") for k, v in getattr(state.opt, m).items()})
    out["opt.count"] = state.opt.count.numpy().copy()
    return out


class ReplayDraws:
    """train_stage1_dp's draws from lists made ahead (the reference's key
    chain, replayed): each step's (B, 2) ARAP sample times, each
    densification's split noise, in the loop's order."""

    def __init__(self, arap, noise):
        self.arap, self.noise = list(arap), list(noise)

    def phase_b_batch(self, n):
        return self.arap.pop(0)

    def split_noise(self, capacity):
        return self.noise.pop(0)


def dp_loop_cfg(cls):
    """The loop's configuration in either package: every event fires within
    LOOP_ITERS iterations of B = 2 (see the module's docstring)."""
    cfg = cls()
    m, o, p = cfg.model, cfg.opt, cfg.pipe
    m.capacity, m.node_num, m.sh_degree, m.hyper_dim = 512, 24, 1, 2
    p.max_per_tile, p.ladder_check_every = 256, 4
    o.iterations, o.warm_up, o.oneupSHdegree_step = LOOP_ITERS, 3, 8
    o.densification_interval, o.densify_from_iter, o.densify_until_iter = 4, 11, 14
    o.node_force_densify_prune_step, o.opacity_reset_interval = 5, 9
    o.densify_grad_threshold, o.percent_dense = 1e-7, 0.02
    return cfg


def _dp_steps(mesh, p, flow):
    """Three make_dp_stage1_step steps of B = 2 from the payload's state."""
    state = copy.deepcopy(p["state"])
    step = make_dp_stage1_step(mesh, use_chamfer=True, use_motion_loss=True, use_flow_loss=flow, max_per_tile=512)
    frames = p["flow_frames" if flow else "frames"]
    metrics = []
    for k, uids in enumerate(BATCHES):
        lam_flow = np.array([LAMBDA_FLOW if flow and u == FLOW_UID else 0.0 for u in uids], np.float32)
        state, m = step(state, stack_frames([frames[u] for u in uids]), torch.zeros(3), LRS_GS, LRS_WARP,
                        p["arap_ts"][k], *LAMBDAS, lam_flow, stage1_flags(warm=False, active_sh=3))
        metrics.append({k2: v.numpy().copy() for k2, v in m.items()})
    return {"state": state, "metrics": metrics, "hash": leaves_hash(stage1_leaves(state))}


def _static_steps(mesh, p):
    state = copy.deepcopy(p["static_state"])
    step = make_dp_static_step(mesh, active_sh=0, max_per_tile=512)
    losses = []
    for _ in BATCHES:
        state, loss = step(state, stack_frames(p["static_frames"]), torch.zeros(3), STATIC_LR)
        losses.append(float(loss))
    leaves = static_leaves(state)
    return {"leaves": leaves, "losses": losses, "hash": leaves_hash(leaves)}


def run_loop(mesh, p):
    """train_stage1_dp from the payload's initial state with the replayed
    draws; its events, history, frame picks and the ladder policy's refits."""
    from riggs_tpu_torch.render.ladder import LadderPolicy
    from riggs_tpu_torch.train.sampling import FrameSampler

    events, picks, calls = [], [], []
    real_sample = FrameSampler.sample

    def sample(self_, *a, **k):
        picks.append(real_sample(self_, *a, **k))
        return picks[-1]

    with few_probes(LadderPolicy) as policies, mock.patch.object(FrameSampler, "sample", sample):
        state, hist = train_stage1_dp(p["scene"], p["loop_cfg"], mesh, seed=SEED, log_every=1,
                                      init=copy.deepcopy(p["loop_state"]), draws=copy.deepcopy(p["draws"]),
                                      events=events, step_callback=lambda st, it: calls.append(it), device="cpu")
    return {"state": state, "history": hist, "events": events, "picks": picks, "calls": calls,
            "refits": policies[0].refits, "ladder": policies[0].ladder, "hash": leaves_hash(stage1_leaves(state))}


def _worker(rank, world, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    try:
        mesh = make_mesh(2, 1)
        res = {"dp": _dp_steps(mesh, payload, flow=False), "dp_flow": _dp_steps(mesh, payload, flow=True),
               "static": _static_steps(mesh, payload), "loop": run_loop(mesh, payload)}
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the shared inputs and the reference's side (jax is imported here only: the
# spawned ranks import this module without it)
# ---------------------------------------------------------------------------


def _reference_keys(n_steps, seed=5):
    """The dp steps' (B, 2) ARAP keys as the reference's loop splits them."""
    import jax

    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_steps):
        key, sk = jax.random.split(key)
        out.append(jax.random.split(sk, 2))
    return out


def _flow_frame(jf, tf, flow_on):
    """The reference frame and the port's with a flow: tests/test_torch_stage1_step.py's
    flow to t = 0.55 where ``flow_on``, else zero flow and validity at the
    frame's own time."""
    import jax.numpy as jnp

    import tests.test_torch_stage1_step as T1

    if flow_on:
        return T1.flow_frames(jf)
    s = T1.SIZE
    jff = dataclasses.replace(jf, flow=jnp.zeros((s, s, 2), jnp.float32), flow_mask=jnp.zeros((s, s), jnp.float32),
                              flow_partner_fid=jf.cam.fid)
    tff = dataclasses.replace(tf, flow=torch.zeros((s, s, 2)), flow_mask=torch.zeros((s, s)),
                              flow_partner_fid=tf.fid.clone())
    return jff, tff


def _step_inputs():
    import jax.numpy as jnp

    import tests.test_torch_stage1_step as T1
    from riggs_tpu.train.static import TrainState as JTrainState
    from tests.test_torch_stage1_modules import _reference_arap_t

    setup = T1.setup.__wrapped__()
    js, jf = setup["jstate"], setup["jframe"]
    jframes = [dataclasses.replace(jf, cam=dataclasses.replace(jf.cam, fid=jnp.float32(t))) for t in (0.0, 0.6)]
    jframes.insert(FLOW_UID, jf)
    jframes.append(dataclasses.replace(jf, cam=dataclasses.replace(jf.cam, fid=jnp.float32(0.9))))
    frames = [T1._port_frame(f) for f in jframes]
    flows = [_flow_frame(jframes[u], frames[u], u == FLOW_UID) for u in range(len(frames))]
    keys = _reference_keys(len(BATCHES))
    ps = T1._port_state(js)
    jflip = dataclasses.replace(jf, image=jf.image[::-1])
    static_j = [jf, jflip]
    port = dict(state=ps, frames=frames, flow_frames=[t for _, t in flows],
                arap_ts=[torch.as_tensor(np.stack([_reference_arap_t(k) for k in ks])) for ks in keys],
                static_state=TrainState(gs=ps.gs, opt=ps.opt_gs, stats=ps.stats_gs),
                static_frames=[T1._port_frame(f) for f in static_j])
    ref = dict(jstate=js, jframes=jframes, jflow_frames=[j for j, _ in flows], keys=keys,
               static_state=JTrainState(gs=js.gs, opt=js.opt_gs, stats=js.stats_gs), static_frames=static_j)
    return ref, port


def _loop_inputs():
    """make_scene_data's scene on white in both packages, the reference's
    init_stage1 state (and the port's copy), the configurations, and the
    port's draws replayed from the reference loop's key chain."""
    import jax

    import tests.test_torch_stage1_step as T1
    from riggs_tpu.data import synthetic as JSyn
    from riggs_tpu.train import stage1 as JS1
    from riggs_tpu.train.config import Config as JConfig
    from riggs_tpu_torch.data.dataset import SceneData
    from riggs_tpu_torch.train.config import Config
    from tests.test_torch_densify import reference_split_noise
    from tests.test_torch_stage1_modules import _reference_arap_t

    _, jscene = JSyn.make_scene_data(n_train=6, n_test=1, width=64, height=64, max_thinned=128, n_init_points=200)
    jscene = dataclasses.replace(jscene, white_background=True)
    jcfg, cfg = dp_loop_cfg(JConfig), dp_loop_cfg(Config)
    j0 = JS1.init_stage1(jax.random.PRNGKey(11), jscene, jcfg)
    o, B = jcfg.opt, 2
    key, arap, noise = jax.random.PRNGKey(SEED), [], []
    for it in range(0, o.iterations, B):
        key, sk = jax.random.split(key)
        arap.append(torch.as_tensor(np.stack([_reference_arap_t(k) for k in jax.random.split(sk, B)])))
        if o.densify_from_iter < it < o.densify_until_iter and (it // B) % max(o.densification_interval // B, 1) == 0:
            key, sk = jax.random.split(key)
            noise.append(reference_split_noise(sk, jcfg.model.capacity))
    scene = SceneData(jscene.init_points, jscene.init_colors, is_blender=jscene.is_blender,
                      train_frames=[T1._port_frame(f) for f in jscene.train_frames],
                      cameras_extent=jscene.cameras_extent, white_background=True)
    port = dict(scene=scene, loop_cfg=cfg, loop_state=T1._port_state(j0), draws=ReplayDraws(arap, noise))
    return dict(jscene=jscene, jcfg=jcfg, j0=j0), port


@pytest.fixture(scope="module")
def inputs(loop_job):
    """The steps' inputs (here) and the loop's (from the reference's
    process, where its loops then run)."""
    ref, port = _step_inputs()
    port.update(loop_job[0].result(timeout=600))
    return dict(ref=ref, port=port)


def _reference_steps(ref, flow):
    import jax
    import jax.numpy as jnp

    from riggs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from riggs_tpu.parallel.train import make_dp_stage1_step as j_step
    from riggs_tpu.parallel.train import stack_frames as j_stack
    from riggs_tpu.parallel.train import stage1_flags as j_flags

    step = j_step(j_make_mesh(2, 1), use_chamfer=True, use_motion_loss=True, use_flow_loss=flow, max_per_tile=512)
    frames = ref["jflow_frames" if flow else "jframes"]
    state, metrics = ref["jstate"], []
    for uids, keys in zip(BATCHES, ref["keys"]):
        lam_flow = jnp.asarray([LAMBDA_FLOW if flow and u == FLOW_UID else 0.0 for u in uids], jnp.float32)
        state, m = step(state, j_stack([frames[u] for u in uids]), jnp.zeros(3), jax.tree.map(jnp.float32, LRS_GS),
                        jax.tree.map(jnp.float32, LRS_WARP), keys, jnp.float32(LAMBDAS[0]), jnp.float32(LAMBDAS[1]),
                        lam_flow, j_flags(warm=False, active_sh=3))
        metrics.append(m)
    return state, metrics


def _reference_static(ref):
    import jax.numpy as jnp

    from riggs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from riggs_tpu.parallel.train import make_dp_static_step as j_static
    from riggs_tpu.parallel.train import stack_frames as j_stack

    step = j_static(j_make_mesh(2, 1), active_sh=0, max_per_tile=512)
    state, losses = ref["static_state"], []
    for _ in BATCHES:
        state, loss = step(state, j_stack(ref["static_frames"]), jnp.zeros(3), jnp.float32(STATIC_LR))
        losses.append(float(loss))
    return state, losses


def _reference_loops(ref):
    """riggs_tpu's train_stage1_dp on make_mesh(2, 1) from the initial
    state, and twice more with its DeformNetwork's weights scaled by
    1 + 2^-23 and 1 - 2^-24: each run's trained leaves (tests/test_torch_stage1_loop.py's
    ``_leaves``), alive masks, node count, history, frame picks, ladder and
    refits, as numpy and Python values."""
    import contextlib

    import jax

    from riggs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from riggs_tpu.parallel.stage1_dp import train_stage1_dp as j_loop
    from riggs_tpu.render.ladder import LadderPolicy as JLadderPolicy
    from riggs_tpu.train.sampling import FrameSampler as JFrameSampler
    from tests.test_torch_stage1_loop import _leaves

    out = []
    for scale in (1.0, 1 + 2.0 ** -23, 1 - 2.0 ** -24):
        w = ref["j0"].warp
        init = dataclasses.replace(ref["j0"], warp=w.replace_params(dict(
            w.params_dict(), mlp=jax.tree.map(lambda x: x * np.float32(scale), w.mlp))))
        picks, real_sample = [], JFrameSampler.sample

        def sample(self_, *a, **k):
            picks.append(real_sample(self_, *a, **k))
            return picks[-1]

        with few_probes(JLadderPolicy) as policies, mock.patch.object(JFrameSampler, "sample", sample), \
                contextlib.redirect_stdout(None):
            state, hist = j_loop(ref["jscene"], ref["jcfg"], j_make_mesh(2, 1), seed=SEED, log_every=1, init=init)
        out.append(dict(leaves=_leaves(state), alive={n: np.asarray(getattr(state, n).alive) for n in ("gs", "node_gs")},
                        node_num=state.warp.node_num, history=hist, picks=picks, ladder=policies[0].ladder,
                        refits=policies[0].refits))
    return out


# the reference's process keeps the loop's inputs between its two tasks
_LOOP_REF = {}


def _reference_loop_inputs():
    """In a process of its own (spawned, with the suite's jax settings):
    the loop's inputs; returns the port's, keeps the reference's."""
    import tests.conftest  # noqa: F401  (jax on the CPU mesh, the compilation cache)

    _LOOP_REF["ref"], lport = _loop_inputs()
    return lport


def _reference_loop_job():
    """In the same process, after ``_reference_loop_inputs``: riggs_tpu's
    three loops."""
    return _reference_loops(_LOOP_REF.pop("ref"))


@pytest.fixture(scope="module")
def loop_job():
    """The reference's loops in a process of their own, started first: the
    loop's inputs (a future of the port's), then the three loops (a future
    of their readings), which run while this process computes the
    reference's steps and the two ranks run theirs."""
    pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    yield pool.submit(_reference_loop_inputs), pool.submit(_reference_loop_job)
    pool.shutdown(cancel_futures=True)


@pytest.fixture(scope="module")
def ranks_job(inputs, tmp_path_factory):
    """Start the two-rank job as soon as its inputs are there; (the
    processes, their directory)."""
    out = tmp_path_factory.mktemp("dp_stage1")
    ctx = mp.start_processes(_worker, args=(2, inputs["port"], str(out)), nprocs=2, join=False, start_method="spawn")
    yield ctx, out
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def reference(inputs, loop_job, ranks_job):
    """The reference's steps (here, while the ranks run) and loops (from
    their process)."""
    ref = inputs["ref"]
    out = {"dp": _reference_steps(ref, flow=False), "dp_flow": _reference_steps(ref, flow=True),
           "static": _reference_static(ref)}
    out["loops"] = loop_job[1].result(timeout=600)
    return out


@pytest.fixture(scope="module")
def ranks(ranks_job, reference):
    """Wait for the two-rank job; each rank's saved results."""
    ctx, out = ranks_job
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two gloo ranks did not finish in 300 s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _assert_stage1_state(jstate, ts, count):
    from tests.test_torch_stage2_step import _assert_tree, _skel_ref_layout

    _assert_tree(jstate.gs.params_dict(), {k: v.numpy() for k, v in ts.gs.params_dict().items()}, "gs", **STEP_TOL)
    _assert_tree(jstate.warp.params_dict(), _skel_ref_layout(ts.warp.params_dict()), "warp", **STEP_TOL)
    for name in ("opt_gs", "opt_warp"):
        a, b = getattr(jstate, name), getattr(ts, name)
        conv = (lambda t: {k: v.numpy() for k, v in t.items()}) if name == "opt_gs" else _skel_ref_layout
        _assert_tree(a.mu, conv(b.mu), f"{name}.mu", **STEP_TOL)
        _assert_tree(a.nu, conv(b.nu), f"{name}.nu", **STEP_TOL)
        assert int(a.count) == int(b.count) == count, name
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(ts.stats_gs, k).numpy(), np.asarray(getattr(jstate.stats_gs, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("flow", [False, True], ids=["no_flow", "flow"])
def test_dp_stage1_step_matches_reference(reference, ranks, flow):
    """Three make_dp_stage1_step steps of B = 2 at 2 x 1 against
    riggs_tpu's on make_mesh(2, 1): the state after them, each step's
    loss, PSNR, overflow and (B, T) tile counts; both ranks' states
    bitwise equal."""
    name = "dp_flow" if flow else "dp"
    jstate, jm = reference[name]
    got = ranks[0][name]
    assert ranks[1][name]["hash"] == got["hash"]
    _assert_stage1_state(jstate, got["state"], count=5 + len(BATCHES))
    for a, b in zip(jm, got["metrics"]):
        np.testing.assert_array_equal(b["tile_counts"], np.asarray(a["tile_counts"]))
        assert int(b["overflow_tiles"]) == int(a["overflow_tiles"]) == 0 and int(b["overflow_rect"]) == 0
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(float(b[k]), float(a[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    if flow:  # the flow term moved the state
        plain = ranks[0]["dp"]["state"].gs.xyz
        assert not torch.equal(plain, got["state"].gs.xyz)


def test_dp_static_step_matches_reference(reference, ranks):
    """Three make_dp_static_step steps of B = 2 at 2 x 1 against
    riggs_tpu's on make_mesh(2, 1): the losses, the Gaussians and the Adam
    state after them; both ranks bitwise equal."""
    from tests.test_torch_stage2_step import _assert_tree

    jstate, jlosses = reference["static"]
    got = ranks[0]["static"]
    assert ranks[1]["static"]["hash"] == got["hash"]
    np.testing.assert_allclose(got["losses"], jlosses, atol=1e-5, rtol=1e-5)
    assert len(set(got["losses"])) == len(BATCHES)
    _assert_tree(jstate.gs.params_dict(), {k[3:]: v for k, v in got["leaves"].items() if k.startswith("gs.")}, "gs",
                 **STEP_TOL)
    for m in ("mu", "nu"):
        _assert_tree(getattr(jstate.opt, m), {k[len(m) + 5:]: v for k, v in got["leaves"].items()
                                               if k.startswith(f"opt.{m}.")}, f"opt.{m}", **STEP_TOL)
    assert int(jstate.opt.count) == int(got["leaves"]["opt.count"]) == 5 + len(BATCHES)


def test_dp_stage1_two_ranks_equal_one_rank_batch(inputs, ranks):
    """The 2 x 1 state after three steps against the same three steps of
    B = 2 on a one-rank 1 x 1 mesh: within 1e-6 of each leaf's largest
    |value| (bitwise on the card)."""
    with one_rank_mesh() as mesh:
        one = _dp_steps(mesh, inputs["port"], flow=False)
    a, b = stage1_leaves(ranks[0]["dp"]["state"]), stage1_leaves(one["state"])
    assert set(a) == set(b)
    bitwise = True
    for k in a:
        scale = max(float(np.abs(b[k]).max()), 1e-30) if b[k].size else 1.0
        assert float(np.abs(a[k].astype(np.float64) - b[k]).max(initial=0.0)) <= 1e-6 * scale, k
        bitwise &= np.array_equal(a[k], b[k])
    print(f"2 x 1 state bitwise equal to one rank's B = 2 steps: {bitwise}")
    for x, y in zip(ranks[0]["dp"]["metrics"], one["metrics"]):
        np.testing.assert_array_equal(x["tile_counts"], y["tile_counts"])
        np.testing.assert_allclose(x["loss"], y["loss"], atol=1e-6, rtol=0)


def test_train_stage1_dp_events_and_discrete_outcomes_match(inputs, reference, ranks):
    """train_stage1_dp at 2 x 1 against riggs_tpu's on make_mesh(2, 1):
    every event fires; frame picks, alive masks, node counts, the ladder
    and its refits exactly equal; both ranks bitwise equal."""
    got, ref = ranks[0]["loop"], reference["loops"][0]
    assert ranks[1]["loop"]["hash"] == got["hash"]
    kinds = [(e["it"], e["event"]) for e in got["events"]]
    for want in [(4, "node densify/prune"), (12, "gs densify"), (8, "opacity reset"), (16, "opacity reset")]:
        assert want in kinds, (want, kinds)
    fits = [e for e in got["events"] if e["event"] == "ladder fit"]
    assert len(fits) == 1 and fits[0]["it"] == 2 * (N_PROBE - 1)
    assert got["calls"] == list(range(0, LOOP_ITERS, 2))
    assert got["picks"] == ref["picks"] and len(got["picks"]) == LOOP_ITERS and len(set(got["picks"])) > 1
    assert got["ladder"] == ref["ladder"] and got["refits"] == ref["refits"]
    ts = got["state"]
    for name in ("gs", "node_gs"):
        np.testing.assert_array_equal(getattr(ts, name).alive.numpy(), ref["alive"][name])
    dens = [e for e in got["events"] if e["event"] in ("node densify/prune", "gs densify")]
    assert all(e["after"] != e["before"] for e in dens), dens
    assert ts.warp.node_num == ref["node_num"] != inputs["port"]["loop_cfg"].model.node_num


def test_train_stage1_dp_parameters_and_history_match(reference, ranks):
    """Each parameter leaf after the loop within three times the
    reference's own spread (its three runs) plus 1e-6; the loss and PSNR
    histories within three times that spread or the dp step's tolerance
    (1e-5, rtol 1e-5), whichever is larger: from an untrained start over
    ten steps a last-bit change moves the reference's losses by less than
    the two packages' float32 rounding of a render. Prints each leaf's
    readings (pytest -s)."""
    from tests.test_torch_stage1_loop import PAIRS, _port_leaves, _spread

    loops = reference["loops"]
    for r in loops[1:]:
        np.testing.assert_array_equal(r["alive"]["gs"], loops[0]["alive"]["gs"])
        assert r["node_num"] == loops[0]["node_num"]
    runs = [r["leaves"] for r in loops]
    port = _port_leaves(ranks[0]["loop"]["state"])
    assert set(port) == set(runs[0])
    bad = {}
    for k, ref in runs[0].items():
        pm, p50 = _spread(port[k], ref)
        sm = max(_spread(runs[i][k], runs[j][k])[0] for i, j in PAIRS)
        s50 = max(_spread(runs[i][k], runs[j][k])[1] for i, j in PAIRS)
        print(f"{k}: port max {pm:.3e} median {p50:.3e}; reference spread max {sm:.3e} median {s50:.3e}")
        if not (pm <= 3 * sm + 1e-6 and p50 <= 3 * s50 + 1e-6):
            bad[k] = (pm, p50, sm, s50)
    assert not bad, bad
    hists = [r["history"] for r in loops]
    th = ranks[0]["loop"]["history"]
    assert [(p, i) for p, i, _ in th] == [(p, i) for p, i, _ in hists[0]] == [("Bdp", i) for i in
                                                                           range(0, LOOP_ITERS, 2)]
    for k in ("loss", "psnr"):
        for t, ((_, it, a), (_, _, b)) in enumerate(zip(hists[0], th)):
            ref_d = max(abs(hists[i][t][2][k] - hists[j][t][2][k]) for i, j in PAIRS)
            assert abs(b[k] - a[k]) <= max(3 * ref_d, 1e-5 + 1e-5 * abs(a[k])), (k, it, a[k], b[k], ref_d)


def test_train_stage1_dp_runs_phase_a_when_given_no_state(tmp_path):
    """Without ``init`` the loop trains phase A in one process: with phase
    B's budget at 0 its state is train_stage1's with ``iterations`` 0, bit
    for bit."""
    from riggs_tpu_torch.data import synthetic as TSyn
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage1 import train_stage1

    _, scene = TSyn.make_scene_data(n_train=3, n_test=1, width=48, height=48, max_thinned=64, n_init_points=120,
                                    device="cpu")
    cfg = Config()
    m, o = cfg.model, cfg.opt
    m.capacity, m.node_num, m.sh_degree, m.hyper_dim = 256, 16, 1, 2
    o.iterations_node_rendering, o.iterations_node_sampling, o.node_warm_up, o.iterations = 4, 2, 1, 0
    o.node_max_num_ratio_during_init = 2
    cfg.pipe.max_per_tile = 256
    with one_rank_mesh() as mesh:
        dp, hist = train_stage1_dp(scene, cfg, mesh, seed=SEED, device="cpu")
    one, _ = train_stage1(scene, cfg, seed=SEED, device="cpu")
    a, b = stage1_leaves(dp), stage1_leaves(one)
    assert hist == [] and set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
