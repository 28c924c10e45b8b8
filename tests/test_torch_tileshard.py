"""The tile-parallel path of the port (riggs_tpu_torch/parallel/) on two
gloo ranks on the CPU, against riggs_tpu's.

One job of two spawned processes (gloo, a file store in a temporary
directory: no port to race other test processes for) runs
every two-rank case once: ``rasterize_tile_sharded`` on a 1 x 2 mesh at
128 x 128 and at 96 x 96 (9 tiles, padded to 10), one
``make_dp_stage2_step`` at 1 x 2 (tile-parallel, B = 1) and one at 2 x 1
(B = 2) on the stage-2 scene of tests/test_torch_stage2_step.py, and two
runs of ``train_stage2_dp``: three iterations at 1 x 2 (the warm-up step,
then the unlock with its FPS reset) and six at 2 x 1 with the tile ladder on
(three steps of B = 2: the warm-up, the unlock, and a step on the ladder
that the policy fitted from the first two steps' (B, T) tile counts; the
policy's probe is cut from 12 steps to 2 in both packages). Each rank saves
what it computed; this process computes every reference result while the
ranks run, and the tests hold the ranks' results to the reference and the
ranks to each other.

Tolerances: the sharded frame against riggs_tpu's
``rasterize_tile_sharded`` on ``make_mesh(1, 2)``: image and alpha 3e-5,
the slice's bound for the port's blend against the Pallas kernel in
interpret mode (tests/test_torch_slice.py; 4.1e-6 here); its gradient of
means3d 1e-6, as tests/test_shard_render.py holds the reference's sharded
render to its own single-device one (2.9e-9 here, of 1.3e-2); the port's sharded frame against its own single-device
frame: bitwise (the forward's out and tentry of a shard are the rows of the
full call), its gradient 1e-6 (the plain backward batches its products
over the active tiles, and the CPU's sums round with the batch). A dp step
against riggs_tpu's step on a mesh of the same shape: parameters and Adam
moments after the step 1e-5, statistics 1e-5 / rtol 1e-4, the loss 1e-5,
as tests/test_torch_stage2_step.py holds the single-device step. A loop
against riggs_tpu's ``train_stage2_dp`` on a mesh of the same shape from
the same state and frames: the frame draws, the FPS indices and the fitted
ladder exactly equal, the state and the logged losses within the dp step's
tolerances. Every rank's state bitwise equal to rank 0's.
"""
import contextlib
import copy
import dataclasses
import datetime
import hashlib
import tempfile
import time
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from riggs_tpu_torch.parallel.mesh import make_mesh
from riggs_tpu_torch.parallel.render import rasterize_tile_sharded
from riggs_tpu_torch.parallel.stage2_dp import train_stage2_dp
from riggs_tpu_torch.parallel.train import make_dp_stage2_step, stack_frames, stage2_flags
from riggs_tpu_torch.render.tiles import rasterize_tiled

LRS_GS = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05, "scaling": 1e-3, "rotation": 1e-3,
          "feature": 2.5e-3}
FLAGS = dict(warm=False, active_sh=3, enable_to=True, enable_sm=True)
UIDS = (2, 1)  # the batch's frames (B = 2 takes both)
LOOP_STEPS = 3  # train_stage2_dp's iterations at 1 x 2
LADDER_LOOP_STEPS = 6  # and at 2 x 1 (three steps of B = 2)
N_PROBE = 2  # the ladder policy's probe steps in the loops


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This process's torch ops on one intra-op thread, as
    tests/test_torch_stage1_loop.py's fixture (not imported: the spawned
    ranks import this module, and that one imports jax)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def state_leaves(state) -> dict:
    """Every tensor of a Stage2State by path (the skeleton's in its
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

    put("gs", state.gs.params_dict())
    put("skel", state.skel.params_dict())
    for name in ("opt_gs", "opt_skel"):
        opt = getattr(state, name)
        put(f"{name}.mu", opt.mu)
        put(f"{name}.nu", opt.nu)
        put(f"{name}.count", opt.count)
    put("stats", list(dataclasses.astuple(state.stats_gs)))
    put("proj_loss", state.proj_loss)
    put("it", state.it)
    return out


def leaves_hash(leaves: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(leaves):
        h.update(k.encode())
        h.update(np.ascontiguousarray(leaves[k]).tobytes())
    return h.hexdigest()


def _render_case(mesh, case):
    """The sharded frame and d mean(image) / d means3d, and the same of the
    single-device rasterize_tiled."""
    res = {}
    for name, fn in (("sharded", lambda m: rasterize_tile_sharded(mesh, case["cam"], m, *case["rest"],
                                                                   max_per_tile=256)),
                     ("single", lambda m: rasterize_tiled(case["cam"], m, *case["rest"], max_per_tile=256))):
        means = case["means"].clone().requires_grad_(True)
        out = fn(means)
        (g,) = torch.autograd.grad(out["image"].mean(), means)
        res[name] = {k: out[k].detach().numpy() for k in ("image", "alpha", "depth")}
        res[name]["grad"] = g.numpy()
    return res


def _dp_step(mesh, p, B, tile_parallel):
    state = copy.deepcopy(p["state"])
    step = make_dp_stage2_step(mesh, use_chamfer=True, max_per_tile=512, tile_parallel=tile_parallel)
    uids = np.array(UIDS[:B])
    new, m = step(state, stack_frames([p["frames"][u] for u in uids]), uids, torch.zeros(3), LRS_GS, 1e-4,
                  p["pre_d_xyz"][uids], p["pre_d_joints"][uids], np.ones(B, np.float32), np.zeros(B, np.float32),
                  stage2_flags(**FLAGS))
    return {"state": new, "metrics": m, "hash": leaves_hash(state_leaves(new))}


@contextlib.contextmanager
def few_probes(policy_cls):
    """``policy_cls`` (either package's LadderPolicy) fits its ladder after
    N_PROBE observations; yields the list of the policies made."""
    made, real_init = [], policy_cls.__init__

    def init(self_, *a, **k):
        real_init(self_, *a, **dict(k, n_probe=N_PROBE))
        made.append(self_)

    with mock.patch.object(policy_cls, "__init__", init):
        yield made


def run_loop(mesh, p, ladder=False):
    """train_stage2_dp from the prebuilt state: LOOP_STEPS iterations, or
    LADDER_LOOP_STEPS with the tile ladder on."""
    from riggs_tpu_torch.render.ladder import LadderPolicy
    from riggs_tpu_torch.train.sampling import FrameSampler

    events, picks = [], []
    real_sample = FrameSampler.sample

    def sample(self_, *a, **k):
        picks.append(real_sample(self_, *a, **k))
        return picks[-1]

    with few_probes(LadderPolicy), mock.patch.object(FrameSampler, "sample", sample):
        state, _, hist = train_stage2_dp(None, p["scene"], p["cfg_ladder" if ladder else "cfg"], mesh,
                                         init=(copy.deepcopy(p["state"]), p["info"], p["frames"]),
                                         log_every=1, events=events, device="cpu")
    return {"state": state, "history": hist, "events": events, "picks": picks,
            "hash": leaves_hash(state_leaves(state))}


def _worker(rank, world, payload, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from riggs_tpu_torch.render import blend

        tile, data = make_mesh(1, 2), make_mesh(2, 1)
        res = {"render": {k: _render_case(tile, c) for k, c in payload["render"].items()}}
        blend.reset_launches()
        res["dp_1x2"] = _dp_step(tile, payload, 1, tile_parallel=True)
        res["plain_bwd_calls"] = dict(blend.plain_bwd_calls)
        res["dp_2x1"] = _dp_step(data, payload, 2, tile_parallel=False)
        res["loop_1x2"] = run_loop(tile, payload)
        blend.reset_launches()
        res["loop_2x1_ladder"] = run_loop(data, payload, ladder=True)
        res["loop_2x1_plain_bwd_calls"] = dict(blend.plain_bwd_calls)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's side and the shared inputs (jax is imported here only: the
# spawned ranks import this module without it)
# ---------------------------------------------------------------------------


def _render_inputs():
    import jax.numpy as jnp

    from riggs_tpu.camera import make_camera as jmake_camera
    from riggs_tpu_torch import convert
    from tests.test_render import make_scene

    scene = make_scene(np.random.default_rng(0), n=300)
    cases = {}
    for size in (128, 96):
        jc = jmake_camera(np.eye(3), np.array([0, 0, 3.0]), size, size, fovx=1.0, fovy=1.0)
        tc = convert.camera_from_numpy(np.asarray(jc.w2c), np.asarray(jc.intrinsics), 0.0, size, size, device="cpu")
        bg = np.array([0.1, 0.2, 0.3], np.float32)
        t = [torch.as_tensor(np.array(a)) for a in scene]
        cases[size] = dict(jcam=jc, jscene=scene, jbg=jnp.asarray(bg), cam=tc, means=t[0],
                           rest=(t[1], t[2], t[3], t[4], torch.as_tensor(bg)))
    return cases


def loop_cfg(cls, ladder=False):
    """The loops' configuration in either package: the warm-up's one step,
    the unlock at 2, no densification; with ``ladder`` the tile ladder on
    for LADDER_LOOP_STEPS iterations, else off for LOOP_STEPS."""
    cfg = cls()
    o = cfg.opt
    o.iterations_stage2 = LADDER_LOOP_STEPS if ladder else LOOP_STEPS
    o.skeleton_warm_up, o.optimize_template_offsets_iters = 1, 2
    o.densify_until_iter = 0
    o.progressive_train = False
    cfg.pipe.max_per_tile = 512
    cfg.pipe.use_tile_ladder = ladder
    cfg.model.use_template_offsets = cfg.model.use_skinning_weight_mlp = True
    cfg.model.skeleton_gs_sample_num = 64
    return cfg


def _stage2_inputs():
    """The stage-2 scene of tests/test_torch_stage2_step.py in both
    packages: the state (the port's: each use takes a copy, as a step
    updates the skeleton's module in place), four frames (uid u is
    frames[u], at t = 0, 0.6, 0.3, 0.9), the deformations, and the loops'
    scene, info and configurations."""
    import jax.numpy as jnp

    import tests.test_torch_stage2_step as T2
    from riggs_tpu.data.dataset import SceneData as JSceneData
    from riggs_tpu.train.config import Config as JConfig
    from riggs_tpu.train.stage2 import PretrainInfo as JPretrainInfo
    from riggs_tpu_torch.data.dataset import SceneData
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage2 import PretrainInfo
    from tests.test_torch_slice import PARENTS

    setup = T2.setup.__wrapped__()
    js, jf = setup["jstate"], setup["jframe"]
    jframes = [dataclasses.replace(jf, cam=dataclasses.replace(jf.cam, fid=jnp.float32(t))) for t in (0.0, 0.6)]
    jframes.insert(2, jf)
    jframes.append(dataclasses.replace(jf, cam=dataclasses.replace(jf.cam, fid=jnp.float32(0.9))))
    frames = [T2._port_frame(f) for f in jframes]
    rest = dict(template_idx=T2.UID, joints=np.asarray(js.skel.joints), parents=np.asarray(PARENTS),
                joint_node_indices=np.arange(len(PARENTS)))
    info = PretrainInfo(d_xyz=torch.as_tensor(setup["pre_d_xyz"]), d_joints=torch.as_tensor(setup["pre_d_joints"]),
                        **rest)
    jinfo = JPretrainInfo(d_xyz=setup["pre_d_xyz"], d_joints=setup["pre_d_joints"], **rest)
    points = (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32))
    scene = SceneData(*points, train_frames=frames, cameras_extent=1.0)
    jscene = JSceneData(train_frames=jframes, test_frames=[], init_points=points[0], init_colors=points[1],
                        cameras_extent=1.0)
    port = dict(state=T2._port_state(js), frames=frames, pre_d_xyz=info.d_xyz, pre_d_joints=info.d_joints, info=info,
                scene=scene, cfg=loop_cfg(Config), cfg_ladder=loop_cfg(Config, ladder=True))
    ref = dict(jstate=js, jframes=jframes, setup=setup, info=jinfo, scene=jscene, cfg=loop_cfg(JConfig),
               cfg_ladder=loop_cfg(JConfig, ladder=True))
    return ref, port


@pytest.fixture(scope="module")
def inputs():
    render = _render_inputs()
    ref, port = _stage2_inputs()
    port["render"] = {k: {n: c[n] for n in ("cam", "means", "rest")} for k, c in render.items()}
    return dict(render=render, ref=ref, port=port)


@pytest.fixture(scope="module")
def ranks_job(inputs, tmp_path_factory):
    """Start the two-rank job (it runs while this process computes the
    reference's side); (the processes, their directory)."""
    out = tmp_path_factory.mktemp("tileshard")
    ctx = mp.start_processes(_worker, args=(2, inputs["port"], str(out)), nprocs=2, join=False,
                             start_method="spawn")
    yield ctx, out
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def reference(inputs, ranks_job):
    """Every reference result of the file, computed while the ranks run:
    the sharded frames and their gradients, the dp steps and the loops."""
    out = {"render": {size: _reference_render(inputs, size) for size in (128, 96)}}
    for shape in ((1, 2), (2, 1)):
        out[shape] = _reference_dp_step(inputs, shape)
    out["loop_1x2"] = _reference_loop(inputs, (1, 2), ladder=False)
    out["loop_2x1_ladder"] = _reference_loop(inputs, (2, 1), ladder=True)
    return out


@pytest.fixture(scope="module")
def ranks(ranks_job, reference):
    """Wait for the two-rank job; each rank's saved results."""
    ctx, out = ranks_job
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two gloo ranks did not finish in 240 s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@contextlib.contextmanager
def one_rank_mesh():
    """A 1 x 1 mesh over a one-rank gloo default group in this process (a
    file store: no port to race other test processes for)."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            yield make_mesh(1, 1)
        finally:
            dist.destroy_process_group()


def _reference_render(inputs, size):
    """riggs_tpu's rasterize_tile_sharded on make_mesh(1, 2) and its
    gradient of mean(image) in the means."""
    import jax
    import jax.numpy as jnp

    from riggs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from riggs_tpu.parallel.render import rasterize_tile_sharded as j_sharded

    c = inputs["render"][size]
    mesh = j_make_mesh(data=1, tile=2)
    means, colors, opacity, scales, rots = c["jscene"]
    ref = j_sharded(mesh, c["jcam"], means, colors, opacity, scales, rots, c["jbg"], max_per_tile=256)
    g_ref = jax.grad(lambda m: jnp.mean(j_sharded(mesh, c["jcam"], m, colors, opacity, scales, rots, c["jbg"],
                                                  max_per_tile=256)["image"]))(means)
    return {"image": np.asarray(ref["image"]), "alpha": np.asarray(ref["alpha"]), "grad": np.asarray(g_ref)}


@pytest.mark.parametrize("size", [128, 96])
def test_tile_sharded_render_matches_reference(reference, ranks, size):
    ref = reference["render"][size]
    got = ranks[0]["render"][size]["sharded"]
    np.testing.assert_allclose(got["image"], ref["image"], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["alpha"], ref["alpha"], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["grad"], ref["grad"], rtol=0, atol=1e-6)
    assert float(np.abs(got["grad"]).max()) > 1e-3
    for k, v in got.items():  # both ranks hold the whole frame and gradient
        assert np.array_equal(ranks[1]["render"][size]["sharded"][k], v), k


@pytest.mark.parametrize("size", [128, 96])
def test_tile_sharded_frame_is_the_single_device_frame(ranks, size):
    got, single = ranks[0]["render"][size]["sharded"], ranks[0]["render"][size]["single"]
    for k in ("image", "alpha", "depth"):
        assert np.array_equal(got[k].view(np.int32), single[k].view(np.int32)), k
    np.testing.assert_allclose(got["grad"], single["grad"], rtol=0, atol=1e-6)


def _reference_dp_step(inputs, shape):
    """riggs_tpu's make_dp_stage2_step on make_mesh(*shape), one step of
    B = the data size from the shared state."""
    import jax
    import jax.numpy as jnp

    from riggs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from riggs_tpu.parallel.train import make_dp_stage2_step as j_step
    from riggs_tpu.parallel.train import stack_frames as j_stack
    from riggs_tpu.parallel.train import stage2_flags as j_flags

    ref = inputs["ref"]
    B = shape[0]
    step = j_step(j_make_mesh(*shape), use_chamfer=True, max_per_tile=512, tile_parallel=shape[1] > 1)
    uids = np.array(UIDS[:B])
    s = ref["setup"]
    return step(ref["jstate"], j_stack([ref["jframes"][u] for u in uids]), jnp.asarray(uids, jnp.int32),
                jnp.zeros(3), jax.tree.map(jnp.float32, LRS_GS), jnp.float32(1e-4),
                jnp.asarray(s["pre_d_xyz"][uids]), jnp.asarray(s["pre_d_joints"][uids]),
                jnp.ones(B, jnp.float32), jnp.zeros(B, jnp.float32), j_flags(**FLAGS))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2_tile_parallel", "2x1_data_parallel"])
def test_dp_stage2_step_matches_reference(reference, ranks, shape):
    import tests.test_torch_stage2_step as T2

    jnew, jm = reference[shape]
    name = f"dp_{shape[0]}x{shape[1]}"
    got = ranks[0][name]
    T2._assert_step(jnew, jm, got["state"], got["metrics"], warm=False)
    assert ranks[1][name]["hash"] == got["hash"]
    if shape[1] > 1:  # the blend's backward ran through the offset entry only
        calls = ranks[0]["plain_bwd_calls"]
        assert calls["blend_cm_offset_bwd"] > 0 and calls["blend_cm_bwd"] == 0


class _Record:
    """The reference loop's frame picks and FPS indices."""

    def __init__(self):
        from riggs_tpu.parallel import stage2_dp as JDP
        from riggs_tpu.train.sampling import FrameSampler

        self.picks, self.fps = [], []
        real_sample, real_fps = FrameSampler.sample, JDP.farthest_point_sample

        def sample(self_, *a, **k):
            self.picks.append(real_sample(self_, *a, **k))
            return self.picks[-1]

        def fps(*a, **k):
            self.fps.append(np.asarray(real_fps(*a, **k)))
            return self.fps[-1]

        self.patches = [mock.patch.object(FrameSampler, "sample", sample),
                        mock.patch.object(JDP, "farthest_point_sample", fps)]

    def __enter__(self):
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def _reference_loop(inputs, shape, ladder):
    """riggs_tpu's train_stage2_dp on a mesh of ``shape`` from the same
    state and frames, with its frame picks and FPS indices."""
    from riggs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from riggs_tpu.parallel.stage2_dp import train_stage2_dp as j_loop
    from riggs_tpu.render.ladder import LadderPolicy as JLadderPolicy

    ref = inputs["ref"]
    with few_probes(JLadderPolicy) as policies, _Record() as rec, contextlib.redirect_stdout(None):
        state, _, hist = j_loop(None, ref["scene"], ref["cfg_ladder" if ladder else "cfg"], j_make_mesh(*shape),
                                init=(ref["jstate"], ref["info"], ref["jframes"]), log_every=1)
    rec.ladders = [p.ladder for p in policies]
    return state, hist, rec


def _assert_loop(jstate, jhist, rec, got, n_steps, B):
    """The port's loop (rank 0's) against the reference's: frame picks and
    FPS indices exactly, the state and the logged losses and PSNRs within
    the dp step's tolerances."""
    import tests.test_torch_stage2_step as T2

    ts = got["state"]
    reset = [e for e in got["events"] if e["event"] == "fps reset"]
    assert len(reset) == len(rec.fps) == 1
    np.testing.assert_array_equal(reset[0]["idx"].numpy(), rec.fps[0])
    assert got["picks"] == rec.picks and len(rec.picks) == n_steps and len(set(rec.picks)) > 1
    T2._assert_tree(jstate.gs.params_dict(), {k: v.numpy() for k, v in ts.gs.params_dict().items()}, "gs",
                    atol=1e-5, rtol=0)
    T2._assert_tree(jstate.skel.params_dict(), T2._skel_ref_layout(ts.skel.params_dict()), "skel", atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.skel.control_nodes.numpy(), np.asarray(jstate.skel.control_nodes), atol=1e-5,
                               rtol=0)
    for name, a, b in (("opt_gs", jstate.opt_gs, ts.opt_gs), ("opt_skel", jstate.opt_skel, ts.opt_skel)):
        conv = (lambda t: {k: v.numpy() for k, v in t.items()}) if name == "opt_gs" else T2._skel_ref_layout
        T2._assert_tree(a.mu, conv(b.mu), f"{name}.mu", atol=1e-5, rtol=0)
        T2._assert_tree(a.nu, conv(b.nu), f"{name}.nu", atol=1e-5, rtol=0)
        assert int(a.count) == int(b.count), name
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(ts.stats_gs, k).numpy(), np.asarray(getattr(jstate.stats_gs, k)),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ts.proj_loss.numpy(), np.asarray(jstate.proj_loss), atol=1e-5, rtol=0)
    assert int(ts.it) == int(jstate.it) == n_steps
    assert [it for it, _ in got["history"]] == [it for it, _ in jhist] == list(range(0, n_steps, B))
    for (_, a), (_, b) in zip(got["history"], jhist):
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-6, err_msg=k)


def test_train_stage2_dp_tile_parallel_matches_reference(reference, ranks):
    """LOOP_STEPS iterations at 1 x 2 (the warm-up step, then the unlock
    with its FPS reset) against riggs_tpu's loop on make_mesh(1, 2); both
    ranks' states bitwise equal."""
    got = ranks[0]["loop_1x2"]
    assert ranks[1]["loop_1x2"]["hash"] == got["hash"]
    assert [e["event"] for e in got["events"]] == ["fps reset"]
    jstate, jhist, rec = reference["loop_1x2"]
    _assert_loop(jstate, jhist, rec, got, LOOP_STEPS, 1)


def test_train_stage2_dp_data_parallel_ladder_matches_reference(reference, ranks):
    """LADDER_LOOP_STEPS iterations at 2 x 1 with the tile ladder on (the
    ladder fitted from the first two steps' (B, T) tile counts, the last
    step on it) against riggs_tpu's loop on make_mesh(2, 1); both ranks'
    states bitwise equal."""
    got = ranks[0]["loop_2x1_ladder"]
    assert ranks[1]["loop_2x1_ladder"]["hash"] == got["hash"]
    fits = [e for e in got["events"] if e["event"] == "ladder fit"]
    assert [e["event"] for e in got["events"]] == ["fps reset", "ladder fit"] and fits[0]["it"] == 2
    calls = ranks[0]["loop_2x1_plain_bwd_calls"]
    # two steps on plain windows, the last on the ladder's buckets
    assert calls["blend_cm_bwd"] == 2 and calls["blend_permuted_gm_bwd"] > 0, calls
    jstate, jhist, rec = reference["loop_2x1_ladder"]
    assert rec.ladders == [fits[0]["ladder"]]
    _assert_loop(jstate, jhist, rec, got, LADDER_LOOP_STEPS, 2)
