"""The multi-process launch and the sharded checkpoints of the port
(riggs_tpu_torch/parallel/multihost.py, io/checkpoint.py's sharded pair)
and the twins of scripts/multihost_smoke.py and scripts/scaling_bench.py,
on the CPU.

One job of two spawned gloo ranks (a file store in a temporary directory)
runs every two-rank case once and saves each rank's results: the host mesh
at 2 x 1 and 1 x 2 (one host of two ranks), ``host_local_frames`` over
both, ``global_batch`` against ``shard_batch`` of the whole stack, a
stage-2 and a static dp step fed each way, the sharded pair saved from both
ranks (a Stage2State, and a dict with a data-sharded leaf) and loaded on
both, then the multihost twin's ``main`` on both ranks (static and
``--stage2``). The test process meanwhile holds ``host_local_frames``'s
index list to riggs_tpu's, and after the job loads the two-rank
checkpoints on one rank.

Tolerances: none. The index lists, the frames, the batches, the dp states
(hashes of every leaf) and the reloaded leaves are compared bit for bit:
the same draws from the same generator, the same rows, the same sums.
"""
import contextlib
import copy
import dataclasses
import datetime
import io
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from riggs_tpu_torch.data.synthetic import make_scene_data
from riggs_tpu_torch.io import checkpoint as TC
from riggs_tpu_torch.parallel import multihost as MH
from riggs_tpu_torch.parallel.mesh import LocalRows, Mesh, shard_batch
from riggs_tpu_torch.parallel.train import make_dp_static_step, make_dp_stage2_step, stack_frames
from riggs_tpu_torch.train.config import Config
from riggs_tpu_torch.train.stage1 import init_stage1
from scripts import torch_multihost_smoke, torch_scaling_bench
from tests.test_torch_tileshard import leaves_hash, one_rank_mesh, one_torch_thread  # noqa: F401

N_FRAMES = 4  # the tiny scene's train frames
SEED = 7  # host_local_frames' seed in the job
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def _numpy_leaves(tree) -> dict:
    """Every tensor of a stacked Frame (or a dict) by path, as numpy."""
    out = {}

    def put(prefix, a):
        if isinstance(a, torch.Tensor):
            out[prefix] = a.detach().numpy().copy()
        elif isinstance(a, dict):
            for k, v in a.items():
                put(f"{prefix}.{k}", v)
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                put(f"{prefix}.{f.name}", getattr(a, f.name))

    put("", tree)
    return out


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _state_hash(state) -> str:
    return leaves_hash(TC.state_to_numpy(state))


def _static_state(scene):
    from riggs_tpu_torch.models import gaussians as G
    from riggs_tpu_torch.train import optim as O
    from riggs_tpu_torch.train.static import TrainState

    gs = G.create_from_pcd(scene.init_points, scene.init_colors, capacity=256, max_sh_degree=1, device="cpu")
    return TrainState(gs=gs, opt=O.adam_init(gs.params_dict()), stats=G.init_densify_stats(256, device="cpu"))


def _job(rank, out):
    res = {}
    scene, state = torch_scaling_bench.build_tiny_scene(width=32, height=32, n_train=N_FRAMES, device="cpu")
    frames = scene.train_frames
    mesh, mesh_t = MH.make_host_mesh(tile=1), MH.make_host_mesh(tile=2)
    res["meshes"] = [(m.shape, m.data, m.tile) for m in (mesh, mesh_t)]
    # the reference's recipe names one process a host: a tile of two would
    # span the two hosts and raises; a tile of one lays the hosts along data
    jax_env = dict(JAX_COORDINATOR_ADDRESS="localhost:1", JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
    os.environ.update(jax_env)
    try:
        try:
            MH.make_host_mesh(tile=2)
            res["jax_tile2"] = "built"
        except ValueError as e:
            res["jax_tile2"] = str(e)
        m = MH.make_host_mesh(tile=1)
        res["jax_mesh"] = (m.shape, m.data, m.tile)
    finally:
        for k in jax_env:
            del os.environ[k]

    # each rank's frames of two steps' batches of 2, over both meshes
    res["local"] = {}
    for step in (0, 5):
        for name, m in (("2x1", mesh), ("1x2", mesh_t)):
            local, idx = MH.host_local_frames(frames, batch=2, step=step, seed=SEED, mesh=m)
            res["local"][step, name] = ([next(i for i, g in enumerate(frames) if g is f) for f in local],
                                        idx.tolist())

    # global_batch against shard_batch of the whole stack; a stage-2 and a
    # static dp step fed each way
    local, idx = MH.host_local_frames(frames, batch=2, step=0, seed=SEED, mesh=mesh)
    whole = stack_frames([frames[i] for i in idx])
    gb = MH.global_batch(stack_frames(local), mesh)
    res["global_is_shard"] = _same(_numpy_leaves(gb.tree), _numpy_leaves(shard_batch(whole, mesh)))
    res["global_rows"] = (type(gb), gb.data, gb.index)
    step2 = make_dp_stage2_step(mesh, max_per_tile=128, use_chamfer=True)
    _, _, *rest = torch_scaling_bench.dp_stage2_args(state, [frames[i] for i in idx], "cpu")
    fed = {}
    for way, batch in (("global", gb), ("shard", whole)):
        new, m = step2(copy.deepcopy(state), batch, idx, *rest)
        fed[way] = (new, float(m["loss"]))
    res["stage2_hash"] = {k: _state_hash(v[0]) for k, v in fed.items()}
    res["stage2_loss"] = {k: v[1] for k, v in fed.items()}
    stat = make_dp_static_step(mesh, active_sh=1, max_per_tile=128)
    st0 = _static_state(scene)
    res["static"] = {}
    for way, batch in (("global", gb), ("shard", whole)):
        new, loss = stat(copy.deepcopy(st0), batch, torch.zeros(3), 1e-3)
        res["static"][way] = (leaves_hash({k: v.detach().numpy() for k, v in new.gs.params_dict().items()}),
                              float(loss))

    # the sharded pair from both ranks: the new state, and a dict whose "w"
    # is each rank's rows
    new = fed["global"][0]
    TC.save_checkpoint_sharded(out / "ckpt", 3, new, mesh=mesh)
    back, it = TC.load_checkpoint_sharded(out / "ckpt", copy.deepcopy(state), mesh=mesh)
    res["state_back"] = (it, _state_hash(back) == _state_hash(new))
    res["state_hash"] = _state_hash(new)
    w = MH.global_batch(torch.arange(6.0).reshape(2, 3) + 10 * rank, mesh)
    d = {"w": w, "b": torch.ones(5), "count": torch.tensor(3), "empty": torch.zeros((4, 0))}
    written = TC.save_checkpoint_sharded(out / "dict", 7, d, mesh=mesh)
    dback, it = TC.load_checkpoint_sharded(out / "dict", d, mesh=mesh)
    res["dict_back"] = (it, written, _same(_numpy_leaves(dback), _numpy_leaves(d)),
                        isinstance(dback["w"], LocalRows))

    # the multihost twin on both ranks, in the group that exists
    res["twin"] = {}
    for flags in ([], ["--stage2"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            torch_multihost_smoke.main(["--process_id", str(rank), "--device", "cpu", "--out",
                                        str(out / f"twin{len(flags)}")] + flags)
        res["twin"][" ".join(flags) or "static"] = buf.getvalue()
    return res


def _worker(rank, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from pathlib import Path

        torch.save(_job(rank, Path(out)), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Run the two-rank job once: (each rank's results, its directory)."""
    out = tmp_path_factory.mktemp("multihost")
    ctx = mp.start_processes(_worker, args=(2, str(out)), nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two gloo ranks did not finish in 240 s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], out


@pytest.mark.parametrize("n,batch,step,seed", [(5, 2, 0, 0), (5, 4, 9, 7), (3, 8, 1, 0), (30, 6, 123456, 2**40)])
def test_host_local_frames_index_list_matches_reference(n, batch, step, seed):
    """The global index list, with and without replacement, bit for bit
    riggs_tpu's in one process, where both return every frame."""
    from riggs_tpu.parallel.multihost import host_local_frames as j_host_local_frames

    frames = [f"frame{i}" for i in range(n)]
    jl, jidx = j_host_local_frames(frames, batch, step, seed=seed)
    tl, tidx = MH.host_local_frames(frames, batch, step, seed=seed)
    assert tidx.dtype == jidx.dtype and np.array_equal(tidx, jidx)
    assert tl == jl and len(tl) == batch


def test_host_local_frames_splits_by_data_row(job):
    """At 2 x 1 each rank takes its data row's half of the index list; at
    1 x 2 the two ranks are one tile group and both take every frame. A
    group started here is one host; under the reference's recipe (no
    LOCAL_WORLD_SIZE) each process is a host, so a tile of two raises and a
    tile of one is 2 x 1."""
    ranks, _ = job
    for r, res in enumerate(ranks):
        assert res["meshes"] == [({"data": 2, "tile": 1}, r, 0), ({"data": 1, "tile": 2}, 0, r)]
        assert "a tile of 2 must divide the 1 ranks of a host" in res["jax_tile2"]
        assert res["jax_mesh"] == ({"data": 2, "tile": 1}, r, 0)
        for step in (0, 5):
            local, idx = res["local"][step, "2x1"]
            assert idx == ranks[0]["local"][step, "2x1"][1]
            assert local == idx[r:r + 1]
            local_t, idx_t = res["local"][step, "1x2"]
            assert idx_t == idx and local_t == idx
    from riggs_tpu.parallel.multihost import host_local_frames as j_host_local_frames

    _, jidx = j_host_local_frames(list(range(N_FRAMES)), 2, 5, seed=SEED)
    assert ranks[0]["local"][5, "2x1"][1] == jidx.tolist()


def test_global_batch_is_shard_batch_of_the_whole_stack(job):
    """Each rank's global_batch is shard_batch of the whole stack bit for
    bit; the dp stage-2 and static steps fed by it give the states and
    losses they give fed by the whole stack, bit for bit, on both ranks."""
    ranks, _ = job
    for r, res in enumerate(ranks):
        assert res["global_is_shard"] and res["global_rows"] == (LocalRows, 2, r)
        assert res["stage2_hash"]["global"] == res["stage2_hash"]["shard"]
        assert res["stage2_loss"]["global"] == res["stage2_loss"]["shard"]
        assert res["static"]["global"] == res["static"]["shard"]
    assert ranks[0]["stage2_hash"] == ranks[1]["stage2_hash"] and ranks[0]["static"] == ranks[1]["static"]


def _mesh_row(data: int, index: int) -> Mesh:
    """A rank's place on a data x 1 mesh without its groups: enough for
    shard_batch, which the dp steps call before any collective."""
    return Mesh(shape={"data": data, "tile": 1}, rank=index, data=index, tile=0, tile_group=None, data_group=None,
                backend="gloo")


def test_local_rows_are_never_cut_again():
    """shard_batch keeps a LocalRows whole and cuts every other tensor;
    rows of another data row raise. The rows taken out of the wrapper (what
    a dropped mark would leave) beside the step's whole leaves raise in the
    dp stage-2 step instead of training on part of the batch, and a tensor
    op or a field replaced on the wrapper raises: it has no tensor fields."""
    scene, state = torch_scaling_bench.build_tiny_scene(width=32, height=32, n_train=4, device="cpu")
    frames, mesh = scene.train_frames, _mesh_row(2, 1)
    whole, rows = stack_frames(frames), stack_frames(frames[2:])
    gb = LocalRows(rows, data=2, index=1)
    out = shard_batch(dict(frames=gb, uids=torch.arange(4)), mesh)
    assert _same(_numpy_leaves(out["frames"]), _numpy_leaves(rows)) and out["uids"].tolist() == [2, 3]
    assert _same(_numpy_leaves(shard_batch(whole, mesh)), _numpy_leaves(rows))
    with pytest.raises(ValueError, match="data row 0 of 2 on data row 1 of 2"):
        shard_batch(LocalRows(rows, data=2, index=0), mesh)
    with pytest.raises(ValueError, match="different rows"):
        shard_batch(dict(frames=gb.tree, uids=torch.arange(4)), mesh)
    with pytest.raises(AttributeError):
        gb.image.float()
    with pytest.raises(TypeError):
        dataclasses.replace(gb, image=rows.image)
    step2 = make_dp_stage2_step(mesh, max_per_tile=128)
    _, idx, *rest = torch_scaling_bench.dp_stage2_args(state, frames, "cpu")
    with pytest.raises(ValueError, match="different rows"):
        step2(copy.deepcopy(state), gb.tree, idx, *rest)


def test_init_distributed_does_nothing_in_a_single_process(monkeypatch):
    """No launcher environment, or one that names a single process (either
    package's names): False, and no group. The environment parsed: torchrun's
    names, then the reference's recipe (one process a host)."""
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    assert not MH.init_distributed() and not dist.is_initialized()
    for env in ({"WORLD_SIZE": "1", "RANK": "0"},
                {"JAX_COORDINATOR_ADDRESS": "host0:9999", "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            assert not MH.init_distributed() and not dist.is_initialized()
    with monkeypatch.context() as m:
        for k, v in dict(WORLD_SIZE="4", RANK="3", MASTER_ADDR="h", MASTER_PORT="7", LOCAL_RANK="1",
                         LOCAL_WORLD_SIZE="2").items():
            m.setenv(k, v)
        assert MH._launch_env() == dict(rank=3, world=4, addr="h", port=7, local_rank=1, local_world=2)
    with monkeypatch.context() as m:
        for k, v in dict(JAX_COORDINATOR_ADDRESS="host0:9999", JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="1").items():
            m.setenv(k, v)
        assert MH._launch_env() == dict(rank=1, world=2, addr="host0", port=9999, local_rank=0, local_world=1)
    assert MH.pick_backend(1) == ("nccl" if torch.cuda.is_available() else "gloo")
    with one_rank_mesh():  # a host of one rank: a tile of two cannot divide it
        assert MH.make_host_mesh().shape == {"data": 1, "tile": 1}
        with pytest.raises(ValueError, match="must divide"):
            MH.make_host_mesh(tile=2)


def test_sharded_checkpoint_round_trips_a_dict(tmp_path):
    """One process, no group: a dict with a zero-size leaf and an integer
    leaf, two iterations saved, -1 loads the latest; a missing leaf and a
    misshaped one raise."""
    d = {"w": torch.arange(24.0).reshape(8, 3), "b": torch.ones(5), "count": torch.tensor(3, dtype=torch.int32),
         "empty": torch.zeros((4, 0))}
    TC.save_checkpoint_sharded(tmp_path, 3, {k: v + 1 if v.is_floating_point() else v for k, v in d.items()})
    TC.save_checkpoint_sharded(tmp_path, 7, d)
    assert sorted(p.name for p in (tmp_path / "sharded" / "iteration_7").iterdir()) == ["manifest.json",
                                                                                        "replicated.npz"]
    out, it = TC.load_checkpoint_sharded(tmp_path, d)
    assert it == 7 and _same(_numpy_leaves(out), _numpy_leaves(d))
    out3, _ = TC.load_checkpoint_sharded(tmp_path, d, iteration=3)
    assert np.array_equal(out3["w"].numpy(), d["w"].numpy() + 1)
    with pytest.raises(KeyError, match="extra"):
        TC.load_checkpoint_sharded(tmp_path, dict(d, extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_checkpoint_sharded(tmp_path, dict(d, w=torch.zeros(3, 8)))
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint_sharded(tmp_path / "none", d)


def _stage1_state():
    """init_stage1 on a 32 x 32 scene at 512 slots, 16 nodes, hyper_dim 0:
    the Gaussians' feature plane (C, 1) and the node cloud's SH rest
    (C, 0, 3), a zero-size leaf."""
    _, scene = make_scene_data(n_train=2, n_test=1, width=32, height=32, n_init_points=64, device="cpu")
    cfg = Config()
    cfg.model.capacity, cfg.model.node_num, cfg.model.hyper_dim, cfg.model.sh_degree = 512, 16, 0, 1
    return init_stage1(scene, cfg, generator=torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_sharded_checkpoint_round_trips_training_states(tmp_path, stage):
    """A Stage1State and a Stage2State (the scaling twin's, whose feature
    plane is (256, 0)), each with zero-size leaves, onto a template of other
    values: every leaf bit for bit, the template untouched."""
    if stage == "stage1":
        state, other = _stage1_state(), _stage1_state()
    else:
        state = torch_scaling_bench.build_tiny_scene(32, 32, n_train=2, render_gt=False, device="cpu")[1]
        other = copy.deepcopy(state)
    with torch.no_grad():
        for t, _ in TC.state_leaves(state).values():
            if t.is_floating_point():
                t.add_(torch.rand(t.shape, generator=torch.Generator().manual_seed(t.numel())))
    want, before = TC.state_to_numpy(state), TC.state_to_numpy(other)
    assert any(a.size == 0 for a in want.values())
    TC.save_checkpoint_sharded(tmp_path, 5, state)
    back, it = TC.load_checkpoint_sharded(tmp_path, other)
    assert it == 5 and _same(TC.state_to_numpy(back), want)
    assert _same(TC.state_to_numpy(other), before)


def test_two_rank_sharded_checkpoint_loads_on_one_rank(job):
    """The checkpoints the two ranks wrote: on both ranks they loaded back
    bitwise (the dict's "w" as each rank's rows, still marked); here, on one
    rank with no group, the state bitwise, and "w" whole, rank 0's rows then
    rank 1's. Each data row wrote one file, rank 0 the replicated leaves."""
    ranks, out = job
    for res in ranks:
        assert res["state_back"] == (3, True)
        it, written, same, marked = res["dict_back"]
        assert it == 7 and same and marked and written > 0
    assert sorted(p.name for p in (out / "dict" / "sharded" / "iteration_7").iterdir()) == [
        "data0.npz", "data1.npz", "manifest.json", "replicated.npz"]
    template = torch_scaling_bench.build_tiny_scene(32, 32, n_train=N_FRAMES, render_gt=False, device="cpu")[1]
    back, it = TC.load_checkpoint_sharded(out / "ckpt", template)
    assert it == 3 and _state_hash(back) == ranks[0]["state_hash"] == ranks[1]["state_hash"]
    d = {"w": torch.zeros(4, 3), "b": torch.zeros(5), "count": torch.tensor(0), "empty": torch.zeros((4, 0))}
    dback, _ = TC.load_checkpoint_sharded(out / "dict", d)
    want = torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)])
    assert torch.equal(dback["w"], want) and isinstance(dback["w"], torch.Tensor) and int(dback["count"]) == 3


def test_multihost_twin_runs_on_two_processes(job):
    """scripts/torch_multihost_smoke.py's main on both ranks, static and
    --stage2: process 0 prints the reference's line, process 1 nothing."""
    ranks, _ = job
    for mode in ("static", "--stage2"):
        line = ranks[0]["twin"][mode].strip()
        assert line.startswith("MULTIHOST OK loss=") and line.endswith("procs=2"), line
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))
        assert ranks[1]["twin"][mode] == ""


def test_scaling_twin_runs_on_two_cpu_ranks(capsys, monkeypatch):
    """scripts/torch_scaling_bench.py --cpu 2 --iters 1: a job of one rank,
    then one of two; the reference's line for each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = torch_scaling_bench.main(["--cpu", "2", "--iters", "1", "--width", "32"])
    assert [r["data"] for r in rows] == [1, 2] and all(r["backend"] == "gloo" for r in rows)
    assert all(np.isfinite(r["loss"]) and r["ms_per_step"] > 0 for r in rows)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("data=")]
    assert len(lines) == 2 and "scaling-eff 100.0%" in lines[0] and "frames/s" in lines[1]
