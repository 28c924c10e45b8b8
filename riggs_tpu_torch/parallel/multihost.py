"""Multi-process launch and per-host data loading.

Port of ``riggs_tpu/parallel/multihost.py``. The reference scales past one
host by folding the host factor into the mesh's ``data`` axis: frame
parallelism is the only axis whose traffic (one gradient all-reduce a step)
crosses hosts, and tile parallelism, which exchanges work every step, stays
inside one. Each host loads only its own share of the frame batch from disk
and assembles the global batch from its local rows.

Here a device is a process (a rank of ``torch.distributed``'s default
group, one card each, or several ranks sharing one card over gloo):

  * ``init_distributed`` joins the default group from the launcher's
    environment: torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, or the
    reference's launch recipe,

        JAX_COORDINATOR_ADDRESS=host0:9999 JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i \\
            python scripts/torch_run_pipeline.py --dp N ...

    (one process a host unless ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` say
    otherwise). NCCL when every rank of a host has a card of its own, gloo
    otherwise (NCCL takes one rank per device: two ranks on one card run
    gloo, which takes CUDA tensors);
  * ``make_host_mesh`` lays the ranks out so that a tile group never spans
    two hosts;
  * ``host_local_frames`` gives a rank the frames of its data row: a "host"
    of the reference is a data row of the mesh here, and every rank of one
    tile group loads the same frames;
  * ``global_batch`` places the rank's local stack on its card and wraps it
    as its rows of the whole batch (``mesh.LocalRows``), which
    ``mesh.shard_batch`` (and so every dp step) takes as it is: the same
    rows, bit for bit, that ``shard_batch`` would cut from the whole stack.

In a single process all of it reduces to the same code path: no group, every
frame, the whole batch.
"""
from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from riggs_tpu_torch.parallel.mesh import LocalRows, Mesh, map_leaves, make_mesh


def _launch_env() -> dict | None:
    """(rank, world, address, port, local rank, local world) from
    torchrun's names, else from the reference's JAX_* names; None when the
    environment names no group of two or more processes."""
    env = os.environ
    if env.get("WORLD_SIZE"):
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
        addr, port = env.get("MASTER_ADDR", "localhost"), env.get("MASTER_PORT", "29500")
    elif env.get("JAX_NUM_PROCESSES") and env.get("JAX_COORDINATOR_ADDRESS"):
        world, rank = int(env["JAX_NUM_PROCESSES"]), int(env.get("JAX_PROCESS_ID", "0"))
        addr, _, port = env["JAX_COORDINATOR_ADDRESS"].rpartition(":")
    else:
        return None
    if world <= 1:
        return None
    local_world = int(env.get("LOCAL_WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", str(rank % local_world)))
    return dict(rank=rank, world=world, addr=addr, port=int(port), local_rank=local_rank, local_world=local_world)


def pick_backend(local_world: int) -> str:
    """NCCL when CUDA is there and each of a host's ``local_world`` ranks
    has a card of its own; gloo otherwise."""
    return "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local_world else "gloo"


def init_distributed(backend: str | None = None) -> bool:
    """Join the default process group when the launcher started several
    processes (see the module's docstring for the environment it reads),
    with ``backend`` or ``pick_backend``'s, and make the rank's card (its
    local rank, modulo the cards) the current CUDA device. Returns True
    when a group of two or more ranks exists (also when it already did),
    False in a single process, where it does nothing."""
    if dist.is_initialized():
        return True
    e = _launch_env()
    if e is None:
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(e["local_rank"] % torch.cuda.device_count())
    dist.init_process_group(backend or pick_backend(e["local_world"]), init_method=f"tcp://{e['addr']}:{e['port']}",
                            world_size=e["world"], rank=e["rank"])
    return True


def make_host_mesh(data_per_host: int | None = None, tile: int = 1) -> Mesh:
    """A data x tile mesh over every rank of the default group, hosts
    stacked along ``data``: each host's ranks form ``data_per_host`` (all of
    them over ``tile`` by default) whole tile groups, so a tile group's
    collectives never leave its host and only the data axis crosses hosts.
    A host is the ``local_world`` consecutive ranks that ``init_distributed``
    reads from the launcher's environment (one under the reference's
    recipe); a group the environment does not name was started on this
    host, which then holds all of it."""
    world = dist.get_world_size()
    e = _launch_env()
    per_host = e["local_world"] if e is not None else world
    if per_host % tile or world % per_host:
        raise ValueError(f"a tile of {tile} must divide the {per_host} ranks of a host, which divide {world}")
    if data_per_host is None:
        data_per_host = per_host // tile
    if data_per_host * tile != per_host:
        raise ValueError(f"{data_per_host} x {tile} ranks a host, a host has {per_host}")
    return make_mesh(data=world // per_host * data_per_host, tile=tile)


def host_local_frames(frames: Sequence[Any], batch: int, step: int, seed: int = 0, mesh: Mesh | None = None):
    """This rank's frames of the global batch of ``step`` and the batch's
    indices: every rank draws the same ``batch`` indices from (seed, step),
    with no traffic, and takes its data row's contiguous part (every frame
    without a mesh or with one data row). ``batch`` must divide by the
    mesh's data size."""
    D = mesh.shape["data"] if mesh is not None else 1
    if batch % D:
        raise ValueError(f"a global batch of {batch} does not split over {D} data rows")
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    idx = rng.choice(len(frames), size=batch, replace=len(frames) < batch)
    n = batch // D
    lo = n * (mesh.data if mesh is not None else 0)
    return [frames[i] for i in idx[lo : lo + n]], idx


def global_batch(local_tree: Any, mesh: Mesh) -> LocalRows:
    """The rank's part of the global data-sharded batch: ``local_tree`` (a
    stacked Frame, a tensor, dicts, lists; leading axis the rank's rows)
    with every numpy array made a tensor and every CUDA tensor moved to the
    current card, wrapped as the rank's rows of a batch
    ``mesh.shape["data"]`` times as long, which ``shard_batch`` takes as it
    is. Equal, bit for bit, to ``shard_batch`` of the whole batch."""

    def place(a):
        a = torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
        return a.to(torch.device("cuda", torch.cuda.current_device())) if a.is_cuda else a

    return LocalRows(map_leaves(local_tree, place), data=mesh.shape["data"], index=mesh.data)
