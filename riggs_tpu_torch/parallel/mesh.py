"""A data x tile grid of ranks over ``torch.distributed``.

Port of ``riggs_tpu/parallel/mesh.py``. The reference's mesh is a grid of
devices whose ``data`` axis carries frame parallelism (each device renders
and differentiates its own frames; the parameter gradients are summed) and
whose ``tile`` axis carries pixel parallelism within a frame (each device
blends its own screen tiles; only the image is gathered). Here the devices
are the ranks of an initialized default process group, laid out as
``np.asarray(devices).reshape(data, tile)`` lays the reference's out: rank
``d * tile + t`` sits at data index ``d`` and tile index ``t``. Each rank
belongs to one tile group (the ranks of its data row, which share a frame)
and one data group (the ranks of its tile column, which share a shard).

XLA inserted the reference's collectives from sharding annotations. Here
they are explicit calls on the mesh: ``gather_tiles`` (the tile group's
all-gather along the leading axis), ``gather_data`` and ``sum_data`` (the
data group's all-gather and all-reduce). Each collective runs whatever the
group's size, so a 1 x 1 mesh still exercises the backend. The reference's
``replicated``, ``data_sharded`` and ``constrain_tiles`` return or apply
XLA shardings and have no meaning without them: a replicated state is one
every rank holds the same bits of, and ``shard_batch`` takes a rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """The rank's place in the data x tile grid and its two groups."""

    shape: dict  # {"data": D, "tile": K}
    rank: int
    data: int  # this rank's data index (its row)
    tile: int  # this rank's tile index (its column)
    tile_group: Any  # the ranks d * K + [0, K): one frame's tile shards
    data_group: Any  # the ranks [0, D) * K + t: one shard of every frame
    backend: str

    def _all_gather(self, x: torch.Tensor, group, n: int) -> list[torch.Tensor]:
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x, group=group)
        return outs

    def gather_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """The tile group's shards of ``x`` concatenated along the leading
        axis, in tile order."""
        return torch.cat(self._all_gather(x, self.tile_group, self.shape["tile"]))

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """The data group's ``x`` concatenated along the leading axis, in
        data order (a rank's rows of a batch, back to the whole batch)."""
        return torch.cat(self._all_gather(x, self.data_group, self.shape["data"]))

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group (a new tensor)."""
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.data_group)
        return y


def make_mesh(data: int = 1, tile: int = 1, backend: str | None = None) -> Mesh:
    """The data x tile mesh over the initialized default group, whose size
    must be ``data * tile``. Every rank creates every tile row's and every
    data column's group, in the same order (``new_group`` is collective
    over the default group), with ``backend`` (the default group's when
    None)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != data * tile:
        raise ValueError(f"a {data} x {tile} mesh needs {data * tile} ranks, the default group has {world}")
    rank = dist.get_rank()
    d, t = divmod(rank, tile)
    tile_group = data_group = None
    for row in range(data):
        g = dist.new_group([row * tile + c for c in range(tile)], backend=backend)
        if row == d:
            tile_group = g
    for col in range(tile):
        g = dist.new_group([r * tile + col for r in range(data)], backend=backend)
        if col == t:
            data_group = g
    return Mesh(shape={"data": data, "tile": tile}, rank=rank, data=d, tile=t, tile_group=tile_group,
                data_group=data_group, backend=str(dist.get_backend(tile_group)))


@dataclasses.dataclass(frozen=True)
class LocalRows:
    """One data row's rows of a batch split over a mesh's data axis: every
    tensor of ``tree`` (a stacked ``Frame``, a tensor, dicts, lists) holds
    the rows of data row ``index`` of ``data`` equal parts. The counterpart
    of the reference's global array assembled from host-local rows
    (``multihost.global_batch``): ``shard_batch`` takes the tree as it is,
    and a sharded checkpoint writes such a leaf by data row. The fact is the
    wrapper's, so no op on a tensor can drop it: the tree is reached only
    through ``shard_batch`` or ``.tree``."""

    tree: Any
    data: int
    index: int


def map_leaves(tree: Any, fn) -> Any:
    """``tree`` with every tensor (and numpy array) leaf through ``fn``;
    dicts, lists, tuples and dataclasses (a stacked ``Frame``) rebuilt,
    other leaves kept."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_leaves(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of a stacked batch: the leading axis of every tensor
    of ``tree`` (dicts, lists, tuples and dataclasses such as a stacked
    ``Frame``; other leaves stay as they are) split into ``data`` equal
    parts, part ``mesh.data`` kept. A ``LocalRows`` already holds the rank's
    rows and is taken as it is (its mesh must be ``mesh``). Every tensor
    kept must have the same rows, so local rows cut again (a ``LocalRows``
    unwrapped beside whole leaves) raise instead of training on a part."""
    D = mesh.shape["data"]
    kept = set()

    def keep(a):
        kept.add(a.shape[0])
        return a

    def rows(a):
        if a.shape[0] % D:
            raise ValueError(f"a batch of {a.shape[0]} does not split over {D} data ranks")
        n = a.shape[0] // D
        return keep(a[mesh.data * n:(mesh.data + 1) * n])

    def walk(t):
        if isinstance(t, LocalRows):
            if (t.data, t.index) != (D, mesh.data):
                raise ValueError(f"rows of data row {t.index} of {t.data} on data row {mesh.data} of {D}")
            return map_leaves(t.tree, lambda a: keep(a) if isinstance(a, torch.Tensor) else a)
        if isinstance(t, torch.Tensor):
            return rows(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{f.name: walk(getattr(t, f.name)) for f in dataclasses.fields(t)})
        return t

    out = walk(tree)
    if len(kept) > 1:
        raise ValueError(f"the batch's tensors hold different rows on this rank: {sorted(kept)}")
    return out
