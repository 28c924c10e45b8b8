"""A training step replayed as CUDA graphs (no ``riggs_tpu`` counterpart).

An eager step enqueues thousands of small launches, and on the card the host
sets its pace. A step that reads nothing back on the host and whose host
values repeat from call to call can be recorded once as a CUDA graph and
replayed: one launch for the whole step. Such a step is written against
static buffers: the caller copies its inputs into tensors that live as long
as the graphs, and the step writes its results into persistent tensors
itself, so that a replay reads and writes the same memory as the capture.

``StepGraphs`` runs such a step by a key of everything the graph bakes in
(shapes, flags, caps, the identity of tensors it reads in place). A key runs
eagerly until it has been seen ``WARMUP`` times: the eager calls create the
lazy state that a capture cannot (constants copied to the card on first use,
cuBLAS's workspaces). On the next call it is captured and replayed, and every
later call with the key replays it. Only the ``MAX_GRAPHS`` keys replayed
last keep their graphs: a key that changes as training goes on (a refitted
tile ladder) leaves its old graphs behind, and a key that comes back is
captured again at once. The graphs share one memory pool, which is safe
because replays run one after another on one stream; ``clear`` (the step's
buffers were made anew) drops the pool with the graphs, and the next capture
takes another. Nothing is
captured on the CPU, while a profiler records or under anomaly detection
(whose checks read the card); those calls run eagerly. A capture needs the
autograd graphs of the eager calls freed: a leaf's gradient accumulator is
made once on the stream of its first use and lives as long as a graph that
holds it, and the capture cannot wait on another stream.

``copy_in`` fills a buffer from a tensor unless the two share their memory,
``copy_all`` many buffers in a few kernels; ``Packed`` lays a dict of tensors
out in one buffer, so that a step's metrics leave the graph's memory in one
copy. ``StepBuffers`` holds a training step's static buffers (a state of its
own, named by the state's leaf table, and the step's inputs), and
``StaticStep`` runs a step on them through ``StepGraphs``: both training
stages' auto steps (``make_stage2_auto``, ``make_phase_b_auto``) are built
on it.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Any, Callable, Hashable

import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.data.dataset import Frame

WARMUP = 3  # eager calls of a key before it is captured
MAX_GRAPHS = 4  # graphs kept, the keys replayed last


def copy_in(buf: torch.Tensor, src: torch.Tensor) -> None:
    """``buf.copy_(src)`` unless ``src`` already is ``buf``'s memory."""
    if src.data_ptr() != buf.data_ptr():
        buf.copy_(src)


def copy_all(bufs: list[torch.Tensor], srcs: list[torch.Tensor]) -> None:
    """``copy_in`` of each pair, as one ``torch._foreach_copy_`` a dtype: a
    few kernels, where inside a graph a ``copy_`` is a node of its own."""
    groups: dict = {}
    for buf, src in zip(bufs, srcs):
        if src.data_ptr() != buf.data_ptr():
            dst, from_ = groups.setdefault((buf.dtype, src.dtype), ([], []))
            dst.append(buf)
            from_.append(src)
    for dst, from_ in groups.values():
        torch._foreach_copy_(dst, from_)


def layout(t: torch.Tensor) -> tuple:
    """What a graph bakes in of a tensor it reads in place: its address,
    shape, strides, dtype and device."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class StepGraphs:
    """CUDA graphs of one step function by key; see the module docstring.
    ``captures``, ``replays`` and ``eager`` count the calls of each kind (the
    trace counters ``step_graph_captures`` and ``step_graph_replays`` count
    them only while a profiler records)."""

    def __init__(self):
        self.seen: collections.Counter = collections.Counter()
        self.graphs: collections.OrderedDict = collections.OrderedDict()  # the last replayed last
        self.pool = None
        self.stream = None
        self.captures = self.replays = self.eager = 0

    def clear(self) -> None:
        """Drop every graph (their buffers are gone) and the keys' counts,
        and the pool: once no graph holds a pool, the allocator takes no
        new capture into it."""
        self.graphs.clear()
        self.seen.clear()
        self.pool = None

    @staticmethod
    def capturable(device: torch.device) -> bool:
        return (device.type == "cuda" and not torch.autograd._profiler_enabled()
                and not torch.is_anomaly_enabled())

    def run(self, key: Hashable, fn: Callable[[], None], device: torch.device) -> None:
        """Run ``fn`` (which reads and writes only static buffers) for
        ``key``: eagerly, by capturing and replaying it, or by replaying its
        graph."""
        graph = self.graphs.get(key)
        if graph is None:
            if self.seen[key] < WARMUP or not self.capturable(device):
                self.seen[key] += 1
                self.eager += 1
                fn()
                return
            graph = self.graphs[key] = self._capture(fn, device)
            self.captures += 1
            trace.count("step_graph_captures")
            if len(self.graphs) > MAX_GRAPHS:  # an exec graph in flight is freed when it ends
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        graph.replay()
        self.replays += 1
        trace.count("step_graph_replays")

    def _capture(self, fn: Callable[[], None], device: torch.device):
        """Record ``fn`` on a side stream into a graph of the shared pool.
        No synchronize: the buffers ``fn`` reads are filled on the current
        stream, on which the graph is replayed after them."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            # thread_local: another thread's work on the card (a viewer's
            # frames) may go on during the capture
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was already invalidated; report fn's error
                raise
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(self.stream)
        return graph


class Packed:
    """Tensors laid out in one byte buffer, each at a 16-byte aligned slot:
    ``write`` copies them in (inside a graph, its last nodes), ``read``
    copies the buffer out once and returns views of the copy, which the next
    replay leaves alone."""

    ALIGN = 16

    def __init__(self, like: dict[str, torch.Tensor], device: torch.device):
        self.slots, off = [], 0
        for k, v in like.items():
            self.slots.append((k, off, v.dtype, tuple(v.shape)))
            off += -(-v.numel() * v.dtype.itemsize // self.ALIGN) * self.ALIGN
        self.buf = torch.empty(off, dtype=torch.uint8, device=device)
        self.views = self._views(self.buf)

    def _views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for k, off, dtype, shape in self.slots:
            n = torch.Size(shape).numel() * dtype.itemsize
            out[k] = buf[off:off + n].view(dtype).view(shape)
        return out

    def write(self, tensors: dict[str, torch.Tensor]) -> None:
        copy_all(list(self.views.values()), [tensors[k] for k in self.views])

    def read(self) -> dict[str, torch.Tensor]:
        return self._views(self.buf.clone())


# the tensors of a frame that a training step reads, each copied into the
# static frame of its layout (a field that is None stays None)
FRAME_TENSORS = ("image", "alpha_mask", "thinned", "thinned_mask", "flow", "flow_mask", "flow_partner_fid")


def signature(static: tuple, leaves: dict) -> tuple:
    """What a state's buffers are made for: its static fields and every
    leaf's key, shape, dtype and device, by key (the order of a tree's dict
    is not part of it)."""
    return static + tuple(sorted((k, tuple(t.shape), t.dtype, t.device) for k, (t, _) in leaves.items()))


class StepBuffers:
    """The static buffers of a step run through ``StepGraphs``: a training
    state of its own (``state``, a deep copy of the state it was made from;
    the step returns this object) with its tensors by name in the state's
    leaf table (``leaves_of``: key -> (tensor, transposed), as the
    checkpoints name them), and the step's inputs: a frame of each layout,
    a tensor of each name and layout, device scalars by name; and the packed
    metrics of each key."""

    def __init__(self, state, leaves_of: Callable[[Any], dict], sig: tuple):
        self.leaves_of, self.signature = leaves_of, sig
        self.state = copy.deepcopy(state)
        self.bufs = {k: t for k, (t, _) in leaves_of(self.state).items()}
        self.device = next(iter(self.bufs.values())).device
        self.scalars: dict = {}
        self.inputs: dict = {}
        self.frames: dict = {}
        self.packs: dict = {}

    @torch.no_grad()
    def load(self, state, leaves: dict) -> None:
        """Copy in each leaf of ``state`` that is not its buffer, then point
        every tensor that was assigned over the own state's (``train_stage2``'s
        FPS reset assigns ``control_nodes``) at its buffer."""
        self._copy(leaves)
        own = leaves if state is self.state else self.leaves_of(self.state)
        for k, (t, _) in own.items():
            if t.data_ptr() != self.bufs[k].data_ptr():
                t.set_(self.bufs[k])

    @torch.no_grad()
    def keep(self, new) -> None:
        """Write a step's new state into the buffers (inside a graph, its
        last nodes)."""
        self._copy(self.leaves_of(new))

    def _copy(self, leaves: dict) -> None:
        copy_all([self.bufs[k] for k in leaves], [t for t, _ in leaves.values()])

    def scalar(self, name: str, value, dtype=torch.float32, shape: tuple = ()) -> torch.Tensor:
        """The device scalar ``name`` filled with the host ``value`` (a value
        that changes from call to call, read by the graph in place)."""
        buf = self.scalars.get(name)
        if buf is None:
            buf = self.scalars[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        buf.fill_(value)
        return buf

    def input(self, name: str, t: torch.Tensor) -> tuple[torch.Tensor, tuple]:
        """The buffer of ``t``'s shape and dtype under ``name`` with ``t``
        copied in, and its layout."""
        key = (name, tuple(t.shape), t.dtype)
        buf = self.inputs.get(key)
        if buf is None:
            buf = self.inputs[key] = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        copy_in(buf, t)
        return buf, key

    def frame(self, fr: Frame) -> tuple[Frame, tuple]:
        """The static frame of ``fr``'s layout with ``fr`` copied in, and
        the layout: the camera's size and planes, and the shape and dtype of
        each tensor of ``FRAME_TENSORS`` and of the camera, or None where
        ``fr`` has none (so the presence of each field is part of it)."""
        cam = fr.cam
        parts = (cam.w2c, cam.intrinsics, cam.fid) + tuple(getattr(fr, f) for f in FRAME_TENSORS)
        key = (cam.width, cam.height, cam.znear, cam.zfar) + tuple(
            None if t is None else (tuple(t.shape), t.dtype) for t in parts)
        st = self.frames.get(key)
        if st is None:
            bufs = [None if t is None else torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in parts]
            w2c, intr, fid = bufs[:3]
            st = self.frames[key] = (bufs, Frame(cam=dataclasses.replace(cam, w2c=w2c, intrinsics=intr, fid=fid),
                                                 **dict(zip(FRAME_TENSORS, bufs[3:]))))
        for buf, src in zip(st[0], parts):
            if src is not None:
                copy_in(buf, src)
        return st[1], key

    def pack(self, key: Hashable, metrics: dict) -> None:
        """Write a step's metrics into the packed buffer of ``key`` (inside a
        graph, its last nodes)."""
        if key not in self.packs:
            self.packs[key] = Packed(metrics, self.device)
        self.packs[key].write(metrics)


class StaticStep:
    """A step run on ``StepBuffers`` through ``StepGraphs`` (``graphs``):
    ``load`` gives the buffers of a state, new ones (and no graphs) where
    the state's signature (``static_of(state)``, its static fields, and its
    leaves' keys and shapes) is not the buffers', else the held ones with
    the state copied in; ``run`` runs the step's body for a key and returns
    the own state and a copy of the metrics."""

    def __init__(self, leaves_of: Callable[[Any], dict], static_of: Callable[[Any], tuple]):
        self.leaves_of, self.static_of = leaves_of, static_of
        self.graphs = StepGraphs()
        self.buffers: StepBuffers | None = None

    def load(self, state) -> StepBuffers:
        sb, leaves = self.buffers, self.leaves_of(state)
        sig = signature(self.static_of(state), leaves)
        if sb is None or sig != sb.signature:
            self.graphs.clear()
            self.buffers = StepBuffers(state, self.leaves_of, sig)
        else:
            sb.load(state, leaves)
        return self.buffers

    def run(self, key: Hashable, body: Callable[[], None]):
        sb = self.buffers
        self.graphs.run(key, body, sb.device)
        return sb.state, sb.packs[key].read()
