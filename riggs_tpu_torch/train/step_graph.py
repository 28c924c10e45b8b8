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
because replays run one after another on one stream. Nothing is
captured on the CPU, while a profiler records or under anomaly detection
(whose checks read the card); those calls run eagerly. A capture needs the
autograd graphs of the eager calls freed: a leaf's gradient accumulator is
made once on the stream of its first use and lives as long as a graph that
holds it, and the capture cannot wait on another stream.

``copy_in`` fills a buffer from a tensor unless the two share their memory,
``copy_all`` many buffers in a few kernels; ``Packed`` lays a dict of tensors
out in one buffer, so that a step's metrics leave the graph's memory in one
copy.
"""
from __future__ import annotations

import collections
from typing import Callable, Hashable

import torch

from riggs_tpu_torch import trace

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
        """Drop every graph (their buffers are gone) and the keys' counts."""
        self.graphs.clear()
        self.seen.clear()

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
