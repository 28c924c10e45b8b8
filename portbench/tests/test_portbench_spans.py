"""The program's spans by layer (``portbench/spans.py``) on hand-made traces:
idle gaps split at the ranges' boundaries and given to the shortest range
active over each piece, on any thread; launch calls given to the innermost
span around their start; nothing read from a program without spans."""
from __future__ import annotations

import random

import pytest

from portbench import harness, spans
from portbench.harness import LayerContext, Trace


def ctx(trace, units=1):
    return LayerContext(trace=trace, units=units, host_s=[], flops=0.0, bounds_ms={}, kernel_match={})


def test_a_gap_over_two_ranges_is_split_between_them():
    # device idle from 10 to 50; the entry 0-100 holds the deform 20-30 and
    # the render set-up 30-45
    tr = Trace(kernels=[("k", 0.0, 10.0), ("k", 50.0, 60.0)],
               host=[("riggs.entry.stage2_step", 0.0, 100.0), ("riggs.deform.skeleton", 20.0, 30.0),
                     ("riggs.render_prep.setup", 30.0, 45.0), ("aten::mul", 21.0, 29.0)])
    idle = spans.idle_by_layer(tr)
    assert idle == pytest.approx({"outside": 0.0, "entry": 15.0, "deform": 10.0, "render_prep": 15.0})
    assert spans.idle_ms(ctx(tr, units=5), "deform") == pytest.approx(10.0 / 1e3 / 5)
    assert spans.idle_ms(ctx(tr), "blend") == 0.0


def test_the_shortest_range_wins_across_threads():
    # the backward's span on the main thread; the blend's backward on the
    # autograd engine's thread inside it, and an entry that outlasts both
    tr = Trace(kernels=[("k", 0.0, 1.0), ("k", 40.0, 41.0)],
               host=[("riggs.entry.phase_b_step", 0.0, 100.0), ("riggs.backward.grad", 0.0, 50.0),
                     ("riggs.blend.bwd", 5.0, 25.0)])
    idle = spans.idle_by_layer(tr)
    assert idle == pytest.approx({"outside": 0.0, "backward": 19.0, "blend": 20.0})


def test_loss_and_optim_spans_are_one_layer_and_time_outside_spans_is_outside():
    tr = Trace(kernels=[("k", 0.0, 1.0), ("k", 30.0, 31.0)],
               host=[("riggs.loss.photometric", 5.0, 10.0), ("riggs.optim.adam", 10.0, 20.0)])
    assert spans.idle_by_layer(tr) == pytest.approx({"outside": 14.0, "loss_optim": 15.0})


def test_idle_pieces_add_up_to_the_idle_time():
    rng = random.Random(3)
    kernels, t = [], 0.0
    for _ in range(400):
        t += rng.uniform(0.0, 5.0)
        d = rng.uniform(0.1, 4.0)
        kernels.append(("k", t, t + d))
        t += rng.uniform(-d, d)  # some overlap the one before
    host = []
    for _ in range(60):
        s = rng.uniform(-50.0, t + 50.0)
        host.append((f"riggs.{rng.choice(sorted(spans.LAYERS))}.x", s, s + rng.uniform(0.5, 300.0)))
    tr = Trace(kernels=kernels, host=host)
    idle = spans.idle_by_layer(tr)
    total = sum(e - s for s, e in tr.gaps())
    assert total > 0 and abs(sum(idle.values()) - total) <= 1e-9 * total
    assert all(v >= -1e-9 for v in idle.values())


def test_a_launch_counts_in_its_innermost_span():
    tr = Trace(kernels=[("k", 0.0, 1.0)],
               host=[("riggs.entry.frame", 0.0, 100.0), ("riggs.render_prep.windows", 10.0, 60.0),
                     ("riggs.blend.fwd", 40.0, 50.0), ("cudaLaunchKernel", 41.0, 42.0),
                     ("cudaMemsetAsync", 40.5, 40.7), ("cudaLaunchKernelExC", 12.0, 13.0),
                     ("cuLaunchKernel", 70.0, 71.0), ("cudaMemcpyAsync", 150.0, 151.0), ("aten::add", 20.0, 21.0)])
    n = spans.launches_by_layer(tr)
    assert n == {"outside": 1, "blend": 2, "render_prep": 1, "entry": 1}
    assert spans.launches(ctx(tr, units=2), "blend") == 1.0
    assert spans.launches(ctx(tr), "deform") == 0.0


def test_a_program_without_spans_reads_nothing():
    tr = Trace(kernels=[("k", 0.0, 1.0), ("k", 5.0, 6.0)],
               host=[("stage2_step.forward", 0.0, 10.0), ("portbench.step", 0.0, 10.0), ("cudaLaunchKernel", 1, 2)])
    assert spans.idle_by_layer(tr) is None and spans.launches_by_layer(tr) is None
    assert spans.idle_ms(ctx(tr), "entry") is None and spans.launches(ctx(tr), "deform") is None


def test_every_new_reader_reads_the_helper():
    root = harness.HERE / "layer_metrics"
    for part, layer in (("entry", "entry"), ("deform", "deform"), ("render_prep", "render_prep"),
                        ("blend", "blend"), ("loss", "loss_optim"), ("backward", "backward")):
        tr = Trace(kernels=[("k", 0.0, 1.0), ("k", 9.0, 10.0)],
                   host=[(f"riggs.{part}.x", 0.0, 10.0), ("cudaLaunchKernel", 2.0, 3.0)])
        mod = harness.load_module(root / f"idle_ms.{layer}.train.py", "t")
        assert mod.read(ctx(tr, units=2)) == pytest.approx(8.0 / 1e3 / 2)
        if layer in ("deform", "render_prep", "loss_optim"):
            assert harness.load_module(root / f"launches.{layer}.train.py", "t").read(ctx(tr)) == 1.0
