"""Copies from the device to the host a frame inside the entry: the program's
``host_reads`` counter (``riggs_tpu_torch/trace.py``) over the traced
window."""
from portbench import spans


def read(ctx):
    return spans.counter(ctx, "host_reads")
