"""Milliseconds a frame in which the device ran nothing while the host was in
the blend's entries and its backward (``riggs.blend.*``), the shortest of
the program's spans active then (``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "blend")
