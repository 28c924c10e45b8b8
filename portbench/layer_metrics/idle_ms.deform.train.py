"""Milliseconds a step in which the device ran nothing while the host was in
the deformation's spans (``riggs.deform.*``), the shortest of the program's
spans active then (``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "deform")
