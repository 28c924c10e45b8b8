"""Launch calls a step (kernels, copies, memsets) that the host made in the
deformation's spans (``riggs.deform.*``), the shortest of the program's
spans around each call (``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    return spans.launches(ctx, "deform")
