"""Launch calls a step (kernels, copies, memsets) that the host made in the
losses and Adam (``riggs.loss.*``, ``riggs.optim.adam``), the shortest of
the program's spans around each call (``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    return spans.launches(ctx, "loss_optim")
