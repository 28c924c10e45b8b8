"""Launch calls a frame (kernels, copies, memsets) that the host made in the
render's set-up, binning, windows and ladder fits (``riggs.render_prep.*``),
the shortest of the program's spans around each call
(``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    return spans.launches(ctx, "render_prep")
