"""Milliseconds a frame in which the device ran nothing while the host was in
the render's set-up, binning, windows and ladder fits
(``riggs.render_prep.*``), the shortest of the program's spans active then
(``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "render_prep")
