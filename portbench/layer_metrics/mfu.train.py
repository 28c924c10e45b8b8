"""The whole unit's share of the card's FP32 peak: the FLOPs counted from
the traced units' inputs (roofline.py) over the traced window, in percent."""
from portbench import roofline


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.kernels:
        return None
    return 100.0 * ctx.flops / ctx.trace.window_s / roofline.FP32_FLOPS_PER_S
