"""The share of the traced window in which the device ran nothing: 1 minus
the union of its operations' intervals over the window, in percent."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
