"""The blend fwd kernels' share of their roofline: the least time the card
could take for the traced units' pairs and bytes (roofline.py) over the
device time of the kernels, in percent."""


def read(ctx):
    s = ctx.trace.device_s(ctx.kernel_match["blend_fwd"])
    return 100.0 * ctx.bounds_ms["blend_fwd"] / (s * 1e3) if s > 0 else None
