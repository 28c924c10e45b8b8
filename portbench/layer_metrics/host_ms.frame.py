"""The host's time to enqueue one unit (the entry's call until it
returns), averaged over the traced window."""


def read(ctx):
    return 1e3 * sum(ctx.host_s) / ctx.units if ctx.units else None
