"""Kernels the profiler recorded a unit (copies and memsets apart)."""


def read(ctx):
    return len(ctx.trace.kernels) / ctx.units if ctx.trace.kernels else None
