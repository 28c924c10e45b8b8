"""Device milliseconds a unit in GEMM kernels (the deformation's MLPs and
skinning product), from the profiler's trace."""
from portbench import harness


def read(ctx):
    s = ctx.trace.device_s(harness.gemm)
    return s * 1e3 / ctx.units if s > 0 else None
