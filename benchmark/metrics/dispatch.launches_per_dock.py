"""dispatch.launches_per_dock: the CUDA runtime's launch calls per dock in
the profiled cycle (a graph launch counts as one)."""


def read(ctx):
    return ctx.trace.launches / ctx.trace.docks if ctx.trace.launches and ctx.trace.docks else None
