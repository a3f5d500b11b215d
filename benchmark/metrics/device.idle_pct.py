"""device.idle_pct: the share (%) of the untraced docking time in which no
operation ran on the device: one minus the device's busy seconds in the
profiled cycle (one dock of each complex, kernels timed by the profiler)
over the time the same docks take untraced (each complex's mean dock time
over the window). The profiled cycle's own wall is not the divisor: the
profiler slows the host about twofold and would count its own cost as
idle."""

import numpy as np


def read(ctx):
    if ctx.trace.busy_s <= 0 or ctx.trace.docks <= 0:
        return None
    n = len(ctx.cycle)
    means = [np.mean([r.seconds for r in ctx.records if r.complex == c]) for c in range(n)]
    untraced_s = float(np.sum(means)) * ctx.trace.docks / n
    return 100.0 * (1.0 - ctx.trace.busy_s / untraced_s) if untraced_s > 0 else None
