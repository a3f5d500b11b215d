"""fused_tp3_roofline: the least time (%) of the merged tensor-product
contractions of the profiled cycle's docks (both models, at the buckets the
docks ran in; the frozen ``tp3_work``/``bound_ms`` of ``benchmark/work``,
the same work whatever implements it) over the device time of the kernels
that implement them, by the names below, in the profiler's trace."""

KERNELS = ("fused_tp3",)


def read(ctx):
    kernel_s = sum(s for name, (s, _n) in ctx.trace.kernels.items() if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    docks = ctx.trace.docks // len(ctx.cycle)  # whole cycles profiled
    bound_ms = docks * sum(w["score_bucket"].bound_ms() + w["confidence_bucket"].bound_ms()
                           for w in ctx.work)
    return 100.0 * bound_ms / 1e3 / kernel_s
