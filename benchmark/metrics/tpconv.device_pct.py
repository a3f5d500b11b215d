"""tpconv.device_pct: the share (%) of the device's busy time in the
profiled cycle that the merged-contraction kernels (the names below) take."""

KERNELS = ("fused_tp3",)


def read(ctx):
    kernel_s = sum(s for name, (s, _n) in ctx.trace.kernels.items() if any(k in name for k in KERNELS))
    return 100.0 * kernel_s / ctx.trace.busy_s if kernel_s > 0 and ctx.trace.busy_s > 0 else None
