"""confidence.ms_per_dock: the ranking's time (ms) per dock on the device's
stream: the program's ``confidence`` spans (every confidence chunk) and
``rank`` spans (the confidences' copy and the sort), each between the
CUDA events recorded as it opens and closes (``DockingResult.timings``),
summed per dock and averaged over the window's docks."""

NAMES = ("confidence", "rank")


def read(ctx):
    per_dock = []
    for r in ctx.records:
        rec = getattr(r.result, "timings", None)
        if rec is None:
            continue
        ms = [rec.device_ms(i) for i, s in enumerate(rec.spans) if s.name in NAMES]
        if ms and None not in ms:
            per_dock.append(sum(ms))
    return sum(per_dock) / len(per_dock) if per_dock else None
