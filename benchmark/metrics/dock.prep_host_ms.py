"""dock.prep_host_ms: the host's time (ms) per dock before the first step:
the program's ``prep`` spans (pre-crop, bucket, padding and the copies to
the device, the confidence input, the noise draw and the start poses) and
its ``embed_receptor`` span (the receptor cache), summed per dock from
``DockingResult.timings`` and averaged over the window's docks."""

NAMES = ("prep", "embed_receptor")


def read(ctx):
    per_dock = []
    for r in ctx.records:
        rec = getattr(r.result, "timings", None)
        if rec is not None:
            per_dock.append(sum((s.end_ns - s.start_ns) / 1e6 for s in rec.spans if s.name in NAMES))
    return sum(per_dock) / len(per_dock) if per_dock else None
