"""sampler.step_ms: the mean span (ms) of one reverse-diffusion step (the
score forward and the sampler's update) on the device's stream, over the
window's docks: the stream time of each dock's ``diffusion`` span, between
the CUDA events the program records as it opens and closes
(``DockingResult.timings``), over the ``step`` spans that tile it. It is
the steps' wall time as the device sees it, waits on the host included."""


def read(ctx):
    ms, steps = 0.0, 0
    for r in ctx.records:
        rec = getattr(r.result, "timings", None)
        if rec is None:
            continue
        for i, s in enumerate(rec.spans):
            if s.name == "diffusion":
                m = rec.device_ms(i)
                if m is not None:
                    ms += m
                    steps += sum(1 for t in rec.spans if t.parent == i and t.name == "step")
    return ms / steps if steps else None
