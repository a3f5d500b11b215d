"""sampler.step_host_ms: the mean span (ms) of one reverse-diffusion step
on the host's clock, from the program's ``step`` span
(``DockingResult.timings``) over the window's docks: the host's time to
issue the step's work, with no synchronisation. Near ``sampler.step_ms``
the device waits on the host; far below it the device works behind the
host."""


def read(ctx):
    ms = []
    for r in ctx.records:
        rec = getattr(r.result, "timings", None)
        if rec is not None:
            ms += [(s.end_ns - s.start_ns) / 1e6 for s in rec.spans if s.name == "step"]
    return sum(ms) / len(ms) if ms else None
