"""score.step_wall_ms: the mean span (ms) of one score-model forward over
the window's docks, between CUDA events the benchmark's forward hooks
record on the stream as the forward starts and ends. It is the forward's
wall time as the device sees it, waits on the host included: in a
host-bound dock mostly the host's dispatch, not device work."""


def read(ctx):
    ms = [m for dock, m in ctx.forward_ms.get("score", []) if dock is not None]
    return sum(ms) / len(ms) if ms else None
