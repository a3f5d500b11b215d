"""confidence.wall_ms_per_dock: the confidence model's forwards per dock
(ms), each the span between CUDA events the benchmark's forward hooks
record on the stream as the forward starts and ends (its wall time as the
device sees it, waits on the host included), summed over a dock's pose
chunks and averaged over the window's docks."""


def read(ctx):
    per_dock = {}
    for dock, m in ctx.forward_ms.get("confidence", []):
        if dock is not None:
            per_dock[dock] = per_dock.get(dock, 0.0) + m
    return sum(per_dock.values()) / len(per_dock) if per_dock else None
