"""dock.mfu: the model FLOPs of the window's docks (score and confidence
forwards at the real, unpadded sizes, from the benchmark's work census)
over the window's seconds times the H100's dense TF32 peak (495 TFLOP/s,
the highest rate of float32-input products; at the card's power limit of
700 W)."""

from benchmark.work.peaks import TF32_PEAK_FLOPS


def read(ctx):
    flops = sum(ctx.work[r.complex]["score_real"].flops() + ctx.work[r.complex]["confidence_real"].flops()
                for r in ctx.records)
    return 100.0 * flops / (ctx.window_s * TF32_PEAK_FLOPS) if flops > 0 and ctx.window_s > 0 else None
