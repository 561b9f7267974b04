"""mfu: the model FLOPs of every request of the window (the benchmark's
own count, ``perfbench/roofline/work.py::model_flops``) over the window's
time x the H100's bf16 peak."""
from perfbench.roofline import peaks, work


def read(ctx):
    flops = sum(work.model_flops(ctx.conf, s.request.length)
                for s in ctx.served)
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
