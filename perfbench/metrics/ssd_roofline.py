"""ssd_roofline: the least time of every Mamba mixer's SSD scan (the
larger of the chunked algorithm's FLOPs at the bf16 peak and its bytes
at HBM bandwidth, each call apart), over the device time of the SSD
kernels in the traced cycle."""
from perfbench.roofline import peaks, work

KERNEL = ("ssd_state_", "ssd_pass_", "ssd_out_")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.seconds(KERNEL)
    least = sum(peaks.least_time(*w) for s in ctx.traced
                for w in work.step_calls(ctx.conf, s.request.length)["ssd"])
    return 100.0 * least / spent if spent and least else None
