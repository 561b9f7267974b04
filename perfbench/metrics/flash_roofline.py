"""flash_roofline: the least time of causal attention's work in every
attention layer (the larger of FLOPs at the bf16 peak and bytes at HBM
bandwidth, each call apart), over the device time of the flash kernel in
the traced cycle."""
from perfbench.roofline import peaks, work

KERNEL = ("flash_wgmma_kernel", "flash_fwd_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.seconds(KERNEL)
    least = sum(peaks.least_time(*w) for s in ctx.traced
                for w in work.step_calls(ctx.conf, s.request.length)["flash"])
    return 100.0 * least / spent if spent and least else None
