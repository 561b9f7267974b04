"""gmm_roofline: the least time of the expert FFNs' grouped products for
the tokens x top_k assignments the router makes (the larger of FLOPs at
the bf16 peak and bytes at HBM bandwidth, each product apart), over the
device time of the GMM kernel in the traced cycle."""
from perfbench.roofline import peaks, work

KERNEL = ("gmm_tma_kernel", "gmm_decode_kernel", "gmm_bf16_kernel",
          "gmm_f32_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.seconds(KERNEL)
    least = sum(peaks.least_time(*w) for s in ctx.traced
                for w in work.step_calls(ctx.conf, s.request.length)["gmm"])
    return 100.0 * least / spent if spent and least else None
