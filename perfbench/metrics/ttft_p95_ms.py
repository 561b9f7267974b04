"""ttft_p95_ms: the 95th percentile over every request of the window of
the time from the start of the step that takes it to its first token on
the host (host clock)."""
import statistics


def read(ctx):
    ttft = [s.done - s.start for s in ctx.served]
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=20, method="inclusive")[-1] * 1e3
