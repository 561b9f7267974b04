"""host_enqueue_ms: the host's time in the ``prefill_step`` call, before
the first token is read back (which waits for the device), per step,
over every step of the window (host clock)."""


def read(ctx):
    t = [s.enqueued - s.start for s in ctx.served]
    return sum(t) / len(t) * 1e3 if t else None
