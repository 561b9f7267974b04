"""tokens_per_s: every prompt token of the requests completed in the
window, over the window (host clock)."""


def read(ctx):
    return sum(s.request.length for s in ctx.served) / ctx.window_s
