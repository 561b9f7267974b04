"""device_idle_share: the share of the traced cycle (host clock) in which
no operation ran on the device (1 - the union of the device's busy
intervals over the cycle)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
