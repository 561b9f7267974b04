"""step_idle_share: the device's idle time inside the program's steps
(the host ranges ``repro_torch.prefill_step`` of ``repro_torch.obs``'s
spans) as a share of the traced cycle: the idle that the program's own
host work causes (launches, host syncs, allocations).  The rest of
``device_idle_share`` lies between steps, in the harness.

Both are read on the trace's clock, over one window: from the first
step's start to the cycle's last event (a host range or a device
operation; after the last step the device still runs its work).  Device
work outside that window is clipped away.  So the share is at most the
device's idle share of the same window, which is at most
``device_idle_share`` where the trace holds only the cycle's device work.
None where the trace has no step range (a program without spans) or no
device operations (a CPU run)."""
import bisect

SPAN = "repro_torch.prefill_step"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    steps = sorted((s, e) for n, s, e in tr.host if n == SPAN)
    if not steps:
        return None
    a0 = steps[0][0]
    z = max(e for _, _, e in tr.device + tr.host)
    busy = [(max(s, a0), min(e, z)) for s, e in tr.busy() if e > a0 and s < z]
    starts = [s for s, _ in busy]
    inside = 0.0
    for a, b in steps:
        covered = 0.0
        for s, e in busy[max(bisect.bisect_right(starts, a) - 1, 0):
                         bisect.bisect_left(starts, b)]:
            covered += max(0.0, min(b, e) - max(a, s))
        inside += (b - a) - covered
    return 100.0 * inside / (z - a0)
