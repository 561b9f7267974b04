"""moe_plain_share: the device time of the MoE blocks' own plain code
(routing and each FIFO, dispatch, the activation between the grouped
products, combine) over the device time of the program's steps, in the
traced cycle.

Each device operation is put down to the innermost ``repro_torch.*``
profiler range (the program's spans, ``repro_torch.obs``) open where the
host call that enqueued it began; the share is the operations under
``repro_torch.moe`` or a ``repro_torch.moe.*`` range other than
``repro_torch.moe.gmm``, over those under ``repro_torch.prefill_step``.
Idle time counts in neither.  The trace keeps names and times, not the
profiler's correlation ids: on one stream the device runs its operations
in the order they were enqueued, so the n-th kernel is the n-th launch
call, the n-th copy the n-th copy call, the n-th memset the n-th memset
call (where the counts differ, paired from the end that leaves no
operation starting before its call).  None where the trace has no step
range (a program without spans) or no device operations (a CPU run)."""
import bisect

STEP = "repro_torch.prefill_step"
MOE = "repro_torch.moe"
GMM = "repro_torch.moe.gmm"


def _op_kind(name):
    return "copy" if name.startswith("Memcpy") else \
        "memset" if name.startswith("Memset") else "kernel"


def _call_kind(name):
    """The kind of device operation a host call enqueues, or None."""
    if not name.startswith("cu"):
        return None
    if "Launch" in name and "Kernel" in name:
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "copy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def launches(tr):
    """Each device operation of ``tr`` with the host time at which the
    call that enqueued it began: [(device seconds, call start)], the
    operations without a call left out."""
    calls, ops = {}, {}
    last_end = None
    for n, s, e in sorted(tr.host, key=lambda t: t[1]):
        kind = _call_kind(n)
        if kind is None:
            continue
        if last_end is not None and s < last_end:
            continue            # a call made inside another: one operation
        last_end = e
        calls.setdefault(kind, []).append(s)
    for n, s, e in sorted(tr.device, key=lambda t: t[1]):
        ops.setdefault(_op_kind(n), []).append((s, e))
    out = []
    for kind, got in ops.items():
        made = calls.get(kind, [])
        n = min(len(got), len(made))
        # where the counts differ, the unpaired ones lie at one end (a
        # profiler session after the first in a process loses its first
        # operations): pair from the end that leaves no operation
        # starting before its call, else from the start
        pairs = min(
            (list(zip(got[len(got) - n:], made[len(made) - n:])),
             list(zip(got[:n], made[:n]))),
            key=lambda ps: sum(1 for (s, _), c in ps if s < c))
        out += [((e - s) / 1e6, c) for (s, e), c in pairs]
    return out


def innermost(ranges, times):
    """For each time (ascending), the ``repro_torch.*`` ranges open there,
    outermost first; ``ranges`` are (name, start, end) that nest."""
    ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
    starts = [r[1] for r in ranges]
    stack, j, out = [], 0, []
    for t in times:
        k = bisect.bisect_right(starts, t)
        while j < k:
            r = ranges[j]
            while stack and stack[-1][2] <= r[1]:
                stack.pop()
            stack.append(r)
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append([r[0] for r in stack])
    return out


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    ranges = [r for r in tr.host if r[0].startswith("repro_torch.")]
    if not any(r[0] == STEP for r in ranges):
        return None
    ops = sorted(launches(tr), key=lambda o: o[1])
    moe = step = 0.0
    for (sec, _), open_ in zip(ops, innermost(ranges, [t for _, t in ops])):
        if STEP not in open_:
            continue
        step += sec
        inner = open_[-1]
        if (inner == MOE or inner.startswith(MOE + ".")) and inner != GMM:
            moe += sec
    if step <= 0:
        return None
    return 100.0 * moe / step
