"""Reading the profiler's trace of the traced cycle: every operation that
ran on the device, the time the device was busy (the union of their
intervals), and what took the most time, device and idle."""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float]]    # (name, start us, end us)
    host: List[Tuple[str, float, float]]
    window_s: float                            # host clock of the cycle

    def seconds(self, patterns) -> float:
        """Device seconds of the operations whose name holds a pattern."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in patterns)) / 1e6

    def total_s(self) -> float:
        return sum(e - s for _, s, e in self.device) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6


def read(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.events():
        r = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type != DeviceType.CUDA:
            host.append(r)
        elif not getattr(ev, "is_user_annotation", False):
            dev.append(r)   # a range's copy on the device side is not work
    return Trace(dev, host, window_s)


def _short(name: str) -> str:
    return name[:120]


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (summed by name), and
    the device's idle time between operations summed by the innermost
    host operation running at each gap's midpoint."""
    ops = collections.Counter()
    for n, s, e in tr.device:
        ops[_short(n)] += (e - s) / 1e6
    busy = tr.busy()
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    host = sorted(tr.host, key=lambda t: t[1])
    idle = collections.Counter()
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
        mid = (g0 + g1) / 2
        inner = [h for h in host if h[1] <= mid <= h[2]]
        label = max(inner, key=lambda h: h[1])[0] if inner else "no host op"
        idle[_short(label)] += (g1 - g0) / 1e6
    return {"device_ops": [[n, t] for n, t in ops.most_common(top)],
            "idle_gaps": [[n, t] for n, t in idle.most_common(top)]}
