"""Spans and counters: where the program's time and work go, read where
the work happens.

* :func:`span` — ``with obs.span("moe.gmm"): ...`` around a piece of work;
* :func:`count` — ``obs.count("moe.kept", keep.sum())`` at a boundary;
* :func:`collecting` — one counter's values, a block at a time, with
  spans and every other counter off;
* the readers :func:`device_seconds`, :func:`counters`, :func:`records`,
  and :func:`reset`.

**Off** (the default) a span is a check of two flags that returns a
shared empty context, and a counter site (``if obs.active(): ...``) the
same check: no profiler range, no CUDA event, nothing kept.  **On** —
while ``torch.profiler`` records, or inside :func:`recording` — a span

1. while a profiler records, opens its range ``repro_torch.<name>``, so
   that the trace places the span on the clock of the device's kernels;
2. records a pair of timing CUDA events on the current stream (once CUDA
   is initialised), and the host clock at both ends;
3. keeps its name, its parent span and its step id until :func:`reset`.

A span opened where no span is open is a root, and starts a new step
id; every span inside it carries that id.  A counter keeps each value
added while on (a host number, or a 0-d device tensor, summed on the
device when read: no host sync where it is counted).  Records are kept
only while on, so their memory is bounded by the window recorded.  One
thread opens spans at a time: autograd's device thread runs a backward's
recompute while the thread that called ``backward()`` waits, so its
spans nest under the open one.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "active", "recording", "collecting", "Span",
           "records", "device_seconds", "counters", "reset"]

_recording = 0                    # open recording() blocks
_open: List["Span"] = []          # the spans open now, outermost first
_spans: List["Span"] = []         # every span opened while on
_counts: Dict[str, list] = {}     # counter name -> each value added
_collect: Dict[str, List[list]] = {}  # counter name -> open collecting()s
_step = 0
_stream = (None, None)            # (device, raw stream) -> its Stream
_OFF = contextlib.nullcontext()


def active(name: str = None) -> bool:
    """Whether spans and counters record: while ``torch.profiler``
    records, or inside :func:`recording`; with ``name``, also inside a
    :func:`collecting` block of that counter."""
    return bool(_recording) or _profiler._is_profiler_enabled \
        or name in _collect


@contextlib.contextmanager
def recording():
    """Spans and counters on within the block, profiler or not."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


@contextlib.contextmanager
def collecting(name: str):
    """The counter ``name`` alone on within the block: the yielded list
    gets each value added to it there, and nothing is kept beyond the
    list unless obs is on besides.  No span records."""
    got: list = []
    _collect.setdefault(name, []).append(got)
    try:
        yield got
    finally:
        rest = [g for g in _collect[name] if g is not got]
        if rest:
            _collect[name] = rest
        else:
            del _collect[name]


class Span:
    """One span: ``name``, ``parent`` (the enclosing :class:`Span` or
    None), ``step`` (the step id of its root), its host clock and, where
    CUDA is in use, its two events."""
    __slots__ = ("name", "parent", "step", "t0", "t1", "ev0", "ev1",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self) -> "Span":
        global _step
        self.parent = _open[-1] if _open else None
        if self.parent is None:
            _step += 1
            self.step = _step
        else:
            self.step = self.parent.step
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function("repro_torch."
                                                         + self.name)
            self._range.__enter__()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(_current_stream())
        _open.append(self)
        _spans.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self.ev1 is not None:
            self.ev1.record(_current_stream())
        _open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    def seconds(self) -> float:
        """Its time on the device's stream (its events; after a
        synchronise), or on the host clock without CUDA."""
        if self.ev0 is not None:
            return self.ev0.elapsed_time(self.ev1) / 1e3
        return self.t1 - self.t0


def _current_stream():
    """The current CUDA stream; its Python object is kept while it stays
    current (``torch.cuda.current_stream()`` builds a new one on every
    call, most of an event's host cost)."""
    global _stream
    dev = torch._C._cuda_getDevice()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    if _stream[0] != key:
        _stream = (key, torch.cuda.current_stream(dev))
    return _stream[1]


def span(name: str):
    """A context manager: the span ``name`` while on, else nothing."""
    if _recording or _profiler._is_profiler_enabled:
        return Span(name)
    return _OFF


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a 0-d tensor left on its device) to the
    counter ``name`` while on.  A site whose value costs work computes it
    under ``if obs.active(name):``."""
    if _recording or _profiler._is_profiler_enabled:
        _counts.setdefault(name, []).append(value)
    for got in _collect.get(name, ()):
        got.append(value)


def records() -> List[Span]:
    """The spans opened while on since :func:`reset`, in order of
    opening."""
    return list(_spans)


def device_seconds() -> Dict[str, Dict[str, float]]:
    """Per span name over the closed spans: ``total`` (device-stream
    seconds), ``self`` (the total less what its child spans cover) and
    ``calls``.  Synchronises once."""
    done = [s for s in _spans if s.t1 is not None]
    if any(s.ev0 is not None for s in done):
        torch.cuda.synchronize()
    took = {id(s): s.seconds() for s in done}
    covered: Dict[int, float] = {}
    for s in done:
        if s.parent is not None:
            covered[id(s.parent)] = covered.get(id(s.parent), 0.0) \
                + took[id(s)]
    out: Dict[str, Dict[str, float]] = {}
    for s in done:
        d = out.setdefault(s.name, {"total": 0.0, "self": 0.0, "calls": 0})
        d["total"] += took[id(s)]
        d["self"] += took[id(s)] - covered.get(id(s), 0.0)
        d["calls"] += 1
    return out


def counters() -> Dict[str, float]:
    """Each counter's sum (device values summed on their device, then
    read)."""
    return {name: _total(vals) for name, vals in _counts.items()}


def _total(vals: list):
    host = sum(v for v in vals if not isinstance(v, torch.Tensor))
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for v in vals:
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(v.reshape(()))
    return host + sum(torch.stack(g).sum().item() for g in groups.values())


def reset() -> None:
    """Forget every span and counter value kept (spans open now close
    unrecorded)."""
    global _step
    _spans.clear()
    _counts.clear()
    _step = 0

