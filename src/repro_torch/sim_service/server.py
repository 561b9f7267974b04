"""The async simulation server and its synchronous facade.

The port of ``repro/sim_service/server.py``.  Its structure mirrors
:mod:`repro_torch.launch.serve`'s continuous-batching decode loop: a
bounded admission queue (a ``deque``, popped from the head), a per-tick
scheduler, and one batched call per shape per tick.  Slots here are
*batch lanes* grouped by :class:`~repro_torch.sim_service.bucketing.BucketKey`
(batched-shape identity) instead of a fixed slot pool, and a request runs
a statically-scheduled sequence of fence blocks rather than an
open-ended decode.

Scheduling contract (the amortization story):

* every tick, each bucket with work advances its in-flight
  :class:`~repro_torch.sim_service.streaming.BatchRunner` by exactly one
  fence block — ONE batched call per bucket per tick, on a card one
  router kernel call by default, and one copy to the host;
* a new batch forms only when the bucket has no runner in flight, from
  every lane then waiting (up to ``max_batch``, padded to a power of
  two) — so late arrivals join the *next* batch, never an in-flight
  one;
* admission is bounded (``queue_limit`` waiting lanes); beyond it
  ``submit`` raises :class:`~repro_torch.sim_service.request.ServiceOverloaded`
  — backpressure, not silent dropping;
* telemetry streams per fence block: each lane's
  :class:`~repro_torch.netsim.measure.StreamChunk` lands on its request's
  :class:`Ticket` as soon as the block has run (async-iterate
  ``Ticket.stream()`` under a running ``serve()`` task, or consume the
  sync generator ``SimService.stream``).

The server runs on the card unless ``device="cpu"`` (the plain PyTorch
step); with no card and no ``device="cpu"`` it raises.  On a card the
router library is built, or loaded from the build directory, when the
server is made.  ``compile_cache_dir`` names that directory: the server
keeps it and sets it (:func:`repro_torch.kernels.build.using_build_dir`)
around its own work only, so a *process* restart loads the library from
disk instead of building it, and the rest of the process keeps its own
build directory.  On the CPU there is nothing to build.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
from typing import (AsyncIterator, Deque, Dict, List, NamedTuple, Optional,
                    Sequence, Union)

from repro_torch.kernels import build
from repro_torch.kernels.backend import resolve_device
from repro_torch.netsim.measure import PhaseStats, StreamChunk

from .bucketing import BucketKey, bucket_key, next_pow2
from .metrics import ServiceMetrics
from .request import (LaneSpec, ServiceOverloaded, SimRequest, SimResponse,
                      SweepRequest, SweepResponse)
from .streaming import BatchRunner

__all__ = ["TelemetryChunk", "Ticket", "SimServer", "SimService"]

Request = Union[SimRequest, SweepRequest]
Response = Union[SimResponse, SweepResponse]


class TelemetryChunk(NamedTuple):
    """One streamed fence-block delta, addressed to a request: ``lane``
    indexes the request's lanes (always 0 for a :class:`SimRequest`; the
    rate index for sweeps) and ``label`` names it (e.g. ``uniform@0.3``)."""
    rid: int
    lane: int
    label: str
    chunk: StreamChunk


class Ticket:
    """A submitted request's handle: chunks accumulate on ``.chunks`` as
    ticks run; ``.done``/``.response`` flip when every lane finished.
    Async consumption (``stream()`` / ``result()``) needs the server's
    ``serve()`` loop running somewhere; the sync paths
    (``SimService.run`` / ``SimService.stream``) drive ticks themselves."""

    def __init__(self, server: "SimServer", rid: int, request: Request,
                 n_lanes: int):
        self._server = server
        self.rid = rid
        self.request = request
        self.chunks: List[TelemetryChunk] = []
        self.stats: List[Optional[PhaseStats]] = [None] * n_lanes
        self.done = False
        self.response: Optional[Response] = None
        self.submitted_at = time.perf_counter()
        self.started_at: Optional[float] = None
        self._runner_meta: Dict[str, object] = {}

    async def stream(self) -> AsyncIterator[TelemetryChunk]:
        cursor = 0
        while True:
            while cursor < len(self.chunks):
                yield self.chunks[cursor]
                cursor += 1
            if self.done:
                return
            await self._server._wait_tick()

    async def result(self) -> Response:
        while not self.done:
            await self._server._wait_tick()
        assert self.response is not None
        return self.response


@dataclasses.dataclass
class _Waiter:
    ticket: Ticket
    lane_idx: int
    spec: LaneSpec


@dataclasses.dataclass
class _Bucket:
    waiting: Deque[_Waiter] = dataclasses.field(
        default_factory=collections.deque)
    inflight: Optional[BatchRunner] = None
    members: List[_Waiter] = dataclasses.field(default_factory=list)


class SimServer:
    """Continuous-batching phased-measurement server (see module doc)."""

    def __init__(self, *, max_batch: int = 8, queue_limit: int = 64,
                 compile_cache_dir=None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        # batch widths are pow2-padded, so the cap must be a power of two
        # to stay a cap; round down (8 -> 8, 6 -> 4)
        self.max_batch = 1 << (int(max_batch).bit_length() - 1)
        self.queue_limit = int(queue_limit)
        self.device = resolve_device(device)
        self.metrics = ServiceMetrics()
        self.metrics.device = self.device
        self._buckets: Dict[BucketKey, _Bucket] = {}
        self._pending = 0          # waiting lanes (the bounded queue)
        self._next_rid = 0
        self._tick_event: Optional[asyncio.Event] = None
        self._stop = False
        self.compile_cache_dir = compile_cache_dir
        if self.device.type == "cuda":
            from repro_torch.kernels.router_step import _library
            with build.using_build_dir(compile_cache_dir):
                _library()
                self.metrics.build_dir = build.build_dir()

    # -- admission -----------------------------------------------------
    def submit(self, request: Request) -> Ticket:
        """Queue a request; raises :class:`ServiceOverloaded` when the
        bounded queue cannot take its lanes."""
        lanes = request.lanes()
        if self._pending + len(lanes) > self.queue_limit:
            self.metrics.rejected += 1
            raise ServiceOverloaded(
                f"queue holds {self._pending}/{self.queue_limit} lanes; "
                f"request needs {len(lanes)} more — retry after ticks "
                f"drain the backlog")
        rid = self._next_rid
        self._next_rid += 1
        ticket = Ticket(self, rid, request, len(lanes))
        key = request.sweep_key()
        for idx, lane in enumerate(lanes):
            bkey = bucket_key(key, lane.program, request.check_every)
            self._buckets.setdefault(bkey, _Bucket()).waiting.append(
                _Waiter(ticket, idx, lane))
        self._pending += len(lanes)
        self.metrics.submitted += 1
        self.metrics.lanes += len(lanes)
        self.metrics.peak_pending = max(self.metrics.peak_pending,
                                        self._pending)
        return ticket

    @property
    def pending_lanes(self) -> int:
        return self._pending

    @property
    def idle(self) -> bool:
        return not self._buckets

    # -- the scheduler tick ---------------------------------------------
    def tick(self) -> bool:
        """One scheduler step: form batches where buckets are free, then
        advance every in-flight batch by one fence block (one batched
        call per bucket).  Returns True when any work ran."""
        with build.using_build_dir(self.compile_cache_dir):
            return self._tick()

    def _tick(self) -> bool:
        did = False
        for bkey, b in list(self._buckets.items()):
            if b.inflight is None and b.waiting:
                take = [b.waiting.popleft()
                        for _ in range(min(len(b.waiting), self.max_batch))]
                self._pending -= len(take)
                b.members = take
                b.inflight = BatchRunner(bkey, [w.spec for w in take],
                                         next_pow2(len(take)), self.device)
                now = time.perf_counter()
                for w in take:
                    if w.ticket.started_at is None:
                        w.ticket.started_at = now
                self.metrics.batches += 1
            if b.inflight is not None:
                for lane_i, chunk in b.inflight.advance():
                    w = b.members[lane_i]
                    w.ticket.chunks.append(TelemetryChunk(
                        w.ticket.rid, w.lane_idx, w.spec.label, chunk))
                    self.metrics.chunks += 1
                self.metrics.blocks += 1
                did = True
                if b.inflight.done:
                    self._finish(bkey, b)
            if b.inflight is None and not b.waiting:
                del self._buckets[bkey]
        self.metrics.ticks += 1
        self._notify()
        return did

    def _finish(self, bkey: BucketKey, b: _Bucket) -> None:
        runner = b.inflight
        assert runner is not None
        stats = runner.finalize()
        self.metrics.sim_compiles += runner.sim_compiles
        self.metrics.aux_compiles += runner.aux_compiles
        now = time.perf_counter()
        for w, st in zip(b.members, stats):
            t = w.ticket
            t.stats[w.lane_idx] = st
            t._runner_meta = {
                "bucket": f"{bkey.key.cfg.topology.spec}-"
                          f"{bkey.key.cfg.nx}x{bkey.key.cfg.ny}"
                          f"/L{bkey.prog_len}/ce{bkey.check_every}",
                "batch_width": runner.width,
                "batch_lanes": len(runner.lanes),
                "blocks": len(runner.schedule),
                "new_sim_compiles": runner.sim_compiles,
                "new_aux_compiles": runner.aux_compiles,
            }
            if all(s is not None for s in t.stats):
                meta = dict(t._runner_meta)
                meta.update(
                    queue_wait_s=round((t.started_at or now)
                                       - t.submitted_at, 6),
                    service_s=round(now - (t.started_at or now), 6),
                    total_s=round(now - t.submitted_at, 6),
                    chunks=len(t.chunks))
                t.response = t.request.build_response(t.rid, t.stats, meta)
                t.done = True
                self.metrics.completed += 1
        b.inflight = None
        b.members = []

    def run_until_idle(self, max_ticks: int = 1_000_000) -> int:
        """Drive ticks synchronously until every request finished."""
        n = 0
        while not self.idle:
            if n >= max_ticks:
                raise RuntimeError(
                    f"server not idle after {max_ticks} ticks")
            self.tick()
            n += 1
        return n

    # -- async surface ---------------------------------------------------
    def _notify(self) -> None:
        ev, self._tick_event = self._tick_event, None
        if ev is not None:
            ev.set()

    async def _wait_tick(self) -> None:
        if self._tick_event is None:
            self._tick_event = asyncio.Event()
        await self._tick_event.wait()

    async def serve(self, *, until_idle: bool = False,
                    idle_sleep: float = 0.001) -> None:
        """The server loop: tick until :meth:`stop` (or, with
        ``until_idle``, until the queue drains).  Run as a task next to
        async consumers of ``Ticket.stream()`` / ``Ticket.result()``."""
        self._stop = False
        while not self._stop:
            did = self.tick()
            if until_idle and self.idle:
                return
            await asyncio.sleep(0 if did else idle_sleep)

    def stop(self) -> None:
        self._stop = True


class SimService:
    """Synchronous facade over :class:`SimServer` — no event loop needed.
    ``run`` batches a list of requests through to completion; ``stream``
    is a generator of :class:`TelemetryChunk` whose ``StopIteration``
    value is the response.  Keyword arguments go to :class:`SimServer`
    (``device="cpu"`` runs the plain PyTorch step)."""

    def __init__(self, **kw):
        self.server = SimServer(**kw)

    @property
    def metrics(self) -> ServiceMetrics:
        return self.server.metrics

    def submit(self, request: Request) -> Ticket:
        return self.server.submit(request)

    def run(self, requests: Union[Request, Sequence[Request]]
            ) -> List[Response]:
        reqs = [requests] if isinstance(requests, (SimRequest, SweepRequest)) \
            else list(requests)
        tickets = [self.server.submit(r) for r in reqs]
        self.server.run_until_idle()
        return [t.response for t in tickets]

    def run_one(self, request: Request) -> Response:
        return self.run([request])[0]

    def stream(self, request: Request):
        ticket = self.server.submit(request)
        cursor = 0
        while not ticket.done:
            self.server.tick()
            while cursor < len(ticket.chunks):
                yield ticket.chunks[cursor]
                cursor += 1
        while cursor < len(ticket.chunks):
            yield ticket.chunks[cursor]
            cursor += 1
        return ticket.response
