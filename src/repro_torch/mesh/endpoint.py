"""The mesh-attach interface: how a user design plugs into the network.

The paper's headline deliverable is the standardized
``bsg_manycore_link`` endpoint interface — a valid/ready forward
(request) link plus a credit-counted reverse (response) link — that lets
arbitrary designs (accelerators, memory controllers, off-chip bridges)
attach to any tile of the mesh.  :class:`Endpoint` is that interface for
the simulators:

* ``offer(cycle, credits)`` — the forward link.  The simulator calls it
  once per cycle **only when the link is ready** (the tile has a credit
  and the injection FIFO has space); returning a :class:`Request` asserts
  *valid* and the packet is guaranteed to inject THIS cycle (so the
  endpoint may commit its state immediately); returning ``None`` leaves
  the link idle.  ``credits`` is the tile's remaining credit count, for
  endpoints that pace themselves below the hardware window.
* ``deliver(response)`` — the reverse link.  Called when a response lands
  in the tile's registered output port.  Per the paper's sink rule the
  endpoint **cannot back-pressure** this call; it must absorb the
  response at line rate.
* ``done()`` — drain fence: ``True`` once the endpoint will never offer
  another packet.  ``Simulator.run_until_drained`` waits for every
  endpoint's ``done()`` plus the credit fence.

Built-ins:

* :class:`ProgramEndpoint` — one tile's slice of a precomputed injection
  program, re-expressed through the reactive interface.  Driving a whole
  program through ProgramEndpoints is cycle-identical to the simulators'
  native program path (asserted in ``tests/test_torch_endpoints.py``).
* :class:`DmaEndpoint` — a remote-store DMA engine: streams a buffer into
  a remote tile's memory with a configurable outstanding-request window.
* :class:`MemoryControllerEndpoint` — the request/reply client of the
  paper's source-code integration example: each reply's data selects the
  next request (pointer chase), so the traffic is *reactive* — it cannot
  be expressed as a precomputed program without running the mesh.

Endpoints run natively on the numpy oracle
(:class:`repro_torch.core.netsim.MeshSim`, on the host: the callbacks are
the user's Python).  On the torch backend the facade replays them through
:func:`trace_to_program`: the oracle records the exact cycle each packet
injected, and an injection program with ``not_before`` pinned to those
cycles reproduces the run bit-identically on the card (the injection
condition is a pure function of simulator state, which matches by
induction).  That keeps endpoint-driven scenarios stackable as lanes of a
sweep.

The port's own copy of the JAX package's ``repro/mesh/endpoint.py``;
``tests/test_torch_endpoints.py`` holds every scenario bit-identical to
the original's oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.netsim import OP_LOAD, OP_STORE

from .traffic import empty_program

__all__ = ["Request", "Response", "Endpoint", "ProgramEndpoint",
           "DmaEndpoint", "MemoryControllerEndpoint", "trace_to_program"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One forward-link packet (the master side of the link).

    ``src_x/src_y`` and the injection-cycle tag are filled in by the
    simulator; the endpoint only names the remote operation."""
    dst_x: int
    dst_y: int
    addr: int
    data: int = 0
    cmp: int = 0
    op: int = OP_STORE


@dataclasses.dataclass(frozen=True)
class Response:
    """One reverse-link packet as seen at the registered output port."""
    op: int
    addr: int
    data: int          # load/CAS return value; 0 for store acks
    src_x: int         # the tile that serviced the request
    src_y: int
    tag: int           # the request's injection cycle
    cycle: int         # the cycle this response became visible

    @property
    def latency(self) -> int:
        """Round-trip cycles, injection -> registered response."""
        return self.cycle - self.tag


@runtime_checkable
class Endpoint(Protocol):
    """The mesh-attach protocol (see module docstring for the contract)."""

    def offer(self, cycle: int, credits: int) -> Optional[Request]:
        """Forward link: return a packet to inject this cycle, or None.
        Called only when the link is ready; a returned packet is
        guaranteed accepted."""
        ...

    def deliver(self, response: Response) -> None:
        """Reverse link: absorb one response (cannot back-pressure)."""
        ...

    def done(self) -> bool:
        """True once no further packet will ever be offered."""
        ...


# ----------------------------------------------------------------------
# built-in endpoints
# ----------------------------------------------------------------------
class ProgramEndpoint:
    """One tile's slice of an injection program behind the reactive
    interface — the compatibility bridge from precomputed dict-of-arrays
    programs to the :class:`Endpoint` world.

    Use :meth:`grid` to wrap a whole ``(ny, nx, L)`` program as one
    endpoint per tile.
    """

    def __init__(self, entries: Dict[str, np.ndarray], x: int, y: int):
        tile = {k: np.asarray(v)[y, x] for k, v in entries.items()}
        n = int((tile["op"] >= 0).sum())
        self._fields = {k: tile.get(k, np.zeros(len(tile["op"]), np.int64))
                        for k in ("dst_x", "dst_y", "addr", "data", "cmp",
                                  "op", "not_before")}
        self._n = n
        self._ptr = 0

    @classmethod
    def grid(cls, entries: Dict[str, np.ndarray]
             ) -> Dict[Tuple[int, int], "ProgramEndpoint"]:
        """One endpoint per tile, keyed ``(x, y)`` — ready for
        ``Simulator.attach(ep, at=(x, y))``."""
        ny, nx = np.asarray(entries["op"]).shape[:2]
        return {(x, y): cls(entries, x, y)
                for y in range(ny) for x in range(nx)}

    def offer(self, cycle: int, credits: int) -> Optional[Request]:
        if self._ptr >= self._n:
            return None
        f, i = self._fields, self._ptr
        if int(f["not_before"][i]) > cycle:
            return None
        self._ptr += 1
        return Request(dst_x=int(f["dst_x"][i]), dst_y=int(f["dst_y"][i]),
                       addr=int(f["addr"][i]), data=int(f["data"][i]),
                       cmp=int(f["cmp"][i]), op=int(f["op"][i]))

    def deliver(self, response: Response) -> None:
        pass                      # fire-and-forget, like the program path

    def done(self) -> bool:
        return self._ptr >= self._n


class DmaEndpoint:
    """Remote-store DMA engine: streams ``data`` into the memory of tile
    ``(dst_x, dst_y)`` starting at ``addr``, at most ``max_inflight``
    stores outstanding (its own window on top of the hardware credits).

    After the drain fence, ``acked`` equals ``len(data)`` and the
    destination tile's memory holds the buffer.
    """

    def __init__(self, dst_x: int, dst_y: int, data: Sequence[int],
                 addr: int = 0, max_inflight: Optional[int] = None):
        self.dst_x, self.dst_y, self.addr = dst_x, dst_y, addr
        self.data = [int(v) for v in data]
        self.max_inflight = len(self.data) if max_inflight is None \
            else max_inflight
        if self.max_inflight < 1:
            raise ValueError(
                f"DMA window must allow at least one outstanding store, "
                f"got max_inflight={max_inflight}")
        self.sent = 0
        self.acked = 0
        self.peak_inflight = 0

    def offer(self, cycle: int, credits: int) -> Optional[Request]:
        inflight = self.sent - self.acked
        if self.sent >= len(self.data) or inflight >= self.max_inflight:
            return None
        req = Request(dst_x=self.dst_x, dst_y=self.dst_y,
                      addr=self.addr + self.sent,
                      data=self.data[self.sent], op=OP_STORE)
        self.sent += 1
        self.peak_inflight = max(self.peak_inflight, inflight + 1)
        return req

    def deliver(self, response: Response) -> None:
        self.acked += 1

    def done(self) -> bool:
        return self.sent >= len(self.data)


class MemoryControllerEndpoint:
    """Request/reply memory-controller client — the paper's integration
    example expressed as an endpoint.

    Issues a remote load to the controller tile ``(dst_x, dst_y)``; each
    reply's *data* is the address of the next load (pointer chase), for
    ``n_requests`` links of the chain.  Because every request depends on
    the previous response, this traffic is genuinely reactive: it cannot
    be precomputed without simulating the mesh.

    ``visited`` records the chased addresses; ``latencies`` the per-link
    round-trip cycles.
    """

    def __init__(self, dst_x: int, dst_y: int, start_addr: int,
                 n_requests: int, mem_words: int = 64):
        self.dst_x, self.dst_y = dst_x, dst_y
        self.mem_words = mem_words
        self._addr = start_addr % mem_words
        self.n_requests = n_requests
        self.issued = 0
        self._outstanding = False
        self.visited: List[int] = []
        self.latencies: List[int] = []

    def offer(self, cycle: int, credits: int) -> Optional[Request]:
        if self._outstanding or self.issued >= self.n_requests:
            return None
        self.issued += 1
        self._outstanding = True
        self.visited.append(self._addr)
        return Request(dst_x=self.dst_x, dst_y=self.dst_y,
                       addr=self._addr, op=OP_LOAD)

    def deliver(self, response: Response) -> None:
        self._outstanding = False
        self._addr = int(response.data) % self.mem_words
        self.latencies.append(response.latency)

    def done(self) -> bool:
        return self.issued >= self.n_requests


# ----------------------------------------------------------------------
# the trace -> program bridge (endpoints on the torch backend)
# ----------------------------------------------------------------------
def trace_to_program(trace: Sequence[Tuple[int, int, int, Request]],
                     nx: int, ny: int,
                     base: Optional[Dict[str, np.ndarray]] = None,
                     ) -> Dict[str, np.ndarray]:
    """Convert an injection trace — ``(y, x, cycle, request)`` tuples in
    injection order — into an injection program whose ``not_before``
    fields pin every packet to its recorded cycle.

    Replaying the program reproduces the traced run bit-identically on
    either simulator: at each recorded cycle the injection conditions
    (credit available, FIFO space) held in the traced run, and the state
    evolution matches by induction, so they hold in the replay too.

    ``base`` merges a static injection program (for tiles driven by a
    program rather than an endpoint) into the same schedule; traced tiles
    must not also have base entries.
    """
    per_tile: Dict[Tuple[int, int], List[Tuple[int, Request]]] = {}
    for (y, x, cycle, req) in trace:
        per_tile.setdefault((y, x), []).append((cycle, req))

    base_len = 0
    if base is not None:
        base_len = int(np.asarray(base["op"]).shape[-1])
        for (y, x) in per_tile:
            if (np.asarray(base["op"])[y, x] >= 0).any():
                raise ValueError(
                    f"tile (x={x}, y={y}) is driven by an endpoint but the "
                    "base program also has entries there; a tile has one "
                    "master")

    L = max([len(v) for v in per_tile.values()] + [base_len, 1])
    prog = empty_program(nx, ny, L)
    if base is not None:
        for k in prog:
            if k in base:
                prog[k][..., :base_len] = np.asarray(base[k])
    for (y, x), items in per_tile.items():
        for i, (cycle, req) in enumerate(items):
            prog["op"][y, x, i] = req.op
            prog["dst_x"][y, x, i] = req.dst_x
            prog["dst_y"][y, x, i] = req.dst_y
            prog["addr"][y, x, i] = req.addr
            prog["data"][y, x, i] = req.data
            prog["cmp"][y, x, i] = req.cmp
            prog["not_before"][y, x, i] = cycle
    return prog
