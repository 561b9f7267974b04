"""The numpy oracle of the mesh network, and its constants.

The port's own copy of the JAX package's ``repro/core/netsim.py`` (the
port imports nothing of that package): ``NetConfig``, the struct-of-arrays
FIFOs ``_Fifos`` and the cycle-level ``MeshSim``, a vectorised numpy model
of the mesh exactly as the paper specifies it:

* 5-port routers (P/W/E/N/S, the ``bsg_noc_pkg`` order) with input FIFOs
  and no output FIFOs; every FIFO crossing costs one cycle;
* round-robin arbitration per output port with head-of-line blocking;
* dimension-ordered routing with the reduced crossbar (the N->E and N->W
  turns are structurally forbidden, asserted), on every topology of
  :class:`repro_torch.mesh.topology.Topology`;
* two physical networks, forward (requests) and reverse (responses); the
  reverse network is a sink;
* standard endpoints with ``max_out_credits`` credit counters, an input
  FIFO of ``ep_fifo``, line-rate load/store/CAS service and a registered
  response port; a request is serviced only when the reverse channel has
  space for its response (the paper's masking rule);
* reactive endpoint injectors (``MeshSim._injectors``), offered the link
  at the program-injection stage under the same valid/ready rule.

It runs on the host, in numpy, and is the executor of the user's Python
:class:`repro_torch.mesh.endpoint.Endpoint` callbacks: the facade
(:class:`repro_torch.mesh.Simulator`) runs it as its ``numpy`` backend,
and on its ``torch`` backend traces endpoint scenarios on it and replays
the trace on the card.  All state updates are start-of-cycle-read /
end-of-cycle-write, so each FIFO crossing is exactly one cycle.
``tests/test_torch_mesh.py`` holds every constant equal to its original,
``tests/test_torch_endpoints.py`` every state field of ``MeshSim``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["NetConfig", "MeshSim", "P", "W", "E", "N", "S", "NUM_DIRS",
           "LAT_BINS", "NO_MEASURE", "OP_LOAD", "OP_STORE", "OP_CAS",
           "unloaded_rtt"]

# bsg_noc_pkg: typedef enum {P=0, W, E, N, S}
P, W, E, N, S = 0, 1, 2, 3, 4
NUM_DIRS = 5

# Telemetry: per-packet round-trip latency histogram resolution.  The last
# bin is an overflow bucket (latency >= LAT_BINS - 1 cycles).
LAT_BINS = 512
# Default measurement window = everything (any int32 tag qualifies).
NO_MEASURE = 2**31 - 1

OP_LOAD = 0   # ePacketOp_remote_load
OP_STORE = 1  # ePacketOp_remote_store
OP_CAS = 2    # ePacketOp_remote_swap_aq/_rl pair, modeled as one CAS

_PKT_FIELDS = ("dst_x", "dst_y", "src_x", "src_y", "addr", "data", "cmp",
               "op", "tag")


def unloaded_rtt(hops: int) -> int:
    """Analytic unloaded round-trip latency (cycles) at ``hops`` Manhattan
    distance: inject + hops + deliver-to-endpoint + yumi/service +
    response-inject + hops + deliver + registered output = ``2*hops + 5``.
    For 1 hop this is the paper's 7 cycles."""
    return 2 * hops + 5


@dataclasses.dataclass
class NetConfig:
    nx: int
    ny: int
    router_fifo: int = 4          # input FIFO depth per direction
    ep_fifo: int = 4              # fifo_els_p of the standard endpoint
    max_out_credits: int = 16     # max_out_credits_p
    mem_words: int = 64           # local memory region per tile
    resp_latency: int = 1         # >=1: "response at least one cycle later"
    record_log: bool = False      # keep a full per-response log
    # network topology (repro_torch.mesh.topology.Topology); None -> plain
    # mesh.  Typed loosely and imported lazily: the topology module imports
    # this one's constants, so a module-level import would cycle.
    topology: Optional[object] = None

    def __post_init__(self):
        from repro_torch.mesh.topology import Topology
        if self.topology is None:
            self.topology = Topology.mesh()
        self.topology.validate_for(self.nx, self.ny)
        if (self.topology.wrap_x or self.topology.wrap_y) \
                and self.router_fifo < 2:
            raise ValueError(
                "wrapped (ring/torus) topologies need router_fifo >= 2: "
                "the ring bubble flow control reserves one slot for "
                f"entering packets, got router_fifo={self.router_fifo}")


class _Fifos:
    """Struct-of-arrays circular FIFOs, shape (ny, nx, ports, depth).

    The original gathers and scatters with ``take_along_axis`` /
    ``put_along_axis`` over every FIFO; here the heads are read by one
    flat ``take`` and a push writes only the slots it fills.  Same values, a few times fewer numpy calls a cycle (the oracle
    runs the user's endpoints on the host)."""

    def __init__(self, ny: int, nx: int, ports: int, depth: int):
        self.depth = depth
        self.f = {k: np.zeros((ny, nx, ports, depth), np.int64)
                  for k in _PKT_FIELDS}
        self.head = np.zeros((ny, nx, ports), np.int64)
        self.count = np.zeros((ny, nx, ports), np.int64)
        # flat offset of slot 0 of every FIFO in a field's buffer
        self._base = np.arange(ny * nx * ports).reshape(ny, nx, ports) \
            * depth

    def peek(self) -> Dict[str, np.ndarray]:
        """Head packet of every FIFO, shape (ny, nx, ports) per field."""
        flat = self._base + self.head % self.depth
        return {k: v.reshape(-1).take(flat) for k, v in self.f.items()}

    def pop_mask(self, mask: np.ndarray) -> None:
        """Dequeue head where ``mask`` (ny, nx, ports)."""
        m = mask.astype(np.int64)
        self.head = (self.head + m) % self.depth
        self.count = self.count - m

    def push_mask(self, mask: np.ndarray, pkt: Dict[str, np.ndarray]) -> None:
        """Enqueue ``pkt`` (fields shaped like mask) where ``mask``; caller
        must have verified space."""
        sel = np.nonzero(mask)
        if sel[0].size:
            tail = ((self.head + self.count) % self.depth)[sel]
            for k in _PKT_FIELDS:
                self.f[k][sel + (tail,)] = \
                    np.broadcast_to(pkt[k], mask.shape)[sel]
        self.count = self.count + mask.astype(np.int64)

    def push_port(self, mask: np.ndarray, port: int,
                  pkt: Dict[str, np.ndarray]) -> None:
        """Enqueue ``pkt`` (fields shaped (ny, nx)) into input ``port`` of
        every tile where ``mask`` (ny, nx): ``push_mask`` with the mask
        set on that port alone."""
        ys, xs = np.nonzero(mask)
        self.push_at(ys, xs, port, {k: pkt[k][ys, xs] for k in _PKT_FIELDS})

    def push_at(self, ys: np.ndarray, xs: np.ndarray, port: int,
                vals: Dict[str, np.ndarray]) -> None:
        """Enqueue packet ``i`` (``vals[k][i]``) into input ``port`` of
        tile (``ys[i]``, ``xs[i]``); the tiles are distinct and the caller
        has verified space."""
        if ys.size:
            tail = (self.head[ys, xs, port] + self.count[ys, xs, port]) \
                % self.depth
            for k in _PKT_FIELDS:
                self.f[k][ys, xs, port, tail] = vals[k]
            self.count[ys, xs, port] += 1

    def space(self) -> np.ndarray:
        return self.count < self.depth

    def push_one(self, y: int, x: int, port: int,
                 pkt: Dict[str, int]) -> None:
        """Enqueue a single packet at one (tile, port); caller must have
        verified space.  Scalar path for reactive endpoint injection."""
        tail = int((self.head[y, x, port] + self.count[y, x, port])
                   % self.depth)
        for k in _PKT_FIELDS:
            self.f[k][y, x, port, tail] = int(pkt[k])
        self.count[y, x, port] += 1


class MeshSim:
    """The full mesh: forward + reverse networks, endpoints, memories."""

    def __init__(self, cfg: NetConfig, seed: int = 0):
        self.cfg = cfg
        self.topo = cfg.topology
        ny, nx = cfg.ny, cfg.nx
        self.cycle = 0
        self.rng = np.random.default_rng(seed)
        self.fwd = _Fifos(ny, nx, NUM_DIRS, cfg.router_fifo)
        self.rev = _Fifos(ny, nx, NUM_DIRS, cfg.router_fifo)
        self.ep_in = _Fifos(ny, nx, 1, cfg.ep_fifo)      # endpoint request FIFO
        # response delay line: resp_latency slots of (valid + packet)
        L = cfg.resp_latency
        self.resp_valid = np.zeros((L, ny, nx), bool)
        self.resp_pkt = {k: np.zeros((L, ny, nx), np.int64) for k in _PKT_FIELDS}
        self.mem = np.zeros((ny, nx, cfg.mem_words), np.int64)
        self.credits = np.full((ny, nx), cfg.max_out_credits, np.int64)
        self.rr = np.zeros((ny, nx, NUM_DIRS), np.int64)  # fwd round-robin ptrs
        self.rr_rev = np.zeros((ny, nx, NUM_DIRS), np.int64)
        # injection program, appended via load_program()
        self.prog = {k: np.zeros((ny, nx, 0), np.int64) for k in
                     ("dst_x", "dst_y", "addr", "data", "cmp", "op", "not_before")}
        self.prog_len = np.zeros((ny, nx), np.int64)
        self.prog_ptr = np.zeros((ny, nx), np.int64)
        # registered response port (returned_*_r_o): becomes visible +1 cycle
        self.reg_valid = np.zeros((ny, nx), bool)
        self.reg_pkt = {k: np.zeros((ny, nx), np.int64) for k in _PKT_FIELDS}
        # stats
        self.completed = np.zeros((ny, nx), np.int64)
        self.lat_sum = np.zeros((ny, nx), np.int64)
        self.out_of_credit_cycles = np.zeros((ny, nx), np.int64)
        self.completed_per_cycle: List[int] = []
        # telemetry (see the torch twin, repro_torch.netsim.sim.SimState):
        # packets leaving each router output port per network (P = ejection)
        self.link_util_fwd = np.zeros((ny, nx, NUM_DIRS), np.int64)
        self.link_util_rev = np.zeros((ny, nx, NUM_DIRS), np.int64)
        # input-FIFO occupancy high-water marks, sampled at cycle boundaries
        self.fifo_hwm_fwd = np.zeros((ny, nx, NUM_DIRS), np.int64)
        self.fifo_hwm_rev = np.zeros((ny, nx, NUM_DIRS), np.int64)
        self.ep_hwm = np.zeros((ny, nx), np.int64)
        # per-packet round-trip latency histogram (inject -> registered
        # response), counted only for packets whose injection cycle (tag)
        # falls in [measure_start, measure_stop) — the phased-measurement
        # window; defaults accept every packet
        self.lat_hist = np.zeros(LAT_BINS, np.int64)
        self.measure_start = 0
        self.measure_stop = NO_MEASURE
        self.log: List[Tuple[int, int, int, int, int, int]] = []  # (cycle, sy, sx, op, tag, data)
        # reactive endpoint injectors, (y, x) -> offer(cycle, credits)
        # callable returning a Request-shaped object or None; populated by
        # the repro_torch.mesh.Simulator facade (empty => pure program
        # dynamics)
        self._injectors: Dict[Tuple[int, int], object] = {}
        ys, xs = np.mgrid[0:ny, 0:nx]
        self._xs, self._ys = xs, ys

    # ------------------------------------------------------------------
    # program loading
    # ------------------------------------------------------------------
    def load_program(self, entries: Dict[str, np.ndarray]) -> None:
        """``entries`` fields shaped (ny, nx, L); ``op`` < 0 marks padding.

        ``not_before`` (optional) rate-limits injection to a given cycle.
        """
        ny, nx = self.cfg.ny, self.cfg.nx
        L = entries["op"].shape[-1]
        for k in self.prog:
            if k in entries:
                self.prog[k] = entries[k].astype(np.int64)
            else:
                self.prog[k] = np.zeros((ny, nx, L), np.int64)
        self.prog_len = (entries["op"] >= 0).sum(-1).astype(np.int64)
        self.prog_ptr = np.zeros((ny, nx), np.int64)

    # ------------------------------------------------------------------
    # per-cycle pieces
    # ------------------------------------------------------------------
    def _route(self, heads: Dict[str, np.ndarray]) -> np.ndarray:
        """Dimension-ordered output port for each head packet — the
        pluggable routing decision
        (:meth:`repro_torch.mesh.topology.Topology.route`, shared with the
        torch step and the router kernel)."""
        dx, dy = heads["dst_x"], heads["dst_y"]
        x, y = self._xs[..., None], self._ys[..., None]
        return self.topo.route(dx, dy, x, y, self.cfg.nx, self.cfg.ny, xp=np)

    def _router_step(self, net: _Fifos, rr: np.ndarray,
                     deliver_space: np.ndarray,
                     link_util: Optional[np.ndarray] = None,
                     ) -> Dict[str, np.ndarray]:
        """One cycle of every router in one network.

        ``deliver_space`` (ny, nx) — can the P output deliver this cycle.
        ``link_util`` (ny, nx, 5) — telemetry accumulator, incremented in
        place for every output port that fires (P counts ejections).
        Returns the packets delivered out of the P port (fields + 'valid').
        """
        cfg = self.cfg
        topo = self.topo
        heads = net.peek()
        valid = net.count > 0                       # (ny, nx, 5)
        want = self._route(heads)                   # desired output port

        # Structural turn restriction: N must never request E or W (holds
        # on every topology — routing is X-then-Y and the Y phase never
        # re-enters X).
        assert not (valid[..., N] & ((want[..., N] == E) | (want[..., N] == W))).any(), \
            "illegal N->E/W turn generated"

        # Destination space per output port (start-of-cycle, conservative);
        # wrapped dimensions connect the array edges into rings.
        space = net.space()                         # (ny, nx, 5) input FIFOs
        out_space = np.zeros((cfg.ny, cfg.nx, NUM_DIRS), bool)
        out_space[..., P] = deliver_space
        if topo.wrap_x:
            out_space[..., E] = np.roll(space[..., W], -1, axis=1)
            out_space[..., W] = np.roll(space[..., E], 1, axis=1)
        else:
            out_space[:, :-1, E] = space[:, 1:, W]  # east edge: no space
            out_space[:, 1:, W] = space[:, :-1, E]
        if topo.wrap_y:
            out_space[..., S] = np.roll(space[..., N], -1, axis=0)
            out_space[..., N] = np.roll(space[..., S], 1, axis=0)
        else:
            out_space[:-1, :, S] = space[1:, :, N]
            out_space[1:, :, N] = space[:-1, :, S]

        # Multi-chip boundary links accept one flit every boundary_period
        # cycles — the narrower off-chip channel (both networks share the
        # cycle counter, so both are gated identically).
        if topo.gated and (self.cycle % topo.boundary_period) != 0:
            for c in topo.boundary_cols(cfg.nx):
                out_space[:, c - 1, E] = False
                out_space[:, c, W] = False

        # Ring bubble flow control: a packet ENTERING a wrapped-dimension
        # ring needs TWO free slots in the target FIFO, a packet
        # CONTINUING around it the usual one — every ring keeps a bubble,
        # so dimension-ordered routing stays deadlock-free on rings (see
        # repro_torch.mesh.topology).  bubble[o] is the continuing input port.
        bubble: Dict[int, int] = {}
        out_space2 = None
        if topo.wrap_x or topo.wrap_y:
            space2 = net.count <= net.depth - 2
            out_space2 = np.zeros((cfg.ny, cfg.nx, NUM_DIRS), bool)
            if topo.wrap_x:
                out_space2[..., E] = np.roll(space2[..., W], -1, axis=1)
                out_space2[..., W] = np.roll(space2[..., E], 1, axis=1)
                bubble[E], bubble[W] = W, E
            if topo.wrap_y:
                out_space2[..., S] = np.roll(space2[..., N], -1, axis=0)
                out_space2[..., N] = np.roll(space2[..., S], 1, axis=0)
                bubble[S], bubble[N] = N, S

        # Round-robin arbitration: for each output port o pick the valid
        # requester with minimal (in_port - rr[o]) mod 5.
        winners = np.full((cfg.ny, cfg.nx, NUM_DIRS), -1, np.int64)
        for o in range(NUM_DIRS):
            cand = valid & (want == o) & out_space[..., o:o + 1]
            if o in bubble:
                entering = np.arange(NUM_DIRS) != bubble[o]     # (5,) inputs
                cand = cand & (out_space2[..., o:o + 1] | ~entering)
            prio = (np.arange(NUM_DIRS)[None, None, :] - rr[..., o:o + 1]) % NUM_DIRS
            prio = np.where(cand, prio, NUM_DIRS + 1)
            best = prio.min(-1)
            win = np.where(best <= NUM_DIRS, prio.argmin(-1), -1)
            winners[..., o] = win
            # advance the round-robin pointer past the winner
            rr[..., o] = np.where(win >= 0, (win + 1) % NUM_DIRS, rr[..., o])

        # Gather winning packets per output port and move them; only the
        # tiles where a port fires are read and written.
        pop = np.zeros((cfg.ny, cfg.nx, NUM_DIRS), bool)
        if link_util is not None:
            link_util += winners >= 0
        moved = {}
        for o in range(NUM_DIRS):
            ys, xs = np.nonzero(winners[..., o] >= 0)
            win = winners[ys, xs, o]
            pop[ys, xs, win] = True
            moved[o] = (ys, xs, {k: heads[k][ys, xs, win]
                                 for k in _PKT_FIELDS})

        net.pop_mask(pop)

        # Enqueue into neighbors (each destination FIFO has exactly one
        # feeder); a wrapped dimension's edge output feeds the opposite
        # edge, an open edge's output never fires (no space beyond it).
        for o, dy, dx, in_port in ((E, 0, 1, W), (W, 0, -1, E),
                                   (S, 1, 0, N), (N, -1, 0, S)):
            ys, xs, pkt = moved[o]
            ty, tx = ys + dy, xs + dx
            if topo.wrap_x:
                tx %= cfg.nx
            if topo.wrap_y:
                ty %= cfg.ny
            keep = (tx >= 0) & (tx < cfg.nx) & (ty >= 0) & (ty < cfg.ny)
            net.push_at(ty[keep], tx[keep], in_port,
                        {k: v[keep] for k, v in pkt.items()})

        ys, xs, pkt = moved[P]
        delivered = {k: np.zeros((cfg.ny, cfg.nx), np.int64)
                     for k in _PKT_FIELDS}
        for k in _PKT_FIELDS:
            delivered[k][ys, xs] = pkt[k]
        delivered["valid"] = np.zeros((cfg.ny, cfg.nx), bool)
        delivered["valid"][ys, xs] = True
        return delivered

    # ------------------------------------------------------------------
    def step(self) -> None:
        cfg = self.cfg
        ny, nx = cfg.ny, cfg.nx
        c = self.cycle

        # ---- registered response port becomes visible (stats record) ----
        rv = self.reg_valid
        if rv.any():
            self.completed += rv
            lat = c - self.reg_pkt["tag"]
            self.lat_sum += np.where(rv, lat, 0)
            # latency histogram, gated to the measurement window by the
            # packet's injection cycle (its tag)
            tag = self.reg_pkt["tag"]
            in_win = rv & (tag >= self.measure_start) & (tag < self.measure_stop)
            if in_win.any():
                np.add.at(self.lat_hist,
                          np.clip(lat[in_win], 0, LAT_BINS - 1), 1)
            if cfg.record_log:
                for (y, x) in zip(*np.nonzero(rv)):
                    self.log.append((c, int(y), int(x),
                                     int(self.reg_pkt["op"][y, x]),
                                     int(self.reg_pkt["tag"][y, x]),
                                     int(self.reg_pkt["data"][y, x])))
        self.completed_per_cycle.append(int(rv.sum()))
        self.reg_valid = np.zeros((ny, nx), bool)

        # ---- reverse network: route; P deliveries are ALWAYS absorbed ----
        rdel = self._router_step(self.rev, self.rr_rev,
                                 deliver_space=np.ones((ny, nx), bool),
                                 link_util=self.link_util_rev)
        absorbed = rdel["valid"]
        # credits return for every reverse packet (commit acknowledgement)
        self.credits += absorbed.astype(np.int64)
        # register the data for the core (returned_*_r_o)
        self.reg_valid = absorbed
        for k in _PKT_FIELDS:
            self.reg_pkt[k] = np.where(absorbed, rdel[k], 0)

        # ---- endpoint: inject pending responses into reverse P FIFO ----
        slot = c % cfg.resp_latency
        inj = self.resp_valid[slot]
        if inj.any():
            self.rev.push_port(inj, P, {k: self.resp_pkt[k][slot]
                                        for k in _PKT_FIELDS})
            self.resp_valid[slot] = False

        # ---- endpoint: service one request/cycle (line rate) ----------
        # Only service when the reverse channel is guaranteed to have space
        # at injection time (the paper's request-masking rule).
        resp_inflight = self.resp_valid.sum(0)
        rev_space = (self.rev.count[..., P] + resp_inflight) < self.rev.depth
        can = (self.ep_in.count[..., 0] > 0) & rev_space
        if can.any():
            req = {k: v[..., 0] for k, v in self.ep_in.peek().items()}
            addr = np.clip(req["addr"], 0, cfg.mem_words - 1)
            yidx, xidx = self._ys, self._xs
            cur = self.mem[yidx, xidx, addr]
            is_store = can & (req["op"] == OP_STORE)
            is_load = can & (req["op"] == OP_LOAD)
            is_cas = can & (req["op"] == OP_CAS)
            cas_hit = is_cas & (cur == req["cmp"])
            newval = np.where(is_store, req["data"],
                              np.where(cas_hit, req["data"], cur))
            self.mem[yidx, xidx, addr] = np.where(can, newval, cur)
            self.ep_in.pop_mask(can[..., None])
            # response: loads return data, stores return a credit packet,
            # CAS returns the observed (pre-swap) value.
            rdata = np.where(is_load, cur, np.where(is_cas, cur, 0))
            # delay-line slot: with resp_latency L the response is injected
            # into the reverse network exactly L cycles after service.
            wslot = c % cfg.resp_latency
            self.resp_valid[wslot] = np.where(can, True, self.resp_valid[wslot])
            for k in _PKT_FIELDS:
                self.resp_pkt[k][wslot] = np.where(can, req[k], self.resp_pkt[k][wslot])
            # swap src<->dst so the reverse packet routes home
            self.resp_pkt["dst_x"][wslot] = np.where(can, req["src_x"], self.resp_pkt["dst_x"][wslot])
            self.resp_pkt["dst_y"][wslot] = np.where(can, req["src_y"], self.resp_pkt["dst_y"][wslot])
            self.resp_pkt["src_x"][wslot] = np.where(can, self._xs, self.resp_pkt["src_x"][wslot])
            self.resp_pkt["src_y"][wslot] = np.where(can, self._ys, self.resp_pkt["src_y"][wslot])
            self.resp_pkt["data"][wslot] = np.where(can, rdata, self.resp_pkt["data"][wslot])

        # ---- forward network: route; P deliveries go to endpoint FIFO ----
        fdel = self._router_step(self.fwd, self.rr,
                                 deliver_space=self.ep_in.space()[..., 0],
                                 link_util=self.link_util_fwd)
        got = fdel["valid"]
        if got.any():
            self.ep_in.push_mask(got[..., None],
                                 {k: fdel[k][..., None] for k in _PKT_FIELDS})

        # ---- master injection from the per-tile program -----------------
        self.out_of_credit_cycles += ((self.prog_ptr < self.prog_len)
                                      & (self.credits <= 0)).astype(np.int64)
        can_inj = (self.prog_ptr < self.prog_len) & (self.credits > 0)
        if can_inj.any():
            pidx = np.clip(self.prog_ptr, 0, max(self.prog["op"].shape[-1] - 1, 0))
            entry = {k: v[self._ys, self._xs, pidx]
                     for k, v in self.prog.items()}
            can_inj &= entry["not_before"] <= c
            can_inj &= self.fwd.space()[..., P]
            if can_inj.any():
                pkt = {
                    "dst_x": entry["dst_x"], "dst_y": entry["dst_y"],
                    "src_x": self._xs.astype(np.int64), "src_y": self._ys.astype(np.int64),
                    "addr": entry["addr"], "data": entry["data"],
                    "cmp": entry["cmp"], "op": entry["op"],
                    "tag": np.full((ny, nx), c, np.int64),
                }
                self.fwd.push_port(can_inj, P, pkt)
                self.credits -= can_inj.astype(np.int64)
                self.prog_ptr += can_inj.astype(np.int64)

        # ---- reactive endpoint injection (the mesh-attach interface) ----
        # Same stage and same valid/ready rule as program injection: the
        # endpoint is offered the link only when a credit and port-P FIFO
        # space are available, so a returned packet always injects.
        # Endpoint tiles have no program entries, so the two paths never
        # contend for the same FIFO slot.
        if self._injectors:
            space_p = self.fwd.space()[..., P]
            for (y, x), offer in self._injectors.items():
                if self.credits[y, x] <= 0 or not space_p[y, x]:
                    continue
                req = offer(c, int(self.credits[y, x]))
                if req is None:
                    continue
                self.fwd.push_one(y, x, P, {
                    "dst_x": req.dst_x, "dst_y": req.dst_y,
                    "src_x": x, "src_y": y, "addr": req.addr,
                    "data": req.data, "cmp": req.cmp, "op": req.op,
                    "tag": c})
                self.credits[y, x] -= 1

        # ---- telemetry: FIFO occupancy high-water marks (cycle edge) ----
        np.maximum(self.fifo_hwm_fwd, self.fwd.count, out=self.fifo_hwm_fwd)
        np.maximum(self.fifo_hwm_rev, self.rev.count, out=self.fifo_hwm_rev)
        np.maximum(self.ep_hwm, self.ep_in.count[..., 0], out=self.ep_hwm)

        self.cycle += 1

    # ------------------------------------------------------------------
    def run(self, cycles: int) -> None:
        for _ in range(cycles):
            self.step()

    def run_until_drained(self, max_cycles: int = 100000) -> int:
        """Run until all programs issued and all credits returned (global
        fence); returns the cycle count."""
        for _ in range(max_cycles):
            if (self.prog_ptr >= self.prog_len).all() and \
               (self.credits == self.cfg.max_out_credits).all() and \
               not self.reg_valid.any():
                return self.cycle
            self.step()
        raise RuntimeError(f"network did not drain in {max_cycles} cycles")

    # ------------------------------------------------------------------
    def set_measure_window(self, start: int, stop: int) -> None:
        """Restrict the latency histogram to packets *injected* in cycle
        range [start, stop) — the phased warmup/measure/drain gate."""
        self.measure_start = int(start)
        self.measure_stop = int(stop)

    # ------------------------------------------------------------------
    def mean_latency(self) -> float:
        done = self.completed.sum()
        return float(self.lat_sum.sum()) / max(int(done), 1)

    def throughput(self, warmup: int = 0) -> float:
        """Completed remote operations per cycle (steady state)."""
        per = self.completed_per_cycle[warmup:]
        return float(np.sum(per)) / max(len(per), 1)
