"""The cycle-level mesh simulator in PyTorch, with an explicit lane axis.

The port of ``repro/netsim_jax/sim.py``.  Same semantics, bit for bit:
5-port routers with input FIFOs only, per-output round-robin arbitration,
dimension-ordered routing off the packed header word
(:mod:`repro_torch.mesh.encoding`), stacked forward/reverse networks,
credit-counted endpoints with load/store/CAS service, and the telemetry
counters.  What differs is the shape of the computation:

* every :class:`SimState` leaf carries a leading **lane** axis ``B``
  (the JAX package gets lanes from ``jax.vmap``).  Lanes are independent
  simulations sharing one shape: a load sweep runs its offered loads as
  lanes of one state, and per-lane ``fifo_depth`` / ``max_credits`` /
  ``measure_start`` / ``measure_stop`` are ``(B,)`` tensors;
* the device decides how a cycle runs.  On a CUDA state every cycle goes
  through the hand-written Hopper kernel
  (:func:`repro_torch.kernels.router_step.router_step_call`), which updates
  the state in place; on a CPU state it goes through :func:`step_core`, the
  plain PyTorch cycle.  There is no switch, and no fallback from one to
  the other;
* the drivers are Python loops: :func:`simulate` splits a run into
  ``cycles // C`` launches of ``C`` cycles plus a remainder, and
  :func:`run_until_drained` checks the drain fence on the host once per
  ``check_every``-cycle block while recording the exact drain cycle.

Keep the sub-step order of :func:`step_core` in lockstep with the
reference's ``_step_core`` (and with ``csrc/router_step.cu``): it is
load-bearing for exact parity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.netsim import (E, LAT_BINS, N, NO_MEASURE, NUM_DIRS,
                                     OP_CAS, OP_LOAD, OP_STORE, P, S, W)
from repro_torch.kernels.backend import resolve_device
from repro_torch.mesh.encoding import (COORD_LIMIT, COORD_MASK, DST_Y_SHIFT,
                                       OP_MASK, OP_SHIFT, pack_dst_op,
                                       swap_for_response, validate_program,
                                       with_src)
from repro_torch.mesh.topology import Topology

__all__ = ["SimConfig", "SimState", "Fifo", "Program", "FWD", "REV",
           "FIELDS", "PROG_FIELDS", "STATE_LEAVES", "BOOL_LEAVES",
           "init_state", "load_program", "stack_programs", "step_core",
           "drained", "simulate", "launch_sizes", "run_until_drained",
           "run_until_drained_traced", "flatten_state", "unflatten_state",
           "TorchMeshSim"]

# packet lanes: the five header fields are packed into the single `hdr`
# word (see repro_torch.mesh.encoding for the layout)
FIELDS = ("hdr", "addr", "data", "cmp", "tag")
F = len(FIELDS)
HDR, ADDR, DATA, CMP, TAG = range(F)

# injection-program lanes: `hdr` holds (dst_x, dst_y, op) with the source
# pair zero — the injecting tile ORs itself in at injection time
PROG_FIELDS = ("hdr", "addr", "data", "cmp", "not_before")
NOT_BEFORE = 4

# the stacked physical-network axis: 0 = forward (requests),
# 1 = reverse (responses/credits)
FWD, REV = 0, 1

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (shape-determining) configuration.

    ``router_fifo`` / ``max_out_credits`` are *capacities*; the effective
    values used by the dynamics are the per-lane ``SimState.fifo_depth`` /
    ``SimState.max_credits`` (``fifo_depth <= router_fifo``).
    """
    nx: int
    ny: int
    router_fifo: int = 4
    ep_fifo: int = 4
    max_out_credits: int = 16
    mem_words: int = 64
    resp_latency: int = 1
    topology: Optional[Topology] = None     # None -> the plain mesh

    def __post_init__(self):
        if not (0 < self.nx <= COORD_LIMIT and 0 < self.ny <= COORD_LIMIT):
            raise ValueError(
                f"mesh dimensions must be in [1, {COORD_LIMIT}] to fit the "
                f"packed header coordinate fields, got nx={self.nx}, "
                f"ny={self.ny}")
        if self.topology is None:
            object.__setattr__(self, "topology", Topology.mesh())
        self.topology.validate_for(self.nx, self.ny)
        if (self.topology.wrap_x or self.topology.wrap_y) \
                and self.router_fifo < 2:
            raise ValueError(
                "wrapped (ring/torus) topologies need router_fifo >= 2: "
                "the ring bubble flow control reserves one slot for "
                f"entering packets, got router_fifo={self.router_fifo}")
        if self.resp_latency < 1:
            raise ValueError(
                f"resp_latency must be >= 1, got {self.resp_latency}")


class Fifo(NamedTuple):
    """Struct-of-arrays circular FIFOs.  The router networks are stacked:
    ``buf`` is ``(B, F, 2, ny, nx, 5, cap)`` with ``head``/``count``
    ``(B, 2, ny, nx, 5)``; the endpoint request FIFO is
    ``(B, F, ny, nx, 1, cap)`` with ``(B, ny, nx, 1)`` pointers."""
    buf: torch.Tensor
    head: torch.Tensor
    count: torch.Tensor


class Program(NamedTuple):
    """Injection programs, one per lane; ``buf`` lanes are
    ``PROG_FIELDS`` (header-packed)."""
    buf: torch.Tensor      # (B, len(PROG_FIELDS), ny, nx, Lp) int32
    length: torch.Tensor   # (B, ny, nx) — entries with op >= 0


class SimState(NamedTuple):
    net: Fifo                  # stacked fwd/rev router FIFOs (see Fifo)
    ep_in: Fifo
    resp_valid: torch.Tensor   # (B, L, ny, nx) bool
    resp_buf: torch.Tensor     # (B, F, L, ny, nx)
    mem: torch.Tensor          # (B, ny, nx, mem_words)
    credits: torch.Tensor      # (B, ny, nx)
    rr: torch.Tensor           # (B, 2, ny, nx, 5) round-robin pointers
    prog_ptr: torch.Tensor     # (B, ny, nx)
    reg_valid: torch.Tensor    # (B, ny, nx) bool
    reg_buf: torch.Tensor      # (B, F, ny, nx)
    completed: torch.Tensor    # (B, ny, nx)
    lat_sum: torch.Tensor      # (B, ny, nx)
    out_of_credit_cycles: torch.Tensor  # (B, ny, nx)
    cycle: torch.Tensor        # (B,)
    fifo_depth: torch.Tensor   # (B,) effective router FIFO depth
    max_credits: torch.Tensor  # (B,) effective credit allowance
    link_util: torch.Tensor    # (B, 2, ny, nx, 5) packets out of each port
    fifo_hwm: torch.Tensor     # (B, 2, ny, nx, 5) occupancy high-water marks
    ep_hwm: torch.Tensor       # (B, ny, nx)
    lat_hist: torch.Tensor     # (B, LAT_BINS) per-packet RTT histogram
    measure_start: torch.Tensor  # (B,) window gate on the packet tag
    measure_stop: torch.Tensor   # (B,)


# The leaves of a SimState in the order jax.tree_util flattens the
# reference's SimState (nested Fifo fields expand in place).  The
# conversions and the kernel's argument struct use this order.
STATE_LEAVES = ("net_buf", "net_head", "net_count", "ep_buf", "ep_head",
                "ep_count") + SimState._fields[2:]
BOOL_LEAVES = ("resp_valid", "reg_valid")


def flatten_state(st: SimState) -> List[torch.Tensor]:
    """The leaves of ``st`` in :data:`STATE_LEAVES` order."""
    return [st.net.buf, st.net.head, st.net.count,
            st.ep_in.buf, st.ep_in.head, st.ep_in.count, *st[2:]]


def unflatten_state(leaves: Sequence[torch.Tensor]) -> SimState:
    """Inverse of :func:`flatten_state`."""
    if len(leaves) != len(STATE_LEAVES):
        raise ValueError(f"expected {len(STATE_LEAVES)} state leaves, "
                         f"got {len(leaves)}")
    return SimState(Fifo(*leaves[0:3]), Fifo(*leaves[3:6]), *leaves[6:])


def _per_lane(value, default: int, lanes: int, name: str) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    v = np.asarray(default if value is None else value, np.int64)
    if v.ndim == 0:
        v = np.full((lanes,), int(v), np.int64)
    if v.shape != (lanes,):
        raise ValueError(f"{name} must be a scalar or have one value per "
                         f"lane ({lanes}), got shape {v.shape}")
    return v.astype(np.int32)


def init_state(cfg: SimConfig, fifo_depth=None, max_credits=None,
               lanes: Optional[int] = None, device=None) -> SimState:
    """Fresh all-idle state of ``lanes`` independent simulations (no
    program loaded).

    ``fifo_depth`` / ``max_credits`` default to the config capacities and
    may be scalars or one value per lane (a sequence, array or tensor;
    ``lanes`` is then inferred).
    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; with no
    card and no explicit ``"cpu"`` this raises.
    """
    device = resolve_device(device)
    if lanes is None:
        lanes = max([len(v) for v in (fifo_depth, max_credits)
                     if v is not None and np.ndim(v) > 0] or [1])
    B, ny, nx, L = int(lanes), cfg.ny, cfg.nx, cfg.resp_latency
    d = _per_lane(fifo_depth, cfg.router_fifo, B, "fifo_depth")
    if bool((d < 1).any()) or bool((d > cfg.router_fifo).any()):
        raise ValueError(
            f"fifo_depth must lie in [1, router_fifo={cfg.router_fifo}], "
            f"got {d.tolist()}")
    # checked on the host and copied without a stream sync, so a state
    # can be made while earlier work still runs on the card
    depth, mc = (torch.as_tensor(v).to(device, non_blocking=True) for v in (
        d, _per_lane(max_credits, cfg.max_out_credits, B, "max_credits")))

    def z(*shape, dtype=I32):
        return torch.zeros((B,) + shape, dtype=dtype, device=device)

    return SimState(
        net=Fifo(buf=z(F, 2, ny, nx, NUM_DIRS, cfg.router_fifo),
                 head=z(2, ny, nx, NUM_DIRS), count=z(2, ny, nx, NUM_DIRS)),
        ep_in=Fifo(buf=z(F, ny, nx, 1, cfg.ep_fifo),
                   head=z(ny, nx, 1), count=z(ny, nx, 1)),
        resp_valid=z(L, ny, nx, dtype=torch.bool),
        resp_buf=z(F, L, ny, nx),
        mem=z(ny, nx, cfg.mem_words),
        credits=mc[:, None, None].expand(B, ny, nx).contiguous(),
        rr=z(2, ny, nx, NUM_DIRS),
        prog_ptr=z(ny, nx),
        reg_valid=z(ny, nx, dtype=torch.bool),
        reg_buf=z(F, ny, nx),
        completed=z(ny, nx), lat_sum=z(ny, nx),
        out_of_credit_cycles=z(ny, nx),
        cycle=z(),
        fifo_depth=depth, max_credits=mc,
        link_util=z(2, ny, nx, NUM_DIRS), fifo_hwm=z(2, ny, nx, NUM_DIRS),
        ep_hwm=z(ny, nx),
        lat_hist=z(LAT_BINS),
        measure_start=z(),
        measure_stop=torch.full((B,), NO_MEASURE, dtype=I32, device=device),
    )


def load_program(entries: Dict[str, np.ndarray], device=None) -> Program:
    """Pack one injection program (fields shaped ``(ny, nx, L)``, ``op`` <
    0 marks padding) into a one-lane header-packed :class:`Program`.

    Validates the packet domain first (:func:`validate_program`: the
    error names the offending field)."""
    device = resolve_device(device)
    op = np.asarray(entries["op"])
    validate_program(entries)
    zero = np.zeros(op.shape, np.int64)

    def get(k):
        return np.asarray(entries[k]) if k in entries else zero

    buf = np.stack([
        pack_dst_op(get("dst_x").astype(np.int64), get("dst_y"), op),
        get("addr"), get("data"), get("cmp"), get("not_before"),
    ]).astype(np.int32)
    return Program(
        buf=torch.as_tensor(buf[None], device=device),
        length=torch.as_tensor((op >= 0).sum(-1).astype(np.int32)[None],
                               device=device))


def stack_programs(progs: Sequence[Program]) -> Program:
    """Concatenate programs of equal shape along the lane axis."""
    return Program(buf=torch.cat([p.buf for p in progs]),
                   length=torch.cat([p.length for p in progs]))


# ----------------------------------------------------------------------
# the plain PyTorch cycle
# ----------------------------------------------------------------------
def _shift(a: torch.Tensor, dim: int, k: int, wrap: bool) -> torch.Tensor:
    """``out[i] = a[i - k]`` along ``dim`` (``k`` is +1 or -1): the value
    of the neighbour on the low (k=+1) or high (k=-1) side.  The vacated
    edge is zero / False unless the dimension wraps."""
    out = torch.roll(a, k, dim)
    if not wrap:
        out.select(dim, 0 if k > 0 else a.shape[dim] - 1).zero_()
    return out


def _fifo_peek(f: Fifo) -> torch.Tensor:
    """Head packet of every FIFO: ``buf`` minus its capacity axis."""
    idx = f.head.unsqueeze(1).unsqueeze(-1).long()
    return f.buf.gather(-1, idx.expand(f.buf.shape[:-1] + (1,))).squeeze(-1)


def _arbitrate(cfg: SimConfig, net: Fifo, rr: torch.Tensor,
               xs: torch.Tensor, ys: torch.Tensor, depth: torch.Tensor,
               cycle: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing + round-robin arbitration for both networks at once.

    Returns ``(win, moved)``: ``win`` (B, 2, ny, nx, out) is the winning
    input port per output (-1 = none) with the port-P deliver gate NOT
    yet applied, and ``moved`` (B, F, 2, ny, nx, out) the winner's packet.
    The gate is a pure AND on the P column, applied per network by
    :func:`_finalize`."""
    topo, dev = cfg.topology, net.buf.device
    heads = _fifo_peek(net)                        # (B, F, 2, ny, nx, 5)
    valid = net.count > 0                          # (B, 2, ny, nx, 5)
    h = heads[:, HDR]
    dx, dy = h & COORD_MASK, (h >> DST_Y_SHIFT) & COORD_MASK
    want = topo.route(dx, dy, xs[None, None, :, :, None],
                      ys[None, None, :, :, None], cfg.nx, cfg.ny, xp=torch)

    # destination space per output port (start-of-cycle); P is
    # provisionally True.  Axis 3 is x, axis 2 is y.
    d5 = depth[:, None, None, None, None]
    space = net.count < d5
    w_sp = _shift(space[..., E], 3, +1, topo.wrap_x)   # W out -> west's E in
    e_sp = _shift(space[..., W], 3, -1, topo.wrap_x)   # E out -> east's W in
    n_sp = _shift(space[..., S], 2, +1, topo.wrap_y)   # N out -> north's S in
    s_sp = _shift(space[..., N], 2, -1, topo.wrap_y)   # S out -> south's N in
    if topo.gated:
        # multi-chip boundary links accept a flit every boundary_period
        # cycles: the E output west of each boundary, the W output east
        open_now = ((cycle % topo.boundary_period) == 0)[:, None, None, None]
        e_gate = torch.zeros(cfg.nx, dtype=torch.bool, device=dev)
        w_gate = torch.zeros(cfg.nx, dtype=torch.bool, device=dev)
        for c0 in topo.boundary_cols(cfg.nx):
            e_gate[c0 - 1] = True
            w_gate[c0] = True
        e_sp = e_sp & (open_now | ~e_gate)
        w_sp = w_sp & (open_now | ~w_gate)
    ones = torch.ones_like(w_sp)
    out_space = torch.stack([ones, w_sp, e_sp, n_sp, s_sp], -1)

    io = torch.arange(NUM_DIRS, device=dev)
    io_in = io[:, None]
    cand = (valid[..., :, None] & (want[..., :, None] == io)
            & out_space[..., None, :])           # (B, 2, ny, nx, in, out)

    # ring bubble flow control: a packet ENTERING a wrapped ring needs two
    # free slots, one CONTINUING around it (in = ((out - 1) ^ 1) + 1) one
    if topo.wrap_x or topo.wrap_y:
        space2 = net.count < d5 - 1
        if topo.wrap_x:
            w2 = _shift(space2[..., E], 3, +1, True)
            e2 = _shift(space2[..., W], 3, -1, True)
        else:
            w2 = e2 = ones
        if topo.wrap_y:
            n2 = _shift(space2[..., S], 2, +1, True)
            s2 = _shift(space2[..., N], 2, -1, True)
        else:
            n2 = s2 = ones
        out_space2 = torch.stack([ones, w2, e2, n2, s2], -1)
        bubble_out = torch.zeros(NUM_DIRS, dtype=torch.bool, device=dev)
        if topo.wrap_x:
            bubble_out |= (io == E) | (io == W)
        if topo.wrap_y:
            bubble_out |= (io == N) | (io == S)
        is_cont = io_in == (((io - 1) ^ 1) + 1)
        need2 = bubble_out & ~is_cont
        cand = cand & (out_space2[..., None, :] | ~need2)

    prio = (io_in - rr[..., None, :]) % NUM_DIRS
    prio = torch.where(cand, prio, NUM_DIRS + 1)
    best = prio.min(-2).values                    # (B, 2, ny, nx, out)
    winner = torch.zeros_like(best)               # lowest input index wins
    for i in range(NUM_DIRS - 1, -1, -1):
        winner = torch.where(prio[..., i, :] == best, i, winner)
    win = torch.where(best <= NUM_DIRS, winner, -1).to(I32)
    # the winner's packet per output; the P column comes from the UNGATED
    # winner, which every consumer masks with the gated `has`
    widx = win.clamp(0, NUM_DIRS - 1).long().unsqueeze(1)
    moved = heads.gather(-1, widx.expand(heads.shape))
    return win, moved


def _finalize(win: torch.Tensor, rr: torch.Tensor,
              deliver_space: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply one network's port-P deliver gate to its slice of the fused
    arbitration result; returns (rr', pop (B,ny,nx,in), has (B,ny,nx,out))."""
    win = torch.cat([torch.where(deliver_space, win[..., P], -1)[..., None],
                     win[..., 1:]], -1)
    has = win >= 0
    rr = torch.where(has, (win + 1) % NUM_DIRS, rr)
    io_in = torch.arange(NUM_DIRS, device=win.device)[:, None]
    pop = ((io_in == win.clamp(0, NUM_DIRS - 1)[..., None, :])
           & has[..., None, :]).any(-1)
    return rr, pop, has


def _neighbor_push(has: torch.Tensor, moved: torch.Tensor,
                   p_mask: torch.Tensor, p_pkt: torch.Tensor,
                   topo: Topology) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output winners -> per-input push masks of the neighbour FIFOs,
    with the local port-P enqueue folded in: in-port W of a tile receives
    its west neighbour's E output, E the east's W, N the north's S and S
    the south's N.  Every (tile, in-port) has one feeder."""
    mask_in = torch.stack([
        p_mask,
        _shift(has[..., E], 2, +1, topo.wrap_x),
        _shift(has[..., W], 2, -1, topo.wrap_x),
        _shift(has[..., S], 1, +1, topo.wrap_y),
        _shift(has[..., N], 1, -1, topo.wrap_y)], -1)
    pkt_in = torch.stack([
        p_pkt,
        _shift(moved[..., E], 3, +1, topo.wrap_x),
        _shift(moved[..., W], 3, -1, topo.wrap_x),
        _shift(moved[..., S], 2, +1, topo.wrap_y),
        _shift(moved[..., N], 2, -1, topo.wrap_y)], -1)
    return mask_in, pkt_in


def step_core(cfg: SimConfig, prog: Program, st: SimState
              ) -> Tuple[SimState, torch.Tensor]:
    """One simulator cycle of every lane, in plain PyTorch; returns
    ``(state', completions_this_cycle (B,))``.

    The sub-step order matches the reference's ``_step_core`` exactly —
    do not reorder.  Both networks' FIFO *counts* advance at their
    original points in the cycle, and the two buffer writes are one
    stacked write at the end."""
    ny, nx = cfg.ny, cfg.nx
    dev = st.cycle.device
    B = st.cycle.shape[0]
    ys, xs = torch.meshgrid(torch.arange(ny, dtype=I32, device=dev),
                            torch.arange(nx, dtype=I32, device=dev),
                            indexing="ij")
    c = st.cycle
    c3 = c[:, None, None]
    depth = st.fifo_depth
    d3, d4 = depth[:, None, None], depth[:, None, None, None]

    # ---- registered response port becomes visible (stats record) ----
    rv = st.reg_valid
    completed = st.completed + rv.to(I32)
    tag = st.reg_buf[:, TAG]
    lat = c3 - tag
    lat_sum = st.lat_sum + torch.where(rv, lat, 0)
    done_now = rv.sum((1, 2)).to(I32)
    in_win = rv & (tag >= st.measure_start[:, None, None]) \
        & (tag < st.measure_stop[:, None, None])
    bin_idx = lat.clamp(0, LAT_BINS - 1)
    lat_hist = st.lat_hist.scatter_add(1, bin_idx.reshape(B, -1).long(),
                                       in_win.reshape(B, -1).to(I32))

    # ---- both networks: one routing + arbitration pass ----
    win2, moved2 = _arbitrate(cfg, st.net, st.rr, xs, ys, depth, c)

    # ---- reverse network: P deliveries are ALWAYS absorbed ----
    rr_rev, rpop, rhas = _finalize(win2[:, REV], st.rr[:, REV],
                                   torch.ones_like(st.reg_valid))
    rmoved = moved2[:, :, REV]
    rev_head = (st.net.head[:, REV] + rpop.to(I32)) % d4
    rev_count = st.net.count[:, REV] - rpop.to(I32)
    absorbed, rpkt = rhas[..., P], rmoved[..., P]
    credits = st.credits + absorbed.to(I32)
    reg_valid = absorbed
    reg_buf = torch.where(absorbed[:, None], rpkt, 0)

    # ---- endpoint: inject the pending response of slot c % L ----
    L = cfg.resp_latency
    slot = c % L                                            # (B,)
    slot_oh = (torch.arange(L, device=dev) == slot[:, None])[:, :, None, None]
    inj = st.resp_valid.gather(
        1, slot[:, None, None, None].long().expand(B, 1, ny, nx)).squeeze(1)
    inj_pkt = st.resp_buf.gather(
        2, slot[:, None, None, None, None].long().expand(B, F, 1, ny, nx)
    ).squeeze(2)
    rmask_in, rpkt_in = _neighbor_push(rhas, rmoved, inj, inj_pkt,
                                       cfg.topology)
    rev_tail = (rev_head + rev_count) % d4
    rev_count = rev_count + rmask_in.to(I32)
    resp_valid = st.resp_valid & ~slot_oh

    # ---- endpoint: service one request per cycle (line rate) ----
    resp_inflight = resp_valid.sum(1).to(I32)
    rev_space = (rev_count[..., P] + resp_inflight) < d3
    can = (st.ep_in.count[..., 0] > 0) & rev_space
    req = _fifo_peek(st.ep_in)[..., 0]                      # (B, F, ny, nx)
    req_hdr = req[:, HDR]
    req_op = (req_hdr >> OP_SHIFT) & OP_MASK
    addr = req[:, ADDR].clamp(0, cfg.mem_words - 1).long()[..., None]
    cur = st.mem.gather(-1, addr).squeeze(-1)
    is_store = can & (req_op == OP_STORE)
    is_load = can & (req_op == OP_LOAD)
    is_cas = can & (req_op == OP_CAS)
    cas_hit = is_cas & (cur == req[:, CMP])
    newval = torch.where(is_store | cas_hit, req[:, DATA], cur)
    mem = st.mem.scatter(-1, addr, newval[..., None])
    can_i = can.to(I32)[..., None]
    ep_head = (st.ep_in.head + can_i) % cfg.ep_fifo
    ep_count = st.ep_in.count - can_i
    rdata = torch.where(is_load | is_cas, cur, 0)
    # the response: src<->dst swapped so it routes home; it carries the
    # request's UNCLAMPED address
    resp = torch.stack([swap_for_response(req_hdr, xs, ys), req[:, ADDR],
                        rdata, req[:, CMP], req[:, TAG]], 1)
    # refill the slot just injected from (it was cleared above)
    resp_valid = torch.where(slot_oh, can[:, None], resp_valid)
    resp_buf = torch.where(slot_oh[:, None] & can[:, None, None],
                           resp[:, :, None], st.resp_buf)

    # ---- forward network: P deliveries go to the endpoint FIFO ----
    rr_fwd, fpop, fhas = _finalize(win2[:, FWD], st.rr[:, FWD],
                                   ep_count[..., 0] < cfg.ep_fifo)
    fmoved = moved2[:, :, FWD]
    fwd_head = (st.net.head[:, FWD] + fpop.to(I32)) % d4
    fwd_count = st.net.count[:, FWD] - fpop.to(I32)
    got, fpkt = fhas[..., P], fmoved[..., P]
    ep_tail = (ep_head + ep_count) % cfg.ep_fifo            # (B, ny, nx, 1)
    ep_oh = (torch.arange(cfg.ep_fifo, device=dev) == ep_tail[..., None]) \
        & got[..., None, None]
    ep_buf = torch.where(ep_oh[:, None], fpkt[..., None, None], st.ep_in.buf)
    ep_count = ep_count + got.to(I32)[..., None]

    # ---- master injection from the per-lane, per-tile program ----
    pending = st.prog_ptr < prog.length
    out_of_credit = st.out_of_credit_cycles \
        + (pending & (credits <= 0)).to(I32)
    can_inj = pending & (credits > 0)
    Lp = prog.buf.shape[-1]
    pidx = st.prog_ptr.clamp(0, max(Lp - 1, 0)).long()[:, None, :, :, None]
    entry = prog.buf.gather(
        -1, pidx.expand(B, len(PROG_FIELDS), ny, nx, 1)).squeeze(-1)
    can_inj = can_inj & (entry[:, NOT_BEFORE] <= c3)
    can_inj = can_inj & (fwd_count[..., P] < d3)
    pkt = torch.stack([with_src(entry[:, HDR], xs, ys), entry[:, ADDR],
                       entry[:, DATA], entry[:, CMP],
                       c3.expand(B, ny, nx)], 1)
    fmask_in, fpkt_in = _neighbor_push(fhas, fmoved, can_inj, pkt,
                                       cfg.topology)
    fwd_tail = (fwd_head + fwd_count) % d4
    fwd_count = fwd_count + fmask_in.to(I32)
    credits = credits - can_inj.to(I32)
    prog_ptr = st.prog_ptr + can_inj.to(I32)

    # ---- one stacked buffer write: both networks at once ----
    cap = st.net.buf.shape[-1]
    mask2 = torch.stack([fmask_in, rmask_in], 1)            # (B,2,ny,nx,5)
    pkt2 = torch.stack([fpkt_in, rpkt_in], 2)               # (B,F,2,ny,nx,5)
    tail2 = torch.stack([fwd_tail, rev_tail], 1)
    onehot = (torch.arange(cap, device=dev) == tail2[..., None]) \
        & mask2[..., None]
    count = torch.stack([fwd_count, rev_count], 1)
    net = Fifo(buf=torch.where(onehot[:, None], pkt2[..., None], st.net.buf),
               head=torch.stack([fwd_head, rev_head], 1), count=count)

    # ---- telemetry: link counts + occupancy high-water marks ----
    link_util = st.link_util + torch.stack([fhas, rhas], 1).to(I32)
    fifo_hwm = torch.maximum(st.fifo_hwm, count)
    ep_hwm = torch.maximum(st.ep_hwm, ep_count[..., 0])

    st = SimState(net=net, ep_in=Fifo(ep_buf, ep_head, ep_count),
                  resp_valid=resp_valid, resp_buf=resp_buf, mem=mem,
                  credits=credits, rr=torch.stack([rr_fwd, rr_rev], 1),
                  prog_ptr=prog_ptr, reg_valid=reg_valid, reg_buf=reg_buf,
                  completed=completed, lat_sum=lat_sum,
                  out_of_credit_cycles=out_of_credit,
                  cycle=c + 1, fifo_depth=st.fifo_depth,
                  max_credits=st.max_credits,
                  link_util=link_util, fifo_hwm=fifo_hwm, ep_hwm=ep_hwm,
                  lat_hist=lat_hist, measure_start=st.measure_start,
                  measure_stop=st.measure_stop)
    return st, done_now


def drained(st: SimState, prog: Program) -> torch.Tensor:
    """Per-lane global fence (B,) bool: programs issued, credits home,
    nothing in the registered response port."""
    return ((st.prog_ptr >= prog.length).flatten(1).all(1)
            & (st.credits == st.max_credits[:, None, None]).flatten(1).all(1)
            & ~st.reg_valid.flatten(1).any(1))


# ----------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------
def _check_cycles_per_call(cycles_per_call: Optional[int]) -> None:
    if cycles_per_call is not None and cycles_per_call < 1:
        raise ValueError(
            f"cycles_per_call must be >= 1 or None, got {cycles_per_call}")


def launch_sizes(cycles: int, cycles_per_call: Optional[int]) -> List[int]:
    """``cycles // C`` launches of ``C`` cycles plus one remainder;
    ``C=None`` is one launch of all ``cycles``."""
    C = cycles if cycles_per_call is None else min(cycles_per_call, cycles)
    n_full, rem = divmod(cycles, max(C, 1))
    return [C] * n_full + ([rem] if rem else [])


def simulate(cfg: SimConfig, prog: Program, state: SimState, cycles: int,
             cycles_per_call: Optional[int] = None
             ) -> Tuple[SimState, torch.Tensor]:
    """Run ``cycles`` cycles of every lane; returns
    ``(final_state, completions_per_cycle (B, cycles))``.

    On a CUDA state each call of the router kernel advances
    ``cycles_per_call`` cycles (``None``: all ``cycles`` in one call, with
    no host sync) and updates ``state`` in place (do not reuse the
    argument); on a CPU state the cycles run through :func:`step_core`.
    ``cycles_per_call`` changes speed only."""
    from repro_torch.kernels.router_step import router_step_call
    _check_cycles_per_call(cycles_per_call)
    dones = [state.cycle.new_zeros((state.cycle.shape[0], 0))]
    for c in launch_sizes(cycles, cycles_per_call):
        state, done, _drained = router_step_call(cfg, prog, state, c)
        dones.append(done)
    return state, torch.cat(dones, 1)


def _drain_loop(cfg: SimConfig, prog: Program, state: SimState,
                max_cycles: int, check_every: int, trace: bool,
                cycles_per_call: Optional[int]):
    """Shared driver of the two drain entry points: run blocks of
    ``check_every`` cycles and check the fence on the host once per block,
    recording the *exact* per-lane fence cycle from inside the block.

    A lane stops at the end of the block in which its fence closed, as
    each lane of the reference's vmapped ``while_loop`` does.  Its
    network is quiescent from the fence on (programs issued, credits home,
    nothing in flight), so stepping it on with the other lanes changes
    only its ``cycle``, which is set back at the end.  With
    ``cycles_per_call=None`` each block is one call."""
    from repro_torch.kernels.router_step import router_step_call
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    _check_cycles_per_call(cycles_per_call)
    K = check_every
    blocks = -(-max_cycles // K)
    c0 = state.cycle.clone()
    active = ~drained(state, prog)
    dcyc = torch.where(active, -1, c0)
    lane_blocks = torch.zeros_like(c0)
    sizes = launch_sizes(K, cycles_per_call)
    traces = [c0.new_zeros((c0.shape[0], 0))]
    i = 0
    while i < blocks and bool(active.any()):    # one host check per block
        c_start = state.cycle.clone()
        dones, drains = [], []
        for c in sizes:
            state, d, dr = router_step_call(cfg, prog, state, c)
            dones.append(d)
            drains.append(dr)
        drain_vec = torch.cat(drains, 1) > 0             # (B, K) post-cycle
        first = drain_vec.to(I32).argmax(1).to(I32)
        hit = active & drain_vec.any(1)
        dcyc = torch.where(hit, c_start + first + 1, dcyc)
        if trace:
            traces.append(torch.where(active[:, None], torch.cat(dones, 1), 0))
        lane_blocks = lane_blocks + active.to(I32)
        active = active & ~hit
        i += 1
    state = state._replace(cycle=c0 + lane_blocks * K)
    steps = torch.where(dcyc >= 0, dcyc - c0, lane_blocks * K)
    return state, steps, dcyc, torch.cat(traces, 1)


def run_until_drained(cfg: SimConfig, prog: Program, state: SimState,
                      max_cycles: int = 100_000, check_every: int = 1,
                      cycles_per_call: Optional[int] = None
                      ) -> Tuple[SimState, torch.Tensor]:
    """Step until each lane's fence closes (or ``max_cycles`` further
    cycles); returns ``(final_state, drain_cycle (B,))``.

    The drain cycle is exact for any ``check_every``; the *state* of a
    lane may have stepped up to ``check_every - 1`` cycles past its fence
    (only ``cycle`` differs — a drained network is quiescent)."""
    final, _steps, dcyc, _ = _drain_loop(cfg, prog, state, max_cycles,
                                         check_every, False, cycles_per_call)
    return final, torch.where(dcyc >= 0, dcyc, final.cycle)


def run_until_drained_traced(cfg: SimConfig, prog: Program, state: SimState,
                             max_cycles: int = 100_000, check_every: int = 1,
                             cycles_per_call: Optional[int] = None
                             ) -> Tuple[SimState, torch.Tensor, torch.Tensor]:
    """Like :func:`run_until_drained` but also returns the per-cycle
    completion trace of the blocks run: ``(final_state, steps_taken (B,),
    trace (B, blocks_run * check_every))`` — ``trace[b, :steps_taken[b]]``
    is lane ``b``'s valid part."""
    final, steps, _dcyc, tr = _drain_loop(cfg, prog, state, max_cycles,
                                          check_every, True, cycles_per_call)
    return final, steps, tr


# ----------------------------------------------------------------------
# stateful wrapper mirroring the oracle's driving API (one lane)
# ----------------------------------------------------------------------
class TorchMeshSim:
    """Thin stateful one-lane wrapper over the functional API::

        sim = TorchMeshSim(SimConfig(nx=4, ny=4), device="cpu")
        sim.load_program(prog)
        sim.run(100)            # or sim.run_until_drained()
        sim.mem, sim.completed, sim.completed_per_cycle, ...

    ``check_every`` / ``cycles_per_call`` are speed knobs of
    :func:`run_until_drained` / :func:`simulate`; they never change
    results."""

    def __init__(self, cfg, fifo_depth=None, max_credits=None, *,
                 check_every: int = 1,
                 cycles_per_call: Optional[int] = None, device=None):
        if not isinstance(cfg, SimConfig):
            from repro_torch.mesh.config import MeshConfig
            cfg = MeshConfig.coerce(cfg).to_sim()
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        _check_cycles_per_call(cycles_per_call)
        self.cfg = cfg
        self.check_every = int(check_every)
        self.cycles_per_call = cycles_per_call
        self.device = resolve_device(device)
        self.state = init_state(cfg, fifo_depth, max_credits, lanes=1,
                                device=self.device)
        self.program = Program(
            buf=torch.zeros((1, len(PROG_FIELDS), cfg.ny, cfg.nx, 1),
                            dtype=I32, device=self.device),
            length=torch.zeros((1, cfg.ny, cfg.nx), dtype=I32,
                               device=self.device))
        self.completed_per_cycle: list = []

    def load_program(self, entries: Dict[str, np.ndarray]) -> None:
        self.program = load_program(entries, self.device)
        self.state = self.state._replace(
            prog_ptr=torch.zeros_like(self.state.prog_ptr))

    def run(self, cycles: int) -> None:
        self.state, per_cycle = simulate(self.cfg, self.program, self.state,
                                         cycles, self.cycles_per_call)
        self.completed_per_cycle.extend(per_cycle[0].tolist())

    def run_until_drained(self, max_cycles: int = 100_000) -> int:
        cycle0 = self.cycle
        self.state, steps, trace = run_until_drained_traced(
            self.cfg, self.program, self.state, max_cycles,
            self.check_every, self.cycles_per_call)
        steps = int(steps[0])
        self.completed_per_cycle.extend(trace[0, :steps].tolist())
        if steps >= max_cycles and \
                not bool(drained(self.state, self.program)[0]):
            raise RuntimeError(f"network did not drain in {max_cycles} cycles")
        # exact fence cycle even when check_every > 1 overshoots the state
        return cycle0 + steps

    def _lane0(self, t: torch.Tensor) -> np.ndarray:
        return t[0].cpu().numpy().astype(np.int64)

    # oracle-shaped accessors -----------------------------------------
    @property
    def mem(self) -> np.ndarray:
        return self._lane0(self.state.mem)

    @property
    def completed(self) -> np.ndarray:
        return self._lane0(self.state.completed)

    @property
    def lat_sum(self) -> np.ndarray:
        return self._lane0(self.state.lat_sum)

    @property
    def credits(self) -> np.ndarray:
        return self._lane0(self.state.credits)

    @property
    def out_of_credit_cycles(self) -> np.ndarray:
        return self._lane0(self.state.out_of_credit_cycles)

    # telemetry ---------------------------------------------------------
    @property
    def link_util_fwd(self) -> np.ndarray:
        return self._lane0(self.state.link_util[:, FWD])

    @property
    def link_util_rev(self) -> np.ndarray:
        return self._lane0(self.state.link_util[:, REV])

    @property
    def fifo_hwm_fwd(self) -> np.ndarray:
        return self._lane0(self.state.fifo_hwm[:, FWD])

    @property
    def fifo_hwm_rev(self) -> np.ndarray:
        return self._lane0(self.state.fifo_hwm[:, REV])

    @property
    def ep_hwm(self) -> np.ndarray:
        return self._lane0(self.state.ep_hwm)

    @property
    def lat_hist(self) -> np.ndarray:
        return self._lane0(self.state.lat_hist)

    def set_measure_window(self, start: int, stop: int) -> None:
        """Restrict the latency histogram to packets *injected* in cycle
        range [start, stop)."""
        self.state = self.state._replace(
            measure_start=torch.full_like(self.state.measure_start, start),
            measure_stop=torch.full_like(self.state.measure_stop, stop))

    @property
    def cycle(self) -> int:
        return int(self.state.cycle[0])

    def mean_latency(self) -> float:
        done = int(self.completed.sum())
        return float(self.lat_sum.sum()) / max(done, 1)

    def throughput(self, warmup: int = 0) -> float:
        per = self.completed_per_cycle[warmup:]
        return float(np.sum(per)) / max(len(per), 1)
