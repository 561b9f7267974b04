"""PGAS scatter/gather lowered to mesh traffic.

``repro/core/pgas.py`` expresses remote memory traffic as a
:class:`~repro.core.pgas.PacketBatch` — a destination-major ``(T, S)``
buffer per source tile (the paper's N^2 FIFO-provisioning rule as a
static shape), delivered by one SPMD ``xy_all_to_all``.  This compiler
takes the *global* view of those batches — ``(T_src, T_dst, S)`` arrays
of addr / data / mask — and lowers every valid slot into an individual
remote load/store packet, so the cycle-level simulator prices the exact
same scatter the SPMD collective executes in one shot.

Injection order is destination-major then slot order, matching the
batch's commit semantics: packets from one source to one destination
stay in slot order (the mesh preserves point-to-point ordering), while
cross-source interleavings are up to the routers — exactly the paper's
*Transaction ordering* rules that :func:`repro.core.pgas.remote_store`
reproduces on the SPMD side.

:func:`expected_memory` computes the post-scatter memory image (for
store batches with collision-free addresses), which
``examples/pgas_scatter_gather.py`` asserts against both the SPMD result
and the simulator's ``mem``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.netsim import OP_LOAD, OP_STORE

from .base import Packet, Workload, program_from_packets
from .placement import Placement

__all__ = ["pgas_from_batches", "pgas_scatter", "expected_memory"]


def _check_batches(addr, data, mask, k):
    addr = np.asarray(addr, np.int64)
    data = np.asarray(data, np.int64)
    mask = np.asarray(mask, bool)
    if not (addr.shape == data.shape == mask.shape) or addr.ndim != 3:
        raise ValueError(
            f"batch arrays must share one (T_src, T_dst, S) shape, got "
            f"addr {addr.shape}, data {data.shape}, mask {mask.shape}")
    if addr.shape[0] != k or addr.shape[1] != k:
        raise ValueError(
            f"batch arrays are {addr.shape[0]}x{addr.shape[1]} tiles but "
            f"the placement has {k} ranks")
    return addr, data, mask


def pgas_from_batches(addr, data, mask, nx: int, ny: int, *,
                      op: int = OP_STORE,
                      placement: Optional[Placement] = None,
                      rate: float = 1.0, mem_words: int = 64,
                      start: int = 0,
                      name: Optional[str] = None) -> Workload:
    """Compile global packet-batch arrays — ``(T_src, T_dst, S)``, one
    row of :class:`~repro.core.pgas.PacketBatch` fields per source tile —
    into a mesh workload.  ``data`` must be integral (the mesh data lane
    is an int32 word; scale floats before compiling)."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"injection rate must be in (0, 1], got {rate}")
    pl = placement if placement is not None else Placement.grid(nx, ny)
    addr, data, mask = _check_batches(addr, data, mask, pl.k)
    if (addr[mask] < 0).any() or (addr[mask] >= mem_words).any():
        raise ValueError(
            f"batch addresses must lie in [0, mem_words={mem_words})")
    T, _, S = addr.shape
    packets = []
    for t in range(T):
        sx, sy = pl.tile(t)
        i = 0
        for d in range(T):
            dx, dy = pl.tile(d)
            for s in range(S):
                if not mask[t, d, s]:
                    continue
                packets.append(Packet(
                    src_x=sx, src_y=sy, dst_x=dx, dst_y=dy,
                    addr=int(addr[t, d, s]), data=int(data[t, d, s]),
                    op=op, not_before=start + int(i / rate)))
                i += 1
    opname = {OP_STORE: "scatter", OP_LOAD: "gather"}.get(op, f"op{op}")
    return Workload(
        name=name or f"pgas_{opname}_t{T}_s{S}",
        family="pgas", nx=nx, ny=ny,
        program=program_from_packets(nx, ny, packets),
        n_steps=1, n_packets=int(mask.sum()), placement=pl,
        meta={"slots": S, "op": opname,
              "valid_slots": int(mask.sum()),
              "source": "core/pgas.py PacketBatch "
                        "(remote_store / remote_load)"})


def pgas_scatter(nx: int, ny: int, slots: int, *, seed: int = 0,
                 mem_words: int = 64,
                 placement: Optional[Placement] = None,
                 start: int = 0) -> Workload:
    """A random scatter in the shape of the PGAS example: each tile
    stores ``slots`` words to ``slots`` distinct successor tiles (slot
    ``s`` goes to rank ``me + s + 1`` at address ``s``), data tagged
    ``me * slots + s`` — "the architecture is very good at random
    scatter"."""
    pl = placement if placement is not None else Placement.grid(nx, ny)
    T = pl.k
    if not 1 <= slots < T:
        raise ValueError(
            f"need 1 <= slots < num_tiles={T} for distinct destinations, "
            f"got slots={slots}")
    if slots > mem_words:
        raise ValueError(f"slots={slots} addresses do not fit "
                         f"mem_words={mem_words}")
    addr = np.zeros((T, T, slots), np.int64)
    data = np.zeros((T, T, slots), np.int64)
    mask = np.zeros((T, T, slots), bool)
    for t in range(T):
        for s in range(slots):
            d = (t + s + 1) % T
            addr[t, d, s] = s
            data[t, d, s] = t * slots + s
            mask[t, d, s] = True
    return pgas_from_batches(addr, data, mask, nx, ny, op=OP_STORE,
                             placement=pl, mem_words=mem_words, start=start,
                             name=f"pgas_scatter_t{T}_s{slots}")


def expected_memory(addr, data, mask, nx: int, ny: int, *,
                    mem_words: int = 64,
                    placement: Optional[Placement] = None) -> np.ndarray:
    """The (ny, nx, mem_words) memory image after committing a *store*
    batch, slot-major across sources (the deterministic commit order of
    :func:`repro.core.pgas.remote_store`).  Collisions — two sources
    writing one (tile, addr) in the same slot — are committed in source
    order here but are unordered on both the SPMD and the cycle-level
    paths, so callers wanting an exact three-way match should compile
    collision-free batches."""
    pl = placement if placement is not None else Placement.grid(nx, ny)
    addr, data, mask = _check_batches(addr, data, mask, pl.k)
    T, _, S = addr.shape
    mem = np.zeros((ny, nx, mem_words), np.int64)
    for s in range(S):
        for t in range(T):
            for d in range(T):
                if mask[t, d, s]:
                    dx, dy = pl.tile(d)
                    mem[dy, dx, addr[t, d, s] % mem_words] = data[t, d, s]
    return mem
