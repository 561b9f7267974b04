"""Workload representation: a named, steppable injection program.

The port of ``repro/workloads/base.py``.  Every workload compiler in this
package lowers a communication pattern into a :class:`Workload` — a plain
injection program (the ``make_traffic`` dict schema, which both facade
backends take, :class:`repro_torch.mesh.Simulator`) plus the bookkeeping
the runner needs to report per-step numbers: how many logical steps the
program encodes, how many packets it injects, and how its ranks are
placed on the mesh.

The compilers emit *packet lists* — ``(src_x, src_y, dst_x, dst_y, addr,
data, cmp, op, not_before)`` — and :func:`program_from_packets` assembles
them into the dense ``(ny, nx, L)`` program arrays, sorting each tile's
packets by ``not_before`` (the simulators inject strictly in slot order,
so an out-of-order slot would stall everything behind it).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.netsim import OP_LOAD, OP_STORE  # noqa: F401 (re-export)
from repro_torch.mesh.traffic import empty_program

from .placement import Placement

__all__ = ["Packet", "Workload", "program_from_packets", "merge_workloads"]


class Packet(NamedTuple):
    """One forward-link packet of a compiled workload (a tuple: a 16x32
    all-reduce makes a million of them)."""
    src_x: int
    src_y: int
    dst_x: int
    dst_y: int
    addr: int
    data: int = 0
    cmp: int = 0
    op: int = OP_STORE
    not_before: int = 0


def program_from_packets(nx: int, ny: int,
                         packets: Iterable[Packet]) -> Dict[str, np.ndarray]:
    """Assemble a packet list into a ``(ny, nx, L)`` injection program.

    Each tile's packets are stably sorted by ``not_before`` (compilers
    emit them in logical order, which breaks ties — so same-cycle packets
    keep their point-to-point program order).  One table and one stable
    sort by (tile, ``not_before``): a 16x32 all-reduce has a million
    packets."""
    packets = list(packets)
    table = np.fromiter(itertools.chain.from_iterable(packets), np.int64,
                        len(packets) * len(Packet._fields)).reshape(
                            len(packets), len(Packet._fields))
    if not len(table):
        return empty_program(nx, ny, 1)
    tile = table[:, 1] * nx + table[:, 0]
    order = np.lexsort((table[:, -1], tile))           # stable
    table, tile = table[order], tile[order]
    counts = np.bincount(tile, minlength=nx * ny)
    slot = np.arange(len(tile)) - (np.cumsum(counts) - counts)[tile]
    prog = empty_program(nx, ny, int(counts.max()))
    for j, name in enumerate(Packet._fields[2:], start=2):
        prog[name][table[:, 1], table[:, 0], slot] = table[:, j]
    return prog


@dataclasses.dataclass(frozen=True)
class Workload:
    """A compiled traffic workload, ready for ``Simulator.attach``.

    ``n_steps`` is the workload's own notion of a logical step (ring
    steps for all-reduce, microbatches for a pipeline, one dispatch for
    an all-to-all); ``WorkloadReport.cycles_per_step`` divides the drain
    cycle by it.  ``meta`` carries compiler-specific facts (payload
    sizes, expert loads, bubble fractions, ...), all JSON-ready.
    """

    name: str
    family: str              # "allreduce" | "broadcast" | "moe" | "pipeline" | "pgas"
    nx: int
    ny: int
    program: Dict[str, np.ndarray]
    n_steps: int
    n_packets: int
    placement: Optional[Placement] = None
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        counted = int((np.asarray(self.program["op"]) >= 0).sum())
        if counted != self.n_packets:
            raise ValueError(
                f"workload {self.name!r} claims {self.n_packets} packets "
                f"but its program holds {counted}")
        if self.n_steps < 1:
            raise ValueError(
                f"workload {self.name!r} needs n_steps >= 1, "
                f"got {self.n_steps}")

    @property
    def mesh(self) -> str:
        return f"{self.nx}x{self.ny}"

    def injected_per_tile(self) -> np.ndarray:
        """(ny, nx) packets each tile's program injects."""
        return (np.asarray(self.program["op"]) >= 0).sum(-1)


def merge_workloads(name: str, workloads: Sequence[Workload], *,
                    gap: int = 0) -> Workload:
    """Concatenate workloads in time: each successive workload's
    ``not_before`` schedule starts ``gap`` cycles after the previous
    one's last scheduled injection.  Families may differ (the merged
    family is "mixed" unless they all agree); steps add up."""
    if not workloads:
        raise ValueError("merge_workloads needs at least one workload")
    nx, ny = workloads[0].nx, workloads[0].ny
    if any(w.nx != nx or w.ny != ny for w in workloads):
        raise ValueError("cannot merge workloads compiled for different "
                         "mesh shapes")
    packets: List[Packet] = []
    offset = 0
    for w in workloads:
        op = np.asarray(w.program["op"])
        live = op >= 0
        for y, x, i in zip(*np.nonzero(live)):
            packets.append(Packet(
                src_x=int(x), src_y=int(y),
                dst_x=int(w.program["dst_x"][y, x, i]),
                dst_y=int(w.program["dst_y"][y, x, i]),
                addr=int(w.program["addr"][y, x, i]),
                data=int(w.program["data"][y, x, i]),
                cmp=int(w.program["cmp"][y, x, i]),
                op=int(op[y, x, i]),
                not_before=int(w.program["not_before"][y, x, i]) + offset))
        sched = np.asarray(w.program["not_before"])[live]
        offset += (int(sched.max()) if sched.size else 0) + 1 + gap
    fams = {w.family for w in workloads}
    return Workload(
        name=name, family=fams.pop() if len(fams) == 1 else "mixed",
        nx=nx, ny=ny, program=program_from_packets(nx, ny, packets),
        n_steps=sum(w.n_steps for w in workloads),
        n_packets=sum(w.n_packets for w in workloads),
        meta={"merged": [w.name for w in workloads]})
