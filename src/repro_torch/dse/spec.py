"""Declarative design-space sweep specifications.

The port of ``repro/dse/spec.py``.  A :class:`SweepSpec` names the axes
the BaseJump paper's sizing question actually spans — router FIFO depth
x credit allowance x traffic pattern x offered load x topology on one
mesh shape, plus (optionally) the real workload families compiled by
:mod:`repro_torch.workloads` — and expands them into the cross product
of :class:`SweepPoint`\\ s the runner simulates.

The spec is *static metadata only*: expansion, feasibility pruning and
bucket grouping are pure Python, so a million-point spec costs nothing
until :func:`repro_torch.dse.run_sweep` actually simulates its cache misses.

Bucketing invariant
-------------------
Every point maps to a :class:`~repro_torch.netsim.measure.SweepKey` whose
``cfg`` carries the *capacity* configuration of its topology bucket
(``router_fifo`` / ``max_out_credits`` = the max swept values), while
the point's own depth/credits ride as per-lane values of the batched
state — so ONE batched shape per (topology, program length) bucket
covers every depth x credits x pattern x load combination: the lanes of
one state, on a card one router-kernel call per phase.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.mesh.config import MeshConfig
from repro_torch.mesh.topology import Topology
from repro_torch.mesh.traffic import PATTERNS
from repro_torch.netsim.measure import DEFAULT_SWEEP_RATES, SweepKey

__all__ = ["SweepPoint", "SweepSpec", "WORKLOAD_FAMILIES",
           "workload_instance", "workload_entries"]

# The model-stack workload families the spec may sweep (lowered by
# repro_torch.workloads).  Sized modestly: the DSE compares *relative*
# throughput across buffer configurations, not absolute workload runtime.
WORKLOAD_FAMILIES = ("allreduce", "broadcast", "moe", "pipeline")

_WL_PREFIX = "wl:"


def workload_instance(family: str, nx: int, ny: int, seed: int = 0):
    """The DSE's fixed instance of one workload family on an nx x ny
    array, as a :class:`repro_torch.workloads.Workload`."""
    from repro_torch.workloads import (moe_all_to_all, parameter_broadcast,
                                       pipeline_p2p, ring_all_reduce)
    k = nx * ny
    if family == "allreduce":
        return ring_all_reduce(nx, ny, 2 * k)
    if family == "broadcast":
        return parameter_broadcast(nx, ny, 2 * k)
    if family == "moe":
        return moe_all_to_all(nx, ny, 4, imbalance=0.25, seed=seed)
    if family == "pipeline":
        return pipeline_p2p(nx, ny, n_micro=4, act_words=8, backward=True)
    raise ValueError(
        f"unknown workload family {family!r}; known: {WORKLOAD_FAMILIES}")


def workload_entries(family: str, nx: int, ny: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Injection-program entries of :func:`workload_instance`."""
    return workload_instance(family, nx, ny, seed).program


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One simulated configuration: (shape, topology, buffer sizing,
    traffic).  ``traffic`` is a synthetic pattern name or ``"wl:family"``
    for a compiled workload; ``load`` is the offered injection rate
    (0 for workload points, whose programs carry their own schedule)."""
    nx: int
    ny: int
    topology: Topology
    fifo_depth: int
    credits: int
    traffic: str
    load: float = 0.0
    seed: int = 0

    @property
    def is_workload(self) -> bool:
        return self.traffic.startswith(_WL_PREFIX)

    @property
    def family(self) -> Optional[str]:
        """The workload family, or None for a synthetic pattern."""
        return self.traffic[len(_WL_PREFIX):] if self.is_workload else None

    def mesh_config(self) -> MeshConfig:
        """This point's *effective* configuration (depth/credits as the
        capacities) — the identity the result cache keys on, independent
        of whichever bucket capacity the point happened to batch under."""
        return MeshConfig(nx=self.nx, ny=self.ny,
                          router_fifo=self.fifo_depth,
                          max_out_credits=self.credits,
                          topology=self.topology)

    def label(self) -> str:
        load = "" if self.is_workload else f"@{self.load:g}"
        return (f"{self.topology.spec}/fifo{self.fifo_depth}"
                f"/cred{self.credits}/{self.traffic}{load}")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The declarative sweep: every axis a tuple, every point their cross
    product.  Topologies accept :class:`Topology` objects or their
    string form (``"torus"``, ``"multi_chip:2:4"``); validation is eager
    and names the offending axis."""
    nx: int
    ny: int
    fifo_depths: Tuple[int, ...] = (2, 4, 8, 16)
    credits: Tuple[int, ...] = (8, 32, 128)
    patterns: Tuple[str, ...] = ("uniform",)
    loads: Tuple[float, ...] = DEFAULT_SWEEP_RATES
    topologies: Tuple[Topology, ...] = ("mesh",)
    workloads: Tuple[str, ...] = ()
    warmup: int = 200
    measure: int = 400
    drain: int = 400
    seed: int = 0
    cycles_per_call: Optional[int] = None
    name: str = "sweep"

    def __post_init__(self):
        dedupe = lambda xs: tuple(dict.fromkeys(xs))  # noqa: E731
        object.__setattr__(self, "fifo_depths",
                           tuple(sorted({int(d) for d in self.fifo_depths})))
        object.__setattr__(self, "credits",
                           tuple(sorted({int(c) for c in self.credits})))
        object.__setattr__(self, "patterns", dedupe(self.patterns))
        object.__setattr__(self, "loads",
                           tuple(sorted({float(r) for r in self.loads})))
        object.__setattr__(
            self, "topologies",
            dedupe(Topology.parse(t) for t in self.topologies))
        object.__setattr__(self, "workloads", dedupe(self.workloads))
        if not self.fifo_depths or min(self.fifo_depths) < 1:
            raise ValueError(
                f"fifo_depths must be positive ints, got {self.fifo_depths}")
        if not self.credits or min(self.credits) < 1:
            raise ValueError(
                f"credits must be positive ints, got {self.credits}")
        for p in self.patterns:
            if p not in PATTERNS:
                raise ValueError(
                    f"unknown traffic pattern {p!r}; known: "
                    f"{sorted(PATTERNS)}")
        for r in self.loads:
            if not 0.0 < r <= 1.0:
                raise ValueError(
                    f"offered loads must be in (0, 1], got {r}")
        for w in self.workloads:
            if w not in WORKLOAD_FAMILIES:
                raise ValueError(
                    f"unknown workload family {w!r}; known: "
                    f"{WORKLOAD_FAMILIES}")
        if not self.patterns and not self.workloads:
            raise ValueError(
                "a sweep needs at least one traffic pattern or workload "
                "family")
        if not self.topologies:
            raise ValueError("a sweep needs at least one topology")
        for topo in self.topologies:
            # surfaces shape/topology mismatches (and the coord-field
            # limits) before any simulation happens
            MeshConfig(nx=self.nx, ny=self.ny,
                       router_fifo=max(max(self.fifo_depths),
                                       topo.min_router_fifo),
                       max_out_credits=max(self.credits), topology=topo)

    # -- expansion ------------------------------------------------------
    @property
    def horizon(self) -> int:
        return self.warmup + self.measure + self.drain

    def feasible_depths(self, topology: Topology) -> Tuple[int, ...]:
        return tuple(d for d in self.fifo_depths
                     if d >= topology.min_router_fifo)

    def points(self) -> List[SweepPoint]:
        """Every feasible point, in deterministic axis order."""
        out = []
        for topo in self.topologies:
            for depth in self.feasible_depths(topo):
                for cred in self.credits:
                    for pat in self.patterns:
                        for load in self.loads:
                            out.append(SweepPoint(
                                self.nx, self.ny, topo, depth, cred, pat,
                                load, self.seed))
                    for fam in self.workloads:
                        out.append(SweepPoint(
                            self.nx, self.ny, topo, depth, cred,
                            _WL_PREFIX + fam, 0.0, self.seed))
        return out

    def infeasible(self) -> List[Tuple[Topology, int, str]]:
        """(topology, fifo_depth, reason) for every pruned combination —
        reported by the runner so a sweep never silently shrinks."""
        out = []
        for topo in self.topologies:
            for depth in self.fifo_depths:
                if depth < topo.min_router_fifo:
                    out.append((topo, depth,
                                f"router_fifo {depth} < "
                                f"{topo.min_router_fifo} required by "
                                f"{topo.spec} bubble flow control"))
        return out

    # -- bucket / cache identities --------------------------------------
    def bucket_config(self, topology: Topology) -> MeshConfig:
        """The *capacity* configuration every point of ``topology``'s
        bucket batches under (max swept depth/credits; per-point values
        ride as dynamic state)."""
        depths = self.feasible_depths(topology)
        if not depths:
            raise ValueError(
                f"no feasible fifo depth for topology {topology.spec} "
                f"in {self.fifo_depths}")
        return MeshConfig(nx=self.nx, ny=self.ny, router_fifo=max(depths),
                          max_out_credits=max(self.credits),
                          topology=topology)

    def sweep_key(self, topology: Topology) -> SweepKey:
        """The batched-run identity of ``topology``'s bucket (the
        :mod:`repro_torch.netsim.measure` key every sweep in the port
        runs under)."""
        return SweepKey(cfg=self.bucket_config(topology).to_sim(),
                        warmup=self.warmup, measure=self.measure,
                        drain=self.drain,
                        cycles_per_call=self.cycles_per_call)

    def traffic_length(self) -> int:
        """Program length for synthetic-pattern points: sized for the
        fastest swept load so every program in a bucket shares one shape
        (slower loads schedule their tail entries past the horizon —
        never injected, exactly like ``stack_rate_programs``)."""
        if not self.loads:
            return 1
        return int(np.ceil(max(self.loads) * self.horizon)) + 1

    def point_key(self, point: SweepPoint) -> str:
        """The on-disk result-cache key: the point's *effective* config
        token plus the measurement recipe.  Deliberately excludes the
        bucket capacity and program-array length — neither changes the
        simulated dynamics, so cached results survive spec regrouping."""
        load = "wl" if point.is_workload else f"{point.load:.6g}"
        return (f"{point.mesh_config().cache_token()}|{point.traffic}"
                f"|load={load}|seed={point.seed}"
                f"|w{self.warmup}m{self.measure}d{self.drain}"
                f"|torch|calls{self.cycles_per_call or 'phase'}")

    def describe(self) -> str:
        n = len(self.points())
        axes = (f"{len(self.topologies)} topologies x "
                f"{len(self.fifo_depths)} depths x "
                f"{len(self.credits)} credits x "
                f"({len(self.patterns)} patterns x {len(self.loads)} loads"
                f" + {len(self.workloads)} workloads)")
        return (f"sweep {self.name!r}: {self.nx}x{self.ny}, {axes} = "
                f"{n} feasible points, horizon {self.horizon} cycles")
