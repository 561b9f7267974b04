"""The design-space-exploration runner: spec in, Pareto frontiers out.

The port of ``repro/dse/runner.py``.  One :func:`run_sweep` submission
absorbs a large point count this way:

1. **Cache probe** — every expanded point is looked up in the
   :class:`~repro_torch.dse.cache.ResultCache` first; re-runs simulate
   nothing for known points.
2. **Bucketing** — cache misses group by
   (:class:`~repro_torch.netsim.measure.SweepKey`, program length): one
   batched shape per bucket, however many depth x credits x pattern x
   load points it holds.
3. **Batching** — each bucket's points run as the lanes of
   :func:`~repro_torch.netsim.measure.batched_phased_stats` with per-lane
   FIFO depths and credit allowances: on a card, one router-kernel call
   per phase for ``chunk`` lanes at once (by default the whole bucket).
   Points that differ only in depth or credits share one program: each
   distinct program is built once on the host, copied once, and gathered
   into lanes on the device.
4. **Fan-out** — with ``devices=N`` a bucket splits in order over
   ``cuda:0`` .. ``cuda:N-1``; every card's slice is launched before any
   result is read back, and the slices merge in point order.  Asking for
   more cards than are visible warns once and runs on one card.

Frontier extraction (:func:`frontier_artifact`) is a pure post-pass over
the cached telemetry: per topology, each (fifo_depth, credits)
configuration's load–latency curve is reduced to (saturation rate,
saturation throughput), priced with the
:class:`~repro_torch.dse.cost.CostModel`, and the undominated
area-vs-throughput set is emitted as JSON + an ASCII figure.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.mesh.topology import Topology
from repro_torch.mesh.traffic import make_traffic
from repro_torch.netsim.measure import (SweepKey, batched_phased_stats,
                                        first_execution, saturation_point)
from repro_torch.netsim.sim import Program, load_program, stack_programs

from .cache import ResultCache, config_hash
from .cost import CostModel
from .pareto import ascii_frontier, frontier_is_monotone, pareto_front
from .spec import SweepPoint, SweepSpec, workload_entries

__all__ = ["SweepResult", "run_sweep", "buckets", "bucket_programs",
           "point_record", "frontier_artifact", "frontier_ascii",
           "write_frontier"]

# the PhaseStats scalars persisted per point (hist stays in-memory only:
# 512 bins x 500+ points of JSON would dwarf the numbers anyone reads)
STAT_FIELDS = ("offered", "accepted", "delivered", "lat_mean", "lat_p50",
               "lat_p95", "lat_p99", "lat_max", "peak_link_util", "hops")


@dataclasses.dataclass
class SweepResult:
    """What one submission did: the per-point records (spec order) plus
    the service accounting the acceptance gates read.  ``compiles``
    counts bucket shapes this process had not run before
    (:func:`repro_torch.netsim.measure.first_execution`); ``program_s`` is
    the host time spent building and copying programs and ``simulate_s``
    the simulation's time: on a card the device time between CUDA events
    around each card's launches, summed over cards; on the CPU the host
    time."""
    spec: SweepSpec
    records: List[Dict]
    n_points: int
    simulated: int
    cache_hits: int
    infeasible: List[str]
    buckets: int
    compiles: int
    devices: int
    wall_s: float
    program_s: float = 0.0
    simulate_s: float = 0.0

    def by_point(self) -> Dict[SweepPoint, Dict]:
        return {_point_from_record(r): r for r in self.records}


def _resolve_devices(requested: Optional[int], device
                     ) -> List[torch.device]:
    """The devices a bucket is split over: ``device`` (the card unless
    ``"cpu"``) alone, or ``cuda:0`` .. ``cuda:N-1`` for ``requested = N``
    cards.  Asking for more than are visible warns and falls back to the
    single device — N cards to one, never to the CPU."""
    device = resolve_device(device)
    if requested is None or requested <= 1:
        return [device]
    avail = torch.cuda.device_count() if device.type == "cuda" else 1
    if requested > avail:
        warnings.warn(
            f"sweep requested {requested} devices but only {avail} "
            f"{device.type} device(s) are visible; falling back to the "
            f"single-device path on {device}", stacklevel=3)
        return [device]
    return [resolve_device(f"cuda:{i}") for i in range(int(requested))]


def _entries(workloads: Dict, p: SweepPoint) -> Dict[str, np.ndarray]:
    """A workload point's program, built once per submission."""
    ident = (p.family, p.nx, p.ny, p.seed)
    if ident not in workloads:
        workloads[ident] = workload_entries(p.family, p.nx, p.ny, p.seed)
    return workloads[ident]


def buckets(spec: SweepSpec, points: Optional[Sequence[SweepPoint]] = None,
            workloads: Optional[Dict] = None
            ) -> Dict[Tuple[SweepKey, int], List[SweepPoint]]:
    """``points`` (default: every point of ``spec``) grouped as
    :func:`run_sweep` runs them, by (:class:`SweepKey`, program length),
    each group in point order.  ``workloads`` memoises the workload
    families' programs, which set their points' lengths."""
    workloads = {} if workloads is None else workloads
    out: Dict[Tuple[SweepKey, int], List[SweepPoint]] = {}
    for p in spec.points() if points is None else points:
        length = _entries(workloads, p)["op"].shape[-1] if p.is_workload \
            else spec.traffic_length()
        out.setdefault((spec.sweep_key(p.topology), int(length)),
                       []).append(p)
    return out


def bucket_programs(pts: Sequence[SweepPoint], length: int,
                    device: torch.device, workloads: Optional[Dict] = None
                    ) -> Tuple[Program, torch.Tensor]:
    """Each distinct program of ``pts`` built once (points that differ
    only in depth or credits share one) and copied to ``device`` in one
    transfer; returns the programs and each point's index into them (on
    ``device``)."""
    workloads = {} if workloads is None else workloads
    index: Dict[tuple, int] = {}
    progs = []
    for p in pts:
        ident = (p.traffic, p.load, p.seed)
        if ident in index:
            continue
        index[ident] = len(progs)
        entries = _entries(workloads, p) if p.is_workload else make_traffic(
            p.traffic, p.nx, p.ny, length, rate=p.load, seed=p.seed,
            topology=p.topology)
        progs.append(load_program(entries, "cpu"))
    both = stack_programs(progs)
    rows = torch.tensor([index[(p.traffic, p.load, p.seed)] for p in pts])
    return (Program(both.buf.to(device), both.length.to(device)),
            rows.to(device))


def _run_bucket(key: SweepKey, length: int, pts: Sequence[SweepPoint],
                devices: Sequence[torch.device], chunk: Optional[int],
                workloads: Dict
                ) -> Tuple[List[Dict[str, float]], int, float, float]:
    """Simulate one bucket split in order over ``devices``, ``chunk``
    lanes at a time (``None``: a device's whole slice at once).  Returns
    (per-point stats, 1 if the bucket's shape is new to this process,
    host seconds building programs, simulation seconds)."""
    n = len(pts)
    per = -(-n // len(devices))
    eff = per if chunk is None else max(1, min(int(chunk), per))
    fresh = first_execution((key, len(devices), eff, n, length))
    t0 = time.perf_counter()
    slices = []
    for i, dev in enumerate(devices):
        sub = pts[i * per:(i + 1) * per]
        if sub:
            slices.append((dev, sub,
                           *bucket_programs(sub, length, dev, workloads)))
    program_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = []
    for dev, sub, progs, rows in slices:      # launch every slice first
        depths = np.fromiter((p.fifo_depth for p in sub), np.int32, len(sub))
        credits = np.fromiter((p.credits for p in sub), np.int32, len(sub))
        events = None
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            events[0].record(torch.cuda.current_stream(dev))
        out = []
        for a in range(0, len(sub), eff):
            lanes = rows[a:a + eff]
            out.append(batched_phased_stats(
                key, Program(progs.buf[lanes], progs.length[lanes]),
                depths[a:a + eff], credits[a:a + eff]))
        if events:
            events[1].record(torch.cuda.current_stream(dev))
        runs.append((out, events))
    host = [torch.stack([torch.cat([getattr(s, f) for s in out])
                         for f in STAT_FIELDS]).cpu().numpy()
            for out, _ in runs]               # then read them back in order
    simulate_s = time.perf_counter() - t0
    if devices[0].type == "cuda":
        simulate_s = sum(a.elapsed_time(b) for _, (a, b) in runs) / 1e3
    table = np.concatenate(host, axis=1)
    return ([{f: float(table[j, i]) for j, f in enumerate(STAT_FIELDS)}
             for i in range(n)], int(fresh), program_s, simulate_s)


def point_record(point: SweepPoint, stats: Dict[str, float]) -> Dict:
    """The record a sweep keeps of ``point``: its coordinates and its
    :data:`STAT_FIELDS` rounded to 6 places."""
    return {
        "point": {"nx": point.nx, "ny": point.ny,
                  "topology": point.topology.spec,
                  "fifo_depth": point.fifo_depth, "credits": point.credits,
                  "traffic": point.traffic, "load": point.load,
                  "seed": point.seed},
        "stats": {k: round(v, 6) for k, v in stats.items()},
    }


def _point_from_record(record: Dict) -> SweepPoint:
    p = record["point"]
    return SweepPoint(nx=p["nx"], ny=p["ny"],
                      topology=Topology.parse(p["topology"]),
                      fifo_depth=p["fifo_depth"], credits=p["credits"],
                      traffic=p["traffic"], load=p["load"],
                      seed=p.get("seed", 0))


def run_sweep(spec: SweepSpec, *, cache_dir=None,
              devices: Optional[int] = None, chunk: Optional[int] = None,
              compile_cache_dir=None,
              progress: Optional[Callable[[str], None]] = None,
              device=None) -> SweepResult:
    """Run (the uncached remainder of) a sweep spec; see the module
    docstring for the pipeline.  ``cache_dir`` may be a directory path
    or a :class:`ResultCache` (None disables caching); ``devices``
    requests the fan-out width over cards; ``chunk`` bounds how many
    lanes are live per device at once (``None``: a whole bucket);
    ``compile_cache_dir`` points the kernel build directory
    (``$REPRO_TORCH_BUILD_DIR``, :mod:`repro_torch.kernels.build`) at that
    path, where the router library — the port's only compiled artefact —
    is built once and reused by later processes.  Runs on the card unless
    ``device="cpu"``; records do not depend on ``chunk`` or ``devices``."""
    t0 = time.perf_counter()
    if compile_cache_dir is not None:
        os.environ["REPRO_TORCH_BUILD_DIR"] = str(compile_cache_dir)
    log = progress if progress is not None else (lambda msg: None)
    cache = cache_dir if isinstance(cache_dir, ResultCache) \
        else ResultCache(cache_dir)
    points = spec.points()
    infeasible = [f"skipped {t.spec} fifo_depth={d}: {why}"
                  for t, d, why in spec.infeasible()]
    for line in infeasible:
        log(line)
    log(spec.describe())

    done: Dict[SweepPoint, Dict] = {}
    misses: List[SweepPoint] = []
    for p in points:
        rec = cache.get(spec.point_key(p))
        if rec is not None:
            done[p] = rec
        else:
            misses.append(p)
    devs = _resolve_devices(devices, device)

    workloads: Dict = {}
    groups = buckets(spec, misses, workloads)

    compiles, program_s, simulate_s = 0, 0.0, 0.0
    for (key, length), pts in groups.items():
        log(f"bucket {key.cfg.topology.spec} L={length}: {len(pts)} points "
            f"({len(devs)} device(s), chunk {chunk or 'bucket'})")
        stats, fresh, ps, ss = _run_bucket(key, length, pts, devs, chunk,
                                           workloads)
        compiles += fresh
        program_s += ps
        simulate_s += ss
        for p, s in zip(pts, stats):
            rec = point_record(p, s)
            cache.put(spec.point_key(p), rec)
            done[p] = rec

    return SweepResult(
        spec=spec, records=[done[p] for p in points], n_points=len(points),
        simulated=len(misses), cache_hits=len(points) - len(misses),
        infeasible=infeasible, buckets=len(groups), compiles=compiles,
        devices=len(devs), wall_s=round(time.perf_counter() - t0, 2),
        program_s=program_s, simulate_s=simulate_s)


# -- frontier extraction -----------------------------------------------

def _config_points(spec: SweepSpec, records: Sequence[Dict], topology: str,
                   pattern: str, cost: CostModel) -> List[Dict]:
    """Reduce one topology's traffic records to per-(depth, credits)
    configuration points: saturation rate/throughput from the load
    curve, area/energy from the cost model."""
    groups: Dict[Tuple[int, int], List[Dict]] = {}
    for r in records:
        p = r["point"]
        if p["topology"] == topology and p["traffic"] == pattern:
            groups.setdefault((p["fifo_depth"], p["credits"]),
                              []).append(r)
    ntiles = spec.nx * spec.ny
    out = []
    for (depth, cred), recs in sorted(groups.items()):
        recs = sorted(recs, key=lambda r: r["point"]["load"])
        loads = [r["point"]["load"] for r in recs]
        lat = [r["stats"]["lat_mean"] for r in recs]
        acc = [r["stats"]["accepted"] for r in recs]
        sat = saturation_point(np.asarray(lat))
        peak = int(np.argmax(acc))
        packets = acc[peak] * ntiles * spec.measure
        cfg = dataclasses.replace(
            _point_from_record(recs[0]), fifo_depth=depth,
            credits=cred).mesh_config()
        out.append({
            "fifo_depth": depth, "credits": cred,
            "area_mm2": round(cost.buffer_area_mm2(cfg), 4),
            "throughput": round(float(max(acc)), 4),
            "saturation_rate": None if sat is None else float(loads[sat]),
            "zero_load_latency": round(float(lat[0]), 2),
            "energy_pj_per_packet": round(cost.energy_per_packet_pj(
                recs[peak]["stats"]["hops"], packets), 2),
            "loads": [round(float(x), 3) for x in loads],
        })
    return out


def frontier_artifact(result: SweepResult, cost: Optional[CostModel] = None,
                      pattern: Optional[str] = None) -> Dict:
    """The persisted JSON artifact: per-topology configuration points +
    Pareto frontier over (buffer area, saturation throughput).

    ``pattern`` picks the traffic pattern the frontier is computed from
    (default: ``"uniform"`` when swept, else the spec's first pattern —
    the standard saturation methodology)."""
    spec = result.spec
    cost = cost if cost is not None else CostModel()
    if pattern is None:
        pattern = "uniform" if "uniform" in spec.patterns else (
            spec.patterns[0] if spec.patterns else None)
    if pattern is None:
        raise ValueError(
            "frontier extraction needs a synthetic traffic pattern; this "
            "sweep spec only ran workload families")
    frontiers = {}
    for topo in spec.topologies:
        pts = _config_points(spec, result.records, topo.spec, pattern, cost)
        front = pareto_front(pts)
        frontiers[topo.spec] = {
            "points": pts,
            "frontier": front,
            "monotone": frontier_is_monotone(front),
        }
    return {
        "name": f"dse_frontier_{spec.name}",
        "mesh": f"{spec.nx}x{spec.ny}",
        "pattern": pattern,
        "config_hash": config_hash(),
        "cost_model": cost.to_json(),
        "spec": spec.describe(),
        "n_points": result.n_points,
        "frontiers": frontiers,
    }


def frontier_ascii(artifact: Dict) -> str:
    """Terminal rendering of every topology's frontier figure."""
    blocks = []
    for topo, f in artifact["frontiers"].items():
        blocks.append(f"  -- {topo} ({artifact['pattern']}, "
                      f"{artifact['mesh']}) --")
        blocks.append(ascii_frontier(f["points"], f["frontier"]))
    return "\n".join(blocks)


def write_frontier(path, artifact: Dict) -> Path:
    import json
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=1, default=str))
    return path
