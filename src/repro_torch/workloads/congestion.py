"""Fit measured mesh congestion; price collectives with it.

The roofline's analytic collective term divides wire bytes by a nominal
link bandwidth — it knows nothing about contention, hotspots, or the
serialization the cycle-level simulator actually exhibits.
:class:`CongestionModel` closes that loop:

1. run calibration workloads (ring all-reduce, MoE all-to-all, pipeline
   p2p, broadcast) at a few payload sizes — :func:`calibrate` — or reuse
   any set of :class:`~repro_torch.workloads.runner.WorkloadReport`\\ s;
2. fit, per workload family, the affine law

       ``drain_cycles = alpha * wire_words_per_rank + beta``

   by least squares, where ``wire_words_per_rank = injected / k`` is
   precisely the per-device word count crossing ring links (for a ring
   all-reduce each rank injects ``2 (k-1)/k`` of the payload — the same
   ``2 (k-1)/k`` the analytic ring model uses for wire bytes, so the two
   paths price the *same* byte count, one with measured cycles, one with
   nominal bandwidth);
3. convert an HLO collective's wire bytes into seconds:
   ``op_seconds = (alpha * wire_bytes / 4 + beta * count) / clock_hz``
   (the mesh moves one 32-bit word per link per cycle).

The JAX package's ``launch/roofline.py`` (``network="netsim"``) takes one
of these models and replaces its analytic collective term with
:meth:`collective_times`; the port has no roofline yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CongestionModel", "calibrate", "OP_FAMILY", "WORD_BYTES"]

# the mesh data lane is one 32-bit word per packet
WORD_BYTES = 4

# HLO collective op -> calibrated workload family
OP_FAMILY = {
    "all-reduce": "allreduce",
    "all-gather": "allreduce",        # one ring phase; wire bytes already
    "reduce-scatter": "allreduce",    # carry the (g-1)/g factor
    "all-to-all": "moe",
    "ragged-all-to-all": "moe",
    "collective-permute": "pipeline",
    "collective-broadcast": "broadcast",
}

# fallbacks when a family was not calibrated (e.g. a broadcast-free
# calibration run pricing a collective-broadcast)
_FAMILY_FALLBACK = {"broadcast": "allreduce", "pipeline": "allreduce",
                    "moe": "allreduce", "allreduce": "moe"}


@dataclasses.dataclass(frozen=True)
class CongestionModel:
    """Measured cycles-per-wire-word per workload family.

    ``coeffs[family] = (alpha, beta)``: simulated drain cycles of a
    family workload moving ``x`` wire words per rank is ``alpha*x +
    beta``.  ``clock_hz`` converts cycles to seconds (the mesh clock —
    1 GHz unless the caller models a specific fabric).
    """

    mesh: str
    coeffs: Dict[str, Tuple[float, float]]
    clock_hz: float = 1e9
    n_points: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.coeffs:
            raise ValueError("a CongestionModel needs at least one fitted "
                             "family")
        if self.clock_hz <= 0:
            raise ValueError(f"clock_hz must be positive, "
                             f"got {self.clock_hz}")

    # -- fitting --------------------------------------------------------
    @classmethod
    def fit(cls, reports: Iterable, *, mesh: str = "",
            clock_hz: float = 1e9) -> "CongestionModel":
        """Least-squares fit from :class:`WorkloadReport`\\ s (each must
        carry ``meta['k']`` or a placement-sized rank count; ``injected /
        k`` is the per-rank wire-word count).  One report per family fits
        a pure slope (beta = 0)."""
        pts: Dict[str, List[Tuple[float, float]]] = {}
        meshes = set()
        for r in reports:
            k = r.meta.get("k") or r.meta.get("n_experts") \
                or r.meta.get("n_stages")
            if not k:
                # fall back to every tile participating
                nx, ny = (int(v) for v in r.mesh.split("x"))
                k = nx * ny
            x = r.injected / float(k)
            pts.setdefault(r.family, []).append((x, float(r.cycles)))
            meshes.add(r.mesh)
        if not pts:
            raise ValueError("no reports to fit a congestion model from")
        coeffs: Dict[str, Tuple[float, float]] = {}
        npts: Dict[str, int] = {}
        for fam, xy in pts.items():
            xs = np.asarray([p[0] for p in xy], float)
            ys = np.asarray([p[1] for p in xy], float)
            if len(xy) == 1 or np.ptp(xs) == 0:
                alpha = float(ys.mean() / max(xs.mean(), 1e-9))
                beta = 0.0
            else:
                alpha, beta = (float(v) for v in np.polyfit(xs, ys, 1))
                # congestion can only add cycles; a tiny-sample fit can
                # go degenerate — clamp to the physical regime
                if alpha <= 0:
                    alpha = float(ys.mean() / max(xs.mean(), 1e-9))
                    beta = 0.0
                beta = max(beta, 0.0)
            coeffs[fam] = (alpha, beta)
            npts[fam] = len(xy)
        return cls(mesh=mesh or (meshes.pop() if len(meshes) == 1 else
                                 ",".join(sorted(meshes))),
                   coeffs=coeffs, clock_hz=clock_hz, n_points=npts)

    # -- pricing --------------------------------------------------------
    def family_for(self, op: str) -> str:
        fam = OP_FAMILY.get(op, "allreduce")
        while fam not in self.coeffs:
            nxt = _FAMILY_FALLBACK.get(fam)
            if nxt is None or nxt == fam or nxt in (None,):
                fam = next(iter(self.coeffs))
                break
            if nxt not in self.coeffs and \
                    _FAMILY_FALLBACK.get(nxt) == fam:
                fam = next(iter(self.coeffs))
                break
            fam = nxt
        return fam

    def op_cycles(self, op: str, wire_bytes: float,
                  count: float = 1.0) -> float:
        """Simulated cycles to move ``wire_bytes`` per device for ``op``
        (``count`` invocations pay the fitted fixed overhead each)."""
        alpha, beta = self.coeffs[self.family_for(op)]
        return alpha * (wire_bytes / WORD_BYTES) + beta * max(count, 0.0)

    def op_seconds(self, op: str, wire_bytes: float,
                   count: float = 1.0) -> float:
        return self.op_cycles(op, wire_bytes, count) / self.clock_hz

    def collective_times(self, colls: Dict[str, Dict[str, float]]
                         ) -> Dict[str, Dict[str, float]]:
        """Price a parsed-collectives dict (the
        :func:`repro.launch.roofline.parse_collectives` schema — per-op
        ``wire_bytes`` and ``count``); returns per-op ``{'sim_cycles',
        'sim_s', 'family'}``."""
        out: Dict[str, Dict[str, float]] = {}
        for op, d in colls.items():
            wb = float(d.get("wire_bytes", d.get("bytes", 0.0)))
            n = float(d.get("count", 1))
            cyc = self.op_cycles(op, wb, n)
            out[op] = {"sim_cycles": cyc, "sim_s": cyc / self.clock_hz,
                       "family": self.family_for(op)}
        return out

    # -- persistence ----------------------------------------------------
    def to_json(self) -> dict:
        return {"mesh": self.mesh, "clock_hz": self.clock_hz,
                "coeffs": {k: list(v) for k, v in self.coeffs.items()},
                "n_points": dict(self.n_points)}

    @classmethod
    def from_json(cls, d: dict) -> "CongestionModel":
        return cls(mesh=d["mesh"], clock_hz=float(d["clock_hz"]),
                   coeffs={k: (float(a), float(b))
                           for k, (a, b) in d["coeffs"].items()},
                   n_points={k: int(v)
                             for k, v in d.get("n_points", {}).items()})


def calibrate(nx: int, ny: int, *, backend: str = "torch",
              payload_words: Sequence[int] = (32, 96),
              tokens_per_tile: Sequence[int] = (2, 6),
              clock_hz: float = 1e9, seed: int = 0,
              cfg=None, device=None) -> CongestionModel:
    """Run the calibration battery on an ``nx x ny`` mesh and fit.

    Two payload sizes per family (all-reduce, broadcast, MoE all-to-all,
    pipeline) — enough for the affine fit — on the requested backend
    (:func:`~repro_torch.workloads.runner.run_workload`'s: the card unless
    ``device="cpu"``, or the numpy oracle).  Returns the fitted
    :class:`CongestionModel` (its reports are not kept; use
    :meth:`CongestionModel.fit` directly to keep them).
    """
    from .collectives import parameter_broadcast, ring_all_reduce
    from .moe import moe_all_to_all
    from .pipeline import pipeline_p2p
    from .runner import run_workload

    reports = []
    for w in payload_words:
        reports.append(run_workload(
            ring_all_reduce(nx, ny, int(w)), cfg, backend=backend,
            device=device))
        reports.append(run_workload(
            parameter_broadcast(nx, ny, int(w)), cfg, backend=backend,
            device=device))
        reports.append(run_workload(
            pipeline_p2p(nx, ny, n_micro=4,
                         act_words=max(int(w) // 4, 1)),
            cfg, backend=backend, device=device))
    for t in tokens_per_tile:
        reports.append(run_workload(
            moe_all_to_all(nx, ny, int(t), seed=seed), cfg,
            backend=backend, device=device))
    return CongestionModel.fit(reports, mesh=f"{nx}x{ny}",
                               clock_hz=clock_hz)
