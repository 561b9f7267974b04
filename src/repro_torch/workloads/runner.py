"""Run compiled workloads through the mesh and report what happened.

The port of ``repro/workloads/runner.py``: a thin loop over the
:class:`repro_torch.mesh.Simulator` facade — attach the workload's
injection program, run to the global drain fence, and normalize the
telemetry into a :class:`WorkloadReport`, the JSON-ready record that
:class:`repro_torch.workloads.CongestionModel` fits.

Backends: ``"torch"`` (the default: on the card, through the router
kernel, unless ``device="cpu"``), ``"numpy"`` (the port's oracle on the
host) and ``"both"``, which runs the two and asserts an equal drain cycle
and bit-identical telemetry, so a workload report doubles as a
differential test of the card against the oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.mesh import MeshConfig, Simulator, Telemetry

from .base import Workload

__all__ = ["WorkloadReport", "run_workload", "default_workload_config"]

# The torch backend checks the drain fence once per block of this many
# cycles: one kernel call and one host sync a block instead of a cycle.
# The drain cycle is exact for any block (repro_torch.netsim.sim
# .run_until_drained), so this changes speed only.
CHECK_EVERY = 256


def default_workload_config(nx: int, ny: int) -> MeshConfig:
    """Mesh configuration for workload runs: the same deep-buffer setup
    the load–latency sweeps use (flow control, not storage, should be the
    limit), see :func:`repro_torch.netsim.measure.sweep_config`."""
    return MeshConfig(nx=nx, ny=ny, max_out_credits=128, router_fifo=16)


@dataclasses.dataclass(frozen=True)
class WorkloadReport:
    """What one workload did to the mesh (all fields JSON-ready)."""

    name: str
    family: str
    mesh: str
    backend: str                     # "numpy" | "torch" | "both" (parity-checked)
    cycles: int                      # drain cycle of the run
    n_steps: int
    cycles_per_step: float
    injected: int                    # packets injected (== workload size)
    delivered: int                   # responses completed (== injected at drain)
    accepted_throughput: float       # pkts/cycle/tile over the whole run
    mean_latency: float              # mean round-trip cycles
    peak_link_util: float            # busiest fwd mesh channel (W/E/N/S)
    hotspots: List[Tuple[float, int, int, str]]   # (util, x, y, port)
    link_heatmap: List               # (ny, nx, 5) fwd utilization, rounded
    meta: Dict[str, object]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        hot = self.hotspots[0] if self.hotspots else (0.0, -1, -1, "?")
        return (f"{self.name:<28s} {self.mesh:<7s} "
                f"{self.cycles:6d} cyc  {self.cycles_per_step:8.1f} cyc/step  "
                f"acc {self.accepted_throughput:6.3f} pkt/cyc/tile  "
                f"lat {self.mean_latency:6.1f}  "
                f"hot ({hot[1]},{hot[2]}){hot[3]} {hot[0]:.3f}")


def _report(w: Workload, t: Telemetry, backend: str,
            drain_cycle: int) -> WorkloadReport:
    delivered = int(t.completed.sum())
    if delivered != w.n_packets:
        raise AssertionError(
            f"workload {w.name!r} leaked packets: injected {w.n_packets} "
            f"!= delivered {delivered} after the drain fence")
    ntiles = w.nx * w.ny
    # peak over the actual mesh channels (ports W/E/N/S; P is ejection)
    hm = t.link_heatmap("fwd")
    return WorkloadReport(
        name=w.name, family=w.family, mesh=w.mesh, backend=backend,
        cycles=int(drain_cycle), n_steps=w.n_steps,
        cycles_per_step=round(drain_cycle / w.n_steps, 2),
        injected=w.n_packets, delivered=delivered,
        accepted_throughput=round(delivered / max(drain_cycle, 1) / ntiles,
                                  4),
        mean_latency=round(t.mean_latency(), 2),
        peak_link_util=round(float(hm[..., 1:].max()), 4),
        hotspots=[(round(u, 4), x, y, p)
                  for (u, x, y, p) in t.hotspots("fwd", top=5)],
        link_heatmap=np.round(hm, 4).tolist(),
        meta=dict(w.meta))


def _drain(w: Workload, cfg: MeshConfig, backend: str, max_cycles: int,
           device) -> Tuple[int, Telemetry]:
    """Run ``w`` to its drain fence on one backend; returns the drain
    cycle and the telemetry at it."""
    if backend == "numpy":
        sim = Simulator(cfg, backend="numpy", device=device)
    else:
        sim = Simulator(cfg, backend="torch", check_every=CHECK_EVERY,
                        device=device)
    sim.attach({k: v.copy() for k, v in w.program.items()})
    n = sim.run_until_drained(max_cycles)
    # A drained network is quiescent: the up to CHECK_EVERY - 1 cycles the
    # torch backend steps past its fence change the cycle count alone.
    return n, dataclasses.replace(sim.telemetry(), cycles=n)


def run_workload(w: Workload, cfg: Optional[MeshConfig] = None, *,
                 backend: str = "torch", max_cycles: int = 200_000,
                 device=None) -> WorkloadReport:
    """Attach ``w`` to a fresh mesh, run to the drain fence, and report.

    ``backend="both"`` runs numpy and torch and asserts bit-identical
    telemetry (and equal drain cycles) before reporting.  ``device`` is
    the torch backend's: the card unless ``"cpu"``.
    """
    cfg = default_workload_config(w.nx, w.ny) if cfg is None \
        else MeshConfig.coerce(cfg)
    if (cfg.nx, cfg.ny) != (w.nx, w.ny):
        raise ValueError(
            f"workload {w.name!r} was compiled for a {w.mesh} mesh but the "
            f"config describes {cfg.nx}x{cfg.ny}")
    if backend not in ("numpy", "torch", "both"):
        raise ValueError(f"unknown backend {backend!r}; known: 'numpy', "
                         "'torch', 'both'")
    if backend != "both":
        n, t = _drain(w, cfg, backend, max_cycles, device)
        return _report(w, t, backend, n)
    ca, ta = _drain(w, cfg, "numpy", max_cycles, None)
    cb, tb = _drain(w, cfg, "torch", max_cycles, device)
    if ca != cb:
        raise AssertionError(f"workload {w.name!r}: drain cycle diverged "
                             f"between backends: numpy {ca} != torch {cb}")
    ta.assert_bit_identical(tb)
    return _report(w, ta, "both", ca)
