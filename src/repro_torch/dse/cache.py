"""Resumable on-disk result cache for design-space sweeps.

The port of ``repro/dse/cache.py``.  A sweep is re-submitted constantly —
widened axes, re-costed frontiers, crashed runs resumed — and
re-simulating already-known points would dwarf the new work.  The cache
stores one small JSON record per simulated point, keyed by

* the **point key** (:meth:`repro_torch.dse.SweepSpec.point_key` — the
  point's effective mesh configuration plus the measurement recipe), and
* the **code hash** (:func:`config_hash`) — a digest of the port's sources
  that determine simulated results: the simulator and its drivers, the
  measurement, routing/topology, traffic generation, packet encoding,
  the router kernel's wrapper and CUDA source (on a card the kernel
  decides the results) and the builders of the workload points'
  programs.  Editing any of them moves the cache to a fresh
  directory, so stale results never leak into a frontier.  The digest
  covers the port's files only, so a port cache and a cache of the JAX
  package never share a directory.

Records hold raw telemetry only.  Costs (area/energy) are applied at
frontier-extraction time, so re-pricing a sweep under a different
:class:`~repro_torch.dse.cost.CostModel` is free.
"""
from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["config_hash", "ResultCache"]

_PACKAGE = Path(__file__).resolve().parents[1]

# the sources whose content determines simulated results, relative to the
# package: the simulator and its constants, the measurement, the mesh
# configuration, routing, traffic and encoding, the router kernel, and the
# builders of the workload points' programs (the workload library and
# ``dse/spec.py::workload_entries``; a point key names only the family and
# the seed).  cost/pareto are applied after simulation and deliberately do
# NOT invalidate cached telemetry
HASHED_SOURCES = (
    "core/netsim.py",
    "netsim/sim.py",
    "netsim/measure.py",
    "mesh/config.py",
    "mesh/topology.py",
    "mesh/traffic.py",
    "mesh/encoding.py",
    "kernels/router_step.py",
    "kernels/csrc/router_step.cu",
    "workloads/placement.py",
    "workloads/base.py",
    "workloads/collectives.py",
    "workloads/pipeline.py",
    "workloads/moe.py",
    "workloads/pgas.py",
    "dse/spec.py",
)


def source_digest(root: Path, names: Sequence[str]) -> str:
    """Digest of the files ``names`` under ``root`` (names and bytes)."""
    h = hashlib.sha256()
    for name in names:
        h.update(name.encode())
        h.update((root / name).read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def config_hash() -> str:
    """Digest of the port's result-determining sources."""
    return source_digest(_PACKAGE, HASHED_SOURCES)


class ResultCache:
    """One JSON file per point under ``root/<config_hash>/``.

    ``root=None`` disables caching (every ``get`` misses, ``put`` is a
    no-op) so callers can thread one code path either way.  Filenames
    are a digest of the point key; the key itself is stored inside the
    record and verified on read, so a (vanishingly unlikely) digest
    collision degrades to a miss, never to a wrong result.
    """

    def __init__(self, root: Optional[Path]):
        self.root = None if root is None else Path(root)
        self.dir = None if self.root is None else self.root / config_hash()

    @staticmethod
    def _filename(key: str) -> str:
        return hashlib.sha256(key.encode()).hexdigest()[:24] + ".json"

    def path_for(self, key: str) -> Optional[Path]:
        return None if self.dir is None else self.dir / self._filename(key)

    def get(self, key: str) -> Optional[Dict]:
        path = self.path_for(key)
        if path is None:
            return None
        try:
            record = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if record.pop("key", None) != key:
            return None
        return record

    def put(self, key: str, record: Dict) -> None:
        path = self.path_for(key)
        if path is None:
            return
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps({**record, "key": key}, default=str))
        tmp.replace(path)  # atomic: concurrent sweeps never read half a file

    def __len__(self) -> int:
        if self.dir is None or not self.dir.is_dir():
            return 0
        return sum(1 for _ in self.dir.glob("*.json"))
