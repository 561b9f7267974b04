"""Service-level accounting: what the server did, and what it cost.

The port of ``repro/sim_service/metrics.py``.  One
:class:`ServiceMetrics` per server instance.  ``sim_compiles`` and
``aux_compiles`` keep the reference's names but count *shapes*, not
builds: the port compiles nothing per shape, so they count the fence
block (``sim_``) and the state-init and stats-reduce (``aux_``) shapes
new to this process, from the registry of
:mod:`repro_torch.sim_service.streaming`.  ``snapshot()`` adds the
router library's build cache (:func:`compilation_cache_stats`), so a run
can show both layers: 0 new shapes on a warm service, and a library
loaded from disk instead of built on a warm *process*.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import ClassVar, Dict, Optional

import torch

from repro_torch.kernels import build

__all__ = ["ServiceMetrics", "compilation_cache_stats"]


def compilation_cache_stats(device: Optional[torch.device] = None,
                            directory=None) -> Dict[str, object]:
    """The router library's build cache in ``directory`` (default
    :func:`repro_torch.kernels.build.build_dir`) as a server on
    ``device`` uses it (:func:`repro_torch.kernels.build.cache_stats`: the
    directory, the
    libraries built there by ``nvcc`` in this process, those loaded from
    it without a build, the entries present).  On the CPU there is nothing
    to build, and the record says so."""
    if device is not None and device.type != "cuda":
        return {"dir": None, "built": 0, "loaded": 0, "entries": 0,
                "note": "the CPU runs the plain PyTorch step; nothing is "
                        "built"}
    return build.cache_stats(directory)


@dataclasses.dataclass
class ServiceMetrics:
    submitted: int = 0        # requests accepted into the queue
    rejected: int = 0         # requests refused by backpressure
    completed: int = 0        # requests finished (response built)
    lanes: int = 0            # batch lanes admitted (sweeps count per rate)
    ticks: int = 0            # scheduler ticks executed
    batches: int = 0          # batch runners formed
    blocks: int = 0           # batched fence-block calls executed
    chunks: int = 0           # telemetry chunks streamed
    sim_compiles: int = 0     # fence-block shapes new to this process
    aux_compiles: int = 0     # init/reduce shapes new to this process
    peak_pending: int = 0     # max lanes waiting in the bounded queue

    # the server's device and build directory (set by the server; not
    # counters): they decide what snapshot() reports of the build cache
    device: ClassVar[Optional[torch.device]] = None
    build_dir: ClassVar[Optional[Path]] = None

    def snapshot(self) -> Dict[str, object]:
        out = dataclasses.asdict(self)
        out["compilation_cache"] = compilation_cache_stats(self.device,
                                                           self.build_dir)
        return out
