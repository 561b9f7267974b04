"""The batched, block-streamed execution engine behind the sim service.

The port of ``repro/sim_service/streaming.py``.  A :class:`BatchRunner`
owns one formed batch: its programs, stacked and copied to the device
once when the batch forms, and one
:class:`~repro_torch.netsim.measure.FenceStream` over the batch's lanes
(the block loop that ``stream_phased_stats`` runs on one lane).  Each ``advance()`` is ONE
:func:`repro_torch.netsim.sim.simulate` over every lane — on a card one
router kernel call per fence block (``cycles_per_call=None``) —
followed by ONE device-to-host copy, from which it emits one
:class:`~repro_torch.netsim.measure.StreamChunk` per real lane.
``finalize()`` reduces the ``n`` real lanes, so every
:class:`PhaseStats` field equals a direct
:func:`~repro_torch.netsim.measure.phased_stats` run of the lane alone.

Shape accounting mirrors the reference's executed-shape registry, but
counts *shapes*, not builds: the port compiles nothing per shape (the
router library is built once for every shape).  ``sim_compiles`` counts
the fence-block shapes (key, cycles, width, program length) and
``aux_compiles`` the state-init (key, width) and reduce (tiles, measure
window, lanes) shapes that are new to this process, so a *second*
service instance in the same process reports 0, as in the reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.kernels.backend import resolve_device
from repro_torch.netsim.measure import (FenceStream, PhaseStats, StreamChunk,
                                        phase_schedule)
from repro_torch.netsim.sim import Program, init_state

from .bucketing import BucketKey, stack_lanes
from .request import LaneSpec

__all__ = ["BatchRunner", "clear_service_cache", "executed_shapes"]

# shapes (block/init/reduce) this process has already run
_EXECUTED: set = set()


def _note(shape_id) -> bool:
    """Record a shape; True when it is new to this process."""
    fresh = shape_id not in _EXECUTED
    _EXECUTED.add(shape_id)
    return fresh


def executed_shapes() -> int:
    """How many distinct shapes this process has run."""
    return len(_EXECUTED)


def clear_service_cache() -> None:
    """Forget every shape the service has run — the cold-start reset the
    benchmarks use (the built router library stays loaded)."""
    _EXECUTED.clear()


class BatchRunner:
    """One in-flight batch of a bucket: advance one fence block per call,
    stream per-lane chunk deltas, reduce to per-lane PhaseStats at the
    end.  ``width`` is the padded (pow2) lane count actually simulated;
    ``lanes`` the real requests (padding replicates lane 0, runs, and is
    never read).  Runs on the card unless ``device="cpu"``."""

    def __init__(self, bkey: BucketKey, lanes: Sequence[LaneSpec],
                 width: int, device=None):
        self.bkey = bkey
        self.lanes = list(lanes)
        self.width = width
        self.device = resolve_device(device)
        key = bkey.key
        self.schedule = phase_schedule(key.warmup, key.measure, key.drain,
                                       bkey.check_every)
        self.sim_compiles = 0
        self.aux_compiles = 0
        progs, depths, credits = stack_lanes(lanes, bkey.prog_len, width)
        self.progs = Program(progs.buf.to(self.device),
                             progs.length.to(self.device))
        self.aux_compiles += _note(("init", key, width))
        st = init_state(key.cfg, depths, credits, lanes=width,
                        device=self.device)
        self._run = FenceStream(key, self.schedule, self.progs, st,
                                lanes=len(self.lanes))

    @property
    def states(self):
        """The batch's simulator state, every lane (padding included)."""
        return self._run.state

    @property
    def done(self) -> bool:
        return self._run.done

    def advance(self) -> List[Tuple[int, StreamChunk]]:
        """Run the next fence block (ONE batched call for the whole
        batch); returns ``(lane_index, chunk)`` telemetry deltas."""
        cycles = self.schedule[self._run.idx][1]
        self.sim_compiles += _note(
            ("block", self.bkey.key, cycles, self.width, self.bkey.prog_len))
        return list(enumerate(self._run.advance()))

    def finalize(self) -> List[PhaseStats]:
        """Per-lane PhaseStats of the real lanes (numpy leaves), equal to
        direct phased_stats runs."""
        cfg, n = self.bkey.key.cfg, len(self.lanes)
        self.aux_compiles += _note(
            ("reduce", cfg.nx * cfg.ny, self.bkey.key.measure, n))
        host = PhaseStats(*(f.cpu().numpy() for f in self._run.finalize()))
        return [PhaseStats(*(f[i] for f in host)) for i in range(n)]
