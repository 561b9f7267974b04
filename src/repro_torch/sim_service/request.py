"""Request/response schema of the simulation service.

The port of ``repro/sim_service/request.py``.  A request is either one
phased measurement (:class:`SimRequest` — a mesh configuration plus a
traffic pattern/load or an explicit injection program) or a full
saturation curve (:class:`SweepRequest` — the service-side equivalent of
:func:`repro_torch.netsim.measure.load_latency_sweep`, one *lane* per
offered load).  Both normalize to the same lane vocabulary the server
batches on: a :class:`~repro_torch.netsim.measure.SweepKey` (the batched
shape's identity), a ``check_every`` streaming cadence, and per-lane
(program, fifo_depth, max_credits) triples whose depth/credit knobs are
per-lane values of one batched state — so one batch serves every buffer
sizing of a shape, as in :mod:`repro_torch.dse.spec`.

The port's :class:`SweepKey` has no ``unroll`` and no ``impl``, so the
requests drop both.  ``cycles_per_call`` defaults to ``None``: one router
kernel call per fence block (a value of ``C`` splits each block into
calls of ``C`` cycles; the results do not depend on it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.mesh.config import MeshConfig
from repro_torch.mesh.traffic import make_traffic
from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES, PhaseStats,
                                        SweepKey, curve_is_monotone,
                                        saturation_point)
from repro_torch.netsim.sim import Program, load_program

__all__ = ["ServiceOverloaded", "LaneSpec", "SimRequest", "SweepRequest",
           "SimResponse", "SweepResponse"]


class ServiceOverloaded(RuntimeError):
    """The server's bounded queue is full; resubmit after ticks drain it
    (the backpressure contract — requests are never silently dropped)."""


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """One batch lane: an injection program plus the per-lane buffer knobs
    it simulates under.  ``program`` is a one-lane :class:`Program` packed
    on the host (CPU tensors) when the request is submitted; it moves to
    the server's device with its batch, once.  ``label`` names the lane in
    streamed telemetry (the offered load for sweep lanes)."""
    program: Program
    fifo_depth: int
    max_credits: int
    label: str = ""


def _program_length(load: float, horizon: int) -> int:
    """Entries needed so ``load`` never exhausts its program inside the
    horizon (same sizing as ``stack_rate_programs``)."""
    return int(np.ceil(load * horizon)) + 1


@dataclasses.dataclass(frozen=True)
class _RequestBase:
    cfg: MeshConfig
    pattern: str = "uniform"
    seed: int = 0
    warmup: int = 200
    measure: int = 400
    drain: int = 400
    check_every: int = 100
    fifo_depth: Optional[int] = None
    max_credits: Optional[int] = None
    cycles_per_call: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "cfg", MeshConfig.coerce(self.cfg))
        if self.check_every < 1:
            raise ValueError(
                f"check_every must be >= 1, got {self.check_every}")
        for knob, cap in (("fifo_depth", self.cfg.router_fifo),
                          ("max_credits", self.cfg.max_out_credits)):
            v = getattr(self, knob)
            if v is not None and not 1 <= v <= cap:
                raise ValueError(
                    f"{knob}={v} outside [1, {cap}] (the static config "
                    f"capacity it must ride under)")

    @property
    def horizon(self) -> int:
        return self.warmup + self.measure + self.drain

    def sweep_key(self) -> SweepKey:
        """The batched-shape identity this request buckets under."""
        return SweepKey(cfg=self.cfg.to_sim(), warmup=self.warmup,
                        measure=self.measure, drain=self.drain,
                        cycles_per_call=self.cycles_per_call)

    def _knobs(self) -> Tuple[int, int]:
        d = self.cfg.router_fifo if self.fifo_depth is None \
            else self.fifo_depth
        c = self.cfg.max_out_credits if self.max_credits is None \
            else self.max_credits
        return int(d), int(c)

    def _pattern_program(self, load: float, length: int) -> Program:
        return load_program(make_traffic(
            self.pattern, self.cfg.nx, self.cfg.ny, length, rate=load,
            seed=self.seed, topology=self.cfg.topology), "cpu")


@dataclasses.dataclass(frozen=True)
class SimRequest(_RequestBase):
    """One phased measurement: ``cfg`` + ``pattern``/``load`` (or an
    explicit injection-program ``entries`` mapping, same schema as
    ``Simulator.attach``).  ``fifo_depth`` / ``max_credits`` pick the
    *effective* buffer sizing (<= the config capacities) — per-lane
    values, so they never change the batch's shape."""
    load: float = 0.1
    entries: Optional[Mapping[str, np.ndarray]] = None

    def lanes(self) -> List[LaneSpec]:
        d, c = self._knobs()
        if self.entries is not None:
            prog = load_program(dict(self.entries), "cpu")
        else:
            prog = self._pattern_program(
                self.load, _program_length(self.load, self.horizon))
        return [LaneSpec(prog, d, c, label=f"{self.pattern}@{self.load:g}")]

    def build_response(self, rid: int, stats: List[PhaseStats],
                       metrics: Dict) -> "SimResponse":
        assert len(stats) == 1
        return SimResponse(rid=rid, stats=stats[0], metrics=metrics)


@dataclasses.dataclass(frozen=True)
class SweepRequest(_RequestBase):
    """A full load–latency saturation curve: one lane per offered rate,
    every lane's program sized for the *fastest* rate (so the whole
    sweep shares one bucket — the ``stack_rate_programs`` trick)."""
    rates: Tuple[float, ...] = DEFAULT_SWEEP_RATES

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "rates",
                           tuple(sorted({float(r) for r in self.rates})))
        if not self.rates or min(self.rates) <= 0 or max(self.rates) > 1:
            raise ValueError(
                f"sweep rates must be in (0, 1], got {self.rates}")

    def lanes(self) -> List[LaneSpec]:
        d, c = self._knobs()
        length = _program_length(max(self.rates), self.horizon)
        return [LaneSpec(self._pattern_program(r, length), d, c,
                         label=f"{self.pattern}@{r:g}")
                for r in self.rates]

    def build_response(self, rid: int, stats: List[PhaseStats],
                       metrics: Dict) -> "SweepResponse":
        lat = np.asarray([float(s.lat_mean) for s in stats])
        sat = saturation_point(lat)
        curve = {k: [float(getattr(s, k)) for s in stats]
                 for k in PhaseStats._fields if k != "hist"}
        curve.update(
            rates=list(self.rates), pattern=self.pattern,
            mesh=f"{self.cfg.nx}x{self.cfg.ny}",
            zero_load_latency=float(lat[0]),
            saturation_index=sat,
            saturation_rate=None if sat is None else float(self.rates[sat]),
            saturation_throughput=float(max(curve["accepted"])),
            monotone=bool(curve_is_monotone(lat)))
        return SweepResponse(rid=rid, rates=self.rates, stats=stats,
                             curve=curve, metrics=metrics)


@dataclasses.dataclass
class SimResponse:
    """One measurement result: the :class:`PhaseStats` (numpy leaves: the
    float32 scalars and the ``(LAT_BINS,)`` int32 histogram, equal to a
    direct :func:`phased_stats` run of the request alone) plus
    per-request service metrics (queue wait, service/total wall seconds,
    bucket id, batch width, new shape counts)."""
    rid: int
    stats: PhaseStats
    metrics: Dict[str, object]


@dataclasses.dataclass
class SweepResponse:
    """One saturation curve: per-rate :class:`PhaseStats` plus the
    ``load_latency_sweep``-shaped ``curve`` record and service metrics."""
    rid: int
    rates: Tuple[float, ...]
    stats: List[PhaseStats]
    curve: Dict[str, object]
    metrics: Dict[str, object]
