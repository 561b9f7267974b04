"""Phased load–latency measurement, batched over the lane axis.

The port of ``repro/netsim_jax/measure.py`` (Dally & Towles §23.1):

1. **warmup** — run the network to steady state; nothing is recorded;
2. **measurement window** — every packet *injected* during the window is
   tagged (the ``SimState.measure_start/stop`` gate on the packet's
   injection-cycle tag) and its round-trip latency lands in the
   histogram; accepted throughput and channel utilization are the deltas
   of the ``completed`` / ``link_util`` counters across the window;
3. **drain** — a fixed budget of further cycles (still injecting) so the
   tagged packets can be delivered; past saturation some may still be in
   flight when it expires, which ``delivered < offered`` exposes.

Every function takes and returns a leading lane axis: where the reference
``vmap``\\ s :func:`phased_stats` over offered loads, the port runs the
loads as lanes of one state, and on a card every cycle of every lane is
one pass of the router kernel.  :class:`FenceStream` runs lanes fence
block by fence block with one read to the host a block;
:func:`stream_phased_stats` drives it on one lane, yielding each block's
telemetry delta.  The
saturation point is the first offered load whose mean latency reaches
``3x`` the zero-load latency (the latency at the lowest swept rate).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.netsim import LAT_BINS
from repro_torch.kernels.backend import resolve_device
from repro_torch.mesh.config import MeshConfig
from repro_torch.mesh.traffic import make_traffic
from repro_torch.netsim.sim import (FWD, Program, SimConfig, SimState,
                                    init_state, load_program, simulate,
                                    stack_programs)

__all__ = ["SATURATION_FACTOR", "DEFAULT_SWEEP_RATES", "sweep_config",
           "SweepKey", "PhaseStats", "hist_quantile", "reduce_window_stats",
           "phased_stats", "StreamChunk", "phase_schedule",
           "stream_phased_stats", "FenceStream", "measure_program",
           "stack_rate_programs", "batched_phased_stats", "first_execution",
           "clear_sweep_cache", "CompiledSweep", "compile_sweep",
           "load_latency_sweep", "saturation_point", "curve_is_monotone",
           "curve_record", "ascii_curve"]

# mean latency >= SATURATION_FACTOR * zero-load latency <=> saturated
SATURATION_FACTOR = 3.0

# the canonical saturation-curve rate grid (the reference's, unchanged)
DEFAULT_SWEEP_RATES = (0.02, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35,
                       0.4, 0.45, 0.5, 0.55)

F32 = torch.float32
I32 = torch.int32


def sweep_config(nx: int, ny: int, topology=None) -> MeshConfig:
    """Mesh configuration for saturation sweeps: buffering deep enough
    that flow control, not storage, is the limit."""
    return MeshConfig(nx=nx, ny=ny, max_out_credits=128, router_fifo=16,
                      topology=topology)


def _as_simconfig(cfg) -> SimConfig:
    if isinstance(cfg, SimConfig):
        return cfg
    return MeshConfig.coerce(cfg).to_sim()


@dataclasses.dataclass(frozen=True)
class SweepKey:
    """Everything that fixes a batched phased run besides its programs:
    the simulator config, the phase lengths and the cycles per kernel
    call (``None``: one call per phase).  ``cfg`` accepts a MeshConfig or
    SimConfig."""
    cfg: SimConfig
    warmup: int
    measure: int
    drain: int
    cycles_per_call: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.cfg, SimConfig):
            object.__setattr__(self, "cfg", _as_simconfig(self.cfg))
        for name in ("warmup", "measure", "drain"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0 or (name == "measure" and v == 0):
                raise ValueError(
                    f"SweepKey.{name} must be a nonnegative int (measure "
                    f"positive), got {v!r}")
        if self.cycles_per_call is not None and self.cycles_per_call < 1:
            raise ValueError(f"cycles_per_call must be >= 1 or None, got "
                             f"{self.cycles_per_call}")

    @property
    def horizon(self) -> int:
        """Total simulated cycles per point (warmup + measure + drain)."""
        return self.warmup + self.measure + self.drain


class PhaseStats(NamedTuple):
    """Measurement-window statistics, one value per lane ((B,) float32
    tensors; ``hist`` is (B, LAT_BINS) int32).  Rates are per tile per
    cycle; latencies are cycles (injection -> registered response)."""
    offered: torch.Tensor
    accepted: torch.Tensor
    delivered: torch.Tensor
    lat_mean: torch.Tensor
    lat_p50: torch.Tensor
    lat_p95: torch.Tensor
    lat_p99: torch.Tensor
    lat_max: torch.Tensor
    peak_link_util: torch.Tensor  # busiest mesh channel (W/E/N/S), fwd network
    hops: torch.Tensor            # link crossings (both networks, W/E/N/S)
    hist: torch.Tensor


def hist_quantile(hist: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile (in bins == cycles) of each lane's counts histogram
    ``hist`` (..., LAT_BINS): smallest bin b with cdf(b) >= ceil(q *
    total), in float32 like the reference; 0 when the histogram is empty."""
    total = hist.sum(-1).to(hist.dtype)
    cdf = hist.cumsum(-1).to(hist.dtype)
    target = torch.ceil(torch.tensor(q, dtype=F32) * total.to(F32)) \
        .to(hist.dtype)
    idx = torch.searchsorted(cdf, target.clamp(min=1)[..., None])[..., 0]
    return torch.where(total > 0, idx.clamp(max=LAT_BINS - 1), 0).to(F32)


def reduce_window_stats(ntiles: int, measure: int, hist: torch.Tensor,
                        d_inj: torch.Tensor, d_comp: torch.Tensor,
                        d_util: torch.Tensor) -> PhaseStats:
    """Reduce raw measurement-window telemetry into :class:`PhaseStats`:
    ``hist`` (B, LAT_BINS) is the window latency histogram, ``d_inj`` /
    ``d_comp`` (B,) the injected/completed deltas across the window and
    ``d_util`` (B, 2, ny, nx, 5) the ``link_util`` delta (all int32).

    The latency sum behind ``lat_mean`` is taken exactly in int64 and
    rounded once to float32: where the reference's float32 sum is exact
    (below 2**24) the two agree, and where it is not the port's is the
    exact one."""
    B = hist.shape[0]
    total = hist.sum(-1)
    denom = total.clamp(min=1).to(F32)
    # divisors as tensors on the device (filled there, no copy): a CPU
    # scalar divisor would become a product with its reciprocal on a card
    per = torch.full((), float(measure * ntiles), dtype=F32,
                     device=hist.device)
    bins = torch.arange(LAT_BINS, device=hist.device)
    lat_weight = (bins * hist.long()).sum(-1).to(F32)
    return PhaseStats(
        offered=d_inj.to(F32) / per,
        accepted=d_comp.to(F32) / per,
        delivered=total.to(F32) / per,
        lat_mean=lat_weight / denom,
        lat_p50=hist_quantile(hist, 0.50),
        lat_p95=hist_quantile(hist, 0.95),
        lat_p99=hist_quantile(hist, 0.99),
        lat_max=torch.where(hist > 0, bins, 0).max(-1).values.to(F32),
        peak_link_util=d_util[:, FWD, ..., 1:].reshape(B, -1).max(-1).values
        .to(F32) / torch.full((), float(measure), dtype=F32,
                              device=hist.device),
        hops=d_util[..., 1:].reshape(B, -1).sum(-1).to(I32).to(F32),
        hist=hist,
    )


def phased_stats(cfg: SimConfig, prog: Program, state: SimState,
                 warmup: int, measure: int, drain: int,
                 cycles_per_call: Optional[int] = None) -> PhaseStats:
    """Run warmup -> measurement window -> drain on every lane and reduce
    the telemetry into :class:`PhaseStats`.  ``state`` should be fresh; the
    window is cycles [warmup, warmup + measure) of each lane.  On a card
    ``state`` is updated in place, by default in one kernel call per
    phase."""
    ntiles = cfg.nx * cfg.ny
    st = state._replace(measure_start=state.cycle + warmup,
                        measure_stop=state.cycle + (warmup + measure))

    def snapshot(s: SimState):
        return (s.prog_ptr.sum((1, 2)).to(I32), s.completed.sum((1, 2)).to(I32),
                s.link_util.clone())

    st, _ = simulate(cfg, prog, st, warmup, cycles_per_call)
    inj0, comp0, util0 = snapshot(st)
    st, _ = simulate(cfg, prog, st, measure, cycles_per_call)
    inj1, comp1, util1 = snapshot(st)
    st, _ = simulate(cfg, prog, st, drain, cycles_per_call)
    return reduce_window_stats(ntiles, measure, st.lat_hist.clone(),
                               inj1 - inj0, comp1 - comp0, util1 - util0)


# -- per-fence-block streaming -------------------------------------------

class StreamChunk(NamedTuple):
    """Telemetry delta of one fence block of a streamed phased run: every
    count is the *change* during cycles [start, stop), so summing the
    chunks reproduces the run's totals exactly."""
    phase: str          # "warmup" | "measure" | "drain"
    start: int          # first cycle of the block
    stop: int           # one past the last cycle
    injected: int       # program entries issued during the block (all tiles)
    completed: int      # requests completed during the block
    delivered: int      # window-tagged packets delivered during the block
    hist: np.ndarray    # (LAT_BINS,) int32 latency-histogram delta


def phase_schedule(warmup: int, measure: int, drain: int,
                   check_every: int) -> Tuple[Tuple[str, int], ...]:
    """The fence-block schedule of a streamed phased run: ``(phase,
    cycles)`` per block, each phase split into ``check_every``-cycle blocks
    plus one remainder, so phase boundaries land on block boundaries."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    out = []
    for phase, total in (("warmup", warmup), ("measure", measure),
                         ("drain", drain)):
        left = total
        while left > 0:
            c = min(check_every, left)
            out.append((phase, c))
            left -= c
    return tuple(out)


def stream_phased_stats(cfg, prog, *, warmup: int = 200,
                        measure: int = 400, drain: int = 400,
                        check_every: int = 100, fifo_depth=None,
                        max_credits=None,
                        cycles_per_call: Optional[int] = None, device=None):
    """Streaming variant of :func:`phased_stats` for one lane: returns a
    generator yielding one :class:`StreamChunk` per ``check_every``-cycle
    fence block as the phases run, and *returning* the final
    :class:`PhaseStats` (one lane: ``(1,)`` fields, ``hist`` ``(1,
    LAT_BINS)``; read it from ``StopIteration.value`` or with ``yield
    from``), equal to :func:`phased_stats` on the same lane.

    ``prog`` is an injection-program dict or a one-lane :class:`Program`.
    The blocks run through a one-lane :class:`FenceStream`.  Runs on the
    card unless ``device="cpu"``; the arguments are checked, and the
    state made, when it is called, before the first block runs."""
    cfg = _as_simconfig(cfg)
    # validates the phase recipe exactly like the one-shot entry points
    key = SweepKey(cfg, warmup, measure, drain, cycles_per_call)
    schedule = phase_schedule(warmup, measure, drain, check_every)
    device = resolve_device(device)
    if isinstance(prog, dict):
        prog = load_program(prog, device)
    elif prog.buf.shape[0] != 1:
        raise ValueError(f"stream_phased_stats runs one lane; the program "
                         f"has {prog.buf.shape[0]}")
    else:
        prog = Program(prog.buf.to(device), prog.length.to(device))
    st = init_state(cfg, fifo_depth, max_credits, lanes=1, device=device)
    return _one_lane(FenceStream(key, schedule, prog, st))


def _one_lane(run: "FenceStream"):
    while not run.done:
        (chunk,) = run.advance()
        yield chunk
    return run.finalize()


class FenceStream:
    """A phased run over the lanes of ``state``, advanced one fence block
    of ``schedule`` (:func:`phase_schedule`) at a time: the block loop of
    :func:`stream_phased_stats` (one lane) and of the simulation service's
    batches (many).

    ``state`` is fresh; the measure window of ``key`` is set on it here.
    Each :meth:`advance` is ONE :func:`repro_torch.netsim.sim.simulate`
    over every lane, on a card one router kernel call by default,
    followed by ONE device-to-host copy: per read lane the issued and
    completed counts and the latency histogram, from which it returns
    one :class:`StreamChunk` per read lane.  The link counters stay on
    the device, snapshotted there at the phase boundaries.  Only the
    first ``lanes`` lanes (default all) are read and reduced; the rest
    run and are never read.  :meth:`finalize` reduces the read lanes with
    :func:`reduce_window_stats`, each equal to :func:`phased_stats` of the
    lane alone."""

    def __init__(self, key: SweepKey, schedule, prog: Program,
                 state: SimState, lanes: Optional[int] = None):
        self.key = key
        self.schedule = tuple(schedule)
        self.prog = prog
        self.state = state._replace(
            measure_start=state.cycle + key.warmup,
            measure_stop=state.cycle + (key.warmup + key.measure))
        self.lanes = int(state.cycle.shape[0]) if lanes is None else lanes
        self.idx = 0
        self.cycle = 0
        # per lane: issued, completed, then the histogram, as last read
        self._prev = np.zeros((self.lanes, 2 + LAT_BINS), np.int64)
        # phase-boundary snapshots; a zero-length warmup's is the fresh
        # state, exactly like phased_stats' 0-cycle run
        self._ints_w = self._ints_m = self._prev[:, :2]
        self._util_w = self._util_m = \
            self.state.link_util[:self.lanes].clone()

    @property
    def done(self) -> bool:
        return self.idx >= len(self.schedule)

    def _read(self) -> np.ndarray:
        """The read lanes' issued and completed counts and histograms,
        ``(lanes, 2 + LAT_BINS)`` int64, in one copy to the host."""
        n, st = self.lanes, self.state
        return torch.cat([st.prog_ptr[:n].sum((1, 2))[:, None],
                          st.completed[:n].sum((1, 2))[:, None],
                          st.lat_hist[:n].long()], 1).cpu().numpy()

    def advance(self) -> Tuple[StreamChunk, ...]:
        """Run the next fence block; returns each read lane's chunk."""
        assert not self.done
        phase, cycles = self.schedule[self.idx]
        self.state, _ = simulate(self.key.cfg, self.prog, self.state, cycles,
                                 self.key.cycles_per_call)
        now = self._read()
        d = now - self._prev
        out = tuple(StreamChunk(
            phase=phase, start=self.cycle, stop=self.cycle + cycles,
            injected=int(row[0]), completed=int(row[1]),
            delivered=int(row[2:].sum()), hist=row[2:].astype(np.int32))
            for row in d)
        self._prev = now
        self.cycle += cycles
        self.idx += 1
        nxt = self.schedule[self.idx][0] if not self.done else None
        if phase != nxt and phase in ("warmup", "measure"):
            self._ints_m = now[:, :2]
            self._util_m = self.state.link_util[:self.lanes].clone()
            if phase == "warmup":
                self._ints_w, self._util_w = self._ints_m, self._util_m
        return out

    def finalize(self) -> PhaseStats:
        """The read lanes' :class:`PhaseStats`, on the state's device."""
        assert self.done
        cfg, n = self.key.cfg, self.lanes
        d = np.ascontiguousarray((self._ints_m - self._ints_w).T, np.int32)
        d_inj, d_comp = torch.as_tensor(d).to(self.state.cycle.device)
        return reduce_window_stats(cfg.nx * cfg.ny, self.key.measure,
                                   self.state.lat_hist[:n].clone(), d_inj,
                                   d_comp, self._util_m - self._util_w)


def measure_program(cfg, entries: Dict[str, np.ndarray], *,
                    warmup: int = 200, measure: int = 400,
                    drain: int = 400, cycles_per_call: Optional[int] = None,
                    device=None) -> Dict[str, object]:
    """Phased measurement of one injection program; returns plain-python
    stats (``hist`` as a numpy array).  ``cfg`` may be a MeshConfig or
    SimConfig.  Runs on the card unless ``device="cpu"``."""
    cfg = _as_simconfig(cfg)
    prog = load_program(entries, resolve_device(device))
    stats = phased_stats(cfg, prog,
                         init_state(cfg, lanes=1, device=prog.buf.device),
                         warmup, measure, drain, cycles_per_call)
    out: Dict[str, object] = {k: float(v[0]) for k, v in
                              stats._asdict().items() if k != "hist"}
    out["hist"] = stats.hist[0].cpu().numpy()
    return out


def stack_rate_programs(pattern: str, nx: int, ny: int,
                        rates: Sequence[float], horizon: int, *,
                        device=None, **traffic_kw) -> Program:
    """One injection program per offered load, one lane each.  Programs
    are sized so the *fastest* rate never exhausts its entries inside
    ``horizon`` cycles; slower rates schedule their tail past the horizon,
    which keeps every lane the same shape."""
    device = resolve_device(device)
    length = int(np.ceil(max(rates) * horizon)) + 1
    return stack_programs([
        load_program(make_traffic(pattern, nx, ny, length, rate=float(r),
                                  **traffic_kw), device)
        for r in rates])


def batched_phased_stats(key, progs: Program, fifo_depths=None,
                         max_credits=None) -> PhaseStats:
    """Batched phased measurement over the lanes of ``progs`` with
    per-lane FIFO depths and credit allowances (default: the config
    capacities), each lane from a fresh state on the programs' device.
    ``key`` is a :class:`SweepKey` (or a config, wrapped with the default
    200/400/400 phases)."""
    if not isinstance(key, SweepKey):
        key = SweepKey(cfg=key, warmup=200, measure=400, drain=400)
    B = int(progs.length.shape[0])
    st = init_state(key.cfg, fifo_depths, max_credits, lanes=B,
                    device=progs.buf.device)
    return phased_stats(key.cfg, progs, st, key.warmup, key.measure,
                        key.drain, key.cycles_per_call)


# Batched shapes run in this process, each a tuple led by its SweepKey:
# the DSE counts one it has not run before as a compile
# (``SweepResult.compiles``), and :func:`clear_sweep_cache` forgets them.
_EXECUTED_SHAPES: set = set()


def first_execution(shape: tuple) -> bool:
    """Record that a batched run of ``shape`` executes; True the first
    time in this process (or since :func:`clear_sweep_cache`)."""
    fresh = shape not in _EXECUTED_SHAPES
    _EXECUTED_SHAPES.add(shape)
    return fresh


def clear_sweep_cache() -> None:
    """Forget every batched shape recorded by :func:`first_execution`, the
    per-key state the port keeps (the built router library is one for
    every key and stays loaded)."""
    _EXECUTED_SHAPES.clear()


class CompiledSweep(NamedTuple):
    """A sweep ready to run: the :class:`SweepKey` it was prepared for and
    the device whose router library is loaded.  The key is checked by
    :func:`load_latency_sweep`: shapes alone cannot tell a permutation of
    the phase lengths with the same horizon."""
    key: SweepKey
    device: torch.device

    def __call__(self, progs: Program) -> PhaseStats:
        if progs.buf.device != self.device:
            raise ValueError(f"the sweep was prepared for {self.device}, "
                             f"the programs are on {progs.buf.device}")
        return batched_phased_stats(self.key, progs)


def compile_sweep(cfg, progs: Program, *, warmup: int = 200,
                  measure: int = 400, drain: int = 400,
                  cycles_per_call: Optional[int] = None):
    """Prepare the batched sweep for ``progs``: on a card, build (at first
    use) and load the router kernel's library, the port's only compiled
    artefact; on the CPU there is nothing to build.  Returns
    ``(CompiledSweep, seconds)`` so a caller can report preparation and
    run time apart."""
    import time
    key = SweepKey(_as_simconfig(cfg), warmup, measure, drain,
                   cycles_per_call)
    device = progs.buf.device
    t0 = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels.router_step import _library
        _library()
    return CompiledSweep(key, device), time.perf_counter() - t0


def load_latency_sweep(pattern: str, nx: int, ny: int,
                       rates: Sequence[float], *,
                       warmup: int = 200, measure: int = 400,
                       drain: int = 400, cfg=None,
                       cycles_per_call: Optional[int] = None,
                       compiled: Optional[CompiledSweep] = None,
                       device=None, **traffic_kw) -> Dict[str, object]:
    """Full load–latency saturation curve for one traffic pattern: every
    offered load is one lane of a single batched phased run.  Returns
    numpy arrays keyed like :class:`PhaseStats` plus the rate grid,
    zero-load latency and the located saturation point.  ``compiled`` is
    a :func:`compile_sweep` result for the same key (a different key
    raises).  Runs on the card unless ``device="cpu"``."""
    rates = sorted(float(r) for r in rates)
    cfg = SimConfig(nx=nx, ny=ny) if cfg is None else _as_simconfig(cfg)
    # topology-aware patterns (tornado) must see the topology the sim
    # runs on; an explicit traffic_kw["topology"] still wins
    traffic_kw.setdefault("topology", cfg.topology)
    key = SweepKey(cfg, warmup, measure, drain, cycles_per_call)
    if compiled is not None and compiled.key != key:
        raise ValueError(
            f"compiled sweep was prepared for {compiled.key}, but "
            f"load_latency_sweep was called with {key}; matching shapes "
            "would run silently with the wrong measurement windows")
    progs = stack_rate_programs(pattern, nx, ny, rates, key.horizon,
                                device=device, **traffic_kw)
    stats = batched_phased_stats(key, progs) if compiled is None \
        else compiled(progs)
    out: Dict[str, object] = {k: v.cpu().numpy()
                              for k, v in stats._asdict().items()}
    out["rates"] = np.asarray(rates)
    out["pattern"] = pattern
    out["mesh"] = f"{nx}x{ny}"
    out["topology"] = cfg.topology.kind
    out["zero_load_latency"] = float(out["lat_mean"][0])
    sat = saturation_point(out["lat_mean"])
    out["saturation_index"] = sat
    out["monotone"] = curve_is_monotone(out["lat_mean"])
    out["saturation_rate"] = None if sat is None else float(rates[sat])
    # saturation (peak accepted) throughput, per tile per cycle
    out["saturation_throughput"] = float(np.max(out["accepted"]))
    return out


def ascii_curve(rates, lat, sat_idx, width: int = 50) -> str:
    """ASCII load–latency figure: one bar per offered load, bar length ~
    log latency, saturation knee marked."""
    lat = np.asarray(lat, float)
    # a rate whose window delivered nothing measures lat 0; clamp the bar
    # scale so the log stays finite instead of aborting the whole figure
    clamped = np.maximum(lat, 1.0)
    scale = width / max(np.log10(clamped.max() / clamped.min()), 1e-9)
    rows = []
    for i, (r, l, lc) in enumerate(zip(rates, lat, clamped)):
        bar = "#" * max(int(np.log10(lc / clamped.min()) * scale), 1)
        mark = "  <- saturation" if i == sat_idx else ""
        rows.append(f"    {r:5.2f} | {bar:<{width}s} {l:8.1f}{mark}")
    return "\n".join(rows)


def saturation_point(lat_mean: np.ndarray,
                     factor: float = SATURATION_FACTOR) -> Optional[int]:
    """Index of the first offered load whose mean latency is >= ``factor``
    times the zero-load latency (``lat_mean[0]``), or None if the sweep
    never saturates."""
    lat = np.asarray(lat_mean, float)
    hits = np.nonzero(lat >= factor * lat[0])[0]
    return int(hits[0]) if hits.size else None


def curve_is_monotone(lat_mean: np.ndarray, rel_tol: float = 0.02,
                      factor: float = SATURATION_FACTOR) -> bool:
    """Is a load–latency curve well formed?  Latency must be monotone
    nondecreasing (within ``rel_tol``) up to and including the saturation
    point, and must *stay* saturated (>= ``factor`` x zero-load) after."""
    lat = np.asarray(lat_mean, float)
    sat = saturation_point(lat, factor)
    knee = len(lat) - 1 if sat is None else sat
    pre = lat[:knee + 1]
    if not np.all(pre[1:] >= pre[:-1] * (1.0 - rel_tol)):
        return False
    return bool(np.all(lat[knee:] >= factor * lat[0] * (1.0 - rel_tol))) \
        if sat is not None else True


def curve_record(out: Dict[str, object]) -> Dict[str, object]:
    """JSON-ready record of a :func:`load_latency_sweep` result (the
    reference's schema)."""
    return {
        "rates": [round(float(r), 3) for r in out["rates"]],
        "offered": np.round(out["offered"], 3).tolist(),
        "accepted": np.round(out["accepted"], 3).tolist(),
        "delivered": np.round(out["delivered"], 3).tolist(),
        "lat_mean": np.round(out["lat_mean"], 2).tolist(),
        "lat_p50": np.round(out["lat_p50"], 1).tolist(),
        "lat_p95": np.round(out["lat_p95"], 1).tolist(),
        "lat_p99": np.round(out["lat_p99"], 1).tolist(),
        "lat_max": np.round(out["lat_max"], 1).tolist(),
        "peak_link_util": np.round(out["peak_link_util"], 3).tolist(),
        "hops": np.asarray(out["hops"]).astype(int).tolist(),
        "zero_load_latency": round(float(out["zero_load_latency"]), 2),
        "saturation_index": out["saturation_index"],
        "saturation_rate": out["saturation_rate"],
        "saturation_throughput": round(float(out["saturation_throughput"]),
                                       3),
        "monotone": bool(out["monotone"]),
    }
