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
one pass of the router kernel.  :func:`stream_phased_stats` runs one lane
fence block by fence block, yielding each block's telemetry delta.  The
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
           "stream_phased_stats", "measure_program", "stack_rate_programs",
           "batched_phased_stats", "first_execution", "clear_sweep_cache",
           "CompiledSweep", "compile_sweep", "load_latency_sweep",
           "saturation_point", "curve_is_monotone", "curve_record",
           "ascii_curve"]

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
    Each block is one :func:`repro_torch.netsim.sim.simulate` run followed
    by one read to the host (the issued and completed counts and the
    histogram); the link counters stay on the device.  Runs on the card
    unless ``device="cpu"``; the arguments are checked, and the state
    made, when it is called, before the first block runs."""
    cfg = _as_simconfig(cfg)
    # validates the phase recipe exactly like the one-shot entry points
    SweepKey(cfg, warmup, measure, drain, cycles_per_call)
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
    st = st._replace(measure_start=st.cycle + warmup,
                     measure_stop=st.cycle + (warmup + measure))
    return _stream(cfg, prog, st, measure, schedule, cycles_per_call)


def _stream(cfg: SimConfig, prog: Program, st: SimState, measure: int,
            schedule, cycles_per_call: Optional[int]):
    """The block loop of :func:`stream_phased_stats`."""
    # phase-boundary snapshots; a zero-length warmup's is the fresh state
    prev = np.zeros(2 + LAT_BINS, np.int64)      # issued, completed, hist
    ints_w = ints_m = prev[:2]
    util_w = util_m = st.link_util.clone()
    cycle = 0
    for i, (phase, cycles) in enumerate(schedule):
        st, _ = simulate(cfg, prog, st, cycles, cycles_per_call)
        now = torch.cat([st.prog_ptr.sum().view(1), st.completed.sum().view(1),
                         st.lat_hist[0].long()]).cpu().numpy()
        d = now - prev
        yield StreamChunk(phase=phase, start=cycle, stop=cycle + cycles,
                          injected=int(d[0]), completed=int(d[1]),
                          delivered=int(d[2:].sum()),
                          hist=d[2:].astype(np.int32))
        prev = now
        cycle += cycles
        last_of_phase = i + 1 == len(schedule) or schedule[i + 1][0] != phase
        if last_of_phase and phase == "warmup":
            ints_w = ints_m = now[:2]
            util_w = util_m = st.link_util.clone()
        elif last_of_phase and phase == "measure":
            ints_m = now[:2]
            util_m = st.link_util.clone()
    d_inj, d_comp = (torch.tensor([int(v)], dtype=I32,
                                  device=st.cycle.device)
                     for v in ints_m - ints_w)
    return reduce_window_stats(cfg.nx * cfg.ny, measure, st.lat_hist.clone(),
                               d_inj, d_comp, util_m - util_w)


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
