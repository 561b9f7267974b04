"""The cycle-level mesh simulator in PyTorch (counterpart of
``repro.netsim_jax``).

* :mod:`.sim` — ``SimState`` with a leading lane axis, ``init_state`` /
  ``load_program``, the plain PyTorch cycle ``step_core`` and the drivers
  ``simulate`` / ``run_until_drained[_traced]`` (on a card every cycle runs
  through the Hopper router kernel);
* :mod:`.measure` — phased warmup/measure/drain load–latency measurement,
  batched over lanes, and streamed one fence block at a time;
* :mod:`.convert` — JAX ``SimState``/``Program`` leaves (as numpy) to the
  port's tensors and back.
"""
from . import convert, measure, sim  # noqa: F401
from .convert import program_from_jax, state_from_jax, state_to_numpy  # noqa: F401
from .measure import (DEFAULT_SWEEP_RATES, CompiledSweep,  # noqa: F401
                      PhaseStats, StreamChunk, SweepKey, ascii_curve,
                      batched_phased_stats, clear_sweep_cache, compile_sweep,
                      curve_is_monotone, curve_record, hist_quantile,
                      load_latency_sweep, measure_program, phase_schedule,
                      phased_stats, reduce_window_stats, saturation_point,
                      stack_rate_programs, stream_phased_stats, sweep_config)
from .sim import (FWD, REV, Program, SimConfig, SimState,  # noqa: F401
                  TorchMeshSim, drained, init_state, load_program,
                  run_until_drained, run_until_drained_traced, simulate,
                  stack_programs, step_core)

__all__ = ["convert", "measure", "sim", "state_from_jax", "program_from_jax",
           "state_to_numpy", "DEFAULT_SWEEP_RATES", "CompiledSweep",
           "PhaseStats", "StreamChunk", "SweepKey", "ascii_curve",
           "batched_phased_stats", "clear_sweep_cache", "compile_sweep",
           "curve_is_monotone", "curve_record", "hist_quantile",
           "load_latency_sweep", "measure_program", "phase_schedule",
           "phased_stats", "reduce_window_stats", "saturation_point",
           "stack_rate_programs", "stream_phased_stats", "sweep_config",
           "FWD", "REV", "Program", "SimConfig", "SimState", "TorchMeshSim",
           "drained", "init_state", "load_program", "run_until_drained",
           "run_until_drained_traced", "simulate", "stack_programs",
           "step_core"]
