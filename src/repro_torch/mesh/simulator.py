"""The port's mesh simulator facade.

One front door, as in the JAX package's ``repro.mesh.Simulator``::

    from repro_torch.mesh import MeshConfig, Simulator, make_traffic

    sim = Simulator(MeshConfig(nx=8, ny=8))          # on the card
    sim.attach(make_traffic("uniform", 8, 8, 64, rate=0.5))
    sim.run_until_drained()
    t = sim.telemetry()          # Telemetry, comparable with the reference's

The simulation runs on the card unless ``device="cpu"`` is given; there
every cycle goes through the Hopper router kernel, on the CPU through the
plain PyTorch step.  Injection programs are the only masters in this
slice: reactive :class:`Endpoint`\\ s need the numpy oracle and the
trace-to-program bridge, which the port does not have yet, so attaching
one raises ``NotImplementedError``.

Everything not defined here (``mem``, ``credits``, ``lat_hist``,
``throughput()``, ...) delegates to the backing
:class:`repro_torch.netsim.sim.TorchMeshSim`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import MeshConfig
from .encoding import validate_program
from .telemetry import Telemetry

__all__ = ["Simulator"]

_ENDPOINTS_ITEM = ("ROADMAP.md, queue A: reactive endpoints with the numpy "
                   "oracle and the trace-to-program bridge")


class Simulator:
    """Facade over one lane of the port's simulator."""

    def __init__(self, cfg, *, fifo_depth: Optional[int] = None,
                 max_credits: Optional[int] = None, check_every: int = 1,
                 cycles_per_call: Optional[int] = None, device=None):
        """``cfg`` may be a MeshConfig or SimConfig.  ``fifo_depth`` /
        ``max_credits`` set the effective router-FIFO depth and credit
        allowance below the config's capacities.  ``check_every`` (drain
        fence cadence) and ``cycles_per_call`` (cycles per kernel call;
        ``None``: one call per ``run`` or per fence block) change speed
        only, never results."""
        from repro_torch.netsim.sim import TorchMeshSim
        self.cfg = MeshConfig.coerce(cfg)
        self._program: Optional[Dict[str, np.ndarray]] = None
        self._sim = TorchMeshSim(self.cfg.to_sim(), fifo_depth=fifo_depth,
                                 max_credits=max_credits,
                                 check_every=check_every,
                                 cycles_per_call=cycles_per_call,
                                 device=device)

    # ------------------------------------------------------------------
    # attachment
    # ------------------------------------------------------------------
    def attach(self, item, at: Optional[Tuple[int, int]] = None
               ) -> "Simulator":
        """Attach an injection program (the ``make_traffic`` schema) to
        every tile at once and return ``self`` (chainable)."""
        if not isinstance(item, dict):
            if all(hasattr(item, m) for m in ("offer", "deliver", "done")):
                raise NotImplementedError(
                    "reactive endpoints are not ported yet; attach an "
                    f"injection program instead (see {_ENDPOINTS_ITEM})")
            raise TypeError(
                f"cannot attach {type(item).__name__}: expected an injection"
                " program dict")
        if at is not None:
            raise ValueError(
                "a program drives every tile; 'at' only applies to "
                "endpoint attachment")
        validate_program(item, nx=self.cfg.nx, ny=self.cfg.ny,
                         topology=self.cfg.topology)
        self._program = {k: np.asarray(v).copy() for k, v in item.items()}
        self._sim.load_program(self._program)
        return self

    # program-compatibility alias (load_program(prog) == attach(prog))
    def load_program(self, entries: Dict[str, np.ndarray]) -> None:
        self.attach(entries)

    # ------------------------------------------------------------------
    # state seeding
    # ------------------------------------------------------------------
    def set_mem(self, mem: np.ndarray) -> None:
        """Initialize every tile's local memory, shape (ny, nx, mem_words)."""
        cfg = self.cfg
        mem = np.asarray(mem)
        if mem.shape != (cfg.ny, cfg.nx, cfg.mem_words):
            raise ValueError(
                f"memory image must be shaped (ny={cfg.ny}, nx={cfg.nx}, "
                f"mem_words={cfg.mem_words}), got {mem.shape}")
        st = self._sim.state
        self._sim.state = st._replace(mem=torch.as_tensor(
            mem.astype(np.int32)[None], device=st.mem.device))

    def set_measure_window(self, start: int, stop: int) -> None:
        """Restrict the latency histogram to packets *injected* in cycle
        range [start, stop)."""
        self._sim.set_measure_window(int(start), int(stop))

    # ------------------------------------------------------------------
    # running
    # ------------------------------------------------------------------
    def run(self, cycles: int) -> None:
        """Advance ``cycles`` cycles."""
        self._sim.run(cycles)

    def run_until_drained(self, max_cycles: int = 100_000) -> int:
        """Run until the global fence closes — programs fully issued, all
        credits home and the registered response port idle; returns the
        drain cycle."""
        return self._sim.run_until_drained(max_cycles)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------
    def telemetry(self) -> Telemetry:
        """The unified telemetry record (a point-in-time copy)."""
        return Telemetry.of(self._sim)

    def __getattr__(self, name):
        # oracle-shaped passthrough (mem, credits, lat_hist, throughput,
        # mean_latency, cycle, state, ...)
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._sim, name)

    def __repr__(self) -> str:
        return (f"Simulator({self.cfg.nx}x{self.cfg.ny}, "
                f"device={self._sim.device}, "
                f"program={'yes' if self._program is not None else 'no'})")
