"""The port's mesh simulator facade.

One front door for every way of driving the mesh, as in the JAX
package's ``repro.mesh.Simulator``::

    from repro_torch.mesh import MeshConfig, Simulator, make_traffic

    sim = Simulator(MeshConfig(nx=8, ny=8))          # on the card
    sim.attach(make_traffic("uniform", 8, 8, 64, rate=0.5))   # a program
    sim.run_until_drained()
    t = sim.telemetry()          # Telemetry, bit-identical across backends

or, attaching a reactive user design (the paper's integration story)::

    from repro_torch.mesh import DmaEndpoint, Simulator

    sim = Simulator(cfg)
    sim.attach(DmaEndpoint(dst_x=3, dst_y=2, data=range(16)), at=(0, 0))
    sim.run_until_drained()

Backends:

* ``backend="torch"`` (the default) —
  :class:`repro_torch.netsim.sim.TorchMeshSim`, on the card unless
  ``device="cpu"`` is given; there every cycle goes through the Hopper
  router kernel, on the CPU through the plain PyTorch step.  Injection
  programs run on it directly.  Reactive endpoints run through the
  **trace-to-program bridge**: the scenario executes once on an internal
  numpy oracle, which calls the endpoints and records the exact injection
  cycle of every packet, and the resulting ``not_before``-pinned program
  (:meth:`Simulator.injection_trace_program`) replays bit-identically on a
  fresh simulator on the facade's device.  Telemetry, memory and credits
  then read that device simulator, never the oracle.
* ``backend="numpy"`` — :class:`repro_torch.core.netsim.MeshSim`, the
  oracle, on the host.  Reactive endpoints run natively: each cycle the
  facade delivers any registered response to its endpoint, then the router
  step asks every ready endpoint for an offer; :meth:`Simulator.step`
  advances one cycle.

Everything not defined here (``mem``, ``credits``, ``lat_hist``,
``throughput()``, ...) delegates to the backend object.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.netsim import MeshSim

from .config import MeshConfig
from .endpoint import Endpoint, Request, Response, trace_to_program
from .encoding import validate_program
from .telemetry import Telemetry

__all__ = ["Simulator", "BACKENDS"]

BACKENDS = ("numpy", "torch")

_I32 = np.iinfo(np.int32)


class Simulator:
    """Facade over one lane of the port's simulator or of its oracle."""

    def __init__(self, cfg, *, backend: str = "torch",
                 fifo_depth: Optional[int] = None,
                 max_credits: Optional[int] = None, check_every: int = 1,
                 cycles_per_call: Optional[int] = None, device=None):
        """``cfg`` may be a MeshConfig, NetConfig or SimConfig.

        ``fifo_depth`` / ``max_credits`` set the effective router-FIFO
        depth and credit allowance below the config's capacities (per-lane
        state on the torch backend; the oracle folds them into its config,
        which is dynamics-identical).  ``check_every`` (drain fence
        cadence), ``cycles_per_call`` (cycles per kernel call; ``None``:
        one call per ``run`` or per fence block) and ``device`` belong to
        the torch backend; the first two change speed only, never
        results."""
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; known: {BACKENDS}")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if cycles_per_call is not None and cycles_per_call < 1:
            raise ValueError(
                f"cycles_per_call must be >= 1, got {cycles_per_call}")
        if backend == "numpy" and device is not None:
            raise ValueError("the numpy backend runs on the host; 'device' "
                             "applies to the torch backend")
        self.cfg = MeshConfig.coerce(cfg)
        self.backend = backend
        self._fifo_depth = fifo_depth
        self._max_credits = max_credits
        self._check_every = int(check_every)
        self._cycles_per_call = cycles_per_call
        self._device = device
        self._endpoints: Dict[Tuple[int, int], Endpoint] = {}  # (y, x) -> ep
        self._trace: List[Tuple[int, int, int, Request]] = []
        self._program: Optional[Dict[str, np.ndarray]] = None
        self._mem0: Optional[np.ndarray] = None
        self._window: Optional[Tuple[int, int]] = None
        self._oracle: Optional["Simulator"] = None   # torch+endpoints bridge
        self._sim = self._make_backend()
        if backend == "torch":
            self._device = self._sim.device

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _effective_cfg(self) -> MeshConfig:
        cfg = self.cfg
        if self._fifo_depth is not None:
            cfg = cfg.replace(router_fifo=int(self._fifo_depth))
        if self._max_credits is not None:
            cfg = cfg.replace(max_out_credits=int(self._max_credits))
        return cfg

    def _make_backend(self, check_every: Optional[int] = None):
        if self.backend == "numpy":
            return MeshSim(self._effective_cfg().to_net())
        from repro_torch.netsim.sim import TorchMeshSim
        return TorchMeshSim(self.cfg.to_sim(), fifo_depth=self._fifo_depth,
                            max_credits=self._max_credits,
                            check_every=check_every or self._check_every,
                            cycles_per_call=self._cycles_per_call,
                            device=self._device)

    def _bridge(self) -> "Simulator":
        """The internal oracle that executes reactive endpoints for the
        torch backend (created on the first endpoint attach)."""
        if self._oracle is None:
            self._oracle = Simulator(self._effective_cfg(), backend="numpy")
            if self._mem0 is not None:
                self._oracle.set_mem(self._mem0)
            if self._window is not None:
                self._oracle.set_measure_window(*self._window)
            if self._program is not None:
                self._oracle.attach(self._program)
        return self._oracle

    # ------------------------------------------------------------------
    # attachment
    # ------------------------------------------------------------------
    def attach(self, item, at: Optional[Tuple[int, int]] = None
               ) -> "Simulator":
        """Attach a master to the mesh and return ``self`` (chainable).

        * a dict injection program (the ``make_traffic`` schema) loads on
          every tile at once;
        * an :class:`Endpoint` attaches to the single tile ``at=(x, y)``.
        """
        if isinstance(item, dict):
            if at is not None:
                raise ValueError(
                    "a program drives every tile; 'at' only applies to "
                    "endpoint attachment")
            self._attach_program(item)
            return self
        if not isinstance(item, Endpoint):
            raise TypeError(
                f"cannot attach {type(item).__name__}: expected an injection"
                " program dict or an object with offer/deliver/done")
        if at is None:
            raise ValueError(
                "attaching an endpoint needs its tile: attach(ep, at=(x, y))")
        x, y = at
        if not (0 <= x < self.cfg.nx and 0 <= y < self.cfg.ny):
            raise ValueError(
                f"endpoint tile (x={x}, y={y}) is outside the "
                f"{self.cfg.nx}x{self.cfg.ny} mesh")
        if (y, x) in self._endpoints:
            raise ValueError(
                f"tile (x={x}, y={y}) already has an endpoint attached; "
                "a tile has one master")
        if self.backend == "torch" and self._cycles_run() > 0:
            raise ValueError(
                "cannot attach an endpoint to a torch-backend Simulator that "
                "has already run: the trace-to-program bridge replays the "
                "scenario from cycle 0, which would drop the pre-attach "
                "history; attach endpoints before running (the numpy "
                "backend supports mid-run attachment natively)")
        if self._program is not None and \
                (np.asarray(self._program["op"])[y, x] >= 0).any():
            raise ValueError(
                f"tile (x={x}, y={y}) already has injection-program "
                "entries; a tile has one master")
        self._endpoints[(y, x)] = item
        if self.backend == "numpy":
            self._sim._injectors[(y, x)] = self._traced_offer(y, x, item)
        else:
            self._bridge().attach(item, at=at)
        return self

    def _attach_program(self, entries: Dict[str, np.ndarray]) -> None:
        # one packet-domain contract for both backends: coordinates and
        # opcode fit the packed header (and the mesh), payloads fit int32
        validate_program(entries, nx=self.cfg.nx, ny=self.cfg.ny,
                         topology=self.cfg.topology)
        op = np.asarray(entries["op"])
        for (y, x) in self._endpoints:
            if (op[y, x] >= 0).any():
                raise ValueError(
                    f"tile (x={x}, y={y}) is driven by an endpoint but the "
                    "program has entries there; a tile has one master")
        if self.backend == "torch" and self._endpoints \
                and self._cycles_run() > 0:
            # the bridge replays from cycle 0, so a program arriving after
            # cycles have run would be scheduled earlier than it was seen
            raise ValueError(
                "cannot attach a program to an endpoint-driven "
                "torch-backend Simulator that has already run: the "
                "trace-to-program bridge replays from cycle 0; attach "
                "everything before running")
        self._program = {k: np.asarray(v).copy() for k, v in entries.items()}
        if self.backend == "torch" and self._endpoints:
            self._bridge().attach(self._program)
        else:
            self._sim.load_program(
                {k: v.copy() for k, v in self._program.items()})

    # program-compatibility alias (load_program(prog) == attach(prog))
    def load_program(self, entries: Dict[str, np.ndarray]) -> None:
        self.attach(entries)

    def _traced_offer(self, y: int, x: int, ep: Endpoint):
        def offer(cycle: int, credits: int) -> Optional[Request]:
            req = ep.offer(cycle, credits)
            if req is not None:
                self._trace.append((y, x, cycle, req))
            return req
        return offer

    # ------------------------------------------------------------------
    # state seeding
    # ------------------------------------------------------------------
    def set_mem(self, mem: np.ndarray) -> None:
        """Initialize every tile's local memory, shape (ny, nx, mem_words),
        e.g. to seed the pointer chains a memory-controller endpoint
        chases.  The torch backend holds int32 words and rejects values
        outside that range."""
        cfg = self.cfg
        mem = np.asarray(mem)
        if mem.shape != (cfg.ny, cfg.nx, cfg.mem_words):
            raise ValueError(
                f"memory image must be shaped (ny={cfg.ny}, nx={cfg.nx}, "
                f"mem_words={cfg.mem_words}), got {mem.shape}")
        if self.backend == "torch" and mem.size and \
                (mem.min() < _I32.min or mem.max() > _I32.max):
            raise ValueError(
                f"memory image values must fit int32 on the torch backend; "
                f"got values in [{int(mem.min())}, {int(mem.max())}]")
        self._mem0 = mem.astype(np.int64)
        if self.backend == "numpy":
            self._sim.mem[:] = self._mem0
            return
        self._seed_mem(self._sim)
        if self._oracle is not None:
            self._oracle.set_mem(self._mem0)

    def _seed_mem(self, sim) -> None:
        import torch
        st = sim.state
        sim.state = st._replace(mem=torch.as_tensor(
            self._mem0.astype(np.int32)[None], device=st.mem.device))

    def set_measure_window(self, start: int, stop: int) -> None:
        """Restrict the latency histogram to packets *injected* in cycle
        range [start, stop), the same contract on every backend."""
        self._window = (int(start), int(stop))
        self._sim.set_measure_window(*self._window)
        if self._oracle is not None:
            self._oracle.set_measure_window(*self._window)

    def _cycles_run(self) -> int:
        """Scenario cycles executed so far (the bridge oracle's view when
        endpoints run on the torch backend)."""
        src = self._oracle if self._oracle is not None else self
        return int(src._sim.cycle)

    # ------------------------------------------------------------------
    # running
    # ------------------------------------------------------------------
    def step(self) -> None:
        """Advance one cycle (numpy backend only: the torch backend
        launches whole runs).  With endpoints attached this is the
        reactive step: responses are delivered before the router cycle,
        exactly as in :meth:`run`."""
        if self.backend != "numpy":
            raise NotImplementedError(
                "cycle-by-cycle stepping is a numpy-backend feature; the "
                "torch backend launches whole runs — use run(cycles)")
        if self._endpoints:
            self._step_reactive()
        else:
            self._sim.step()

    def run(self, cycles: int) -> None:
        """Advance ``cycles`` cycles."""
        if not self._endpoints:
            self._sim.run(cycles)
            return
        if self.backend == "numpy":
            for _ in range(cycles):
                self._step_reactive()
            return
        self._bridge().run(cycles)
        self._replay(int(self._oracle.cycle), drained=False)

    def run_until_drained(self, max_cycles: int = 100_000) -> int:
        """Run until the global fence closes — programs fully issued,
        every endpoint ``done()``, all credits home and the registered
        response port idle; returns the drain cycle."""
        if not self._endpoints:
            return self._sim.run_until_drained(max_cycles)
        if self.backend == "numpy":
            for _ in range(max_cycles):
                if self._reactive_drained():
                    return int(self._sim.cycle)
                self._step_reactive()
            raise RuntimeError(
                f"network did not drain in {max_cycles} cycles")
        n = self._bridge().run_until_drained(max_cycles)
        self._replay(n, drained=True)
        return n

    def _step_reactive(self) -> None:
        """One oracle cycle with the reverse link serviced: deliver any
        registered response to its endpoint (the sink rule: the endpoint
        cannot refuse), then step; offers happen inside the step at the
        injection stage, exactly where program injection lives."""
        sim = self._sim
        rv = sim.reg_valid
        if rv.any():
            c = int(sim.cycle)
            for (y, x), ep in self._endpoints.items():
                if rv[y, x]:
                    p = sim.reg_pkt
                    ep.deliver(Response(
                        op=int(p["op"][y, x]), addr=int(p["addr"][y, x]),
                        data=int(p["data"][y, x]),
                        src_x=int(p["src_x"][y, x]),
                        src_y=int(p["src_y"][y, x]),
                        tag=int(p["tag"][y, x]), cycle=c))
        sim.step()

    def _reactive_drained(self) -> bool:
        sim = self._sim
        return (all(ep.done() for ep in self._endpoints.values())
                and bool((sim.prog_ptr >= sim.prog_len).all())
                and bool((sim.credits == sim.cfg.max_out_credits).all())
                and not bool(sim.reg_valid.any()))

    # ------------------------------------------------------------------
    # the trace -> program bridge (torch backend with endpoints)
    # ------------------------------------------------------------------
    def injection_trace_program(self) -> Dict[str, np.ndarray]:
        """The injection program equivalent to everything injected so far
        (endpoint offers pinned to their recorded cycles, merged with any
        attached base program).  Replayable on either backend, and
        stackable as lanes of a sweep."""
        oracle = self._oracle if self._oracle is not None else self
        return trace_to_program(oracle._trace, self.cfg.nx, self.cfg.ny,
                                base=self._program)

    def _replay(self, cycles: int, drained: bool) -> None:
        """Re-run the oracle-traced scenario on a fresh simulator on the
        facade's device, to the oracle's cycle ``cycles``.  A drained
        replay runs one fence block of exactly ``cycles`` cycles, so its
        drain cycle is checked against the oracle's and its state never
        steps past it."""
        prog = self.injection_trace_program()
        # the device holds int32 lanes: an endpoint's payload (user data)
        # must fit them, or the replay would not be the traced run
        validate_program(prog, nx=self.cfg.nx, ny=self.cfg.ny,
                         topology=self.cfg.topology)
        sim = self._make_backend(check_every=max(cycles, 1))
        if self._mem0 is not None:
            self._seed_mem(sim)
        if self._window is not None:
            sim.set_measure_window(*self._window)
        sim.load_program(prog)
        if drained:
            got = sim.run_until_drained(max(cycles, 1))
            if got != cycles:
                raise RuntimeError(
                    f"the replay on {sim.device} drained at cycle {got}, "
                    f"the oracle at {cycles}")
        else:
            sim.run(cycles)
        self._sim = sim

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------
    def telemetry(self) -> Telemetry:
        """The unified telemetry record (a point-in-time copy), of the
        backend simulator: on the torch backend the device's."""
        return Telemetry.of(self._sim)

    @property
    def endpoints(self) -> Dict[Tuple[int, int], Endpoint]:
        """Attached endpoints, keyed (x, y)."""
        return {(x, y): ep for (y, x), ep in self._endpoints.items()}

    def __getattr__(self, name):
        # oracle-shaped passthrough (mem, credits, lat_hist, throughput,
        # mean_latency, cycle, state, ...)
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._sim, name)

    def __repr__(self) -> str:
        where = f", device={self._device}" if self.backend == "torch" else ""
        return (f"Simulator({self.cfg.nx}x{self.cfg.ny}, "
                f"backend={self.backend!r}{where}, "
                f"endpoints={len(self._endpoints)}, "
                f"program={'yes' if self._program is not None else 'no'})")
