"""Fault-tolerant training runtime on one card or on a mesh of ranks (the
port's counterpart of ``repro.runtime.trainer``).

The loop is the reference's, with the host-side control plane explicit:

* **checkpoint/restart** — resume from the newest committed checkpoint;
  async saves every ``ckpt_every`` steps and at the last (credit-bounded,
  paper C3); a final fence guarantees durability before ``run`` returns.
  ``ckpt_dir=None`` keeps no checkpoints (a run whose state is too large
  to write where it runs): it resumes nothing, and repeated failures
  start again from :meth:`Trainer.init`, as the reference does before its
  first checkpoint.
* **step retry** — a failed step (an injected fault, a flaky worker) is
  retried on the same batch from the last good state; repeated failures
  of one step restore from the last checkpoint; a retry budget bounds the
  loop.  The port's step updates in place, but only after the step's loss
  and gradients exist (``launch/step.py::train_step``), so a step that
  fails before its update leaves the state as it was, as the reference's
  functional step does.
* **straggler detection** — each step's wall time against the rolling
  median of the last steps; a step slower than ``straggler_factor`` times
  it is recorded as an event.
* **elastic re-shard** — :meth:`Trainer.reshard` moves the live
  parameters and optimizer state onto another mesh mid-run (a smaller or
  a larger one): the same global tensors, the new mesh's layouts, no
  restart from disk.

One device, given explicitly (the card unless ``device="cpu"``), or a
mesh: ``Trainer(..., mesh=mesh, strategy=..., **rule_overrides)`` in
every rank (the reference's ``_bind_mesh``: the rules are ``cell_rules``
of the strategy for this cell).  On a mesh each rank holds its blocks of
the parameters (its banks under FSDP) and its ZeRO-1 banks of the
optimizer state, drawn by :meth:`Trainer.init` from the same seeded full
initialisation as one card, or restored by :meth:`resume_or_init` from a
checkpoint in the one on-disk layout (written on a mesh or on one card);
every rank reads the same global batch and the model takes its rows.
``remat`` follows ``rules.remat`` as in the reference: its default
``"full"`` differs from the single-card ``"none"`` (ROADMAP C-9).

**Agreement before a retry.**  One rank that raised while the others
entered the step's collectives would hang the mesh.  So everything that
may fail (the fault check, the batch's copy to the device) runs before
the step's first collective, and the ranks agree on the outcome with one
``all_reduce(MAX)`` of a failure flag: all of them run the step, or all
of them retry (or restore) together.  A fault in the middle of a
collective (a rank dying inside the step) is out of scope: it raises,
and the run ends (ROADMAP C-13).

**A mesh on some ranks of the world.**  The ranks are started for the
larger of the meshes a run will use; a mesh may cover some of them
(``Mesh(..., ranks=)``).  Every rank of the world constructs the
``Trainer`` and calls each method alike; a rank outside the current mesh
holds no state, and its ``init``, ``resume_or_init`` and ``run`` return
at once, taking part in no collective of the mesh's, until a
:meth:`reshard` brings it in.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.step import cell_rules, train_step
from repro_torch.models import get_model
from repro_torch.models.convert import init_params, shard_params, state_layout
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import cut_block, join_blocks

__all__ = ["TrainerConfig", "Trainer", "FaultInjector"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = "checkpoints"   # None: no checkpoints
    ckpt_credits: int = 2
    max_retries_per_step: int = 2
    max_total_retries: int = 10
    straggler_factor: float = 3.0
    log_every: int = 10


class FaultInjector:
    """Deterministic fault schedule for tests/examples: raises
    ``RuntimeError`` the first ``times`` times ``step`` is executed."""

    def __init__(self, fail_at: Dict[int, int]):
        self.fail_at = dict(fail_at)

    def maybe_fail(self, step: int):
        n = self.fail_at.get(step, 0)
        if n > 0:
            self.fail_at[step] = n - 1
            raise RuntimeError(f"injected fault at step {step}")


def _from_rank(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` as global rank ``src`` holds it, on every rank of the world
    (elsewhere ``t`` gives the shape, dtype and device).  Through the
    host where gloo carries the tensors (its CUDA broadcast is not
    relied on; ``parallel.comm.HOST_STAGED``)."""
    host = t.device.type == "cpu" or dist.get_backend() == "gloo"
    w = t.detach().cpu().contiguous() if host else t.detach().contiguous()
    dist.broadcast(w, src)
    return w.to(t.device)


class Trainer:
    """Trains ``cfg``'s model on batches of ``shape`` on one device, or on
    ``mesh`` (every rank constructs it alike) under ``cell_rules(mesh,
    cfg, shape, strategy, **rule_overrides)``.  ``remat``: the models'
    ``"none"``, ``"full"`` or ``"dots"``; default ``"none"`` on one device,
    ``rules.remat`` on a mesh (where a given ``remat`` overrides it)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: Optional[optim.OptConfig] = None,
                 tcfg: Optional[TrainerConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 device=None, remat: Optional[str] = None, mesh=None,
                 strategy: str = "baseline", **rule_overrides):
        self.cfg, self.shape = cfg, shape
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or optim.OptConfig()
        self.fault_injector = fault_injector
        self.strategy = strategy
        if mesh is None:
            if rule_overrides or strategy != "baseline":
                raise ValueError("a strategy and rule overrides need a mesh")
            self.mesh, self.rules, self.specs = None, None, None
            self.device = resolve_device(device)
            self.remat = remat or "none"
        else:
            if remat is not None:
                rule_overrides["remat"] = remat
            self.rule_overrides = rule_overrides
            self._bind_mesh(mesh, device)
        self.events: List[Dict] = []
        self.step_times: List[float] = []
        self.ckpt = None
        self._open_checkpointer()
        self.model = None
        self.opt_state = None
        self.step = 0

    def _bind_mesh(self, mesh, device=None) -> None:
        """(Re)build the rules and the layouts for ``mesh`` (the
        reference's ``_bind_mesh``): ``cell_rules`` of the strategy."""
        self.mesh = mesh
        self.rules = cell_rules(mesh, self.cfg, self.shape, self.strategy,
                                **self.rule_overrides)
        self.device = resolve_device(mesh.device if device is None
                                     else device)
        self.remat = self.rules.remat
        specs = get_model(self.cfg).param_specs(self.cfg, self.rules)
        banks = state_layout(self.cfg, self.rules)
        self.specs = {"params": specs,
                      "opt": {"master": banks, "m": banks, "v": banks,
                              "step": ()}}

    def _open_checkpointer(self) -> None:
        """The async writer of the current mesh (collective over the world
        on a mesh: every rank opens it, a rank outside the mesh too)."""
        if self.tcfg.ckpt_dir is not None:
            self.ckpt = AsyncCheckpointer(self.tcfg.ckpt_dir,
                                          credits=self.tcfg.ckpt_credits,
                                          mesh=self.mesh)

    @property
    def active(self) -> bool:
        """Whether this rank is in the current mesh (holds state, steps)."""
        return self.mesh is None or self.mesh.member

    # ------------------------------------------------------------------
    def _bind(self, params: Dict[str, torch.Tensor], opt_state) -> None:
        """Build the model around ``params`` (held, not copied), trainable."""
        self.model = get_model(self.cfg)(self.cfg, self.device, params=params,
                                         rules=self.rules)
        self.model.requires_grad_(True)
        self.opt_state = opt_state

    def init(self, seed: int = 0,
             params: Optional[Dict[str, torch.Tensor]] = None):
        """Fresh parameters (``init_params`` from a generator seeded
        ``seed``, or the full state dict ``params`` on the device) and a
        fresh optimizer state, at step 0.  On a mesh, this rank's blocks
        and banks of them: the same numbers as one card's."""
        self.step = 0
        if not self.active:
            return self
        if params is None:
            params = init_params(self.cfg, torch.Generator(
                self.device).manual_seed(seed), self.device, rules=self.rules)
        elif self.rules is not None:
            params = shard_params(self.cfg, params, self.rules)
        on_mesh = {} if self.rules is None else {
            "rules": self.rules, "specs": self.specs["params"]}
        self._bind(params, optim.init(params, **on_mesh))
        return self

    def resume_or_init(self, seed: int = 0):
        """Restore the newest committed checkpoint (params and optimizer
        state, onto the device; on a mesh this rank's blocks and banks),
        or :meth:`init` where there is none."""
        if not self.active:
            return self
        last = None if self.ckpt is None else latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return self.init(seed)
        model = get_model(self.cfg)
        table = model.param_table(self.cfg)
        like = {k: torch.empty(shape, dtype=model.param_dtype(self.cfg, k),
                               device="meta") for k, shape in table.items()}
        on_mesh = {} if self.mesh is None else {"specs": self.specs,
                                                "mesh": self.mesh}
        tree, step, _extra = restore(
            self.tcfg.ckpt_dir, {"params": like,
                                 "opt": optim.state_shapes(table)},
            device=self.device, **on_mesh)
        self._bind(tree["params"], tree["opt"])
        self.step = step
        self.events.append({"kind": "resume", "step": step})
        return self

    # ------------------------------------------------------------------
    def reshard(self, new_mesh):
        """Elastic re-shard: move the live state onto ``new_mesh``, then
        keep training (the reference's ``reshard``): the rules, layouts
        and banks rebound to ``cell_rules`` of the new mesh, the
        parameters and the ZeRO-1/FSDP banks of the optimizer state moved
        into its layout, and ``{"kind": "reshard", "step", "from_chips",
        "to_chips"}`` recorded.

        Collective over the whole process group: every rank calls it
        (and has built ``new_mesh``), those outside either mesh too.  The
        checkpoint writer is fenced on the old mesh and reopened on the
        new one, so a checkpoint written after the move restores there.
        Each tensor moves whole: joined on the old mesh
        (``sharding.join_blocks``), sent from the old mesh's first rank
        to every rank, and cut on the new one (``sharding.cut_block``),
        one tensor at a time, so a rank holds one full tensor at most."""
        if self.mesh is None:
            raise ValueError("reshard moves a mesh trainer's state; this "
                             "one runs on one device")
        old_chips, was_active = self.mesh.size, self.active
        old_rules, old_specs = self.rules, self.specs
        src = self.mesh.ranks[0]
        if self.ckpt is not None:
            self.ckpt.close()
        model = get_model(self.cfg)
        table = model.param_table(self.cfg)
        held = {} if not was_active else {
            "params": {k: p.detach() for k, p in
                       self.model.named_parameters()},
            **{q: self.opt_state[q] for q in ("master", "m", "v")}}
        self._bind_mesh(new_mesh)
        moved = {"params": {}, "master": {}, "m": {}, "v": {}}
        for part in moved:
            specs = self.specs["params"] if part == "params" \
                else self.specs["opt"][part]
            was = old_specs["params"] if part == "params" \
                else old_specs["opt"][part]
            for k, shape in table.items():
                dtype = model.param_dtype(self.cfg, k) \
                    if part == "params" else torch.float32
                full = join_blocks(held[part][k], was[k], old_rules) \
                    if was_active else torch.empty(shape, dtype=dtype,
                                                   device=self.device)
                full = _from_rank(full, src)
                if self.active:
                    moved[part][k] = cut_block(full, specs[k], self.rules)
        step = _from_rank(torch.tensor(
            [self.step, int(self.opt_state["step"]) if was_active else 0],
            dtype=torch.int64, device=self.device), src)
        self.step = int(step[0])
        if self.active:
            state = {q: moved[q] for q in ("master", "m", "v")}
            state["step"] = torch.tensor(int(step[1]), dtype=torch.int32,
                                         device=self.device)
            self._bind(moved["params"], state)
        else:
            self.model, self.opt_state = None, None
        self._open_checkpointer()
        self.events.append({"kind": "reshard", "step": self.step,
                            "from_chips": old_chips,
                            "to_chips": new_mesh.size})
        return self

    # ------------------------------------------------------------------
    def _put_batch(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _agree(self, failed: bool) -> bool:
        """Whether any rank failed (one all-reduce of the flag)."""
        if self.mesh is None:
            return failed
        flag = torch.tensor([int(failed)], dtype=torch.int32,
                            device=self.device)
        return bool(comm.all_reduce(flag, self.mesh, self.mesh.axis_names,
                                    "max").item())

    def _try_step(self, batch):
        """(metrics, None), or (None, the error) where the step failed on
        this rank or, on a mesh, on any rank."""
        err = None
        try:
            if self.fault_injector is not None:
                self.fault_injector.maybe_fail(self.step)
            tb = self._put_batch(batch)
        except Exception as e:
            err = e
        if self._agree(err is not None):
            return None, err or RuntimeError("a step failure on another "
                                             "rank")
        try:
            metrics = train_step(self.model, self.opt_cfg, self.opt_state,
                                 tb, self.remat, self.rules)
            float(metrics["loss"])                  # wait for the step
            return metrics, None
        except Exception as e:
            if self.mesh is not None:
                raise        # inside the step's collectives: no agreement
            return None, e

    def run(self, batches: Iterator[Dict[str, np.ndarray]],
            on_step: Optional[Callable[[int, Dict], None]] = None) -> Dict:
        if not self.active:
            return {}
        if self.model is None:
            raise RuntimeError("call init() or resume_or_init() first")
        total_retries = 0
        metrics = {}
        while self.step < self.tcfg.total_steps:
            batch = next(batches)
            retries = 0
            while True:
                t0 = time.perf_counter()
                metrics, err = self._try_step(batch)
                if err is None:
                    break
                retries += 1
                total_retries += 1
                self.events.append({"kind": "step_failure",
                                    "step": self.step, "error": str(err)})
                if total_retries > self.tcfg.max_total_retries:
                    raise RuntimeError("retry budget exhausted") from err
                if retries > self.tcfg.max_retries_per_step:
                    # fall back to last durable state
                    if self.ckpt is not None:
                        self.ckpt.fence()
                    self.resume_or_init()
                    retries = 0
                dt = time.perf_counter() - t0
                self._heartbeat(dt)
            dt = time.perf_counter() - t0
            self._heartbeat(dt)
            self.step += 1
            if self.ckpt is not None and (
                    self.step % self.tcfg.ckpt_every == 0
                    or self.step == self.tcfg.total_steps):
                self.ckpt.submit(self.step, {
                    "params": {k: p.detach() for k, p
                               in self.model.named_parameters()},
                    "opt": self.opt_state},
                    extra={"loss": float(metrics["loss"])},
                    **({} if self.specs is None else {"specs": self.specs}))
            if on_step is not None:
                on_step(self.step, metrics)
            if self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d}  loss {float(metrics['loss']):.4f}"
                      f"  ({dt*1e3:.0f} ms)", flush=True)
        if self.ckpt is not None:
            self.ckpt.fence()   # durability barrier (paper C3 fence)
        return {k: float(v) for k, v in metrics.items()}

    def _heartbeat(self, dt: float):
        self.step_times.append(dt)
        hist = self.step_times[-20:-1]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.tcfg.straggler_factor * med:
                self.events.append({"kind": "straggler", "step": self.step,
                                    "dt": dt, "median": med})

    def close(self):
        if self.ckpt is not None:
            self.ckpt.close()
