"""AdamW with an fp32 master copy and ZeRO-1 banked optimizer state (the
port's counterpart of ``repro.optim.adamw``).

The reference is functional: ``apply`` returns new parameters and a new
state.  The port updates in place, to hold one copy of each tensor: the
state's ``master``, ``m`` and ``v`` (fp32, one per parameter) and
``step`` change in place, and each updated master copy is cast back into
its parameter (bf16, or fp32 for the router, ``A_log`` and ``dt_bias``).
``apply`` reads every gradient (the global norm) before it writes
anything, and its caller computes the loss and the gradients before it
calls ``apply``: a step that fails before then leaves parameters and
state as they were, so it can be retried.

**On a mesh** (``rules`` and the parameters' ``specs``, the tuples of
the model's ``param_specs``): ZeRO-1 is the paper's "virtual mesh"
(C7) applied to the optimizer state, banked over the ``zero1`` axis
(``data``) as the reference's :func:`state_specs` lays it out
(``parallel.sharding.zero1_spec``: the largest still-divisible
dimension, an existing entry extended in place).  Each rank holds
``master``, ``m`` and ``v`` of its bank only (``init(params, rules=,
specs=)``); ``step`` is replicated.  ``apply`` then does what the reference leaves to GSPMD: it
reduce-scatters each gradient (fp32) over ``zero1`` into the rank's bank
and all-reduces it over the other axes the parameter is replicated on
(an all-reduce over all of them where the spec is not banked), takes the
global norm counting every element once (a bank replicated over an axis
counts on that axis' first rank), updates the bank in place and
all-gathers the updated master, cast to the parameter's dtype, back into
the parameter's block.  Under FSDP the parameters are banked themselves:
their gradients arrive reduce-scattered (the weight all-gather's
backward), and the update writes the bank straight into the parameter.
The cross-pod gradient compression is :mod:`repro_torch.optim.compress`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (block_of, entry_names,
                                           replicated_axes, zero1_spec)

__all__ = ["OptConfig", "init", "apply", "clip_by_global_norm", "no_decay",
           "schedule", "state_shapes", "state_specs", "Bank", "banks"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def no_decay(name: str) -> bool:
    """Norm scales / biases / SSM scalars are excluded from weight decay."""
    leaf = name.rsplit("/", 1)[-1]
    return ("norm" in leaf or leaf.startswith("b")
            or leaf in ("A_log", "dt_bias", "D_skip", "conv_b"))


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``lr_min``, in fp32 (``step`` an
    int or a tensor; the result on the tensor's device)."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# ZeRO-1 banking (the reference's state_shapes, state_specs; its
# _zero1_spec is parallel.sharding.zero1_spec)
# ---------------------------------------------------------------------------

def state_shapes(param_shapes: Dict[str, Any]) -> Dict[str, Any]:
    """The state's leaves as ``meta`` tensors (fp32 ``master``, ``m``,
    ``v`` of each parameter's global shape; int32 ``step``), from
    name -> shape (a tuple, or anything with ``.shape``)."""
    def f32(s):
        return torch.empty(tuple(getattr(s, "shape", s)), dtype=F32,
                           device="meta")
    return {"master": {k: f32(s) for k, s in param_shapes.items()},
            "m": {k: f32(s) for k, s in param_shapes.items()},
            "v": {k: f32(s) for k, s in param_shapes.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_specs(param_specs: Dict[str, Tuple],
                param_shapes: Dict[str, Any], rules) -> Dict[str, Any]:
    """The state's layout: each parameter's spec with its ZeRO-1 bank
    (``master``, ``m``, ``v``), ``step`` replicated (``()``)."""
    banked = {k: zero1_spec(param_specs[k],
                             tuple(getattr(s, "shape", s)), rules)
              for k, s in param_shapes.items()}
    return {"master": banked, "m": dict(banked), "v": dict(banked),
            "step": ()}


@dataclasses.dataclass(frozen=True)
class Bank:
    """Where a parameter's optimizer state lives on this rank: ``dim``, the
    dimension of the parameter's block cut into ``size`` banks over the
    ``zero1`` axes, this rank's the ``index``-th (``dim`` None: the state
    is the whole block); ``reduce``, the axes the gradient is all-reduced
    over besides (those the bank is replicated on); ``owner``, whether
    this rank counts the bank in the global norm (it is the first along
    ``reduce``)."""

    dim: Optional[int]
    zero1: Tuple[str, ...]
    size: int
    index: int
    reduce: Tuple[str, ...]
    owner: bool

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's bank of a tensor shaped like the parameter's
        block."""
        if self.dim is None:
            return t
        n = t.shape[self.dim] // self.size
        return t.narrow(self.dim, self.index * n, n)


def banks(params: Dict[str, torch.Tensor], specs: Dict[str, Tuple], rules
          ) -> Dict[str, Bank]:
    """:class:`Bank` of every parameter block of ``params`` laid out by
    ``specs`` under ``rules``."""
    mesh, out = rules.mesh, {}
    for name, p in params.items():
        spec = tuple(specs[name]) + (None,) * (p.dim() - len(specs[name]))
        bank = zero1_spec(spec, block_of(mesh, spec, p.shape)[0], rules)
        dim, zero1 = None, ()
        if tuple(bank) != spec:
            dim = next(d for d in range(p.dim()) if bank[d] != spec[d])
            zero1 = entry_names(rules._clean(rules.zero1))
        reduce = replicated_axes(rules, bank)
        out[name] = Bank(dim, zero1, mesh.axis_size(zero1),
                         mesh.index(zero1), reduce,
                         all(mesh.index(a) == 0 for a in reduce))
    return out


def init(params: Dict[str, torch.Tensor], rules=None,
         specs: Optional[Dict[str, Tuple]] = None) -> Dict[str, Any]:
    """The state of ``params`` (name -> tensor), on their devices: an fp32
    master copy, zero ``m`` and ``v``, and ``step`` 0 (int32).  On a mesh
    (``rules`` and the blocks' ``specs``) each rank's bank of them
    (:func:`banks`)."""
    params = {k: p.detach() for k, p in params.items()}
    device = next(iter(params.values())).device
    if rules is not None:
        bk = banks(params, specs, rules)
        params = {k: bk[k].cut(p) for k, p in params.items()}
    return {
        "master": {k: p.to(F32, copy=True) for k, p in params.items()},
        "m": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _clip_scale(grads: Dict[str, torch.Tensor], max_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm): the squares summed in fp32, leaf by leaf in
    sorted name order (the reference's tree order)."""
    sq = sum(torch.sum(torch.square(grads[k].to(F32))) for k in sorted(grads))
    norm = torch.sqrt(sq)
    return torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0), norm


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Gradients scaled so their global norm is at most ``max_norm`` (each
    in its own dtype), and the norm before."""
    scale, norm = _clip_scale(grads, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _adam(cfg: OptConfig, name: str, g: torch.Tensor, state, lr, b1c, b2c
          ) -> torch.Tensor:
    """One AdamW update of ``name``'s (bank of) state by the fp32 gradient
    ``g``, in place; returns the updated master."""
    master, m, v = (state[k][name] for k in ("master", "m", "v"))
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if cfg.weight_decay and not no_decay(name):
        upd.add_(master, alpha=cfg.weight_decay)
    master.sub_(upd.mul_(lr))
    return master


@torch.no_grad()
def apply(cfg: OptConfig, params: Dict[str, torch.Tensor],
          grads: Dict[str, torch.Tensor], state: Dict[str, Any],
          rules=None, specs: Optional[Dict[str, Tuple]] = None
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                     Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``state`` and ``params`` are updated and
    returned, with {"grad_norm", "lr"} (0-d fp32 tensors).  On a mesh
    (``rules``, the blocks' ``specs``; collective) ``grads`` are this
    rank's shares, reduced here into the banks of ``state`` (module
    docstring)."""
    if rules is not None:
        return _apply_mesh(cfg, params, grads, state, rules, specs)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)
    for name, p in params.items():
        g = grads[name]
        g = (g * scale.to(g.dtype)).to(F32)
        p.copy_(_adam(cfg, name, g, state, lr, b1c, b2c))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _apply_mesh(cfg, params, grads, state, rules, specs):
    mesh = rules.mesh
    bk = banks(params, specs, rules)
    reduced, sq = {}, None
    for name in sorted(params):
        b, g = bk[name], grads[name].to(F32)
        if b.dim is not None:
            g = comm.reduce_scatter(g, mesh, b.zero1, b.dim)
        if b.reduce:
            g = comm.all_reduce(g, mesh, b.reduce)
        reduced[name] = g
        if b.owner:
            part = torch.sum(torch.square(g))
            sq = part if sq is None else sq + part
    if sq is None:
        sq = torch.zeros((), dtype=F32, device=state["step"].device)
    gnorm = torch.sqrt(comm.all_reduce(sq, mesh, mesh.axis_names))
    scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)
    for name, p in params.items():
        b = bk[name]
        master = _adam(cfg, name, reduced.pop(name) * scale, state, lr,
                       b1c, b2c)
        new = master.to(p.dtype)
        if b.dim is not None:
            new = comm.all_gather(new, mesh, b.zero1, b.dim)
        p.copy_(new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
