"""AdamW with an fp32 master copy (the port's counterpart of
``repro.optim.adamw``, one card).

The reference is functional: ``apply`` returns new parameters and a new
state.  The port updates in place, to hold one copy of each tensor: the
state's ``master``, ``m`` and ``v`` (fp32, one per parameter) and
``step`` change in place, and each updated master copy is cast back into
its parameter (bf16, or fp32 for the router, ``A_log`` and ``dt_bias``).
``apply`` reads every gradient (the global norm) before it writes
anything, and its caller computes the loss and the gradients before it
calls ``apply``: a step that fails before then leaves parameters and
state as they were, so it can be retried.

The reference's ZeRO-1 banking of the state (``state_specs``,
``state_shapes``, ``_zero1_spec``) belongs to the SPMD training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

__all__ = ["OptConfig", "init", "apply", "clip_by_global_norm", "no_decay",
           "schedule"]

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


def init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The state of ``params`` (name -> tensor), on their devices: an fp32
    master copy, zero ``m`` and ``v``, and ``step`` 0 (int32)."""
    params = {k: p.detach() for k, p in params.items()}
    device = next(iter(params.values())).device
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


@torch.no_grad()
def apply(cfg: OptConfig, params: Dict[str, torch.Tensor],
          grads: Dict[str, torch.Tensor], state: Dict[str, Any]
          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                     Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``state`` and ``params`` are updated and
    returned, with {"grad_norm", "lr"} (0-d fp32 tensors)."""
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)
    for name, p in params.items():
        g = grads[name]
        g = (g * scale.to(g.dtype)).to(F32)
        master, m, v = (state[k][name] for k in ("master", "m", "v"))
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and not no_decay(name):
            upd.add_(master, alpha=cfg.weight_decay)
        master.sub_(upd.mul_(lr))
        p.copy_(master)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
