"""The three step kinds (the port's counterpart of the steps of
``repro.launch.step``, one card, no sharding rules).

* ``train_step``   — loss, backward and the AdamW update;
* ``prefill_step`` — forward, last-token logits only;
* ``serve_step``   — one ``decode_step`` against the KV cache, then greedy
                     next tokens.

The reference's ``make_train_step(cfg, rules, opt_cfg)``,
``make_prefill_step(cfg, rules)`` and ``make_serve_step(cfg, rules)``
build closures over the config and the sharding rules; on one card there
is nothing to close over, so these are plain functions of the model (an
``nn.Module`` from ``repro_torch.models.get_model``).
``batch["positions"]`` is passed through as the reference passes it: (B,
S), or (3, B, S) for Qwen2-VL's M-RoPE; for the ``audio`` family
(Whisper) ``batch["frames"]`` (B, encoder_seq, D) too.  The serving steps
build no autograd graph, whether or not the parameters require
gradients.  The reference's cells (``build_cell``, shardings,
ShapeDtypeStruct stand-ins) belong to the SPMD slice and the dry run.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch import optim

__all__ = ["train_step", "prefill_step", "serve_step"]


def train_step(model, opt_cfg: optim.OptConfig, opt_state: Dict[str, Any],
               batch: Dict[str, torch.Tensor], remat: str = "none"
               ) -> Dict[str, torch.Tensor]:
    """One training step on ``batch`` (``tokens``, ``labels``, ``mask``;
    ``positions`` or ``frames`` where the family reads them): the model's
    ``loss``, its gradients, then ``optim.apply``, which updates the
    model's parameters and ``opt_state`` in place.  Nothing is written
    before the loss and every gradient exist, so a step that raises before
    then can be retried.  Returns {"loss", "ce"[, "moe_aux"], "grad_norm",
    "lr"} as 0-d tensors, as the reference's step does.  The three phases
    are profiler ranges (``train_step: loss``, ``: backward``,
    ``: optimizer``), free unless a profiler runs."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    with record_function("train_step: loss"):
        loss, metrics = model.loss(batch, remat=remat)
    with record_function("train_step: backward"):
        loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in params.items()}
    with record_function("train_step: optimizer"):
        _, _, om = optim.apply(opt_cfg, params, grads, opt_state)
    for p in params.values():
        p.grad = None
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}


@torch.no_grad()
def prefill_step(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, V) next-token logits of ``batch["tokens"]`` (B, S) (optional
    ``batch["positions"]``, (B, S) or (3, B, S); ``batch["frames"]`` for
    the audio family)."""
    kwargs = {}
    if model.cfg.family == "audio":
        kwargs["frames"] = batch["frames"]
    logits, _aux = model(batch["tokens"], positions=batch.get("positions"),
                         last_only=True, **kwargs)
    return logits[:, 0]


@torch.no_grad()
def serve_step(model, cache: Dict[str, torch.Tensor], tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step, then the argmax of the logits: (next_tokens (B,)
    int32, cache)."""
    logits, cache = model.decode_step(cache, tokens)
    return logits.argmax(-1).to(torch.int32), cache
