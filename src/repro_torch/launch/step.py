"""The three step kinds and the per-cell sharding rules (the port's
counterpart of ``repro.launch.step``).

* ``train_step``   — loss, backward and the AdamW update (one card, or
                     a mesh with ZeRO-1 / FSDP);
* ``prefill_step`` — forward, last-token logits only;
* ``serve_step``   — one ``decode_step`` against the KV cache, then greedy
                     next tokens.

The reference's ``make_train_step(cfg, rules, opt_cfg)``,
``make_prefill_step(cfg, rules)`` and ``make_serve_step(cfg, rules)``
build closures over the config and the sharding rules; here they are
plain functions of the model (an ``nn.Module`` from
``repro_torch.models.get_model``), each with an optional ``rules``:
without it they run on one card exactly as before; with it (on a mesh,
every rank calling them in lockstep with the global batch) the model
runs its SPMD islands and every rank gets the global result, the
training step the global loss and every rank's blocks updated.  Every
family runs them on a mesh: the transformer's, Mamba-2, Jamba and
Whisper.
:func:`cell_rules` adapts a strategy to a cell as the reference's does.
``batch["positions"]`` is passed through as the reference passes it: (B,
S), or (3, B, S) for Qwen2-VL's M-RoPE; for the ``audio`` family
(Whisper) ``batch["frames"]`` (B, encoder_seq, D) too.  The serving steps
build no autograd graph, whether or not the parameters require
gradients.  The reference's jit cells (``build_cell``, shardings,
ShapeDtypeStruct stand-ins) serve its dry run, which has no counterpart
here: a mesh training step's layouts are the model's ``param_specs``
and the optimizer's banks.  ``remat`` is ``"none"``, ``"full"`` or
``"dots"`` (``models/base.py::run_layer``).  The pipeline schedule is
``parallel/pipeline.py`` and the compressed cross-pod reduction
``optim/compress.py``; as in the reference, neither is part of this step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import optim
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Rules, make_rules

__all__ = ["train_step", "prefill_step", "serve_step", "cell_rules"]


def cell_rules(mesh, cfg: ModelConfig, shape: ShapeConfig,
               strategy: str = "baseline", **overrides) -> Rules:
    """The strategy's rules adapted to the cell's divisibility: a batch
    that does not divide the data-parallel axes is not sharded, and a
    decode cell then spreads the KV cache's sequence over every axis
    ("virtual mesh" over the whole edge); inference rematerialises
    nothing and banks no parameters (``fsdp`` is a training cell's, as
    the reference's ``build_cell`` applies it)."""
    rules = make_rules(mesh, strategy, **overrides)
    dp = rules.axis_size(rules.batch)
    if shape.global_batch % max(dp, 1) != 0:
        kv = tuple(a for a in ("data", "model") if rules.has_axis(a))
        rules = dataclasses.replace(rules, batch=None, zero1=None,
                                    kv_seq=kv if shape.kind == "decode"
                                    else rules.kv_seq)
    if shape.kind != "train":
        rules = dataclasses.replace(rules, remat="none", fsdp=False)
    return rules


def train_step(model, opt_cfg: optim.OptConfig, opt_state: Dict[str, Any],
               batch: Dict[str, torch.Tensor], remat: str = "none",
               rules: Optional[Rules] = None) -> Dict[str, torch.Tensor]:
    """One training step on ``batch`` (``tokens``, ``labels``, ``mask``;
    ``positions`` or ``frames`` where the family reads them): the model's
    ``loss``, its gradients, then ``optim.apply``, which updates the
    model's parameters and ``opt_state`` in place.  Nothing is written
    before the loss and every gradient exist, so a step that raises before
    then can be retried.  Returns {"loss", "ce"[, "moe_aux"], "grad_norm",
    "lr"} as 0-d tensors, as the reference's step does.  The three phases
    are profiler ranges (``train_step: loss``, ``: backward``,
    ``: optimizer``), free unless a profiler runs.

    On a mesh (``rules``, or the model's own; collective: every rank calls
    it in lockstep with the global batch) the loss is the global loss,
    the backward leaves each rank its share of its blocks' gradients, and
    the mesh ``apply`` reduces them into the optimizer's banks (ZeRO-1)
    and all-gathers the updated blocks; the collectives are counted under
    the phases ``loss``, ``backward`` and ``optimizer``
    (``comm.phase_stats``).  ``opt_state`` is the banked state of
    ``optim.init(params, rules=, specs=)``."""
    rules = rules if rules is not None else getattr(model, "rules", None)
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    on_mesh = {} if rules is None else {
        "rules": rules, "specs": model.param_specs(model.cfg, rules)}
    with record_function("train_step: loss"), _phase(rules, "loss"):
        loss, metrics = model.loss(batch, remat=remat, **(
            {} if rules is None else {"rules": rules}))
    with record_function("train_step: backward"), _phase(rules, "backward"):
        loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in params.items()}
    with record_function("train_step: optimizer"), \
            _phase(rules, "optimizer"):
        _, _, om = optim.apply(opt_cfg, params, grads, opt_state, **on_mesh)
    for p in params.values():
        p.grad = None
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}


def _phase(rules, name: str):
    return contextlib.nullcontext() if rules is None else \
        comm.counting_phase(name)


@torch.no_grad()
def prefill_step(model, batch: Dict[str, torch.Tensor],
                 rules: Optional[Rules] = None) -> torch.Tensor:
    """(B, V) next-token logits of ``batch["tokens"]`` (B, S) (optional
    ``batch["positions"]``, (B, S) or (3, B, S); ``batch["frames"]`` for
    the audio family); on a mesh under ``rules``."""
    kwargs = {}
    if model.cfg.family == "audio":
        kwargs["frames"] = batch["frames"]
    if rules is not None:
        kwargs["rules"] = rules
    logits, _aux = model(batch["tokens"], positions=batch.get("positions"),
                         last_only=True, **kwargs)
    return logits[:, 0]


@torch.no_grad()
def serve_step(model, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
               rules: Optional[Rules] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step, then the argmax of the logits: (next_tokens (B,)
    int32, cache); on a mesh under ``rules``."""
    kwargs = {} if rules is None else {"rules": rules}
    logits, cache = model.decode_step(cache, tokens, **kwargs)
    return logits.argmax(-1).to(torch.int32), cache
