"""The serving steps (the port's counterpart of the prefill and
decode steps of ``repro.launch.step``, one card, no sharding rules).

* ``prefill_step`` — forward, last-token logits only;
* ``serve_step``   — one ``decode_step`` against the KV cache, then greedy
                     next tokens.

The reference's ``make_prefill_step(cfg, rules)`` and
``make_serve_step(cfg, rules)`` build closures over the config and the
sharding rules; on one card there is nothing to close over, so these are
plain functions of the model (an ``nn.Module`` from
``repro_torch.models.get_model``).  ``batch["positions"]`` is passed
through as the reference passes it: (B, S), or (3, B, S) for Qwen2-VL's
M-RoPE; for the ``audio`` family (Whisper) ``batch["frames"]`` (B,
encoder_seq, D) too.  The training step is a later slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["prefill_step", "serve_step"]


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


def serve_step(model, cache: Dict[str, torch.Tensor], tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step, then the argmax of the logits: (next_tokens (B,)
    int32, cache)."""
    logits, cache = model.decode_step(cache, tokens)
    return logits.argmax(-1).to(torch.int32), cache
