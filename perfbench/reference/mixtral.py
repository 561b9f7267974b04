"""Plain fp32 reference of a Mixtral-style decoder (``perfbench/configs``
files with ``"reference": "mixtral"``): per layer pre-norm causal GQA
attention with RoPE (and the sliding window when the configuration has
one), then pre-norm top-k MoE with its capacity FIFO, each with its
residual; then the final norm and the head.  Parameters are read under
the names the benchmark draws them with (``layers/...``, stacked over
layers), one layer's slice at a time, upcast by ``linear`` one matrix at
a time."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import common as c


@torch.no_grad()
def last_logits(cfg: Dict, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, linear: c.Linear = c.fp32_linear,
                stats=None, rule=None) -> torch.Tensor:
    """fp32 logits (1 + n, V) of the last position of ``tokens`` (S,):
    the reference's own, then each of its other paths under ``rule``
    (``common.Paths``); with ``stats`` (a list) each MoE layer's routing
    appended to it (``common.moe``)."""
    eps = cfg["norm_eps"]
    x = c.embed(params, tokens)
    paths = c.Paths(rule, x)
    for i in range(cfg["num_layers"]):
        lp = c.layer_slice(params, "layers/",
                           ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                            "router", "moe_gate", "moe_up", "moe_down"), i)
        x = paths.add(x, c.attention(
            c.rms_norm(x, lp["attn_norm"], eps),
            paths.normed(lp["attn_norm"], eps),
            lp["wq"], lp["wk"], lp["wv"], lp["wo"], cfg, linear))
        x = paths.add(x, c.moe(
            c.rms_norm(x, lp["mlp_norm"], eps),
            paths.normed(lp["mlp_norm"], eps), lp["router"], lp["moe_gate"],
            lp["moe_up"], lp["moe_down"], cfg, linear, stats, rule,
            paths.scores))
    return paths.logits(x, params, cfg, linear)
