"""Plain fp32 reference of the repo's Jamba hybrid (``perfbench/configs``
files with ``"reference": "jamba"``): periods of ``attn_period`` layers,
Mamba-2 mixers first and causal GQA attention with RoPE last, each mixer
followed by its MLP: a top-k MoE with its capacity FIFO on every
``moe.every_n_layers``-th layer, a dense SwiGLU elsewhere; pre-norm and a
residual around each; then the final norm and the head.

It follows the repo's definition of the model; where that departs from
the published Jamba v0.1 (Mamba-2 for Mamba-1, RoPE, attention last in
the period) the configuration file lists it under ``departures``.
Parameters are read under the names the benchmark draws them with
(``periods/...``, stacked over periods and layers), one layer's slice at
a time, upcast by ``linear`` one matrix at a time.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import common as c

MIXER = ("norm", "in_proj", "conv_w", "conv_b", "A_log", "D_skip",
         "dt_bias", "gate_norm", "out_proj")


@torch.no_grad()
def last_logits(cfg: Dict, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, linear: c.Linear = c.fp32_linear,
                stats=None, rule=None) -> torch.Tensor:
    """fp32 logits (1 + n, V) of the last position of ``tokens`` (S,):
    the reference's own, then each of its other paths under ``rule``
    (``common.Paths``); with ``stats`` (a list) each MoE layer's routing
    appended to it (``common.moe``)."""
    P = cfg["attn_period"]
    every = cfg["moe"]["every_n_layers"]
    eps = cfg["norm_eps"]
    x = c.embed(params, tokens)
    paths = c.Paths(rule, x)
    for per in range(cfg["num_layers"] // P):
        n_mix = n_dense = n_moe = 0
        for i in range(P):
            if i == P - 1:
                lp = c.layer_slice(params, "periods/",
                                   ("attn_norm", "wq", "wk", "wv", "wo"), per)
                x = paths.add(x, c.attention(
                    c.rms_norm(x, lp["attn_norm"], eps),
                    paths.normed(lp["attn_norm"], eps),
                    lp["wq"], lp["wk"], lp["wv"], lp["wo"], cfg, linear))
            else:
                lp = c.layer_slice(params, "periods/mamba_", MIXER, per,
                                   n_mix)
                n_mix += 1
                x = paths.add(x, c.mamba2_mixer(
                    c.rms_norm(x, lp["norm"], eps),
                    paths.normed(lp["norm"], eps), lp, cfg, linear))
            if i % every == every - 1:
                lp = c.layer_slice(params, "periods/",
                                   ("moe_norm", "router", "moe_gate",
                                    "moe_up", "moe_down"), per, n_moe)
                n_moe += 1
                x = paths.add(x, c.moe(
                    c.rms_norm(x, lp["moe_norm"], eps),
                    paths.normed(lp["moe_norm"], eps), lp["router"],
                    lp["moe_gate"], lp["moe_up"], lp["moe_down"], cfg,
                    linear, stats, rule, paths.scores))
            else:
                lp = c.layer_slice(params, "periods/",
                                   ("mlp_norm", "w_gate", "w_up", "w_down"),
                                   per, n_dense)
                n_dense += 1
                w = (lp["w_gate"], lp["w_up"], lp["w_down"], linear)
                x = paths.add(x, (
                    c.swiglu(c.rms_norm(x, lp["mlp_norm"], eps), *w),
                    c.swiglu(paths.normed(lp["mlp_norm"], eps), *w)))
    return paths.logits(x, params, cfg, linear)
