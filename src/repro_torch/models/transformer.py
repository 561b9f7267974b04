"""The parts of the decoder-only transformer that the Jamba hybrid uses
(the port's counterpart of those parts of ``repro.models.transformer``):
the attention block on one card and the KV-cache write of decode.

The dense and MoE transformer LMs, with their sliding-window cache, are a
later slice.  Without sharding rules the reference's ``_decode_rules`` has
nothing to rewrite, so it has no counterpart here.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention_op
from .layers import rms_norm, rope

__all__ = ["attn_block", "scatter_kv"]


def attn_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
               cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm GQA attention with RoPE and its residual, x (B, S, D).

    The reference repeats KV to the H query heads before attention when it
    runs without rules; the flash kernel reads the K KV heads natively
    (query head h reads KV head h // (H / K)), which gives the same
    result without the copy."""
    B, S, _D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, K, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, K, hd)
    out = flash_attention_op(q, k, v, causal=True, window=cfg.sliding_window)
    return x + out.reshape(B, S, H * hd) @ lp["wo"]


def scatter_kv(cache: torch.Tensor, new: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, 1, K, hd) into ``cache`` (B, S, K, hd) at
    sequence position ``slot[b]`` of each row, in place; returns the
    cache."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new[:, 0].to(cache.dtype)
    return cache
