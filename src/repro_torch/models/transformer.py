"""Decoder-only transformer: the dense, MoE and VLM backbones (the port's
counterpart of ``repro.models.transformer``, for serving on one card).

Covers qwen2-72b, yi-34b, qwen1.5-32b, stablelm-3b, mixtral-8x7b,
moonshot-v1-16b-a3b and qwen2-vl-72b, and lends its attention block and
KV-cache write to the Jamba hybrid.  Parameters are stacked over layers
under the reference's names (``layers/wq`` is (L, D, H*hd), ...), so the
two packages run on the same weights.

On a CUDA tensor every attention layer of the forward goes through the
flash kernel (GQA read natively, the sliding window masked in the
kernel) and every expert FFN through the GMM kernel; on the CPU through
their plain versions.  Decode attention, the dense projections and the
LM head are plain tensor code.  A sliding-window cache is sized to the
window and wraps (``len % S_cache``), so in decode residency is the
window, as in the reference.

M-RoPE (``mrope_sections``) takes (3, B, S) positions.  The flash kernel
masks by token index, as the reference's flash path does; the
reference's ``ref`` path masks by the temporal stream ``positions[0]``,
which is the same for text positions (``ROADMAP.md`` C-5).

:meth:`Transformer.loss` is the reference's ``loss_fn`` and the forward's
``remat="full"`` its ``Rules.remat`` (each layer rematerialised in the
backward).  The reference's SPMD islands (``_attn_manual``,
``_mlp_manual``, ``_resolve_axis``, ``param_specs``, ``cache_specs``)
belong to the SPMD slice; without sharding rules its ``_decode_rules``
has nothing to rewrite, so it has no counterpart here.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention_op
from . import moe as moe_mod
from .attention import decode_attention
from .base import TableModule, run_layer
from .layers import embed_lookup, mrope, rms_norm, rope, swiglu

__all__ = ["param_table", "param_dtype", "init_rule", "attn_block",
           "scatter_kv", "scatter_pos", "Transformer"]

F32 = torch.float32


def param_table(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter (the reference's names)."""
    D, hd = cfg.d_model, cfg.head_dim
    H, K, F, V, L = (cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
                     cfg.vocab_size, cfg.num_layers)
    t = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tie_embeddings:
        t["lm_head"] = (D, V)
    lt = {
        "attn_norm": (L, D),
        "wq": (L, D, H * hd),
        "wk": (L, D, K * hd),
        "wv": (L, D, K * hd),
        "wo": (L, H * hd, D),
        "mlp_norm": (L, D),
    }
    if cfg.qkv_bias:
        lt.update(bq=(L, H * hd), bk=(L, K * hd), bv=(L, K * hd))
    if F > 0:
        lt.update(w_gate=(L, D, F), w_up=(L, D, F), w_down=(L, F, D))
    if cfg.moe is not None:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        lt.update(router=(L, D, E), moe_gate=(L, E, D, Fe),
                  moe_up=(L, E, D, Fe), moe_down=(L, E, Fe, D))
    t.update({f"layers/{k}": v for k, v in lt.items()})
    return t


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """fp32 for the router; else the config's parameter dtype."""
    return F32 if name.endswith("router") else cfg.param_dtype


def init_rule(name: str) -> str:
    """How the reference initialises a parameter: norms ones, the
    ``layers/b*`` biases zeros, the rest (the router included) dense."""
    if "norm" in name:
        return "ones"
    if name.startswith("layers/b"):
        return "zeros"
    return "dense"


def _rotate(t: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor) -> torch.Tensor:
    """RoPE, or M-RoPE when the config has ``mrope_sections``.
    t: (B, S, heads, hd); positions (B, S), or (3, B, S) for M-RoPE."""
    if cfg.mrope_sections is not None:
        return mrope(t, positions, cfg.mrope_sections, cfg.rope_theta)
    return rope(t, positions, cfg.rope_theta)


def attn_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
               cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm GQA attention with RoPE (or M-RoPE), the optional q/k/v
    biases and its residual, x (B, S, D).

    The reference repeats KV to the H query heads before attention when it
    runs without rules; the flash kernel reads the K KV heads natively
    (query head h reads KV head h // (H / K)), which gives the same
    result without the copy."""
    B, S, _D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = _rotate(q.reshape(B, S, H, hd), cfg, positions)
    k = _rotate(k.reshape(B, S, K, hd), cfg, positions)
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


def scatter_pos(pos: torch.Tensor, cur_len: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """Record position ``cur_len[b]`` at ``slot[b]`` of ``pos`` (B, S), in
    place; returns ``pos``."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    pos[rows, slot.long()] = cur_len.to(pos.dtype)
    return pos


class Transformer(TableModule):
    """The dense / MoE / VLM decoder-only LM, its parameters under the
    reference's names; see :class:`~repro_torch.models.base.TableModule`
    for ``params``."""

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(init_rule)

    @functools.cached_property
    def _layer_names(self) -> Tuple[str, ...]:
        return tuple(k.split("/", 1)[1] for k in param_table(self.cfg)
                     if k.startswith("layers/"))

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return self._stack("layers/", self._layer_names, i)

    def _head(self) -> torch.Tensor:
        return self._p("embed").T if self.cfg.tie_embeddings \
            else self._p("lm_head")

    def _mlp(self, x: torch.Tensor, lp: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The MLP (dense SwiGLU, MoE, or both) with its residual, x
        (B, S, D); returns (x, MoE aux loss)."""
        cfg = self.cfg
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        aux = torch.zeros((), dtype=F32, device=x.device)
        if cfg.moe is None:
            return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), aux
        out, aux = moe_mod.moe_block(
            h, {"router": lp["router"], "w_gate": lp["moe_gate"],
                "w_up": lp["moe_up"], "w_down": lp["moe_down"]}, cfg)
        if cfg.d_ff > 0:
            out = out + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        return x + out, aux

    def _block(self, x: torch.Tensor, i: int, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        lp = self._layer(i)
        return self._mlp(attn_block(x, lp, self.cfg, positions), lp)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False, remat: str = "none"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S or 1, V), MoE aux loss summed
        over layers).  ``positions``: (B, S), or (3, B, S) for M-RoPE;
        ``last_only`` computes the last position's logits only;
        ``remat="full"`` rematerialises each layer in the backward."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, B, S)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for i in range(cfg.num_layers):
            x, a = run_layer(self._block, remat, x, i, positions)
            aux = aux + a
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._head(), aux

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask`` and ``positions``): cross entropy plus ``AUX_COEF`` times
        the MoE aux loss, and {"ce", "moe_aux"}."""
        logits, aux = self(batch["tokens"], positions=batch.get("positions"),
                           remat=remat)
        return self._loss(logits, aux, batch, moe=True)

    def cache_len(self, max_seq: int) -> int:
        """Sequence length of the KV cache: the window, when it is
        shorter than ``max_seq``."""
        w = self.cfg.sliding_window
        return max_seq if w is None else min(w, max_seq)

    def init_cache(self, batch: int, max_seq: int,
                   filled: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: KV (L, B, S_cache, K, hd),
        the position held in each cache row ``pos`` (B, S_cache) (-1 where
        empty) and the filled length ``len`` (B,)."""
        cfg, dev = self.cfg, self.device
        S = self.cache_len(max_seq)
        filled = 0 if filled is None else filled
        shape = (cfg.num_layers, batch, S, cfg.num_kv_heads, cfg.head_dim)
        idx = torch.arange(S, dtype=torch.int32, device=dev)
        pos = torch.where(idx < filled, idx, -1)
        return {
            "k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "pos": pos.expand(batch, S).contiguous(),
            "len": torch.full((batch,), filled, dtype=torch.int32,
                              device=dev),
        }

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor,
                    positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) to every sequence of the cache and return
        (logits (B, V), cache).  ``positions`` defaults to ``len`` (for
        M-RoPE broadcast to (3, B)).  The K, V and ``pos`` tensors of
        ``cache`` are updated in place (the reference returns new arrays);
        ``len`` is a new tensor."""
        cfg = self.cfg
        B = tokens.shape[0]
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cur_len = cache["len"]
        if positions is None:
            positions = cur_len.to(torch.int32)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, B)
        pos = positions[..., None]                      # (B, 1) / (3, B, 1)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        slot = cur_len % cache["k"].shape[2]            # a window wraps
        for i in range(cfg.num_layers):
            lp = self._layer(i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
            if cfg.qkv_bias:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            q = _rotate(q.reshape(B, 1, H, hd), cfg, pos)[:, 0]
            k = _rotate(k.reshape(B, 1, K, hd), cfg, pos)
            k_c = scatter_kv(cache["k"][i], k, slot)
            v_c = scatter_kv(cache["v"][i], v.reshape(B, 1, K, hd), slot)
            # no window mask: the cache is sized to the window and wraps
            att = decode_attention(q, k_c, v_c, cur_len + 1)
            x = x + att.reshape(B, H * hd) @ lp["wo"]
            x2, _aux = self._mlp(x[:, None], lp)
            x = x2[:, 0]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        scatter_pos(cache["pos"], cur_len, slot)
        return x @ self._head(), {**cache, "len": cur_len + 1}
