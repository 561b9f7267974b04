"""Decoder-only transformer: the dense, MoE and VLM backbones (the port's
counterpart of ``repro.models.transformer``), on one card or on a mesh of
ranks.

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
``remat="full"`` / ``"dots"`` its ``Rules.remat`` (each layer
rematerialised in the backward).

**On a mesh** (``Transformer(cfg, device, params, rules=rules)``, every
rank running the same code on its own block; ``rules`` from
``repro_torch.parallel.sharding``).  :func:`param_specs` is the
reference's table of parameter shardings and :func:`shard_params` cuts a
rank's block out of full parameters (``convert.init_params(...,
rules=)`` draws them so).  The forward and ``decode_step`` take the
global tokens on every rank and return the global logits on every rank.
Inside, the activations are the reference's layout: rows over
``rules.batch``, the sequence over ``model`` (Megatron SP), and

* the embedding is vocab-sharded: each rank looks up the tokens of its
  vocabulary block and the blocks are reduce-scattered straight to the
  sequence-sharded layout; the LM head's vocab blocks are all-gathered;
* attention is the reference's Megatron island (:func:`_attn_manual`,
  where :func:`_manual_tp_ok`): the normed input all-gathered once, this
  column's q heads and GQA KV slice, RoPE or M-RoPE, the flash kernel at
  the local heads, ``wo``, then a reduce-scatter back to
  sequence-sharded (a sum where the sequence does not divide);
* the dense MLP is its SwiGLU island (:func:`_mlp_manual`); the MoE FFN
  is ``moe.moe_block``'s dispatch mode;
* where the reference leaves a layer to GSPMD (``manual_tp=False``, or
  heads that do not land whole on each column), the port gathers that
  layer's weight blocks over their axes and computes the single-card
  layer on the gathered sequence, keeping its own sequence block: the
  same function in a layout of the port's own choosing;
* decode keeps the KV cache sharded over ``batch`` and ``kv_seq``
  (:func:`cache_specs`): the new token's K/V are written by the rank that
  owns its slot, and attention combines the slabs' partial softmax
  statistics (``attention.decode_attention``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (Layout, Rules, cut_block,
                                           entry_index, entry_names,
                                           join_blocks, spec_axes,
                                           zero1_spec)
from . import moe as moe_mod
from .attention import decode_attention
from .base import TableModule, run_layer
from .layers import embed_lookup, mrope, rms_norm, rope, swiglu

__all__ = ["param_table", "param_dtype", "init_rule", "attn_block",
           "mlp_block", "layer_apply",
           "scatter_kv", "scatter_pos", "Transformer", "param_specs",
           "layout_specs", "shard_table", "shard_params", "gather_params",
           "cache_specs"]

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


# ---------------------------------------------------------------------------
# sharding of the parameters (the reference's ``param_table`` axes,
# ``_resolve_axis`` and ``param_specs``)
# ---------------------------------------------------------------------------

def param_labels(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Name -> the logical axis of each dimension, the reference table's:
    "vocab" | "heads" | "kv_heads" | "ff" | "experts" | "ff_expert" |
    None (the leading layer dimension included)."""
    t = {"embed": ("vocab", None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        t["lm_head"] = (None, "vocab")
    lt = {"attn_norm": (None, None), "wq": (None, None, "heads"),
          "wk": (None, None, "kv_heads"), "wv": (None, None, "kv_heads"),
          "wo": (None, "heads", None), "mlp_norm": (None, None)}
    if cfg.qkv_bias:
        lt.update(bq=(None, "heads"), bk=(None, "kv_heads"),
                  bv=(None, "kv_heads"))
    if cfg.d_ff > 0:
        lt.update(w_gate=(None, None, "ff"), w_up=(None, None, "ff"),
                  w_down=(None, "ff", None))
    if cfg.moe is not None:
        exp = (None, "experts", None, "ff_expert")
        lt.update(router=(None, None, None), moe_gate=exp, moe_up=exp,
                  moe_down=(None, "experts", "ff_expert", None))
    t.update({f"layers/{k}": v for k, v in lt.items()})
    return t


def _resolve_axis(cfg: ModelConfig, rules: Rules, label, size: int):
    """The mesh axes a dimension labelled ``label`` of ``size`` is laid
    over (the reference's ``_resolve_axis``; divisibility is checked on the
    flat weight dimension).  Expert weights are sharded over ``experts``
    (EP) where E divides it, else their FFN width over ``ff``.  One
    difference: under ``dispatch="local"`` they are held FFN-sharded, as
    ``_moe_local`` reads them, where the reference's table shards them
    over experts and GSPMD reshards them inside every layer."""
    if label is None:
        return None
    if label in ("heads", "kv_heads"):
        return rules.dim_axis(rules.heads, size)
    if label in ("vocab", "ff"):
        return rules.dim_axis(getattr(rules, label), size)
    ep = rules.axis_size(rules.experts)
    use_ep = cfg.moe is not None and ep > 1 and \
        cfg.moe.num_experts % ep == 0 and rules.dispatch not in ("tp",
                                                                 "local")
    if label == "experts":
        return rules._clean(rules.experts) if use_ep else None
    if label == "ff_expert":
        return None if use_ep else rules.dim_axis(rules.ff, size)
    raise KeyError(label)


def layout_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """Name -> the mesh axes of each dimension (None: whole on every
    rank) as the islands read the parameters: the reference's
    ``param_specs``."""
    table = param_table(cfg)
    return {name: tuple(_resolve_axis(cfg, rules, a, table[name][d])
                        for d, a in enumerate(labels))
            for name, labels in param_labels(cfg).items()}


def param_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """Name -> the mesh axes of each dimension of the blocks a rank
    holds: :func:`layout_specs`, and under ``rules.fsdp`` each banked over
    ``zero1`` as the reference's ``build_cell`` banks a training cell's
    parameters (``parallel.sharding.zero1_spec``; ZeRO-3).  The forward
    all-gathers a banked weight over ``zero1`` before it is used
    (:meth:`Transformer._use`)."""
    specs = layout_specs(cfg, rules)
    if not rules.fsdp:
        return specs
    table = param_table(cfg)
    return {k: zero1_spec(v, table[k], rules) for k, v in specs.items()}


def shard_table(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """Name -> the shape of this rank's block of each parameter."""
    table = param_table(cfg)
    return {name: tuple(n // rules.axis_size(a)
                        for n, a in zip(table[name], axes))
            for name, axes in param_specs(cfg, rules).items()}


def shard_params(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 rules: Rules) -> Dict[str, torch.Tensor]:
    """Full parameters (every rank holding the same) -> this rank's
    blocks, the shapes of :func:`shard_table`."""
    return {name: cut_block(params[name], axes, rules)
            for name, axes in param_specs(cfg, rules).items()}


def gather_params(cfg: ModelConfig, shards: Dict[str, torch.Tensor],
                  rules: Rules) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params` (collective; for tests and the
    smoke)."""
    return {name: join_blocks(shards[name], axes, rules)
            for name, axes in param_specs(cfg, rules).items()}


def cache_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """The decode cache's sharding: KV (L, B, S, K, hd) over ``batch``
    and ``kv_seq``, ``pos`` (B, S) likewise, ``len`` (B,) over
    ``batch``."""
    b, s = rules._clean(rules.batch), rules._clean(rules.kv_seq)
    return {"k": (None, b, s, None, None), "v": (None, b, s, None, None),
            "pos": (b, s), "len": (b,)}


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


def mlp_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP (dense SwiGLU, MoE, or both) with its residual, x
    (B, S, D); returns (x, MoE aux loss)."""
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


def layer_apply(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer on one card (the reference's ``_layer_body`` with
    ``rules=None``): attention, then the MLP; ``lp`` holds the layer's
    slice of every ``layers/`` parameter under its short name.  Returns
    (x, MoE aux loss).  A pipeline stage's body loops it over its
    layers."""
    return mlp_block(attn_block(x, lp, cfg, positions), lp, cfg)


# ---------------------------------------------------------------------------
# the SPMD islands (each runs on this rank's block)
# ---------------------------------------------------------------------------

def _manual_tp_ok(cfg: ModelConfig, rules: Optional[Rules]) -> bool:
    """Explicit-island Megatron TP applies when whole q heads land on
    each column and the per-column heads align with GQA groups."""
    if rules is None or not rules.manual_tp or rules.heads != "model" \
            or not rules.has_axis("model"):
        return False
    tp = rules.axis_size("model")
    H, K = cfg.num_heads, cfg.num_kv_heads
    if tp <= 1 or H % tp:
        return False
    hq, g = H // tp, H // K
    return hq % g == 0 or g % hq == 0


def _seq_gather(h: torch.Tensor, rules: Rules, lay: Layout) -> torch.Tensor:
    return comm.all_gather(h, rules.mesh, "model", 1) if lay.seq else h


def _seq_return(out: torch.Tensor, rules: Rules, lay: Layout):
    """A partial (b, S, D) sum over ``model`` back to this rank's block:
    reduce-scattered over the sequence, or summed."""
    if lay.seq:
        return comm.reduce_scatter(out, rules.mesh, "model", 1)
    return comm.all_reduce(out, rules.mesh, "model")


def _attn_manual(x, lp, cfg: ModelConfig, rules: Rules, positions,
                 lay: Layout):
    """Megatron TP attention (the reference's ``shard_map`` island over
    ``model``): all-gather the normed block input once, project into this
    column's q heads and its GQA KV slice, attend with the flash kernel at
    the local heads, and reduce-scatter the ``wo`` product straight back
    to the sequence-sharded layout.  Collectives per layer: 1 AG(h) + 2
    AG(k, v) + 1 RS(out).  ``positions``: this rank's rows, the whole
    sequence."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = rules.axis_size("model")
    hq, g = H // tp, H // K
    kv_w = max(hq // g, 1)                       # KV heads per column
    col = rules.mesh.index("model")
    h = _seq_gather(rms_norm(x, lp["attn_norm"], cfg.norm_eps), rules, lay)
    bl, sl, _ = h.shape
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # k/v columns hold K*hd/tp lanes: gather whole KV heads, take this
    # column's GQA slice
    kv0 = (col * hq) // g
    k = comm.all_gather(k, rules.mesh, "model", 2).reshape(bl, sl, K, hd)
    v = comm.all_gather(v, rules.mesh, "model", 2).reshape(bl, sl, K, hd)
    k, v = k[:, :, kv0:kv0 + kv_w], v[:, :, kv0:kv0 + kv_w]
    q = _rotate(q.reshape(bl, sl, hq, hd), cfg, positions)
    k = _rotate(k, cfg, positions)
    out = flash_attention_op(q, k, v, causal=True,
                             window=cfg.sliding_window)
    out = (out.reshape(bl, sl, hq * hd) @ lp["wo"]).to(x.dtype)
    return x + _seq_return(out, rules, lay)


def _mlp_manual(x, lp, cfg: ModelConfig, rules: Rules, lay: Layout):
    """Megatron TP SwiGLU island: AG(h) -> local F/tp -> RS(out)."""
    h = _seq_gather(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), rules, lay)
    out = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]).to(x.dtype)
    return x + _seq_return(out, rules, lay)


def _whole(lp, specs, names, rules: Rules):
    """The named layer parameters with their blocks gathered (the layer
    dimension of ``specs`` dropped)."""
    return {k: join_blocks(lp[k], specs["layers/" + k][1:], rules)
            for k in names if k in lp}


def _attn_gathered(x, lp, cfg: ModelConfig, rules: Rules, positions,
                   lay: Layout, specs):
    """Attention where the reference lets GSPMD place the layer: the port
    gathers the weights and the sequence and runs the single-card block,
    keeping this rank's sequence block."""
    w = _whole(lp, specs, ("attn_norm", "wq", "wk", "wv", "wo", "bq",
                           "bk", "bv"), rules)
    y = attn_block(_seq_gather(x, rules, lay), w, cfg, positions)
    return y[:, lay.positions(rules, y.shape[1])]


def _decode_rules(rules: Optional[Rules]) -> Optional[Rules]:
    """Decode's MoE rules: tokens replicated over the sequence, and the
    ``xy`` dispatch (which needs a sharded sequence) left to divisibility
    (``auto``)."""
    if rules is None:
        return None
    return dataclasses.replace(rules, seq=None,
                               dispatch="auto" if rules.dispatch == "xy"
                               else rules.dispatch)


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
    shard_table = staticmethod(shard_table)
    param_specs = staticmethod(param_specs)

    def _rules(self, rules: Optional[Rules]) -> Optional[Rules]:
        """The rules of a call: ``rules``, else the model's own.  Rules
        that lay the parameters out otherwise than the model holds them
        are refused."""
        if rules is None or rules is self.rules:
            return self.rules
        held = self.param_table(self.cfg) if self.rules is None \
            else shard_table(self.cfg, self.rules)
        if shard_table(self.cfg, rules) != held:
            raise ValueError("these rules shard the parameters otherwise "
                             "than the model holds them")
        return rules

    @functools.cached_property
    def _layer_names(self) -> Tuple[str, ...]:
        return tuple(k.split("/", 1)[1] for k in param_table(self.cfg)
                     if k.startswith("layers/"))

    @functools.cached_property
    def _banked(self) -> Dict[str, Tuple[int, Tuple[str, ...]]]:
        """Under FSDP, name -> (the dimension banked over ``zero1``, the
        ``zero1`` axes) of each parameter held as a bank."""
        if self.rules is None or not self.rules.fsdp:
            return {}
        held = param_specs(self.cfg, self.rules)
        out = {}
        for k, spec in layout_specs(self.cfg, self.rules).items():
            for d, (a, b) in enumerate(zip(held[k], spec)):
                if a != b:
                    out[k] = (d, entry_names(a)[len(entry_names(b)):])
        return out

    def _gather_bank(self, name: str, t: torch.Tensor, dim: int
                     ) -> torch.Tensor:
        """``t`` (a bank, or a slice of one whose banked dimension is now
        ``dim``) all-gathered over ``zero1`` (autograd: the backward
        reduce-scatters the gradient into the bank)."""
        for a in reversed(self._banked[name][1]):
            t = comm.all_gather(t, self.rules.mesh, a, dim)
        return t

    def _use(self, name: str) -> torch.Tensor:
        """Parameter ``name`` as the islands read it: this rank's block,
        a bank all-gathered first under FSDP."""
        t = self._p(name)
        if name in self._banked:
            t = self._gather_bank(name, t, self._banked[name][0])
        return t

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        if not self._banked:
            return self._stack("layers/", self._layer_names, i)
        out = {}
        for k in self._layer_names:
            name = "layers/" + k
            if name not in self._banked:
                out[k] = self._p(name)[i]
            elif self._banked[name][0] == 0:       # the layer dim: whole
                out[k] = self._use(name)[i]
            else:
                out[k] = self._gather_bank(name, self._p(name)[i],
                                           self._banked[name][0] - 1)
        return out

    def _head(self) -> torch.Tensor:
        return self._p("embed").T if self.cfg.tie_embeddings \
            else self._p("lm_head")

    def _block(self, x: torch.Tensor, i: int, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return layer_apply(x, self._layer(i), self.cfg, positions)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False, remat: str = "none",
                rules: Optional[Rules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S or 1, V), MoE aux loss summed
        over layers).  ``positions``: (B, S), or (3, B, S) for M-RoPE;
        ``last_only`` computes the last position's logits only;
        ``remat="full"`` rematerialises each layer in the backward.  On a
        mesh (the model's ``rules``, or ``rules`` laying the parameters
        out alike) every rank passes the global tokens and positions and
        gets the global logits."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, B, S)
        rules = self._rules(rules)
        if rules is not None:
            return self._spmd_forward(tokens, positions, last_only, rules,
                                      remat)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for i in range(cfg.num_layers):
            x, a = run_layer(self._block, remat, x, i, positions)
            aux = aux + a
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._head(), aux

    # -- on a mesh ---------------------------------------------------------
    def _embed(self, tokens: torch.Tensor, rules: Rules, lay: Layout,
               specs) -> torch.Tensor:
        """This rank's block (b, s, D) of the embedding of its rows'
        ``tokens`` (b, S).  A vocab-sharded table: each rank looks up the
        tokens of its block (zeros elsewhere) and the blocks are summed
        (one non-zero term: exact), reduce-scattered straight to the
        sequence block where the sequence is sharded over the same
        axis."""
        table, va = self._use("embed"), specs["embed"][0]
        S = tokens.shape[1]
        if va is None:
            x = embed_lookup(table, tokens)[:, lay.positions(rules, S)]
            return x.to(self.cfg.param_dtype)
        n = table.shape[0]
        local = tokens - entry_index(rules.mesh, va) * n
        ok = (local >= 0) & (local < n)
        x = torch.where(ok[..., None], embed_lookup(table,
                                                    local.clamp(0, n - 1)),
                        0)
        if lay.seq and rules.mesh.names(va) == ("model",):
            x = comm.reduce_scatter(x, rules.mesh, "model", 1)
        else:
            x = comm.all_reduce(x, rules.mesh, va)
            x = x[:, lay.positions(rules, S)]
        return x.to(self.cfg.param_dtype)

    def _spmd_head(self, specs) -> Tuple[torch.Tensor, object]:
        """(this rank's block of the LM head (D, V / n), the axes of its
        vocabulary)."""
        if self.cfg.tie_embeddings:
            return self._use("embed").T, specs["embed"][0]
        return self._use("lm_head"), specs["lm_head"][1]

    def _logits(self, x: torch.Tensor, rules: Rules, lay: Layout,
                specs) -> torch.Tensor:
        """The global logits (B, s, V) of this rank's final hidden rows x
        (b, s, D) (every column holding the same rows): the vocab blocks
        all-gathered, then the batch rows."""
        x = rms_norm(x, self._use("final_norm"), self.cfg.norm_eps)
        head, va = self._spmd_head(specs)
        logits = x @ head
        if va is not None:
            logits = comm.all_gather(logits, rules.mesh, va, logits.dim() - 1)
        if lay.batch is not None:
            logits = comm.all_gather(logits, rules.mesh, lay.batch, 0)
        return logits

    def _spmd_mlp(self, x: torch.Tensor, lp, rules: Rules, lay: Layout,
                  specs, decode: bool = False):
        """The MLP with its residual on this rank's block; (x, aux)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=F32, device=x.device)
        ff = specs["layers/w_gate"][2] if cfg.d_ff > 0 else None
        if cfg.moe is None and ff == "model" and (rules.manual_tp or decode):
            return _mlp_manual(x, lp, cfg, rules, lay), aux
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        out = 0
        if cfg.moe is not None:
            out, aux = moe_mod.moe_block(
                h, {"router": lp["router"], "w_gate": lp["moe_gate"],
                    "w_up": lp["moe_up"], "w_down": lp["moe_down"]}, cfg,
                _decode_rules(rules) if decode else rules, lay)
        if cfg.d_ff > 0:
            w = _whole(lp, specs, ("w_gate", "w_up", "w_down"), rules)
            out = out + swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
        return x + out, aux

    def _spmd_layer(self, x, i: int, pos, rules: Rules, lay: Layout, specs,
                    manual: bool):
        """Layer ``i`` on this rank's block: its attention island, then
        its MLP; (x, aux).  Under FSDP the layer's banked weights are
        all-gathered first (inside: ``remat="full"`` gathers them again
        in the backward)."""
        lp = self._layer(i)
        if manual:
            x = _attn_manual(x, lp, self.cfg, rules, pos, lay)
        else:
            x = _attn_gathered(x, lp, self.cfg, rules, pos, lay, specs)
        return self._spmd_mlp(x, lp, rules, lay, specs)

    def _spmd_trunk(self, tokens, positions, rules: Rules, lay: Layout,
                    remat: str):
        """The embedding and every layer on this rank's block of the
        global ``tokens``: (x (b, s, D), the MoE aux loss summed over
        layers, the same on every rank)."""
        cfg = self.cfg
        rows = lay.rows(rules, tokens.shape[0])
        pos = positions[..., rows, :]
        specs = layout_specs(cfg, rules)
        x = self._embed(tokens[rows], rules, lay, specs)
        aux = torch.zeros((), dtype=F32, device=x.device)
        body = functools.partial(self._spmd_layer, rules=rules, lay=lay,
                                 specs=specs,
                                 manual=_manual_tp_ok(cfg, rules))
        for i in range(cfg.num_layers):
            x, a = run_layer(body, remat, x, i, pos)
            aux = aux + a
        return x, aux

    def _spmd_forward(self, tokens, positions, last_only: bool,
                      rules: Rules, remat: str = "none"):
        B, S = tokens.shape
        lay = Layout.of(rules, B, S)
        specs = layout_specs(self.cfg, rules)
        x, aux = self._spmd_trunk(tokens, positions, rules, lay, remat)
        if last_only:
            x = x[:, -1:]
            if lay.seq:       # the last position lives on the last column
                last = rules.mesh.index("model") == \
                    rules.axis_size("model") - 1
                x = comm.all_reduce(x if last else torch.zeros_like(x),
                                    rules.mesh, "model")
        else:
            x = _seq_gather(x, rules, lay)
        return self._logits(x, rules, lay, specs), aux

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none",
             rules: Optional[Rules] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask`` and ``positions``): cross entropy plus ``AUX_COEF`` times
        the MoE aux loss, and {"ce", "moe_aux"}.  On a mesh every rank
        passes the global batch and gets the global loss, whose backward
        is this rank's share (``TableModule._mesh_loss``; the convention
        of ``repro_torch.parallel.comm``)."""
        rules = self._rules(rules)
        if rules is not None:
            return self._spmd_loss(batch, remat, rules)
        logits, aux = self(batch["tokens"], positions=batch.get("positions"),
                           remat=remat)
        return self._loss(logits, aux, batch, moe=True)

    def _spmd_loss(self, batch, remat: str, rules: Rules):
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
            if self.cfg.mrope_sections is not None:
                positions = positions.expand(3, B, S)
        lay = Layout.of(rules, B, S)
        x, aux = self._spmd_trunk(tokens, positions, rules, lay, remat)
        nll, count = self._spmd_ce(x, batch, rules, lay,
                                   layout_specs(self.cfg, rules))
        return self._mesh_loss(nll, count, aux, rules, moe=True)

    def _spmd_ce(self, x, batch, rules: Rules, lay: Layout, specs):
        """(the masked cross-entropy sum of the tokens this rank counts,
        their mask's sum) from its final hidden block x (b, s, D).  Each
        token is counted on exactly one rank: its rows' and positions'
        owner, the first rank along every axis that neither the rows nor
        the positions are laid over.  A vocab-sharded head takes a
        vocab-parallel log-sum-exp: the ranks of the vocabulary's axes
        hold the same tokens (the sequence gathered; the rows too where
        the vocabulary shares an axis with them), each its logits'
        vocabulary block, and reduce the shift (max), the exponentials'
        sum and the label's logit over them; no logits are gathered."""
        cfg, mesh = self.cfg, rules.mesh
        labels, mask = batch["labels"], batch.get("mask")
        B, S = labels.shape
        if mask is None:
            mask = torch.ones((B, S), dtype=F32, device=labels.device)
        rows, cols = lay.rows(rules, B), lay.positions(rules, S)
        x = rms_norm(x, self._use("final_norm"), cfg.norm_eps)
        head, va = self._spmd_head(specs)
        if va is None:
            logits = (x @ head).to(F32)
            lab = labels[rows][:, cols].long()
            nll = torch.logsumexp(logits, -1) - \
                logits.gather(-1, lab[..., None])[..., 0]
        else:
            x = _seq_gather(x, rules, lay)
            whole = lay.batch is not None and rules.overlaps(va, lay.batch)
            if whole:
                x = comm.all_gather(x, mesh, lay.batch, 0)
            logits = (x @ head).to(F32)
            n = logits.shape[-1]
            loc = (labels if whole else labels[rows]).long() - \
                entry_index(rules.mesh, va) * n
            top = comm.all_reduce(logits.detach().amax(-1), mesh, va, "max")
            se = comm.all_reduce(torch.exp(logits - top[..., None]).sum(-1),
                                 mesh, va)
            ok = (loc >= 0) & (loc < n)
            gold = logits.gather(-1, loc.clamp(0, n - 1)[..., None])[..., 0]
            gold = comm.all_reduce(torch.where(ok, gold, 0), mesh, va)
            nll = top + torch.log(se) - gold
            nll = (nll[rows] if whole else nll)[:, cols]
        held = set(spec_axes((lay.batch, "model" if lay.seq else None)))
        owner = all(mesh.index(a) == 0 for a in mesh.axis_names
                    if a not in held)
        w = mask[rows][:, cols].to(F32) * float(owner)
        return (nll * w).sum(), w.sum()

    def cache_len(self, max_seq: int) -> int:
        """Sequence length of the KV cache: the window, when it is
        shorter than ``max_seq``."""
        w = self.cfg.sliding_window
        return max_seq if w is None else min(w, max_seq)

    def init_cache(self, batch: int, max_seq: int,
                   filled: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: KV (L, B, S_cache, K, hd),
        the position held in each cache row ``pos`` (B, S_cache) (-1 where
        empty) and the filled length ``len`` (B,).  On a mesh, this rank's
        block of it (:func:`cache_specs`): its rows and its slab of the
        sequence."""
        cfg, dev, rules = self.cfg, self.device, self.rules
        S = self.cache_len(max_seq)
        filled = 0 if filled is None else filled
        idx = torch.arange(S, dtype=torch.int32, device=dev)
        if rules is not None:
            kv = rules._clean(rules.kv_seq)
            if S % rules.axis_size(kv):
                raise ValueError(f"a cache of {S} positions does not "
                                 f"divide over kv_seq {kv}")
            n = S // rules.axis_size(kv)
            idx = idx[rules.mesh.index(kv) * n:][:n] if kv else idx
            lay = Layout(rules.dim_axis(rules.batch, batch), False)
            self._cache_rows = lay.rows(rules, batch)
            batch = len(range(batch)[self._cache_rows])
        shape = (cfg.num_layers, batch, len(idx), cfg.num_kv_heads,
                 cfg.head_dim)
        pos = torch.where(idx < filled, idx, -1)
        return {
            "k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "pos": pos.expand(batch, len(idx)).contiguous(),
            "len": torch.full((batch,), filled, dtype=torch.int32,
                              device=dev),
        }

    def reset_slot(self, cache: Dict[str, torch.Tensor], s: int) -> None:
        """Start slot ``s`` (a global row) afresh; on a mesh only the
        ranks holding that row of the cache of :meth:`init_cache` touch
        it."""
        if self.rules is not None:
            rows = self._cache_rows          # of the last init_cache
            if not rows.start <= s < rows.stop:
                return
            s -= rows.start
        super().reset_slot(cache, s)

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    rules: Optional[Rules] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) to every sequence of the cache and return
        (logits (B, V), cache).  ``positions`` defaults to ``len`` (for
        M-RoPE broadcast to (3, B)).  The K, V and ``pos`` tensors of
        ``cache`` are updated in place (the reference returns new arrays);
        ``len`` is a new tensor.  On a mesh every rank passes the global
        tokens (and positions) with its own cache block and gets the
        global logits."""
        rules = self._rules(rules)
        if rules is not None:
            return self._spmd_decode(cache, tokens, positions, rules)
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
            x2, _aux = mlp_block(x[:, None], lp, self.cfg)
            x = x2[:, 0]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        scatter_pos(cache["pos"], cur_len, slot)
        return x @ self._head(), {**cache, "len": cur_len + 1}

    def _spmd_decode(self, cache, tokens, positions, rules: Rules):
        """``decode_step`` on a mesh: this rank's rows (``rules.batch``,
        where the batch divides) against its slab of the cache
        (``kv_seq``).  The projections run on this rank's weight blocks
        and gather their head blocks; the slot's owner writes the new K/V
        (a remote store to the owning shard); attention partials combine
        over ``kv_seq``; ``wo`` and the dense MLP are row-parallel sums;
        the MoE FFN runs under ``_decode_rules``."""
        cfg, mesh = self.cfg, rules.mesh
        B = tokens.shape[0]
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lay = Layout(rules.dim_axis(rules.batch, B), False)
        rows = lay.rows(rules, B)
        specs = layout_specs(cfg, rules)
        cur_len = cache["len"]
        b = cur_len.shape[0]
        if positions is None:
            positions = cur_len.to(torch.int32)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, b)
        else:
            positions = positions[..., rows]
        pos = positions[..., None]
        kv = rules._clean(rules.kv_seq)
        s_l = cache["k"].shape[2]
        slot = cur_len % (s_l * rules.axis_size(kv))     # a window wraps
        here = slot - (mesh.index(kv) * s_l if kv else 0)
        mine = (here >= 0) & (here < s_l)                # this slab's slot
        here = here.clamp(0, s_l - 1)
        brow = torch.arange(b, device=slot.device)
        x = self._embed(tokens[rows][:, None], rules, lay, specs)[:, 0]

        def cols(h, lp, w, bias):
            y = h @ lp[w]
            if cfg.qkv_bias:
                y = y + lp[bias]
            a = specs["layers/" + w][2]
            return y if a is None else comm.all_gather(y, mesh, a, 1)

        def write(c, new):
            c[brow, here] = torch.where(mine[:, None, None],
                                        new.to(c.dtype), c[brow, here])
            return c

        for i in range(cfg.num_layers):
            lp = self._layer(i)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            q = _rotate(cols(h, lp, "wq", "bq").reshape(b, 1, H, hd), cfg,
                        pos)[:, 0]
            k = _rotate(cols(h, lp, "wk", "bk").reshape(b, 1, K, hd), cfg,
                        pos)[:, 0]
            v = cols(h, lp, "wv", "bv").reshape(b, K, hd)
            k_c, v_c = write(cache["k"][i], k), write(cache["v"][i], v)
            att = decode_attention(q, k_c, v_c, cur_len + 1, rules=rules)
            att = att.reshape(b, H * hd)
            ha = specs["layers/wo"][1]
            if ha is None:
                x = x + att @ lp["wo"]
            else:
                n = H * hd // rules.axis_size(ha)
                part = att[:, mesh.index(ha) * n:][:, :n] @ lp["wo"]
                x = x + comm.all_reduce(part, mesh, ha)
            x2, _aux = self._spmd_mlp(x[:, None], lp, rules, lay, specs,
                                      decode=True)
            x = x2[:, 0]
        cur = cache["pos"][brow, here]
        cache["pos"][brow, here] = torch.where(mine, cur_len.to(cur.dtype),
                                               cur)
        return self._logits(x, rules, lay, specs), \
            {**cache, "len": cur_len + 1}
