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
reference's table of parameter shardings (``base.TableModule``'s, from
:func:`param_labels`) and ``convert.shard_params`` cuts a rank's block
out of full parameters (``convert.init_params(..., rules=)`` draws them
so).  The forward and ``decode_step`` take the
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
  statistics (``attention.decode_attention``; :func:`decode_attn`).

Jamba and Whisper run these islands too (:func:`attn_island`, with
cross-attention's ``kv_x``; :func:`dense_mlp`; :func:`decode_attn`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Layout, Rules
from . import moe as moe_mod
from .attention import decode_attention
from .base import (TableModule, run_layer, seq_gather, seq_return,
                   stack_specs, whole)
from .layers import embed_lookup, mrope, rms_norm, rope, swiglu

__all__ = ["param_table", "param_dtype", "init_rule", "param_labels",
           "attn_block", "attn_island", "mlp_block", "layer_apply",
           "dense_mlp", "decode_attn", "decode_slot", "kv_slab",
           "scatter_kv", "scatter_pos", "Transformer", "param_specs",
           "layout_specs", "shard_table", "cache_specs"]

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
# sharding of the parameters (the reference's ``param_table`` axes; the
# layouts are ``base.TableModule``'s, from these labels)
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


def kv_slab(rules: Rules, S: int) -> slice:
    """This rank's slab of a KV cache of ``S`` positions sharded over
    ``kv_seq``."""
    kv = rules._clean(rules.kv_seq)
    n = rules.axis_size(kv)
    if S % n:
        raise ValueError(f"a cache of {S} positions does not divide over "
                         f"kv_seq {kv}")
    i = rules.mesh.index(kv) if kv else 0
    return slice(i * (S // n), (i + 1) * (S // n))


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
               cfg: ModelConfig, positions: torch.Tensor,
               causal: bool = True, kv_x: Optional[torch.Tensor] = None,
               kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm GQA attention with RoPE (or M-RoPE), the optional q/k/v
    biases and its residual, x (B, S, D); cross-attention (Whisper's)
    reads its keys and values from ``kv_x`` (B, Sk, D) at
    ``kv_positions``.

    The reference repeats KV to the H query heads before attention when it
    runs without rules; the flash kernel reads the K KV heads natively
    (query head h reads KV head h // (H / K)), which gives the same
    result without the copy.  Spans: ``attention`` > ``attention.flash``
    (the op, its layout copies included)."""
    B, S, _D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    with obs.span("attention"):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        src = h if kv_x is None else kv_x
        kp = positions if kv_positions is None else kv_positions
        q, k, v = h @ lp["wq"], src @ lp["wk"], src @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = _rotate(q.reshape(B, S, H, hd), cfg, positions)
        k = _rotate(k.reshape(B, src.shape[1], K, hd), cfg, kp)
        v = v.reshape(B, src.shape[1], K, hd)
        with obs.span("attention.flash"):
            out = flash_attention_op(q, k, v, causal=causal,
                                     window=cfg.sliding_window)
        return x + out.reshape(B, S, H * hd) @ lp["wo"]


def mlp_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP (dense SwiGLU, MoE, or both) with its residual, x
    (B, S, D); returns (x, MoE aux loss).  The dense SwiGLU is the span
    ``mlp``; the MoE's are ``moe_block``'s."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.moe is None:
        with obs.span("mlp"):
            return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), \
                aux
    out, aux = moe_mod.moe_block(
        h, {"router": lp["router"], "w_gate": lp["moe_gate"],
            "w_up": lp["moe_up"], "w_down": lp["moe_down"]}, cfg)
    if cfg.d_ff > 0:
        with obs.span("mlp"):
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


def _attn_manual(x, lp, cfg: ModelConfig, rules: Rules, positions,
                 lay: Layout, causal: bool = True, kv_x=None,
                 kv_positions=None):
    """Megatron TP attention (the reference's ``shard_map`` island over
    ``model``): all-gather the normed block input once, project into this
    column's q heads and its GQA KV slice, attend with the flash kernel at
    the local heads, and reduce-scatter the ``wo`` product straight back
    to the sequence-sharded layout.  Collectives per layer: 1 AG(h) + 2
    AG(k, v) + 1 RS(out).  ``positions``: this rank's rows, the whole
    sequence.  Cross-attention takes its keys and values from ``kv_x``
    (this rank's rows, the whole source sequence) at ``kv_positions``."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = rules.axis_size("model")
    hq, g = H // tp, H // K
    kv_w = max(hq // g, 1)                       # KV heads per column
    col = rules.mesh.index("model")
    h = seq_gather(rms_norm(x, lp["attn_norm"], cfg.norm_eps), rules, lay)
    bl, sl, _ = h.shape
    src = h if kv_x is None else kv_x
    sk = src.shape[1]
    q, k, v = h @ lp["wq"], src @ lp["wk"], src @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # k/v columns hold K*hd/tp lanes: gather whole KV heads, take this
    # column's GQA slice
    kv0 = (col * hq) // g
    k = comm.all_gather(k, rules.mesh, "model", 2).reshape(bl, sk, K, hd)
    v = comm.all_gather(v, rules.mesh, "model", 2).reshape(bl, sk, K, hd)
    k, v = k[:, :, kv0:kv0 + kv_w], v[:, :, kv0:kv0 + kv_w]
    q = _rotate(q.reshape(bl, sl, hq, hd), cfg, positions)
    k = _rotate(k, cfg, positions if kv_positions is None else kv_positions)
    out = flash_attention_op(q, k, v, causal=causal,
                             window=cfg.sliding_window)
    out = (out.reshape(bl, sl, hq * hd) @ lp["wo"]).to(x.dtype)
    return x + seq_return(out, rules, lay)


def _mlp_manual(x, lp, cfg: ModelConfig, rules: Rules, lay: Layout):
    """Megatron TP SwiGLU island: AG(h) -> local F/tp -> RS(out)."""
    h = seq_gather(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), rules, lay)
    out = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]).to(x.dtype)
    return x + seq_return(out, rules, lay)


ATTN_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv")
MLP_NAMES = ("mlp_norm", "w_gate", "w_up", "w_down")


def _attn_gathered(x, lp, cfg: ModelConfig, rules: Rules, positions,
                   lay: Layout, lspecs, causal: bool = True, kv_x=None,
                   kv_positions=None):
    """Attention where the reference lets GSPMD place the layer: the port
    gathers the weights (``lspecs``: the layer's specs) and the sequence
    and runs the single-card block, keeping this rank's sequence
    block."""
    w = whole(lp, lspecs, ATTN_NAMES, rules)
    y = attn_block(seq_gather(x, rules, lay), w, cfg, positions, causal,
                   kv_x, kv_positions)
    return y[:, lay.positions(rules, y.shape[1])]


def attn_island(x, lp, cfg: ModelConfig, rules: Rules, positions,
                lay: Layout, lspecs, causal: bool = True, kv_x=None,
                kv_positions=None):
    """Attention with its residual on this rank's block: the Megatron
    island where :func:`_manual_tp_ok`, else the gathered layer."""
    if _manual_tp_ok(cfg, rules):
        return _attn_manual(x, lp, cfg, rules, positions, lay, causal,
                            kv_x, kv_positions)
    return _attn_gathered(x, lp, cfg, rules, positions, lay, lspecs, causal,
                          kv_x, kv_positions)


def dense_mlp(x, lp, cfg: ModelConfig, rules: Rules, lay: Layout, lspecs,
              decode: bool = False):
    """The dense SwiGLU MLP with its residual on this rank's block: the
    Megatron island where F is sharded over ``model`` (under
    ``manual_tp``, and always in decode), else the weights gathered and
    the single-card MLP on the rank's own positions."""
    if lspecs["w_gate"][-1] == "model" and (rules.manual_tp or decode):
        return _mlp_manual(x, lp, cfg, rules, lay)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    w = whole(lp, lspecs, ("w_gate", "w_up", "w_down"), rules)
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"])


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


def decode_slot(cur_len: torch.Tensor, s_l: int, rules: Rules):
    """Where each row's new token goes in this rank's slab of a KV cache
    sharded over ``kv_seq`` (``s_l`` positions a slab; a window wraps):
    (its position in the slab (clamped), whether this slab owns it)."""
    kv = rules._clean(rules.kv_seq)
    slot = cur_len % (s_l * rules.axis_size(kv))
    here = slot - (rules.mesh.index(kv) * s_l if kv else 0)
    mine = (here >= 0) & (here < s_l)
    return here.clamp(0, s_l - 1), mine


def decode_attn(x, lp, cfg: ModelConfig, rules: Rules, lspecs, k_c, v_c,
                lengths, pos, slot=None):
    """One decode step of attention with its residual on this rank's rows
    x (b, D), on a mesh: the projections on this rank's weight blocks with
    their head blocks gathered, the new K/V written by the slab that owns
    ``slot`` (:func:`decode_slot`; None: a cross-attention cache, read
    only), attention against this rank's slab of ``k_c``/``v_c``
    (``lengths`` valid global positions) with the partials combined over
    ``kv_seq``, and ``wo`` a row-parallel sum."""
    mesh = rules.mesh
    b = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def cols(h, w, bias):
        y = h @ lp[w]
        if cfg.qkv_bias:
            y = y + lp[bias]
        a = lspecs[w][-1]
        return y if a is None else comm.all_gather(y, mesh, a, 1)

    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _rotate(cols(h, "wq", "bq").reshape(b, 1, H, hd), cfg, pos)[:, 0]
    if slot is not None:
        here, mine = slot
        rows = torch.arange(b, device=x.device)
        k = _rotate(cols(h, "wk", "bk").reshape(b, 1, K, hd), cfg, pos)[:, 0]
        v = cols(h, "wv", "bv").reshape(b, K, hd)
        for c, new in ((k_c, k), (v_c, v)):
            c[rows, here] = torch.where(mine[:, None, None],
                                        new.to(c.dtype), c[rows, here])
    att = decode_attention(q, k_c, v_c, lengths, rules=rules)
    att = att.reshape(b, H * hd)
    ha = lspecs["wo"][0]
    if ha is None:
        return x + att @ lp["wo"]
    n = H * hd // rules.axis_size(ha)
    part = att[:, mesh.index(ha) * n:][:, :n] @ lp["wo"]
    return x + comm.all_reduce(part, mesh, ha)


class Transformer(TableModule):
    """The dense / MoE / VLM decoder-only LM, its parameters under the
    reference's names; see :class:`~repro_torch.models.base.TableModule`
    for ``params``."""

    STACKED = ("layers/",)

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(init_rule)
    param_labels = staticmethod(param_labels)
    cache_specs = staticmethod(cache_specs)

    @functools.cached_property
    def _layer_names(self) -> Tuple[str, ...]:
        return tuple(k.split("/", 1)[1] for k in param_table(self.cfg)
                     if k.startswith("layers/"))

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return self._stack("layers/", self._layer_names, i)

    def _head(self) -> torch.Tensor:
        return self._p("embed").T if self.cfg.tie_embeddings \
            else self._p("lm_head")

    def _block(self, x: torch.Tensor, i: int, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return layer_apply(x, self._layer(i), self.cfg, positions)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        if self.cfg.mrope_sections is not None:
            positions = positions.expand(3, B, S)
        return positions

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
        gets the global logits.  On one card the embedding and the head
        (final norm and LM head) are the spans ``embed`` and ``head``."""
        cfg = self.cfg
        if positions is None:
            positions = self._positions(tokens)
        rules = self._rules(rules)
        if rules is not None:
            B, S = tokens.shape
            lay = Layout.of(rules, B, S)
            x, aux = self._spmd_trunk(tokens, positions, rules, lay, remat)
            return self._spmd_out(x, last_only, rules, lay,
                                  self.layout_specs(cfg, rules)), aux
        with obs.span("embed"):
            x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for i in range(cfg.num_layers):
            x, a = run_layer(self._block, remat, x, i, positions)
            aux = aux + a
        with obs.span("head"):
            if last_only:
                x = x[:, -1:]
            x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
            return x @ self._head(), aux

    # -- on a mesh ---------------------------------------------------------
    def _spmd_mlp(self, x: torch.Tensor, lp, rules: Rules, lay: Layout,
                  lspecs, decode: bool = False):
        """The MLP with its residual on this rank's block; (x, aux)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=F32, device=x.device)
        if cfg.moe is None:
            return dense_mlp(x, lp, cfg, rules, lay, lspecs, decode), aux
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        out, aux = moe_mod.moe_block(
            h, {"router": lp["router"], "w_gate": lp["moe_gate"],
                "w_up": lp["moe_up"], "w_down": lp["moe_down"]}, cfg,
            _decode_rules(rules) if decode else rules, lay)
        if cfg.d_ff > 0:
            w = whole(lp, lspecs, ("w_gate", "w_up", "w_down"), rules)
            out = out + swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
        return x + out, aux

    def _spmd_layer(self, x, i: int, pos, rules: Rules, lay: Layout,
                    lspecs):
        """Layer ``i`` on this rank's block: its attention island, then
        its MLP; (x, aux).  Under FSDP the layer's banked weights are
        all-gathered first (inside: ``remat="full"`` gathers them again
        in the backward)."""
        lp = self._layer(i)
        x = attn_island(x, lp, self.cfg, rules, pos, lay, lspecs)
        return self._spmd_mlp(x, lp, rules, lay, lspecs)

    def _spmd_trunk(self, tokens, positions, rules: Rules, lay: Layout,
                    remat: str):
        """The embedding and every layer on this rank's block of the
        global ``tokens``: (x (b, s, D), the MoE aux loss summed over
        layers, the same on every rank)."""
        cfg = self.cfg
        rows = lay.rows(rules, tokens.shape[0])
        pos = positions[..., rows, :]
        specs = self.layout_specs(cfg, rules)
        x = self._embed(tokens[rows], rules, lay, specs)
        aux = torch.zeros((), dtype=F32, device=x.device)
        body = functools.partial(
            self._spmd_layer, rules=rules, lay=lay,
            lspecs=stack_specs(specs, "layers/", self._layer_names))
        for i in range(cfg.num_layers):
            x, a = run_layer(body, remat, x, i, pos)
            aux = aux + a
        return x, aux

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
        if rules is None:
            logits, aux = self(batch["tokens"],
                               positions=batch.get("positions"), remat=remat)
            return self._loss(logits, aux, batch, moe=True)
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = self._positions(tokens)
        lay = Layout.of(rules, *tokens.shape)
        x, aux = self._spmd_trunk(tokens, positions, rules, lay, remat)
        nll, count = self._spmd_ce(x, batch, rules, lay,
                                   self.layout_specs(self.cfg, rules))
        return self._mesh_loss(nll, count, aux, rules, moe=True)

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
        cfg, dev = self.cfg, self.device
        S = self.cache_len(max_seq)
        filled = 0 if filled is None else filled
        idx = torch.arange(S, dtype=torch.int32, device=dev)
        if self.rules is not None:
            idx = idx[kv_slab(self.rules, S)]
            batch = self._cache_batch(batch)
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
        (``kv_seq``), attention through :func:`decode_attn`; the dense
        MLP is a row-parallel sum, the MoE FFN runs under
        ``_decode_rules``."""
        cfg = self.cfg
        B = tokens.shape[0]
        lay = Layout(rules.dim_axis(rules.batch, B), False)
        rows = lay.rows(rules, B)
        specs = self.layout_specs(cfg, rules)
        lspecs = stack_specs(specs, "layers/", self._layer_names)
        cur_len = cache["len"]
        b = cur_len.shape[0]
        if positions is None:
            positions = cur_len.to(torch.int32)
            if cfg.mrope_sections is not None:
                positions = positions.expand(3, b)
        else:
            positions = positions[..., rows]
        pos = positions[..., None]
        here, mine = decode_slot(cur_len, cache["k"].shape[2], rules)
        x = self._embed(tokens[rows][:, None], rules, lay, specs)[:, 0]
        for i in range(cfg.num_layers):
            lp = self._layer(i)
            x = decode_attn(x, lp, cfg, rules, lspecs, cache["k"][i],
                            cache["v"][i], cur_len + 1, pos, (here, mine))
            x2, _aux = self._spmd_mlp(x[:, None], lp, rules, lay, lspecs,
                                      decode=True)
            x = x2[:, 0]
        brow = torch.arange(b, device=cur_len.device)
        cur = cache["pos"][brow, here]
        cache["pos"][brow, here] = torch.where(mine, cur_len.to(cur.dtype),
                                               cur)
        return self._logits(x, rules, lay, specs), \
            {**cache, "len": cur_len + 1}


layout_specs = Transformer.layout_specs
param_specs = Transformer.param_specs
shard_table = Transformer.shard_table
