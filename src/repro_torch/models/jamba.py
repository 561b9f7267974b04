"""Jamba: hybrid Mamba-2 + attention (1:7) with interleaved MoE (the port's
counterpart of ``repro.models.jamba``), on one card or on a mesh of
ranks.

Layer pattern per period of ``attn_period`` (8) layers: mixers are
``[mamba x 7, attention]`` (attention closes each period) and MLPs
alternate ``[dense, MoE, dense, MoE, ...]`` (MoE every
``moe.every_n_layers``).  Parameters are stacked over periods, under the
reference's names (``periods/wq`` is (NP, D, H*hd), ``periods/mamba_in_proj``
is (NP, 7, D, proj), ...), so the two packages run on the same weights.

On a CUDA tensor every attention layer goes through the flash kernel,
every mixer through the SSD kernel and every expert FFN through the GMM
kernel; on the CPU through their plain versions.  Decode attention, the
mixer recurrence of decode, the dense projections and the LM head are
plain tensor code.  :meth:`Jamba.loss` is the reference's ``loss_fn``;
``remat="full"`` (or ``"dots"``, ``base.run_layer``) rematerialises each
period in the backward, as the reference's ``jax.checkpoint`` of its
period body does.

**On a mesh** (``Jamba(cfg, device, params, rules=rules)``) the
parameters keep the reference's layouts (``param_labels``) and each part
of a period reuses an island the port already has: the attention the
transformer's (``transformer.attn_island``: Megatron where whole heads
land on each column, else gathered), the mixers Mamba-2's head-parallel
island (``mamba2.mixer_spmd``), the MoE ``moe.moe_block``'s dispatch
mode, the dense MLP ``transformer.dense_mlp``.  Decode keeps the KV over
``kv_seq`` (``transformer.decode_attn``), runs the mixers'
``mamba2.mixer_decode_spmd`` and the MoE under
``transformer._decode_rules``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Layout, Rules
from . import mamba2, moe as moe_mod
from .attention import decode_attention
from .base import TableModule, run_layer, stack_specs
from .layers import embed_lookup, rms_norm, rope, swiglu
from .transformer import (_decode_rules, attn_block, attn_island,
                          decode_attn, decode_slot, dense_mlp, kv_slab,
                          scatter_kv)

__all__ = ["param_table", "param_dtype", "param_labels", "cache_specs",
           "Jamba"]

ATTN = ("attn_norm", "wq", "wk", "wv", "wo")
DENSE = ("mlp_norm", "w_gate", "w_up", "w_down")
MOE = ("moe_norm", "router", "moe_gate", "moe_up", "moe_down")

F32 = torch.float32


def _layout(cfg: ModelConfig):
    """(period P, periods NP, mamba layers, MoE layers, dense layers) per
    period."""
    P = cfg.attn_period
    NP = cfg.num_layers // P
    n_moe = sum(1 for i in range(P) if _is_moe_layer(cfg, i))
    return P, NP, P - 1, n_moe, P - n_moe


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    n = cfg.moe.every_n_layers
    return (i % n) == n - 1


def param_table(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter (the reference's names)."""
    D, hd = cfg.d_model, cfg.head_dim
    H, K, F = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    _P, NP, n_mamba, n_moe, n_dense = _layout(cfg)
    E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
    t = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab_size),
        "periods/attn_norm": (NP, D),
        "periods/wq": (NP, D, H * hd),
        "periods/wk": (NP, D, K * hd),
        "periods/wv": (NP, D, K * hd),
        "periods/wo": (NP, H * hd, D),
    }
    for k, shape in mamba2.mixer_table(cfg, n_mamba).items():
        t[f"periods/mamba_{k}"] = (NP,) + shape
    t.update({
        "periods/mlp_norm": (NP, n_dense, D),
        "periods/w_gate": (NP, n_dense, D, F),
        "periods/w_up": (NP, n_dense, D, F),
        "periods/w_down": (NP, n_dense, F, D),
        "periods/moe_norm": (NP, n_moe, D),
        "periods/router": (NP, n_moe, D, E),
        "periods/moe_gate": (NP, n_moe, E, D, Fe),
        "periods/moe_up": (NP, n_moe, E, D, Fe),
        "periods/moe_down": (NP, n_moe, E, Fe, D),
    })
    return t


def param_labels(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Name -> the logical axis of each dimension (the reference table's;
    the leading period and layer dimensions None)."""
    t = {"embed": ("vocab", None), "final_norm": (None,),
         "lm_head": (None, "vocab"),
         "periods/attn_norm": (None, None),
         "periods/wq": (None, None, "heads"),
         "periods/wk": (None, None, "kv_heads"),
         "periods/wv": (None, None, "kv_heads"),
         "periods/wo": (None, "heads", None)}
    for k, labels in mamba2.mixer_labels().items():
        t[f"periods/mamba_{k}"] = (None,) + labels
    exp = (None, None, "experts", None, "ff_expert")
    t.update({
        "periods/mlp_norm": (None, None, None),
        "periods/w_gate": (None, None, None, "ff"),
        "periods/w_up": (None, None, None, "ff"),
        "periods/w_down": (None, None, "ff", None),
        "periods/moe_norm": (None, None, None),
        "periods/router": (None, None, None, None),
        "periods/moe_gate": exp, "periods/moe_up": exp,
        "periods/moe_down": (None, None, "experts", "ff_expert", None),
    })
    return t


def cache_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """The decode cache's blocks a rank holds: KV (NP, B, S, K, hd) over
    ``batch`` and ``kv_seq``, the mixers' state and convolution tails as
    ``mamba2.cache_specs`` lays them (a period dimension in front),
    ``len`` over ``batch``."""
    b, s = rules._clean(rules.batch), rules._clean(rules.kv_seq)
    out = {"k": (None, b, s, None, None), "v": (None, b, s, None, None),
           "len": (b,)}
    for k, spec in mamba2.cache_specs(cfg, rules).items():
        if k != "len":
            out[k] = (None,) + spec
    return out


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """fp32 for ``A_log``, ``dt_bias`` and the router; else the config's
    parameter dtype."""
    if name.endswith(("A_log", "dt_bias", "router")):
        return F32
    return cfg.param_dtype


class Jamba(TableModule):
    """The Jamba hybrid LM, its parameters under the reference's names
    (``state_dict()`` keys equal ``param_table``'s); see
    :class:`~repro_torch.models.base.TableModule` for ``params``."""

    RECURRENT_LEAVES = ("state", "conv")   # (NP, 7, B, ...)
    CACHE_BATCH_DIM = 2
    STACKED = ("periods/",)

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(mamba2.init_rule)
    param_labels = staticmethod(param_labels)
    cache_specs = staticmethod(cache_specs)

    def _mamba(self, per: int, i: int) -> Dict[str, torch.Tensor]:
        return self._stack("periods/mamba_", mamba2.mixer_table(self.cfg, 1),
                           per, i)

    def _mlp(self, x, per: int, i: int, counters):
        """Layer ``i``'s MLP with its residual; ``counters`` index the
        dense and MoE stacks.  Returns (x, aux, counters)."""
        cfg, di, mi = self.cfg, counters[0], counters[1]
        if _is_moe_layer(cfg, i):
            lp = {"router": self._p("periods/router")[per, mi],
                  "w_gate": self._p("periods/moe_gate")[per, mi],
                  "w_up": self._p("periods/moe_up")[per, mi],
                  "w_down": self._p("periods/moe_down")[per, mi]}
            h = rms_norm(x, self._p("periods/moe_norm")[per, mi],
                         cfg.norm_eps)
            out, aux = moe_mod.moe_block(h, lp, cfg)
            return x + out, aux, (di, mi + 1)
        h = rms_norm(x, self._p("periods/mlp_norm")[per, di], cfg.norm_eps)
        out = swiglu(h, self._p("periods/w_gate")[per, di],
                     self._p("periods/w_up")[per, di],
                     self._p("periods/w_down")[per, di])
        return x + out, torch.zeros((), dtype=F32, device=x.device), \
            (di + 1, mi)

    def _period(self, x: torch.Tensor, per: int, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One period: ``attn_period - 1`` mixers, then attention, each
        followed by its MLP; returns (x, the period's MoE aux loss)."""
        cfg = self.cfg
        P = cfg.attn_period
        aux = torch.zeros((), dtype=F32, device=x.device)
        counters = (0, 0)
        for i in range(P):
            if i == P - 1:
                lp = {k: self._p(f"periods/{k}")[per]
                      for k in ("attn_norm", "wq", "wk", "wv", "wo")}
                x = attn_block(x, lp, cfg, positions)
            else:
                lp = self._mamba(per, i)
                h = rms_norm(x, lp["norm"], cfg.norm_eps)
                x = x + mamba2.mixer_apply(lp, h, cfg)
            x, a, counters = self._mlp(x, per, i, counters)
            aux = aux + a
        return x, aux

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False, remat: str = "none",
                rules: Optional[Rules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S or 1, V), MoE aux loss).
        ``last_only`` computes the logits of the last position only
        (serving prefill); ``remat="full"`` rematerialises each period in
        the backward.  On a mesh every rank passes the global tokens and
        gets the global logits."""
        cfg = self.cfg
        NP = cfg.num_layers // cfg.attn_period
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
        rules = self._rules(rules)
        if rules is not None:
            lay = Layout.of(rules, B, S)
            x, aux = self._spmd_trunk(tokens, positions, rules, lay, remat)
            return self._spmd_out(x, last_only, rules, lay,
                                  self.layout_specs(cfg, rules)), aux
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for per in range(NP):
            x, a = run_layer(self._period, remat, x, per, positions)
            aux = aux + a
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), aux

    # -- on a mesh ---------------------------------------------------------
    def _spmd_mlp(self, x, per: int, i: int, counters, rules: Rules,
                  lay: Layout, specs, decode: bool = False):
        """Layer ``i``'s MLP with its residual on this rank's block: the
        MoE's dispatch island (under ``_decode_rules`` in decode) or the
        dense MLP; returns (x, aux, counters)."""
        cfg, di, mi = self.cfg, counters[0], counters[1]
        if _is_moe_layer(cfg, i):
            lp = self._stack("periods/", MOE, per, mi)
            h = rms_norm(x, lp["moe_norm"], cfg.norm_eps)
            out, aux = moe_mod.moe_block(
                h, {"router": lp["router"], "w_gate": lp["moe_gate"],
                    "w_up": lp["moe_up"], "w_down": lp["moe_down"]}, cfg,
                _decode_rules(rules) if decode else rules, lay)
            return x + out, aux, (di, mi + 1)
        lp = self._stack("periods/", DENSE, per, di)
        x = dense_mlp(x, lp, cfg, rules, lay,
                      stack_specs(specs, "periods/", DENSE, 2), decode)
        return x, torch.zeros((), dtype=F32, device=x.device), (di + 1, mi)

    def _spmd_period(self, x, per: int, pos, rules: Rules, lay: Layout,
                     specs):
        """One period on this rank's block: the mixers' head-parallel
        islands and the attention island, each followed by its MLP;
        (x, the period's aux loss)."""
        cfg = self.cfg
        P = cfg.attn_period
        aux = torch.zeros((), dtype=F32, device=x.device)
        counters = (0, 0)
        for i in range(P):
            if i == P - 1:
                x = attn_island(x, self._stack("periods/", ATTN, per), cfg,
                                rules, pos, lay,
                                stack_specs(specs, "periods/", ATTN))
            else:
                x = mamba2.mixer_spmd(
                    self._stack("periods/mamba_", mamba2.MIXER_NAMES, per, i),
                    x, cfg, rules, lay,
                    stack_specs(specs, "periods/mamba_", mamba2.MIXER_NAMES,
                                2))
            x, a, counters = self._spmd_mlp(x, per, i, counters, rules, lay,
                                            specs)
            aux = aux + a
        return x, aux

    def _spmd_trunk(self, tokens, positions, rules: Rules, lay: Layout,
                    remat: str):
        """The embedding and every period on this rank's block of the
        global ``tokens``: (x (b, s, D), the MoE aux loss)."""
        rows = lay.rows(rules, tokens.shape[0])
        specs = self.layout_specs(self.cfg, rules)
        x = self._embed(tokens[rows], rules, lay, specs)
        aux = torch.zeros((), dtype=F32, device=x.device)

        def body(x, per, pos):
            return self._spmd_period(x, per, pos, rules, lay, specs)

        for per in range(self.cfg.num_layers // self.cfg.attn_period):
            x, a = run_layer(body, remat, x, per, positions[rows])
            aux = aux + a
        return x, aux

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none",
             rules: Optional[Rules] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask``): cross entropy plus ``AUX_COEF`` times the MoE aux loss,
        and {"ce", "moe_aux"}.  Positions are the default 0..S-1, as the
        reference's ``loss_fn`` passes none.  On a mesh the global loss
        with this rank's share's gradient (``TableModule._mesh_loss``)."""
        rules = self._rules(rules)
        if rules is None:
            logits, aux = self(batch["tokens"], remat=remat)
            return self._loss(logits, aux, batch, moe=True)
        tokens = batch["tokens"]
        B, S = tokens.shape
        lay = Layout.of(rules, B, S)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        x, aux = self._spmd_trunk(tokens, positions, rules, lay, remat)
        nll, count = self._spmd_ce(x, batch, rules, lay,
                                   self.layout_specs(self.cfg, rules))
        return self._mesh_loss(nll, count, aux, rules, moe=True)

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: KV of the attention layers
        (NP, B, S, K, hd), the mixers' fp32 SSM state (NP, 7, B, H, N, P)
        and convolution tails (NP, 7, B, W-1, conv_dim), and the filled
        length (B,).  On a mesh, this rank's part (:func:`cache_specs`)."""
        cfg, dev = self.cfg, self.device
        _P, NP, n_mamba, _nm, _nd = _layout(cfg)
        K, hd = cfg.num_kv_heads, cfg.head_dim
        dt = cfg.param_dtype
        S = max_seq
        if self.rules is not None:
            sl = kv_slab(self.rules, max_seq)
            S = sl.stop - sl.start
        batch = self._cache_batch(batch)
        state, conv = mamba2.mixer_cache_shapes(cfg, self.rules, batch)
        return {
            "k": torch.zeros((NP, batch, S, K, hd), dtype=dt, device=dev),
            "v": torch.zeros((NP, batch, S, K, hd), dtype=dt, device=dev),
            "state": torch.zeros((NP, n_mamba) + state, dtype=F32,
                                 device=dev),
            "conv": torch.zeros((NP, n_mamba) + conv, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, rules: Optional[Rules] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) to every sequence of the cache and return
        (logits (B, V), cache).  The KV, state and convolution tensors of
        ``cache`` are updated in place (the cache is large; the reference
        returns new arrays); ``len`` is a new tensor.  On a mesh every rank
        passes the global tokens with its own cache and gets the global
        logits."""
        rules = self._rules(rules)
        if rules is not None:
            return self._spmd_decode(cache, tokens, rules)
        cfg = self.cfg
        P, NP = cfg.attn_period, cfg.num_layers // cfg.attn_period
        B = tokens.shape[0]
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cur_len = cache["len"]
        pos = cur_len.to(torch.int32)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        slot = cur_len % cache["k"].shape[2]
        for per in range(NP):
            counters = (0, 0)
            k_c, v_c = cache["k"][per], cache["v"][per]
            for i in range(P):
                if i == P - 1:
                    h = rms_norm(x, self._p("periods/attn_norm")[per],
                                 cfg.norm_eps)
                    q = (h @ self._p("periods/wq")[per]).reshape(B, H, hd)
                    k_new = (h @ self._p("periods/wk")[per]).reshape(B, K, hd)
                    v_new = (h @ self._p("periods/wv")[per]).reshape(B, K, hd)
                    q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
                    k_new = rope(k_new[:, None], pos[:, None],
                                 cfg.rope_theta)[:, 0]
                    scatter_kv(k_c, k_new[:, None], slot)
                    scatter_kv(v_c, v_new[:, None], slot)
                    att = decode_attention(q, k_c, v_c, cur_len + 1)
                    x = x + att.reshape(B, H * hd) @ self._p("periods/wo")[per]
                else:
                    lp = self._mamba(per, i)
                    h = rms_norm(x, lp["norm"], cfg.norm_eps)
                    out, st, ct = mamba2.mixer_decode(
                        lp, h, cache["state"][per, i], cache["conv"][per, i],
                        cfg)
                    cache["state"][per, i] = st
                    cache["conv"][per, i] = ct
                    x = x + out
                x2, _aux, counters = self._mlp(x[:, None], per, i, counters)
                x = x2[:, 0]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        logits = x @ self._p("lm_head")
        return logits, {**cache, "len": cur_len + 1}

    def _spmd_decode(self, cache, tokens, rules: Rules):
        """``decode_step`` on a mesh: this rank's rows against its cache;
        the attention layers' KV over ``kv_seq``
        (``transformer.decode_attn``), the mixers head-parallel
        (``mamba2.mixer_decode_spmd``), the MLPs as in the forward (the
        MoE under ``_decode_rules``)."""
        cfg = self.cfg
        P, NP = cfg.attn_period, cfg.num_layers // cfg.attn_period
        B = tokens.shape[0]
        lay = Layout(rules.dim_axis(rules.batch, B), False)
        specs = self.layout_specs(cfg, rules)
        attn_specs = stack_specs(specs, "periods/", ATTN)
        mix_specs = stack_specs(specs, "periods/mamba_", mamba2.MIXER_NAMES,
                                2)
        cur_len = cache["len"]
        pos = cur_len.to(torch.int32)[:, None]
        slot = decode_slot(cur_len, cache["k"].shape[2], rules)
        x = self._embed(tokens[lay.rows(rules, B)][:, None], rules, lay,
                        specs)[:, 0]
        for per in range(NP):
            counters = (0, 0)
            for i in range(P):
                if i == P - 1:
                    x = decode_attn(x, self._stack("periods/", ATTN, per),
                                    cfg, rules, attn_specs, cache["k"][per],
                                    cache["v"][per], cur_len + 1, pos, slot)
                else:
                    lp = self._stack("periods/mamba_", mamba2.MIXER_NAMES,
                                     per, i)
                    out, st, ct = mamba2.mixer_decode_spmd(
                        lp, rms_norm(x, lp["norm"], cfg.norm_eps),
                        cache["state"][per, i], cache["conv"][per, i], cfg,
                        rules, mix_specs)
                    cache["state"][per, i] = st
                    cache["conv"][per, i] = ct
                    x = x + out
                x2, _aux, counters = self._spmd_mlp(
                    x[:, None], per, i, counters, rules, lay, specs,
                    decode=True)
                x = x2[:, 0]
        return self._logits(x, rules, lay, specs), \
            {**cache, "len": cur_len + 1}
