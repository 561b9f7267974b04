"""Jamba: hybrid Mamba-2 + attention (1:7) with interleaved MoE (the port's
counterpart of ``repro.models.jamba``, for serving on one card).

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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from . import mamba2, moe as moe_mod
from .attention import decode_attention
from .base import TableModule, run_layer
from .layers import embed_lookup, rms_norm, rope, swiglu
from .transformer import attn_block, scatter_kv

__all__ = ["param_table", "param_dtype", "Jamba"]

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

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(mamba2.init_rule)

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
                last_only: bool = False, remat: str = "none"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S or 1, V), MoE aux loss).
        ``last_only`` computes the logits of the last position only
        (serving prefill); ``remat="full"`` rematerialises each period in
        the backward."""
        cfg = self.cfg
        NP = cfg.num_layers // cfg.attn_period
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for per in range(NP):
            x, a = run_layer(self._period, remat, x, per, positions)
            aux = aux + a
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), aux

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask``): cross entropy plus ``AUX_COEF`` times the MoE aux loss,
        and {"ce", "moe_aux"}.  Positions are the default 0..S-1, as the
        reference's ``loss_fn`` passes none."""
        logits, aux = self(batch["tokens"], remat=remat)
        return self._loss(logits, aux, batch, moe=True)

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: KV of the attention layers
        (NP, B, S, K, hd), the mixers' fp32 SSM state (NP, 7, B, H, N, P)
        and convolution tails (NP, 7, B, W-1, conv_dim), and the filled
        length (B,)."""
        cfg, dev = self.cfg, self.device
        _P, NP, n_mamba, _nm, _nd = _layout(cfg)
        K, hd = cfg.num_kv_heads, cfg.head_dim
        s, _di, nh, conv_dim, _ = mamba2._dims(cfg)
        dt = cfg.param_dtype
        return {
            "k": torch.zeros((NP, batch, max_seq, K, hd), dtype=dt, device=dev),
            "v": torch.zeros((NP, batch, max_seq, K, hd), dtype=dt, device=dev),
            "state": torch.zeros((NP, n_mamba, batch, nh, s.state_dim,
                                  s.head_dim), dtype=F32, device=dev),
            "conv": torch.zeros((NP, n_mamba, batch, s.conv_width - 1,
                                 conv_dim), dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) to every sequence of the cache and return
        (logits (B, V), cache).  The KV, state and convolution tensors of
        ``cache`` are updated in place (the cache is large; the reference
        returns new arrays); ``len`` is a new tensor."""
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
