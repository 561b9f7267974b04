"""Whisper-style encoder-decoder (the port's counterpart of
``repro.models.whisper``), on one card or on a mesh of ranks.

The conv/audio frontend is a stub, as in the reference: ``frames`` (B,
encoder_seq, d_model) are precomputed frame embeddings.  The encoder is
bidirectional self-attention; each decoder layer runs causal
self-attention, cross-attention into the encoder output, then the SwiGLU
MLP.  Parameters are stacked over layers under the reference's names
(``enc/enc_wq`` is (Le, D, H*hd), ``dec/cross_wk`` (Ld, D, K*hd), ...), so
the two packages run on the same weights.

On a CUDA tensor every attention of :meth:`Whisper.encode` and
:meth:`Whisper.forward` goes through the flash kernel: the encoder's
non-causal, the decoder's causal, and the cross-attention non-causal with
Sq (decoder tokens) != Sk (encoder frames); on the CPU through its plain
version.  Decode attention is the plain single-card
``models/attention.py::decode_attention``, as the reference's is (it runs
no Pallas kernel either).

RoPE stands in for Whisper's learned positions: the cross queries are
rotated at decoder positions and the cross keys at encoder positions, as
the reference does (``ROADMAP.md`` C-7).  :meth:`Whisper.loss` is the
reference's ``loss_fn`` (the encoder run on ``batch["frames"]``);
``remat="full"`` rematerialises each encoder and each decoder layer in
the backward, and so does ``"dots"``: the reference's Whisper treats it
as ``"full"``.

**On a mesh** (``Whisper(cfg, device, params, rules=rules)``) the
parameters keep the reference's layouts (``param_labels``).  The
reference has no islands here (GSPMD places every layer); the port runs
the transformer's: each attention (the encoder's non-causal, the
decoder's causal, the cross-attention with q at decoder positions and K,
V from the whole encoder output, gathered once after the encoder) is
``transformer.attn_island`` (Megatron over ``model`` where whole heads
land on each column, else the weights gathered), each MLP
``transformer.dense_mlp``, with the encoder's frames and the decoder's
tokens sequence-sharded over ``model`` (Megatron SP) where they divide.
A vocabulary that does not divide the axis (51,866 over 4) leaves the
embedding and the head whole.  Decode keeps the self KV over
``kv_seq`` and the cross KV, padded to :func:`cross_seq`, over it too
(masked to ``encoder_seq``): :func:`cache_specs`.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Layout, Rules
from .attention import decode_attention
from .base import TableModule, run_layer, seq_gather, stack_specs
from .layers import embed_lookup, rms_norm, rope, swiglu
from .transformer import (attn_block, attn_island, decode_attn, decode_slot,
                          dense_mlp, kv_slab, scatter_kv)

__all__ = ["param_table", "param_dtype", "init_rule", "param_labels",
           "cross_seq", "cache_specs", "Whisper"]

F32 = torch.float32
I32 = torch.int32


def _attn_fields(prefix: str, L: int, D: int, H: int, K: int, hd: int):
    return {f"{prefix}_norm": (L, D), f"{prefix}_wq": (L, D, H * hd),
            f"{prefix}_wk": (L, D, K * hd), f"{prefix}_wv": (L, D, K * hd),
            f"{prefix}_wo": (L, H * hd, D)}


def _mlp_fields(prefix: str, L: int, D: int, F: int):
    return {f"{prefix}_mlp_norm": (L, D), f"{prefix}_w_gate": (L, D, F),
            f"{prefix}_w_up": (L, D, F), f"{prefix}_w_down": (L, F, D)}


def param_table(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter (the reference's names)."""
    D, hd = cfg.d_model, cfg.head_dim
    H, K, F = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    Le, Ld = cfg.encdec.encoder_layers, cfg.num_layers
    t = {"embed": (cfg.vocab_size, D), "enc_final_norm": (D,),
         "final_norm": (D,), "lm_head": (D, cfg.vocab_size)}
    for k, v in {**_attn_fields("enc", Le, D, H, K, hd),
                 **_mlp_fields("enc", Le, D, F)}.items():
        t[f"enc/{k}"] = v
    for k, v in {**_attn_fields("self", Ld, D, H, K, hd),
                 **_attn_fields("cross", Ld, D, H, K, hd),
                 **_mlp_fields("dec", Ld, D, F)}.items():
        t[f"dec/{k}"] = v
    return t


def param_labels(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Name -> the logical axis of each dimension (the reference table's;
    the leading layer dimension None)."""
    def attn(p):
        return {f"{p}_norm": (None, None), f"{p}_wq": (None, None, "heads"),
                f"{p}_wk": (None, None, "kv_heads"),
                f"{p}_wv": (None, None, "kv_heads"),
                f"{p}_wo": (None, "heads", None)}

    def mlp(p):
        return {f"{p}_mlp_norm": (None, None),
                f"{p}_w_gate": (None, None, "ff"),
                f"{p}_w_up": (None, None, "ff"),
                f"{p}_w_down": (None, "ff", None)}

    t = {"embed": ("vocab", None), "enc_final_norm": (None,),
         "final_norm": (None,), "lm_head": (None, "vocab")}
    t.update({f"enc/{k}": v for k, v in {**attn("enc"),
                                         **mlp("enc")}.items()})
    t.update({f"dec/{k}": v for k, v in {**attn("self"), **attn("cross"),
                                         **mlp("dec")}.items()})
    return t


def cache_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """The decode cache's blocks a rank holds (the reference's
    ``cache_specs``): the self KV ``k``/``v`` (L, B, S, K, hd) and the
    cross KV ``xk``/``xv`` (L, B, :func:`cross_seq`, K, hd) over
    ``batch`` and ``kv_seq``, ``len`` (B,) over ``batch``."""
    b, s = rules._clean(rules.batch), rules._clean(rules.kv_seq)
    kv = (None, b, s, None, None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "len": (b,)}


def _attn_names(prefix: str) -> Dict[str, str]:
    """The transformer's attention names -> this prefix's."""
    return {"attn_norm": f"{prefix}_norm", "wq": f"{prefix}_wq",
            "wk": f"{prefix}_wk", "wv": f"{prefix}_wv", "wo": f"{prefix}_wo"}


def _mlp_names(prefix: str) -> Dict[str, str]:
    """The transformer's MLP names -> this prefix's."""
    return {"mlp_norm": f"{prefix}_mlp_norm", "w_gate": f"{prefix}_w_gate",
            "w_up": f"{prefix}_w_up", "w_down": f"{prefix}_w_down"}


def _as(d: Dict, names: Dict[str, str]) -> Dict:
    """``d``'s entries under the transformer's names."""
    return {k: d[v] for k, v in names.items()}


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """Every parameter in the config's parameter dtype."""
    return cfg.param_dtype


def init_rule(name: str) -> str:
    """How the reference initialises a parameter: norms ones, the rest
    dense."""
    return "ones" if "norm" in name else "dense"


def cross_seq(cfg: ModelConfig) -> int:
    """Sequence length of the cross-attention KV cache: ``encoder_seq``
    padded to a multiple of 16 (1504 for 1500 frames), as the reference
    pads it."""
    return -(-cfg.encdec.encoder_seq // 16) * 16


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=I32, device=device).expand(B, S)


def _remat(remat: str) -> str:
    """The reference's Whisper rematerialises ``"dots"`` as ``"full"``
    (``repro/models/whisper.py``: ``remat in ("full", "dots")``)."""
    return "full" if remat == "dots" else remat


class Whisper(TableModule):
    """The encoder-decoder, its parameters under the reference's names;
    see :class:`~repro_torch.models.base.TableModule` for ``params``.
    ``reset_slot`` zeroes ``len`` alone (``RECURRENT_LEAVES`` is empty):
    stale self-attention KV is masked by length, and the cross KV is the
    same for every request of the cache."""

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(init_rule)
    param_labels = staticmethod(param_labels)
    cache_specs = staticmethod(cache_specs)

    @functools.cached_property
    def _names(self) -> Dict[str, Tuple[str, ...]]:
        out = {"enc/": [], "dec/": []}
        for k in param_table(self.cfg):
            if "/" in k:
                head, tail = k.split("/", 1)
                out[head + "/"].append(tail)
        return {k: tuple(v) for k, v in out.items()}

    def _layer(self, part: str, i: int) -> Dict[str, torch.Tensor]:
        return self._stack(part, self._names[part], i)

    def _attn(self, x: torch.Tensor, lp: Dict[str, torch.Tensor],
              prefix: str, positions: torch.Tensor, causal: bool,
              kv_x: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self- or cross-attention block with its residual, x (B, S, D);
        cross-attention reads keys and values from ``kv_x`` (B, Se, D) at
        ``kv_positions`` (``transformer.attn_block``)."""
        return attn_block(x, _as(lp, _attn_names(prefix)), self.cfg,
                          positions, causal, kv_x, kv_positions)

    def _mlp(self, x: torch.Tensor, lp: Dict[str, torch.Tensor],
             prefix: str) -> torch.Tensor:
        h = rms_norm(x, lp[f"{prefix}_mlp_norm"], self.cfg.norm_eps)
        return x + swiglu(h, lp[f"{prefix}_w_gate"], lp[f"{prefix}_w_up"],
                          lp[f"{prefix}_w_down"])

    def _enc_layer(self, x: torch.Tensor, i: int,
                   positions: torch.Tensor) -> torch.Tensor:
        lp = self._layer("enc/", i)
        x = self._attn(x, lp, "enc", positions, causal=False)
        return self._mlp(x, lp, "enc")

    def _dec_layer(self, x: torch.Tensor, i: int, positions: torch.Tensor,
                   enc_out: torch.Tensor, enc_pos: torch.Tensor
                   ) -> torch.Tensor:
        lp = self._layer("dec/", i)
        x = self._attn(x, lp, "self", positions, causal=True)
        x = self._attn(x, lp, "cross", positions, causal=False,
                       kv_x=enc_out, kv_positions=enc_pos)
        return self._mlp(x, lp, "dec")

    def encode(self, frames: torch.Tensor, remat: str = "none",
               rules: Optional[Rules] = None) -> torch.Tensor:
        """frames (B, Se, D), the stubbed frontend's embeddings -> the
        encoder output (B, Se, D): ``encoder_layers`` non-causal layers,
        then ``enc_final_norm``; ``remat="full"`` rematerialises each
        layer in the backward.  On a mesh every rank passes the global
        frames and gets the global output."""
        rules = self._rules(rules)
        if rules is not None:
            x, lay = self._spmd_encode(frames, rules, remat)
            return lay.gather(x, rules)
        cfg = self.cfg
        B, S, _D = frames.shape
        positions = _positions(B, S, frames.device)
        x = frames.to(cfg.param_dtype)
        for i in range(cfg.encdec.encoder_layers):
            x = run_layer(self._enc_layer, _remat(remat), x, i, positions)
        return rms_norm(x, self._p("enc_final_norm"), cfg.norm_eps)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None,
                last_only: bool = False, remat: str = "none",
                rules: Optional[Rules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decoder pass: tokens (B, S) -> (logits (B, S or
        1, V), a zero aux loss).  ``frames`` (B, Se, D) go through
        :meth:`encode`; ``embeds`` (B, Se, D) stand in for the encoder
        output directly.  ``last_only`` computes the last position's
        logits only; ``remat="full"`` rematerialises each encoder and
        decoder layer in the backward.  On a mesh every rank passes the
        global inputs and gets the global logits."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = _positions(B, S, tokens.device)
        if embeds is None and frames is None:
            raise ValueError("Whisper.forward needs frames, or embeds in "
                             "place of the encoder output")
        zero = torch.zeros((), dtype=F32, device=tokens.device)
        rules = self._rules(rules)
        if rules is not None:
            lay = Layout.of(rules, B, S)
            x = self._spmd_trunk(tokens, positions, frames, embeds, rules,
                                 lay, remat)
            return self._spmd_out(x, last_only, rules, lay,
                                  self.layout_specs(cfg, rules)), zero
        enc_out = embeds if embeds is not None else \
            self.encode(frames, remat)
        enc_pos = _positions(B, enc_out.shape[1], enc_out.device)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        for i in range(cfg.num_layers):
            x = run_layer(self._dec_layer, _remat(remat), x, i, positions,
                          enc_out, enc_pos)
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), zero

    # -- on a mesh ---------------------------------------------------------
    def _spmd_encode(self, frames, rules: Rules, remat: str):
        """The encoder on this rank's block of the global ``frames``: (its
        output block (b, se, D), the encoder's layout)."""
        cfg = self.cfg
        B, Se, _D = frames.shape
        lay = Layout.of(rules, B, Se)
        rows = lay.rows(rules, B)
        x = frames[rows][:, lay.positions(rules, Se)].to(cfg.param_dtype)
        pos = _positions(x.shape[0], Se, frames.device)
        lspecs = stack_specs(self.layout_specs(cfg, rules), "enc/",
                             self._names["enc/"])
        att, mlp = _attn_names("enc"), _mlp_names("enc")

        def layer(x, i):
            lp = self._layer("enc/", i)
            x = attn_island(x, _as(lp, att), cfg, rules, pos, lay,
                            _as(lspecs, att), causal=False)
            return dense_mlp(x, _as(lp, mlp), cfg, rules, lay,
                             _as(lspecs, mlp))

        for i in range(cfg.encdec.encoder_layers):
            x = run_layer(layer, _remat(remat), x, i)
        return rms_norm(x, self._use("enc_final_norm"), cfg.norm_eps), lay

    def _spmd_trunk(self, tokens, positions, frames, embeds, rules: Rules,
                    lay: Layout, remat: str):
        """The encoder (or ``embeds``), the embedding and every decoder
        layer on this rank's block of the global inputs: x (b, s, D).
        The encoder output's sequence is gathered once, for every
        layer's cross-attention."""
        cfg = self.cfg
        rows = lay.rows(rules, tokens.shape[0])
        if embeds is not None:
            enc = embeds[rows]
        else:
            enc, enc_lay = self._spmd_encode(frames, rules, remat)
            enc = seq_gather(enc, rules, enc_lay)
        enc_pos = _positions(enc.shape[0], enc.shape[1], enc.device)
        specs = self.layout_specs(cfg, rules)
        lspecs = stack_specs(specs, "dec/", self._names["dec/"])
        pos = positions[rows]
        sa, xa, mlp = (_attn_names("self"), _attn_names("cross"),
                       _mlp_names("dec"))

        def layer(x, i, enc, enc_pos):
            lp = self._layer("dec/", i)
            x = attn_island(x, _as(lp, sa), cfg, rules, pos, lay,
                            _as(lspecs, sa))
            x = attn_island(x, _as(lp, xa), cfg, rules, pos, lay,
                            _as(lspecs, xa), causal=False, kv_x=enc,
                            kv_positions=enc_pos)
            return dense_mlp(x, _as(lp, mlp), cfg, rules, lay,
                             _as(lspecs, mlp))

        x = self._embed(tokens[rows], rules, lay, specs)
        for i in range(cfg.num_layers):
            x = run_layer(layer, _remat(remat), x, i, enc, enc_pos)
        return x

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none",
             rules: Optional[Rules] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``,
        ``frames``, optional ``mask``): the cross entropy, and {"ce"}; on
        a mesh the global loss with this rank's share's gradient
        (``TableModule._mesh_loss``)."""
        rules = self._rules(rules)
        if rules is None:
            logits, aux = self(batch["tokens"], frames=batch["frames"],
                               remat=remat)
            return self._loss(logits, aux, batch, moe=False)
        tokens = batch["tokens"]
        B, S = tokens.shape
        lay = Layout.of(rules, B, S)
        x = self._spmd_trunk(tokens, _positions(B, S, tokens.device),
                             batch["frames"], None, rules, lay, remat)
        nll, count = self._spmd_ce(x, batch, rules, lay,
                                   self.layout_specs(self.cfg, rules))
        return self._mesh_loss(nll, count, None, rules, moe=False)

    @torch.no_grad()
    def init_cache(self, batch: int, max_seq: int,
                   filled: Optional[int] = None,
                   enc_out: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: the self-attention KV
        ``k``/``v`` (L, B, max_seq, K, hd), the cross KV ``xk``/``xv``
        (L, B, :func:`cross_seq`, K, hd) and the filled length ``len``
        (B,).  The cross KV is zero unless ``enc_out`` (B, Se, D) is given:
        then each layer's keys (rotated at encoder positions) and values of
        it, zero-padded past Se.  On a mesh, this rank's blocks
        (:func:`cache_specs`; ``enc_out`` the global output)."""
        cfg, dev, rules = self.cfg, self.device, self.rules
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        Se = cross_seq(cfg)
        filled = 0 if filled is None else filled
        dt = cfg.param_dtype
        rows = slice(0, batch)
        own, xown = slice(0, max_seq), slice(0, Se)
        if rules is not None:
            own, xown = kv_slab(rules, max_seq), kv_slab(rules, Se)
            b = self._cache_batch(batch)
            rows = self._cache_rows
            batch = b
        S, X = own.stop - own.start, xown.stop - xown.start
        cache = {
            "k": torch.zeros((L, batch, S, K, hd), dtype=dt, device=dev),
            "v": torch.zeros((L, batch, S, K, hd), dtype=dt, device=dev),
            "xk": torch.zeros((L, batch, X, K, hd), dtype=dt, device=dev),
            "xv": torch.zeros((L, batch, X, K, hd), dtype=dt, device=dev),
            "len": torch.full((batch,), filled, dtype=I32, device=dev),
        }
        if enc_out is not None:
            enc_out = enc_out[rows].to(dt)
            B, S, _D = enc_out.shape
            ep = _positions(B, S, enc_out.device)
            specs = None if rules is None else \
                self.layout_specs(cfg, rules)
            for i in range(L):
                lp = self._layer("dec/", i)
                kv = []
                for w in ("cross_wk", "cross_wv"):
                    y = enc_out @ lp[w]
                    a = None if specs is None else specs["dec/" + w][2]
                    if a is not None:
                        y = comm.all_gather(y, rules.mesh, a, 2)
                    y = torch.nn.functional.pad(
                        y.reshape(B, S, K, hd), (0, 0, 0, 0, 0, Se - S))
                    kv.append(y)
                xk = rope(kv[0], _positions(B, Se, enc_out.device),
                          cfg.rope_theta)
                cache["xk"][i] = xk[:, xown]
                cache["xv"][i] = kv[1][:, xown]
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, rules: Optional[Rules] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) to every sequence and return (logits
        (B, V), cache).  Self-attention runs against the KV cache, written
        at ``len % S_cache`` (it wraps); cross-attention against ``xk`` /
        ``xv``, masked to ``encoder_seq`` (the padded tail never counts).
        ``k``/``v`` are updated in place (the reference returns new
        arrays); ``len`` is a new tensor.  On a mesh every rank passes the
        global tokens with its own cache and gets the global logits."""
        rules = self._rules(rules)
        if rules is not None:
            return self._spmd_decode(cache, tokens, rules)
        cfg = self.cfg
        B = tokens.shape[0]
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cur_len = cache["len"]
        pos = cur_len.to(I32)[:, None]                 # (B, 1)
        slot = cur_len % cache["k"].shape[2]
        full = torch.full((B,), cfg.encdec.encoder_seq, dtype=I32,
                          device=tokens.device)
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        for i in range(cfg.num_layers):
            lp = self._layer("dec/", i)
            # causal self-attention against the cache
            h = rms_norm(x, lp["self_norm"], cfg.norm_eps)
            q = rope((h @ lp["self_wq"]).reshape(B, 1, H, hd), pos,
                     cfg.rope_theta)[:, 0]
            k = rope((h @ lp["self_wk"]).reshape(B, 1, K, hd), pos,
                     cfg.rope_theta)
            v = (h @ lp["self_wv"]).reshape(B, 1, K, hd)
            k_c = scatter_kv(cache["k"][i], k, slot)
            v_c = scatter_kv(cache["v"][i], v, slot)
            att = decode_attention(q, k_c, v_c, cur_len + 1)
            x = x + att.reshape(B, H * hd) @ lp["self_wo"]
            # cross-attention against the precomputed encoder KV
            h = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
            qx = rope((h @ lp["cross_wq"]).reshape(B, 1, H, hd), pos,
                      cfg.rope_theta)[:, 0]
            attx = decode_attention(qx, cache["xk"][i], cache["xv"][i], full)
            x = x + attx.reshape(B, H * hd) @ lp["cross_wo"]
            # MLP
            h = rms_norm(x, lp["dec_mlp_norm"], cfg.norm_eps)
            x = x + swiglu(h, lp["dec_w_gate"], lp["dec_w_up"],
                           lp["dec_w_down"])
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), {**cache, "len": cur_len + 1}

    def _spmd_decode(self, cache, tokens, rules: Rules):
        """``decode_step`` on a mesh: this rank's rows against its cache
        blocks; both attentions through ``transformer.decode_attn`` (the
        self KV written by the slab that owns the slot, the cross KV read
        only), the MLP a row-parallel sum."""
        cfg = self.cfg
        B = tokens.shape[0]
        lay = Layout(rules.dim_axis(rules.batch, B), False)
        specs = self.layout_specs(cfg, rules)
        lspecs = stack_specs(specs, "dec/", self._names["dec/"])
        cur_len = cache["len"]
        pos = cur_len.to(I32)[:, None]
        slot = decode_slot(cur_len, cache["k"].shape[2], rules)
        full = torch.full_like(cur_len, cfg.encdec.encoder_seq)
        sa, xa, mlp = (_attn_names("self"), _attn_names("cross"),
                       _mlp_names("dec"))
        x = self._embed(tokens[lay.rows(rules, B)][:, None], rules, lay,
                        specs)[:, 0]
        for i in range(cfg.num_layers):
            lp = self._layer("dec/", i)
            x = decode_attn(x, _as(lp, sa), cfg, rules, _as(lspecs, sa),
                            cache["k"][i], cache["v"][i], cur_len + 1, pos,
                            slot)
            x = decode_attn(x, _as(lp, xa), cfg, rules, _as(lspecs, xa),
                            cache["xk"][i], cache["xv"][i], full, pos)
            x = dense_mlp(x[:, None], _as(lp, mlp), cfg, rules, lay,
                          _as(lspecs, mlp), decode=True)[:, 0]
        return self._logits(x, rules, lay, specs), \
            {**cache, "len": cur_len + 1}
