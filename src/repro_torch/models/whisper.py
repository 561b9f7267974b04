"""Whisper-style encoder-decoder (the port's counterpart of
``repro.models.whisper``, for serving on one card).

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
as ``"full"``.  The reference's ``param_specs`` and ``cache_specs`` belong
to a later slice (Whisper on a mesh, ``ROADMAP.md`` item 13c).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention_op
from .attention import decode_attention
from .base import TableModule, run_layer
from .layers import embed_lookup, rms_norm, rope, swiglu
from .transformer import scatter_kv

__all__ = ["param_table", "param_dtype", "init_rule", "cross_seq",
           "Whisper"]

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
        ``kv_positions``."""
        cfg = self.cfg
        B, S, _D = x.shape
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = rms_norm(x, lp[f"{prefix}_norm"], cfg.norm_eps)
        src = h if kv_x is None else kv_x
        kp = positions if kv_positions is None else kv_positions
        q = rope((h @ lp[f"{prefix}_wq"]).reshape(B, S, H, hd), positions,
                 cfg.rope_theta)
        k = rope((src @ lp[f"{prefix}_wk"]).reshape(B, src.shape[1], K, hd),
                 kp, cfg.rope_theta)
        v = (src @ lp[f"{prefix}_wv"]).reshape(B, src.shape[1], K, hd)
        out = flash_attention_op(q, k, v, causal=causal)
        return x + out.reshape(B, S, H * hd) @ lp[f"{prefix}_wo"]

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

    def encode(self, frames: torch.Tensor, remat: str = "none"
               ) -> torch.Tensor:
        """frames (B, Se, D), the stubbed frontend's embeddings -> the
        encoder output (B, Se, D): ``encoder_layers`` non-causal layers,
        then ``enc_final_norm``; ``remat="full"`` rematerialises each
        layer in the backward."""
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
                last_only: bool = False, remat: str = "none"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decoder pass: tokens (B, S) -> (logits (B, S or
        1, V), a zero aux loss).  ``frames`` (B, Se, D) go through
        :meth:`encode`; ``embeds`` (B, Se, D) stand in for the encoder
        output directly.  ``last_only`` computes the last position's
        logits only; ``remat="full"`` rematerialises each encoder and
        decoder layer in the backward."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = _positions(B, S, tokens.device)
        if embeds is None and frames is None:
            raise ValueError("Whisper.forward needs frames, or embeds in "
                             "place of the encoder output")
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
        return (x @ self._p("lm_head"),
                torch.zeros((), dtype=F32, device=x.device))

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``,
        ``frames``, optional ``mask``): the cross entropy, and {"ce"}."""
        logits, aux = self(batch["tokens"], frames=batch["frames"],
                           remat=remat)
        return self._loss(logits, aux, batch, moe=False)

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
        it, zero-padded past Se."""
        cfg, dev = self.cfg, self.device
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        Se = cross_seq(cfg)
        filled = 0 if filled is None else filled
        dt = cfg.param_dtype
        cache = {
            "k": torch.zeros((L, batch, max_seq, K, hd), dtype=dt, device=dev),
            "v": torch.zeros((L, batch, max_seq, K, hd), dtype=dt, device=dev),
            "xk": torch.zeros((L, batch, Se, K, hd), dtype=dt, device=dev),
            "xv": torch.zeros((L, batch, Se, K, hd), dtype=dt, device=dev),
            "len": torch.full((batch,), filled, dtype=I32, device=dev),
        }
        if enc_out is not None:
            enc_out = enc_out.to(dt)
            B, S, _D = enc_out.shape
            ep = _positions(B, S, enc_out.device)
            for i in range(L):
                lp = self._layer("dec/", i)
                cache["xk"][i, :, :S] = rope(
                    (enc_out @ lp["cross_wk"]).reshape(B, S, K, hd), ep,
                    cfg.rope_theta)
                cache["xv"][i, :, :S] = \
                    (enc_out @ lp["cross_wv"]).reshape(B, S, K, hd)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) to every sequence and return (logits
        (B, V), cache).  Self-attention runs against the KV cache, written
        at ``len % S_cache`` (it wraps); cross-attention against ``xk`` /
        ``xv``, masked to ``encoder_seq`` (the padded tail never counts).
        ``k``/``v`` are updated in place (the reference returns new
        arrays); ``len`` is a new tensor."""
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
