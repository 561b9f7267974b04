"""Attention (the port's counterpart of ``repro.models.attention``): the
materialised reference and decode attention against a KV cache, on one
card or with the cache sharded over the sequence.  The forward's
attention is the flash kernel, ``repro_torch.kernels.ops.
flash_attention_op``, called by the attention block; the reference's
``attention(impl=...)`` dispatch has no counterpart (its ``chunked``,
``ref`` and ``flash`` compute one function).

Decode is the paper-C7 "virtual mesh" layout: the KV cache is
sequence-sharded over ``rules.kv_seq`` (each rank owns a contiguous slab
of the context, like a bank of the distributed DRAM), every rank computes
partial attention for all heads over its slab, and the partials combine
with a numerically exact log-sum-exp on the reverse path:
``all_reduce(MAX)`` of the running maxima, then ``all_reduce(SUM)`` of
the rescaled numerators and denominators over the ``kv_seq`` group (the
reference's ``pmax`` / ``psum`` inside a ``shard_map`` island), including
the two-axis ``("data", "model")`` group ``cell_rules`` builds when the
batch does not divide.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel import comm

__all__ = ["repeat_kv", "reference_attention", "decode_attention"]

NEG_INF = -1e30
F32 = torch.float32


def repeat_kv(k: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*n, hd): each KV head repeated ``n``
    times in place (head ``i`` of the result is KV head ``i // n``)."""
    if n == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n, hd).reshape(b, s, kh * n, hd)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(B, Sq, Sk) additive bias: 0 where attended, -1e30 where masked."""
    ok = torch.ones(q_pos.shape + k_pos.shape[-1:], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        ok &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return torch.where(ok, 0.0, NEG_INF)


def reference_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Full softmax over materialised scores, positions 0..S-1.
    q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) with K | H (grouped natively,
    KV never repeated)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    k_positions = torch.arange(sk, device=q.device).expand(b, sk)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(F32) * hd ** -0.5
    scores = scores + _mask_bias(q_positions, k_positions, causal,
                                 window)[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype), v)
    return out.reshape(b, sq, h, hd)


def decode_attention(q, k_cache, v_cache, cache_len,
                     window: Optional[int] = None, rules=None) -> torch.Tensor:
    """One-token attention against a KV cache.  q: (B, H, hd); k/v_cache:
    (B, S, K, hd); cache_len: (B,) valid prefix length (global positions).

    With ``rules`` whose ``kv_seq`` the mesh has, ``k_cache``/``v_cache``
    are this rank's slab of the sequence, which starts at ``idx * S``
    (``idx`` the rank's row-major index over the ``kv_seq`` axes), and
    the partial statistics combine over the ``kv_seq`` group."""
    kv_axes = None if rules is None else rules._clean(rules.kv_seq)
    if kv_axes is None:
        return _local_decode(q, k_cache, v_cache, cache_len, 0, window)[0]
    mesh = rules.mesh
    offset = mesh.index(kv_axes) * k_cache.shape[1]
    _out, (num, m, den) = _local_decode(q, k_cache, v_cache, cache_len,
                                        offset, window)
    m_all = comm.all_reduce(m, mesh, kv_axes, "max")
    corr = torch.exp(m - m_all)
    num = comm.all_reduce(num * corr[..., None], mesh, kv_axes)
    den = comm.all_reduce(den * corr, mesh, kv_axes)
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)


def _local_decode(q, k, v, cache_len, pos_offset: int,
                  window: Optional[int]):
    """Decode attention over a KV slab starting at ``pos_offset``.
    Returns ``(out, (num, m, den))`` with the fp32 partial statistics."""
    b, h, hd = q.shape
    s_local, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.to(F32).reshape(b, kh, g, hd) * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(F32))
    pos = pos_offset + torch.arange(s_local, device=q.device)
    ok = pos[None, :] < cache_len[:, None]
    if window is not None:
        ok &= pos[None, :] > (cache_len[:, None] - 1 - window)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    den = p.sum(-1)
    num = torch.einsum("bkgs,bskd->bkgd", p, v.to(F32)).reshape(b, h, hd)
    m, den = m.reshape(b, h), den.reshape(b, h)
    out = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out, (num, m, den)
