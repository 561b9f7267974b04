"""Shared model layers (the port's counterpart of ``repro.models.layers``):
norms, RoPE and M-RoPE, embeddings, the SwiGLU MLP, the dense
initialiser and the token-mean cross entropy.

Functions on tensors, with the reference's numerics: RMSNorm and the
rotary embedding in fp32, SiLU in fp32 cast back to the activation dtype.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["init_dense", "rms_norm", "rope", "mrope", "swiglu",
           "embed_lookup", "cross_entropy"]

F32 = torch.float32


def init_dense(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device=None,
               where: Optional[Tuple[slice, ...]] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``fan_in ** -0.5`` (fan_in = ``shape[-2]``, or ``shape[-1]`` for a
    vector).  Drawn in fp32 one slice of the leading dimensions at a time,
    so a large stacked weight never needs a whole fp32 copy, then cast.
    With ``where`` (a slice of every dimension), only that block of the
    same draw: every slice is drawn in turn and only the block's part of
    it kept, so the whole is never held."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = fan_in ** -0.5
    if where is not None and len(shape) < 2:
        return init_dense(shape, dtype, generator, device)[where]
    if where is None:
        where = tuple(slice(0, n) for n in shape)
    out = torch.empty(tuple(w.stop - w.start for w in where), dtype=dtype,
                      device=device)
    lead = where[:-2]
    for idx in itertools.product(*(range(n) for n in shape[:-2])):
        t = torch.empty(shape[-2:] if len(shape) >= 2 else (1, shape[0]),
                        dtype=F32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        if all(w.start <= i < w.stop for i, w in zip(idx, lead)):
            dst = tuple(i - w.start for i, w in zip(idx, lead))
            if len(shape) < 2:
                out.copy_(t[0].mul_(s))
            else:
                out[dst].copy_(t[where[-2], where[-1]].mul_(s))
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation whatever the activation dtype."""
    xf = x.to(F32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, half-split.  x: (B, S, H, hd); positions (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs          # (B, S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def mrope(x: torch.Tensor, positions: torch.Tensor,
          sections: Tuple[int, int, int],
          theta: float = 1e6) -> torch.Tensor:
    """Multi-dimensional RoPE (Qwen2-VL).  x: (B, S, H, hd); positions
    (3, B, S), the temporal, height and width streams; ``sections``
    splits the hd/2 frequency bands among them, in that order."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"mrope: sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    stream = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))        # band -> stream
    pos = positions.to(F32)[stream]                     # (hd/2, B, S)
    ang = pos.permute(1, 2, 0) * freqs                  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x W_g) * (x W_u), then W_d; SiLU in fp32."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return h @ w_down


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32 (logsumexp).  logits (..., V),
    labels (...) of any integer dtype; with ``mask`` (...) the masked sum
    over the mask's sum (at least 1)."""
    logits = logits.to(F32)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1)
    return nll.mean()
