"""Plain PyTorch versions of the model kernels (the port's counterpart of
``repro.kernels.ref``), in the layouts of the hand-written kernels.

They are the ground truth the CPU tests hold against the JAX package and
the kernels' stand-ins on the CPU: each kernel wrapper runs its plain
version when its tensors lie on the CPU, and ``chip_smoke.py`` compares
each kernel with its plain version on the card.  They repeat the kernels'
arithmetic in fp32 and are no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref", "ssd_scan_ref", "grouped_matmul_ref",
           "NEG_INF"]

NEG_INF = -1e30
F32 = torch.float32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        kv_len: Optional[int] = None,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, K, Sk, hd) with K | H.  Full softmax
    over materialised fp32 scores; query head ``h`` reads KV head
    ``h // (H / K)``.  ``kv_len`` masks keys at and beyond it; the scale
    defaults to ``hd ** -0.5``."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    group = h // kh
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= k_pos < kv_len
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence token by token (its definition), fp32 state.

    x: (b, h, S, P); dt: (b, h, S); B/C: (b, g, S, N); A: (h,).
    ``h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T``, ``y_t = C_t^T h_t``.
    """
    b, h, s, p = x.shape
    g, n = B.shape[1], B.shape[3]
    hg = h // g
    Bh = B.repeat_interleave(hg, dim=1).to(F32)
    Ch = C.repeat_interleave(hg, dim=1).to(F32)
    xf, dtf, Af = x.to(F32), dt.to(F32), A.to(F32)
    state = torch.zeros((b, h, n, p), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dtf[:, :, t]                                   # (b, h)
        decay = torch.exp(dtt * Af[None, :])[..., None, None]
        upd = torch.einsum("bhn,bhp->bhnp", Bh[:, :, t],
                           xf[:, :, t] * dtt[..., None])
        state = decay * state + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, :, t], state))
    if not ys:
        return torch.zeros_like(x)
    return torch.stack(ys, dim=2).to(x.dtype)


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N), fp32 accumulation, output in
    ``lhs``'s dtype."""
    return torch.einsum("emk,ekn->emn", lhs.to(F32),
                        rhs.to(F32)).to(lhs.dtype)
