"""Mamba-2 (SSD) mixer blocks (the port's counterpart of the mixer part of
``repro.models.mamba2``).

:func:`mixer_apply` runs a whole sequence through the SSD kernel
(``ssd_scan_op``: the Hopper kernel on a CUDA tensor, the token-by-token
recurrence on the CPU), as the reference does with ``ssd_impl="kernel"``.
:func:`ssd_chunked` is the reference's chunked algorithm in plain PyTorch,
kept as a second oracle for the kernel.  :func:`mixer_decode` carries the
(N, P) state and the convolution tail one token at a time.  The
attention-free LM (``mamba2-370m``) is a later slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import ssd_scan_op
from .layers import rms_norm

__all__ = ["mixer_table", "mixer_apply", "mixer_decode", "ssd_chunked"]

F32 = torch.float32


def ssd_chunked(x, dt, B, C, A, chunk: int = 256) -> torch.Tensor:
    """x: (b, S, H, P); dt: (b, S, H); B/C: (b, S, G, N); A: (H,) -> y
    like x.  The chunked SSD algorithm (intra-chunk quadratic term plus the
    inter-chunk state recurrence), all in fp32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    pad = (-s) % chunk
    if pad:                                  # dt = 0 padding is exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc, q = (s + pad) // chunk, chunk
    xf = x.to(F32).reshape(b, nc, q, h, p)
    dtf = dt.to(F32).reshape(b, nc, q, h)
    Bf = B.to(F32).repeat_interleave(hg, dim=2).reshape(b, nc, q, h, n)
    Cf = C.to(F32).repeat_interleave(hg, dim=2).reshape(b, nc, q, h, n)
    cum = torch.cumsum(dtf * A.to(F32), dim=2)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    L = torch.exp(torch.where(tri, li, -1e30))   # mask before exp
    xdt = xf * dtf[..., None]
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Cf, Bf)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb * L, xdt)
    total = cum[:, :, -1]
    decay_out = torch.exp(total[:, :, None] - cum)
    states = torch.einsum("bcqhn,bcqhp->bchnp", Bf * decay_out[..., None],
                          xdt)
    state = torch.zeros((b, h, n, p), dtype=F32, device=x.device)
    state_in = []
    for c in range(nc):                     # the state entering each chunk
        state_in.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + states[:, c]
    state_in = torch.stack(state_in, dim=1)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Cf * torch.exp(cum)[..., None], state_in)
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    conv_dim = di + 2 * s.num_groups * s.state_dim
    proj_out = 2 * di + 2 * s.num_groups * s.state_dim + nh
    return s, di, nh, conv_dim, proj_out


def mixer_table(cfg: ModelConfig, L: int) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of the parameters of ``L`` stacked mixers."""
    s, di, nh, conv_dim, proj_out = _dims(cfg)
    D = cfg.d_model
    return {
        "norm": (L, D),
        "in_proj": (L, D, proj_out),
        "conv_w": (L, s.conv_width, conv_dim),
        "conv_b": (L, conv_dim),
        "A_log": (L, nh),
        "D_skip": (L, nh),
        "dt_bias": (L, nh),
        "gate_norm": (L, di),
        "out_proj": (L, di, D),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, Cd); w: (W, Cd); b: (Cd,)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def mixer_apply(lp: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """One Mamba-2 mixer over a sequence, x (B, S, D) -> (B, S, D)
    (pre-norm and residual are the caller's)."""
    s, di, nh, conv_dim, _ = _dims(cfg)
    Bsz, S, _D = x.shape
    G, N, P = s.num_groups, s.state_dim, s.head_dim
    zxbcdt = x @ lp["in_proj"]
    z, xbc, dt = zxbcdt.split([di, conv_dim, nh], dim=-1)
    xbc = F.silu(_causal_conv(xbc, lp["conv_w"], lp["conv_b"])
                 .to(F32)).to(x.dtype)
    xs, Bmat, Cmat = xbc.split([di, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, S, nh, P)
    Bmat = Bmat.reshape(Bsz, S, G, N)
    Cmat = Cmat.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.to(F32) + lp["dt_bias"])
    A = -torch.exp(lp["A_log"].to(F32))
    y = ssd_scan_op(xs, dt.to(x.dtype), Bmat, Cmat, A, chunk=s.chunk)
    y = y + xs * lp["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, di)
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), lp["gate_norm"],
                 cfg.norm_eps)
    return y @ lp["out_proj"]


def mixer_decode(lp, x, state, conv_tail, cfg: ModelConfig):
    """One token.  x: (B, D); state: (B, H, N, P) fp32; conv_tail:
    (B, W-1, conv_dim).  Returns (out (B, D), state', conv_tail')."""
    s, di, nh, conv_dim, _ = _dims(cfg)
    Bsz = x.shape[0]
    G, N, P = s.num_groups, s.state_dim, s.head_dim
    zxbcdt = x @ lp["in_proj"]
    z, xbc, dt = zxbcdt.split([di, conv_dim, nh], dim=-1)
    window = torch.cat([conv_tail, xbc[:, None]], dim=1)     # (B, W, Cd)
    conv_out = (window * lp["conv_w"][None]).sum(1) + lp["conv_b"]
    xbc = F.silu(conv_out.to(F32)).to(x.dtype)
    new_tail = window[:, 1:]
    xs, Bmat, Cmat = xbc.split([di, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, nh, P)
    Bmat = Bmat.reshape(Bsz, G, N).repeat_interleave(nh // G, dim=1)
    Cmat = Cmat.reshape(Bsz, G, N).repeat_interleave(nh // G, dim=1)
    dt = F.softplus(dt.to(F32) + lp["dt_bias"])              # (B, H)
    A = -torch.exp(lp["A_log"].to(F32))
    decay = torch.exp(dt * A)[..., None, None]
    upd = torch.einsum("bhn,bhp->bhnp", Bmat.to(F32),
                       xs.to(F32) * dt[..., None])
    state = decay * state + upd
    y = torch.einsum("bhn,bhnp->bhp", Cmat.to(F32), state)
    y = y.to(x.dtype) + xs * lp["D_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(Bsz, di)
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), lp["gate_norm"],
                 cfg.norm_eps)
    return y @ lp["out_proj"], state, new_tail
