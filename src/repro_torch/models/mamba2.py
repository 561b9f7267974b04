"""Mamba-2 (SSD): the mixer blocks and the attention-free LM built of them
(the port's counterpart of ``repro.models.mamba2``, on one card).

:func:`mixer_apply` runs a whole sequence through the SSD kernel
(``ssd_scan_op``: the Hopper kernel on a CUDA tensor, the token-by-token
recurrence on the CPU), as the reference does with ``ssd_impl="kernel"``.
:func:`ssd_chunked` is the reference's chunked algorithm in plain PyTorch:
a second oracle for the kernel, and the recompute that ``ssd_scan_op``'s
backward differentiates.  :func:`mixer_decode` carries the (N, P) state
and the convolution tail one token at a time.  :class:`Mamba2LM`
(``mamba2-370m``) stacks the mixers, pre-norm and residual, between the
embedding and the LM head; its forward runs every mixer through the SSD
kernel, its decode step every mixer's recurrence in plain tensor code,
and its :meth:`~Mamba2LM.loss` is the reference's ``loss_fn``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import ssd_scan_op
from .base import TableModule, run_layer
from .layers import embed_lookup, rms_norm

__all__ = ["mixer_table", "mixer_apply", "mixer_decode", "ssd_chunked",
           "init_rule", "param_table", "param_dtype", "Mamba2LM"]

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


# ---------------------------------------------------------------------------
# the attention-free LM (mamba2-370m)
# ---------------------------------------------------------------------------

def init_rule(name: str) -> str:
    """How the reference initialises a parameter of the Mamba-2 layers:
    norms and ``D_skip`` ones, ``A_log`` the log of ``linspace(1, 16)``
    over the heads, ``dt_bias`` and ``conv_b`` zeros, the rest dense."""
    if "norm" in name or name.endswith("D_skip"):
        return "ones"
    if name.endswith("A_log"):
        return "A_log"
    if name.endswith(("dt_bias", "conv_b")):
        return "zeros"
    return "dense"


def param_table(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter of the LM (the reference's
    names: the mixers stacked over layers as ``layers/<name>``)."""
    t = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab_size),
    }
    for k, shape in mixer_table(cfg, cfg.num_layers).items():
        t[f"layers/{k}"] = shape
    return t


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """fp32 for ``A_log`` and ``dt_bias``; else the parameter dtype."""
    if name.endswith(("A_log", "dt_bias")):
        return F32
    return cfg.param_dtype


class Mamba2LM(TableModule):
    """The Mamba-2 LM, its parameters under the reference's names; see
    :class:`~repro_torch.models.base.TableModule` for ``params``."""

    RECURRENT_LEAVES = ("state", "conv")   # (L, B, ...)
    CACHE_BATCH_DIM = 1

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(init_rule)

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return self._stack("layers/", mixer_table(self.cfg, 1), i)

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        lp = self._layer(i)
        return x + mixer_apply(lp, rms_norm(x, lp["norm"], self.cfg.norm_eps),
                               self.cfg)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False, remat: str = "none"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S or 1, V), 0).  ``positions``
        is accepted and unused, as in the reference; ``last_only``
        computes the last position's logits only; ``remat="full"``
        rematerialises each layer in the backward."""
        cfg = self.cfg
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        for i in range(cfg.num_layers):
            x = run_layer(self._block, remat, x, i)
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), torch.zeros((), dtype=F32,
                                                   device=x.device)

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask``): the cross entropy, and {"ce"}."""
        logits, aux = self(batch["tokens"], remat=remat)
        return self._loss(logits, aux, batch, moe=False)

    def init_cache(self, batch: int, max_seq: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: each layer's fp32 SSM state
        (L, B, H, N, P), convolution tail (L, B, W-1, conv_dim) and the
        filled length (B,).  Its size does not depend on ``max_seq``."""
        cfg, dev = self.cfg, self.device
        s, _di, nh, conv_dim, _ = _dims(cfg)
        L = cfg.num_layers
        return {
            "state": torch.zeros((L, batch, nh, s.state_dim, s.head_dim),
                                 dtype=F32, device=dev),
            "conv": torch.zeros((L, batch, s.conv_width - 1, conv_dim),
                                dtype=cfg.param_dtype, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor,
                    positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) and return (logits (B, V), cache).  The
        state and convolution tensors of ``cache`` are updated in place;
        ``len`` is a new tensor."""
        cfg = self.cfg
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        for i in range(cfg.num_layers):
            lp = self._layer(i)
            out, st, ct = mixer_decode(
                lp, rms_norm(x, lp["norm"], cfg.norm_eps),
                cache["state"][i], cache["conv"][i], cfg)
            cache["state"][i] = st
            cache["conv"][i] = ct
            x = x + out
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), {**cache, "len": cache["len"] + 1}
