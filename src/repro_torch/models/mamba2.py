"""Mamba-2 (SSD): the mixer blocks and the attention-free LM built of them
(the port's counterpart of ``repro.models.mamba2``), on one card or on a
mesh of ranks.

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

**On a mesh** (``Mamba2LM(cfg, device, params, rules=rules)``) the
parameters keep the reference's layouts (``param_labels``: every mixer
weight's ``heads`` dimension over ``model`` where it divides, even the
flat, concatenated ones), and the mixer runs as a head-parallel island
(:func:`mixer_island`, where whole heads land on each column:
:func:`head_blocks`).  The reference constrains only ``xs`` and leaves
the rest to GSPMD; the port's island computes the same function:

* a rank's block of ``in_proj``'s columns ``[z | x | B | C | dt]`` (and
  of ``conv_w``/``conv_b``'s ``[x | B | C]``) is a flat slice, not its
  heads: the forward all-gathers the three weights over ``model`` once a
  layer and takes its heads' ``z``, ``x`` and ``dt`` columns and the
  whole ``B`` and ``C`` (G = 1 in every config; a rank takes the groups
  of its heads); decode gathers the (b, proj_out) product instead;
* the causal convolution runs on the whole sequence (gathered after the
  pre-norm under Megatron SP) at the rank's channels;
* the SSD kernel runs at the rank's nh/tp heads, with their A, dt and
  D skip;
* ``gate_norm`` is one RMSNorm over the whole ``d_inner``: one
  all-reduce over ``model`` of the fp32 sum of squares (b, S, 1);
* ``out_proj``'s rows are head-aligned: a row-parallel product returned
  through a reduce-scatter (or a sum) over ``model``.

Where whole heads do not land on each column, or under
``manual_tp=False``, the layer's weights are gathered and the single-card
mixer runs on the gathered sequence.  Decode moves no weight: the
(b, proj_out) ``in_proj`` product's blocks are gathered instead, and the
convolution runs on the rank's flat block of ``conv_dim`` (its
``conv_w`` block), so the decode cache keeps the reference's layout
(:func:`cache_specs`: the state over heads, the convolution tail's flat
``conv_dim`` over heads).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import ssd_scan_op
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Layout, Rules
from .base import (TableModule, run_layer, seq_gather, seq_return,
                   stack_specs, whole)
from .layers import embed_lookup, rms_norm

__all__ = ["mixer_table", "mixer_labels", "mixer_apply", "mixer_decode",
           "ssd_chunked", "head_blocks", "mixer_island", "mixer_spmd",
           "mixer_decode_spmd", "mixer_cache_shapes", "init_rule",
           "param_table", "param_labels", "param_dtype", "cache_specs",
           "Mamba2LM"]

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


def mixer_labels() -> Dict[str, Tuple]:
    """Name -> the logical axis of each dimension of the stacked mixers
    (the reference table's: ``heads`` on every head-carrying dimension,
    the flat ``proj_out`` and ``conv_dim`` included)."""
    h = "heads"
    return {"norm": (None, None), "in_proj": (None, None, h),
            "conv_w": (None, None, h), "conv_b": (None, h),
            "A_log": (None, h), "D_skip": (None, h), "dt_bias": (None, h),
            "gate_norm": (None, h), "out_proj": (None, h, None)}


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
# the mixer on a mesh (the head-parallel island)
# ---------------------------------------------------------------------------

MIXER_NAMES = tuple(mixer_labels())


def head_blocks(cfg: ModelConfig, rules: Optional[Rules]) -> int:
    """The columns of the head-parallel island (the ``model`` axis'
    size), or 0 where it does not apply: no mesh, heads not laid over
    ``model``, one column, heads that do not divide the columns, or a
    rank's heads that straddle a group of ``B``/``C``."""
    if rules is None or rules.heads != "model" or not rules.has_axis("model"):
        return 0
    tp = rules.axis_size("model")
    nh = _dims(cfg)[2]
    if tp <= 1 or nh % tp:
        return 0
    hl, hg = nh // tp, nh // cfg.ssm.num_groups
    return 0 if hl % hg and hg % hl else tp


def _island_index(cfg: ModelConfig, rules: Rules, device):
    """What this rank reads of a mixer: (its heads' ``z`` columns of
    ``in_proj``'s [z | x | B | C | dt], the channels of the convolution's
    [x | B | C] it reads (its heads' ``x``, its groups' ``B`` and ``C``),
    its heads' ``dt`` columns, its heads, its groups)."""
    s, di, nh, conv_dim, _ = _dims(cfg)
    P, N, G = s.head_dim, s.state_dim, s.num_groups
    hl = nh // rules.axis_size("model")
    h0 = rules.mesh.index("model") * hl
    hg = nh // G
    g0, gl = h0 // hg, max(hl // hg, 1)

    def span(a, n):
        return torch.arange(a, a + n, device=device)

    conv = torch.cat([span(h0 * P, hl * P), di + span(g0 * N, gl * N),
                      di + G * N + span(g0 * N, gl * N)])
    return (span(h0 * P, hl * P), conv, di + conv_dim + span(h0, hl), hl,
            gl)


def _own(t: torch.Tensor, entry, dim: int, rules: Rules) -> torch.Tensor:
    """This rank's heads of a head-aligned tensor (``A_log``, ``D_skip``,
    ``dt_bias``, ``gate_norm``, ``out_proj``'s rows): its block where the
    dimension is laid over ``model``, else its slice."""
    if entry is not None:
        return t
    n = t.shape[dim] // rules.axis_size("model")
    return t.narrow(dim, rules.mesh.index("model") * n, n)


def _gate_norm(y, z, scale, cfg: ModelConfig, rules: Rules, width: int):
    """``rms_norm(y * silu(z), scale)`` over the whole ``d_inner`` of
    ``width`` from this rank's heads' part: the fp32 sum of squares
    all-reduced over ``model``."""
    g = (y * F.silu(z.to(F32)).to(y.dtype)).to(F32)
    ss = comm.all_reduce(g.square().sum(-1, keepdim=True), rules.mesh,
                         "model")
    return (g * torch.rsqrt(ss / width + cfg.norm_eps)
            * scale.to(F32)).to(y.dtype)


def mixer_island(lp: Dict[str, torch.Tensor], h: torch.Tensor,
                 cfg: ModelConfig, rules: Rules, lspecs) -> torch.Tensor:
    """The head-parallel mixer: ``h`` (b, S, D) the normed input, this
    rank's rows and the whole sequence; ``lp`` its blocks of one mixer's
    weights, laid out by ``lspecs``.  Returns this rank's part (b, S, D)
    of the output, a sum over ``model``.  ``in_proj``, ``conv_w`` and
    ``conv_b`` are gathered (their blocks are flat slices, not heads);
    the SSD kernel runs at this rank's heads."""
    s, di, _nh, _cd, _ = _dims(cfg)
    b, S, _D = h.shape
    P, N = s.head_dim, s.state_dim
    zc, conv, dc, hl, gl = _island_index(cfg, rules, h.device)
    w = whole(lp, lspecs, ("in_proj", "conv_w", "conv_b"), rules)
    zxbcdt = h @ w["in_proj"].index_select(-1, torch.cat([zc, di + conv,
                                                          dc]))
    z, xbc, dt = zxbcdt.split([len(zc), len(conv), hl], dim=-1)
    xbc = F.silu(_causal_conv(xbc, w["conv_w"].index_select(-1, conv),
                              w["conv_b"].index_select(-1, conv))
                 .to(F32)).to(h.dtype)
    xs, Bm, Cm = xbc.split([hl * P, gl * N, gl * N], dim=-1)
    xs = xs.reshape(b, S, hl, P)

    def own(k):
        return _own(lp[k], lspecs[k][0], 0, rules)

    dt = F.softplus(dt.to(F32) + own("dt_bias"))
    A = -torch.exp(own("A_log").to(F32))
    y = ssd_scan_op(xs, dt.to(h.dtype), Bm.reshape(b, S, gl, N),
                    Cm.reshape(b, S, gl, N), A, chunk=s.chunk)
    y = y + xs * own("D_skip").to(h.dtype)[None, None, :, None]
    y = _gate_norm(y.reshape(b, S, hl * P), z, own("gate_norm"), cfg, rules,
                   di)
    return y @ own("out_proj")


def mixer_spmd(lp: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, rules: Rules, lay: Layout, lspecs
               ) -> torch.Tensor:
    """One mixer with its pre-norm and residual on this rank's block x
    (b, s, D): the normed input gathered over the sequence (Megatron SP),
    then :func:`mixer_island` returned through a reduce-scatter (or a
    sum) over ``model``; where the island does not apply (or under
    ``manual_tp=False``), the weights gathered and the single-card mixer,
    keeping this rank's positions."""
    h = seq_gather(rms_norm(x, lp["norm"], cfg.norm_eps), rules, lay)
    if rules.manual_tp and head_blocks(cfg, rules):
        out = mixer_island(lp, h, cfg, rules, lspecs).to(x.dtype)
        return x + seq_return(out, rules, lay)
    out = mixer_apply(whole(lp, lspecs, MIXER_NAMES, rules), h, cfg)
    return x + out[:, lay.positions(rules, out.shape[1])]


def _conv_axis(cfg: ModelConfig, rules: Optional[Rules]):
    """The mesh axes a decode cache's convolution tail is laid over where
    the island applies: ``conv_w``'s own (its flat ``conv_dim`` over
    ``heads``, the reference's ``cache_specs``), else None."""
    if not head_blocks(cfg, rules):
        return None
    return rules.dim_axis(rules.heads, _dims(cfg)[3])


def mixer_cache_shapes(cfg: ModelConfig, rules: Optional[Rules],
                       batch: int):
    """(the SSM state's, the convolution tail's) shape a rank holds for
    ``batch`` rows of one mixer: its heads' state and its block of the
    flat ``conv_dim`` channels (``conv_w``'s), or the whole of both where
    the island does not apply."""
    s, _di, nh, conv_dim, _ = _dims(cfg)
    P, N, W = s.head_dim, s.state_dim, s.conv_width
    tp = head_blocks(cfg, rules)
    if not tp:
        return (batch, nh, N, P), (batch, W - 1, conv_dim)
    conv = conv_dim // rules.axis_size(_conv_axis(cfg, rules))
    return (batch, nh // tp, N, P), (batch, W - 1, conv)


@torch.no_grad()
def mixer_decode_spmd(lp, x, state, conv_tail, cfg: ModelConfig,
                      rules: Rules, lspecs):
    """One token of one mixer on a mesh (pre-norm and residual the
    caller's): x (b, D) this rank's rows, ``state``/``conv_tail`` its
    cache (:func:`mixer_cache_shapes`).  Head-parallel: the ``in_proj``
    product's column blocks gathered (b, proj_out); the convolution on
    this rank's flat block of the channels (its ``conv_w`` block and its
    tail), the (b, conv_dim) outputs gathered and its heads' ``x`` and its
    groups' ``B``/``C`` taken; the recurrence at its heads; the gate
    norm's sum of squares and ``out_proj``'s row-parallel product summed
    over ``model``.  No weight moves.  Returns (out (b, D), state',
    conv_tail')."""
    if not head_blocks(cfg, rules):
        return mixer_decode(whole(lp, lspecs, MIXER_NAMES, rules), x, state,
                            conv_tail, cfg)
    s, di, _nh, conv_dim, _ = _dims(cfg)
    b = x.shape[0]
    P, N = s.head_dim, s.state_dim
    zc, conv, dc, hl, gl = _island_index(cfg, rules, x.device)
    p = x @ lp["in_proj"]
    a = lspecs["in_proj"][-1]
    if a is not None:
        p = comm.all_gather(p, rules.mesh, a, 1)
    ca = lspecs["conv_w"][-1]
    n = conv_dim // rules.axis_size(ca)
    c0 = rules.mesh.index(ca) * n if ca is not None else 0
    window = torch.cat([conv_tail, p[:, None, di + c0:di + c0 + n]], dim=1)
    out = (window * lp["conv_w"][None]).sum(1) + lp["conv_b"]
    if ca is not None:
        out = comm.all_gather(out, rules.mesh, ca, 1)
    xbc = F.silu(out.index_select(-1, conv).to(F32)).to(x.dtype)
    xs, Bm, Cm = xbc.split([hl * P, gl * N, gl * N], dim=-1)
    xs = xs.reshape(b, hl, P)
    Bm = Bm.reshape(b, gl, N).repeat_interleave(hl // gl, dim=1)
    Cm = Cm.reshape(b, gl, N).repeat_interleave(hl // gl, dim=1)

    def own(k):
        return _own(lp[k], lspecs[k][0], 0, rules)

    dt = F.softplus(p.index_select(-1, dc).to(F32) + own("dt_bias"))
    A = -torch.exp(own("A_log").to(F32))
    decay = torch.exp(dt * A)[..., None, None]
    upd = torch.einsum("bhn,bhp->bhnp", Bm.to(F32),
                       xs.to(F32) * dt[..., None])
    state = decay * state + upd
    y = torch.einsum("bhn,bhnp->bhp", Cm.to(F32), state)
    y = y.to(x.dtype) + xs * own("D_skip").to(x.dtype)[None, :, None]
    y = _gate_norm(y.reshape(b, hl * P), p.index_select(-1, zc),
                   own("gate_norm"), cfg, rules, di)
    out = comm.all_reduce(y @ own("out_proj"), rules.mesh, "model")
    return out, state, window[:, 1:]


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


def param_labels(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Name -> the logical axis of each dimension (the reference table's:
    the embedding and the head over ``vocab``, the mixers'
    :func:`mixer_labels`)."""
    t = {"embed": ("vocab", None), "final_norm": (None,),
         "lm_head": (None, "vocab")}
    for k, labels in mixer_labels().items():
        t[f"layers/{k}"] = labels
    return t


def cache_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
    """The decode cache's blocks a rank holds (the reference's
    ``cache_specs`` where the island applies): ``state`` (L, B, nh, N, P)
    over ``batch`` and ``heads``, the convolution tail ``conv`` (L, B,
    W-1, conv_dim) over ``batch`` and, like ``conv_w``, its flat
    ``conv_dim`` over ``heads``; ``len`` (B,) over ``batch``.  Where the
    island does not apply the state and the tail are whole."""
    b = rules._clean(rules.batch)
    h = "model" if head_blocks(cfg, rules) else None
    return {"state": (None, b, h, None, None),
            "conv": (None, b, None, _conv_axis(cfg, rules)), "len": (b,)}


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
    STACKED = ("layers/",)

    param_table = staticmethod(param_table)
    param_dtype = staticmethod(param_dtype)
    init_rule = staticmethod(init_rule)
    param_labels = staticmethod(param_labels)
    cache_specs = staticmethod(cache_specs)

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return self._stack("layers/", MIXER_NAMES, i)

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        lp = self._layer(i)
        return x + mixer_apply(lp, rms_norm(x, lp["norm"], self.cfg.norm_eps),
                               self.cfg)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False, remat: str = "none",
                rules: Optional[Rules] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S or 1, V), 0).  ``positions``
        is accepted and unused, as in the reference; ``last_only``
        computes the last position's logits only; ``remat="full"``
        rematerialises each layer in the backward.  On a mesh every rank
        passes the global tokens and gets the global logits."""
        cfg = self.cfg
        rules = self._rules(rules)
        if rules is not None:
            lay = Layout.of(rules, *tokens.shape)
            x = self._spmd_trunk(tokens, rules, lay, remat)
            return (self._spmd_out(x, last_only, rules, lay,
                                   self.layout_specs(cfg, rules)),
                    torch.zeros((), dtype=F32, device=x.device))
        x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
        for i in range(cfg.num_layers):
            x = run_layer(self._block, remat, x, i)
        if last_only:
            x = x[:, -1:]
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), torch.zeros((), dtype=F32,
                                                   device=x.device)

    def _spmd_trunk(self, tokens, rules: Rules, lay: Layout, remat: str):
        """The embedding and every mixer on this rank's block of the
        global ``tokens``: x (b, s, D)."""
        specs = self.layout_specs(self.cfg, rules)
        lspecs = stack_specs(specs, "layers/", MIXER_NAMES)
        x = self._embed(tokens[lay.rows(rules, tokens.shape[0])], rules,
                        lay, specs)

        def block(x, i):
            return mixer_spmd(self._layer(i), x, self.cfg, rules, lay,
                              lspecs)

        for i in range(self.cfg.num_layers):
            x = run_layer(block, remat, x, i)
        return x

    def loss(self, batch: Dict[str, torch.Tensor], remat: str = "none",
             rules: Optional[Rules] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels``, optional
        ``mask``): the cross entropy, and {"ce"}; on a mesh the global
        loss with this rank's share's gradient
        (``TableModule._mesh_loss``)."""
        rules = self._rules(rules)
        if rules is None:
            logits, aux = self(batch["tokens"], remat=remat)
            return self._loss(logits, aux, batch, moe=False)
        lay = Layout.of(rules, *batch["tokens"].shape)
        x = self._spmd_trunk(batch["tokens"], rules, lay, remat)
        nll, count = self._spmd_ce(x, batch, rules, lay,
                                   self.layout_specs(self.cfg, rules))
        return self._mesh_loss(nll, count, None, rules, moe=False)

    def init_cache(self, batch: int, max_seq: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """Decode cache on the model's device: each layer's fp32 SSM state
        (L, B, H, N, P), convolution tail (L, B, W-1, conv_dim) and the
        filled length (B,).  Its size does not depend on ``max_seq``.  On
        a mesh, this rank's part (:func:`cache_specs`)."""
        cfg, dev = self.cfg, self.device
        L = cfg.num_layers
        batch = self._cache_batch(batch)
        state, conv = mixer_cache_shapes(cfg, self.rules, batch)
        return {
            "state": torch.zeros((L,) + state, dtype=F32, device=dev),
            "conv": torch.zeros((L,) + conv, dtype=cfg.param_dtype,
                                device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    rules: Optional[Rules] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Append ``tokens`` (B,) and return (logits (B, V), cache).  The
        state and convolution tensors of ``cache`` are updated in place;
        ``len`` is a new tensor.  On a mesh every rank passes the global
        tokens with its own cache and gets the global logits."""
        cfg = self.cfg
        rules = self._rules(rules)
        if rules is None:
            x = embed_lookup(self._p("embed"), tokens).to(cfg.param_dtype)
            step = mixer_decode
        else:
            lay = Layout(rules.dim_axis(rules.batch, tokens.shape[0]), False)
            specs = self.layout_specs(cfg, rules)
            lspecs = stack_specs(specs, "layers/", MIXER_NAMES)
            x = self._embed(tokens[lay.rows(rules, tokens.shape[0])][:, None],
                            rules, lay, specs)[:, 0]

            def step(lp, h, st, ct, cfg):
                return mixer_decode_spmd(lp, h, st, ct, cfg, rules, lspecs)
        for i in range(cfg.num_layers):
            lp = self._layer(i)
            out, st, ct = step(lp, rms_norm(x, lp["norm"], cfg.norm_eps),
                               cache["state"][i], cache["conv"][i], cfg)
            cache["state"][i] = st
            cache["conv"][i] = ct
            x = x + out
        if rules is not None:
            return self._logits(x, rules, lay, specs), \
                {**cache, "len": cache["len"] + 1}
        x = rms_norm(x, self._p("final_norm"), cfg.norm_eps)
        return x @ self._p("lm_head"), {**cache, "len": cache["len"] + 1}
