"""Mixture-of-Experts with capacity-provisioned FIFO dispatch (the port's
counterpart of ``repro.models.moe``).

Tokens are routed top-k in fp32, ranked per expert in arrival order
(token-major, k-minor: the order that decides which tokens an overflowing
expert drops), scattered into (E, capacity, D) buffers with dropped
assignments sent to a discarded sink row, run through the expert SwiGLU
(the Hopper GMM kernel on a CUDA tensor, its plain version on the CPU),
and gathered back with the routing weights in fp32.  Where autograd does
not record and the operands are bf16 at a ``tma`` shape (a prefill's
capacity), the gate and up products and the SiLU between them are one
fused kernel (``moe_gmm.grouped_swiglu``); elsewhere two grouped matmuls and
the fp32 ``silu(g) * u``: the same function, bit for bit on the CPU.
The down product follows.

On a mesh (``rules``), :func:`moe_block` chooses the reference's dispatch
mode by divisibility, and each rank runs its part on its activation block
(``Layout``):

* ``tp``    — experts replicated, FFN width sharded over ``ff``: every rank
              routes the global tokens (gathered) with the global FIFO,
              runs all E experts at its F/tp slice, and the partial
              outputs are reduced (the row-parallel sum);
* ``ep``    — experts sharded over ``model`` (``_moe_dense_layout``): the
              global tokens and FIFO as in ``tp``, each rank runs its E/C
              local experts through the GMM at the global capacity, and the
              partial outputs are reduced over ``model``; the ``data`` rows
              compute the same buffers, as the reference's GSPMD layout
              replicates them there;
* ``local`` — (``_moe_local``) tokens never move: each rank routes its
              own tokens (the whole sequence of its rows) into its own
              FIFO, runs every expert at its F/tp slice, and the output is
              reduce-scattered back to sequence-sharded (``psum`` where it
              cannot scatter);
* ``xy`` / ``x`` — (``_moe_xy``) the paper's two-phase dispatch: a
              round-robin rebalance over ``data`` (Y), delivery to each
              expert's home column over ``model`` (X), the local experts
              through the GMM, and the reverse path X then Y (``x`` skips
              the Y phase), with the reference's ``cap1``/``cap2``/``cap3``.

The aux loss comes out replicated on every rank (the reference's
``_pmean_all`` over the island's axes); a training loss on a mesh counts
it once, as a value every rank holds alike (``TableModule._mesh_loss``).
Every mode trains: its collectives are ``repro_torch.parallel.comm``'s
autograd functions, so the backward runs each phase's transpose (``xy``'s
two ``all_to_all`` phases over ``data`` and ``model`` each in reverse,
``ep``'s gathers as reduce-scatters), the integer routing metadata
passes with no gradient, and the GMM's backward runs at each rank's
local experts and capacity rows.  Drops differ by layout at low
capacity, as in the reference (each FIFO sees other tokens); with a
capacity that drops nothing every mode computes the same function.
Every mode counts, while ``repro_torch.obs`` records, the assignments
each FIFO stage dropped (``moe.dropped``) and, at the buffers that reach
the expert FFN, the assignments kept (``moe.kept``), the rows the
grouped products compute (``moe.gmm_rows``) and whether the fused gate/up
kernel ran (``moe.ffn_fused``, 1 or 0), once a call;
:func:`counting_drops` collects ``moe.dropped`` alone.  Its spans are
``moe`` (the block), ``moe.route`` (routing and each FIFO),
``moe.dispatch``, ``moe.gmm`` (each grouped product) and ``moe.combine``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.moe_gmm import grouped_swiglu
from repro_torch.kernels.ops import fuses_swiglu, grouped_matmul
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Layout

__all__ = ["capacity", "router_topk", "moe_block", "moe_mode",
           "counting_drops"]

def counting_drops():
    """Within the block, each MoE call adds to the yielded list the
    ``moe.dropped`` values it counts: each FIFO stage's number of
    assignments this rank dropped, a 0-d tensor (no host sync).  Only
    that counter is on (``obs.collecting``); no span records."""
    return obs.collecting("moe.dropped")


def _dropped(keep: torch.Tensor, valid=None) -> None:
    if obs.active("moe.dropped"):
        lost = ~keep if valid is None else valid & ~keep
        obs.count("moe.dropped", lost.sum())


def _ffn_counts(keep: torch.Tensor, rows: int) -> None:
    """Once a call, at the buffers that reach the expert FFN: the
    assignments kept in them and the buffers' rows."""
    if obs.active():
        obs.count("moe.kept", keep.sum())
        obs.count("moe.gmm_rows", rows)

F32 = torch.float32


def capacity(tokens: int, m: MoEConfig) -> int:
    """Slots per expert for ``tokens`` tokens: ceil(tokens * top_k / E *
    capacity_factor), at least 8 and a multiple of 8."""
    raw = int(tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-raw // 8) * 8)


def router_topk(x2d: torch.Tensor, w_router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing in fp32.  x2d: (T, D).  Returns (idx (T, k), weights
    (T, k) renormalised, Switch load-balance aux loss)."""
    with obs.span("moe.route"):
        logits = x2d.to(F32) @ w_router.to(F32)
        probs = torch.softmax(logits, dim=-1)
        weights, idx = torch.topk(probs, k, dim=-1)
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
        E = w_router.shape[-1]
        me = probs.mean(0)
        ce = _one_hot(idx[:, 0], E).to(F32).mean(0)
        return idx, weights, E * (me * ce).sum()


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as one comparison: the same ops on every
    device (``F.one_hot`` checks the values on the CPU and takes another
    route on ``meta``, where the costing tools count the card's ops)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _fifo_slots(assign: torch.Tensor, num_experts: int, cap: int):
    """Slot of each assignment in its expert's FIFO, in arrival order:
    (slot, keep = slot < cap)."""
    with obs.span("moe.route"):
        onehot = _one_hot(assign, num_experts)
        ranks = torch.cumsum(onehot, dim=0) - onehot
        slot = ranks.gather(1, assign[:, None])[:, 0]
        return slot, slot < cap


def _dispatch(x2d, assign, slot, keep, num_experts: int, cap: int):
    """Scatter assignments into (E, cap, D) capacity buffers; dropped ones
    land in a sink row that is cut off."""
    with obs.span("moe.dispatch"):
        T_k = assign.shape[0]
        token_of = torch.arange(T_k, device=x2d.device) \
            // (T_k // x2d.shape[0])
        e_idx = torch.where(keep, assign, num_experts)
        buf = torch.zeros((num_experts + 1, cap, x2d.shape[1]),
                          dtype=x2d.dtype, device=x2d.device)
        buf.index_put_((e_idx, slot.clamp_max(cap - 1)), x2d[token_of],
                       accumulate=True)
        return buf[:num_experts]


def _combine(buf_out, assign, slot, keep, weights2d, T: int):
    """Gather expert outputs back to token order, weighted in fp32."""
    with obs.span("moe.combine"):
        gathered = buf_out[torch.where(keep, assign, 0),
                           slot.clamp_max(buf_out.shape[1] - 1)]
        gathered = torch.where(keep[:, None], gathered, 0)
        k = assign.shape[0] // T
        gathered = gathered.reshape(T, k, -1)
        return (gathered.to(F32) * weights2d[..., None]).sum(1)


def _expert_ffn(buf, w_gate, w_up, w_down):
    """(E, cap, D) -> (E, cap, D): the expert SwiGLU, each kernel call a
    ``moe.gmm`` span.  Where :func:`fuses_swiglu` holds (no autograd, bf16,
    the ``tma`` shape), h = silu(g) u is one fused call; else g and u are
    two grouped matmuls and the activation between them is the block's
    own.  Then the down product."""
    fused = fuses_swiglu(buf, w_gate, w_up)
    if obs.active():
        obs.count("moe.ffn_fused", int(fused))
    if fused:
        with obs.span("moe.gmm"):
            h = grouped_swiglu(buf, w_gate, w_up)
    else:
        with obs.span("moe.gmm"):
            g = grouped_matmul(buf, w_gate)
        with obs.span("moe.gmm"):
            u = grouped_matmul(buf, w_up)
        h = (F.silu(g.to(F32)) * u.to(F32)).to(buf.dtype)
    with obs.span("moe.gmm"):
        return grouped_matmul(h, w_down)


def _single(x, params, m):
    """The single-card FFN (the reference's ``tp`` layout without rules)."""
    Bsz, S, D = x.shape
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    idx, weights, aux = router_topk(x2d, params["router"], m.top_k)
    assign = idx.reshape(-1)
    cap = capacity(T, m)
    slot, keep = _fifo_slots(assign, m.num_experts, cap)
    _dropped(keep)
    _ffn_counts(keep, m.num_experts * cap)
    buf = _dispatch(x2d, assign, slot, keep, m.num_experts, cap)
    out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                          params["w_down"])
    out = _combine(out_buf, assign, slot, keep, weights, T)
    return out.reshape(Bsz, S, D).to(x.dtype), aux


def _names(rules, *axes):
    """The union of ``axes`` (each None, a name or a tuple), in mesh
    order."""
    got = set()
    for a in axes:
        a = rules._clean(a)
        got |= {a} if isinstance(a, str) else set(a or ())
    return tuple(n for n in rules.mesh.axis_names if n in got) or None


def _mean_all(aux, rules, names):
    """The reference's ``_pmean_all``: the mean over every island axis."""
    if not names:
        return aux
    return comm.all_reduce(aux, rules.mesh, names) / rules.axis_size(names)


def _moe_dense_layout(x, params, m, rules, lay: Layout, expert_axis,
                      ff_axis):
    """``ep`` (experts over ``expert_axis``) and ``tp`` (F over
    ``ff_axis``) on a mesh: the global tokens through the global FIFO, this
    rank's experts / F slice, the partial outputs reduced back to the
    rank's block."""
    xg = lay.gather(x, rules)
    B, S, D = xg.shape
    x2d = xg.reshape(-1, D)
    T = x2d.shape[0]
    idx, weights, aux = router_topk(x2d, params["router"], m.top_k)
    assign = idx.reshape(-1)
    cap = capacity(T, m)
    slot, keep = _fifo_slots(assign, m.num_experts, cap)
    _dropped(keep)
    red = expert_axis or ff_axis
    if expert_axis is not None:
        e_loc = m.num_experts // rules.axis_size(expert_axis)
        e0 = rules.mesh.index(expert_axis) * e_loc
        local = assign - e0
        mine = keep & (local >= 0) & (local < e_loc)
        _ffn_counts(mine, e_loc * cap)
        buf = _dispatch(x2d, local, slot, mine, e_loc, cap)
        out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                              params["w_down"])
        out = _combine(out_buf, local, slot, mine, weights, T)
    else:
        _ffn_counts(keep, m.num_experts * cap)
        buf = _dispatch(x2d, assign, slot, keep, m.num_experts, cap)
        out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                              params["w_down"])          # partial over F
        out = _combine(out_buf, assign, slot, keep, weights, T)
    out = out.reshape(B, S, D)[lay.rows(rules, B)]
    if red is not None:
        if lay.seq and rules.mesh.names(red) == ("model",):
            out = comm.reduce_scatter(out, rules.mesh, "model", 1)
            return out.to(x.dtype), aux
        out = comm.all_reduce(out, rules.mesh, red)
    return out[:, lay.positions(rules, S)].to(x.dtype), aux


def _moe_local(x, params, m, rules, lay: Layout):
    """``local`` on a mesh (the reference's ``_moe_local`` island): this
    rank's rows, the whole sequence, its own FIFO, every expert at the F
    slice of ``rules.ff``; the output reduce-scattered over ``ff`` back to
    sequence-sharded (bf16 on the wire for a bf16 model, as the
    reference), or summed where the sequence cannot scatter."""
    mesh = rules.mesh
    ff_names = _names(rules, rules.ff) or ()
    xf = comm.all_gather(x, mesh, "model", 1) if lay.seq else x
    b_l, S, D = xf.shape
    scatter = bool(ff_names) and S > 1 and all(
        S % rules.axis_size(a) == 0 for a in ff_names)
    x2d = xf.reshape(-1, D)
    T_l = x2d.shape[0]
    idx, weights, aux = router_topk(x2d, params["router"], m.top_k)
    assign = idx.reshape(-1)
    cap = capacity(T_l, m)                     # per-rank FIFO provisioning
    slot, keep = _fifo_slots(assign, m.num_experts, cap)
    _dropped(keep)
    _ffn_counts(keep, m.num_experts * cap)
    buf = _dispatch(x2d, assign, slot, keep, m.num_experts, cap)
    out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                          params["w_down"])      # partial over ff shards
    out = _combine(out_buf, assign, slot, keep, weights, T_l)
    out = out.to(x.dtype).reshape(b_l, S, D)
    if scatter:
        for a in ff_names:
            out = comm.reduce_scatter(out, mesh, a, 1)
    elif ff_names:
        out = comm.all_reduce(out, mesh, ff_names)
    aux = _mean_all(aux, rules, _names(rules, lay.batch, rules.ff))
    # the island leaves the sequence sharded over ff where it scattered;
    # the outer layout has it over model (lay.seq) or whole
    if scatter and (not lay.seq or ff_names != ("model",)):
        for a in reversed(ff_names):
            out = comm.all_gather(out, mesh, a, 1)
        scatter = False
    if lay.seq and not scatter:
        out = out[:, lay.positions(rules, S)]
    return out, aux


def _slots_buffer(n, cap, idx, slot, rows, dtype):
    """(n, cap, ...) buffer of ``dtype`` with ``rows`` added at (idx,
    slot); ``idx == n`` is the discarded sink."""
    with obs.span("moe.dispatch"):
        buf = torch.zeros((n + 1, cap) + tuple(rows.shape[1:]),
                          dtype=dtype, device=rows.device)
        buf.index_put_((idx, slot.clamp_max(cap - 1)), rows.to(dtype),
                       accumulate=True)
        return buf[:n]


def _moe_xy(x, params, m, rules, lay: Layout):
    """The paper's two-phase dispatch on a mesh (the reference's
    ``_moe_xy`` island): activations sharded over ``data`` rows and
    ``model`` sequence blocks.  Phase Y (``data``): round-robin token
    rebalance across rows.  Phase X (``model``): delivery to the expert's
    home column.  The local experts through the GMM; the combine runs the
    two phases in reverse (the response network)."""
    mesh = rules.mesh
    R, C = rules.axis_size("data"), rules.axis_size("model")
    E = m.num_experts
    if E % C:
        raise ValueError(f"xy dispatch needs experts {E} divisible by "
                         f"columns {C}")
    if C > 1 and not lay.seq:
        raise ValueError("xy dispatch needs the sequence sharded over "
                         "'model'")
    e_loc = E // C
    use_y = rules.dispatch != "x"
    b_l, s_l, D = x.shape
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    idx, weights, aux = router_topk(x2d, params["router"], m.top_k)
    assign = idx.reshape(-1)
    A = assign.shape[0]
    dev = x.device
    token_of = torch.arange(A, device=dev) // m.top_k
    if use_y:
        # phase Y (rows): round-robin rebalance along `data`
        row_of = torch.arange(A, device=dev) % R
        cap1 = max(8, -(-int(A / R * m.capacity_factor) // 8) * 8)
        slot1, keep1 = _fifo_slots(row_of, R, cap1)
        _dropped(keep1)
        r_idx = torch.where(keep1, row_of, R)
        buf1 = _slots_buffer(R, cap1, r_idx, slot1, x2d[token_of], x.dtype)
        meta1 = _slots_buffer(R, cap1, r_idx, slot1, assign + 1,
                              torch.int32)
        buf1 = comm.all_to_all(buf1, mesh, "data", 0).reshape(R * cap1, D)
        e_in = comm.all_to_all(meta1, mesh, "data", 0).reshape(-1).long() \
            - 1
        rows1 = R * cap1
    else:
        # "x": straight to the expert's home column (skips the rebalance)
        buf1, e_in, rows1 = x2d[token_of], assign, A
    # phase X (columns): deliver to the expert's home column
    col_of = torch.where(e_in >= 0, e_in // e_loc, C)
    cap2 = max(8, -(-int(rows1 * (1 if use_y else m.capacity_factor)
                         / C) // 8) * 8)
    slot2, keep2 = _fifo_slots(col_of, C + 1, cap2)
    keep2 &= e_in >= 0
    _dropped(keep2, e_in >= 0)
    c_idx = torch.where(keep2, col_of, C)
    buf2 = _slots_buffer(C, cap2, c_idx, slot2, buf1, x.dtype)
    meta2 = _slots_buffer(C, cap2, c_idx, slot2, e_in + 1, torch.int32)
    toks = comm.all_to_all(buf2, mesh, "model", 0).reshape(C * cap2, D)
    e_here = comm.all_to_all(meta2, mesh, "model", 0).reshape(-1).long() \
        - 1
    col = mesh.index("model")
    e_local = torch.where(e_here >= 0, e_here - col * e_loc, e_loc)
    # the local expert FFN over capacity buffers
    cap3 = max(8, -(-int(C * cap2 / e_loc) // 8) * 8)
    slot3, keep3 = _fifo_slots(e_local.clamp(0, e_loc), e_loc + 1, cap3)
    keep3 &= e_here >= 0
    _dropped(keep3, e_here >= 0)
    _ffn_counts(keep3, e_loc * cap3)
    el_idx = torch.where(keep3, e_local, e_loc)
    ebuf = _slots_buffer(e_loc, cap3, el_idx, slot3, toks, x.dtype)
    eout = _expert_ffn(ebuf, params["w_gate"], params["w_up"],
                       params["w_down"])
    back = eout[torch.where(keep3, e_local, 0), slot3.clamp_max(cap3 - 1)]
    back = torch.where(keep3[:, None], back, 0).to(x.dtype)
    # the reverse path (the response network): X phase, then Y
    rbuf2 = comm.all_to_all(back.reshape(C, cap2, D), mesh, "model", 0)
    got = rbuf2[torch.where(keep2, col_of, 0), slot2.clamp_max(cap2 - 1)]
    got = torch.where(keep2[:, None], got, 0)
    if use_y:
        rbuf1 = comm.all_to_all(got.reshape(R, cap1, D), mesh, "data", 0)
        out_a = rbuf1[torch.where(keep1, row_of, 0),
                      slot1.clamp_max(cap1 - 1)]
        out_a = torch.where(keep1[:, None], out_a, 0)
    else:
        out_a = got
    out = (out_a.reshape(T, m.top_k, D).to(F32)
           * weights[..., None]).sum(1)
    aux = _mean_all(aux, rules, _names(rules, "data", "model", lay.batch))
    return out.reshape(b_l, s_l, D).to(x.dtype), aux


def moe_mode(cfg: ModelConfig, rules) -> str:
    """The dispatch mode :func:`moe_block` runs under ``rules`` (the
    reference's selection by divisibility): ``xy``/``x`` where the
    sequence is sharded and E divides the columns, else ``ep`` where E
    divides the experts axis (not under ``local``), else ``local`` where
    the FFN width is sharded, else ``tp``."""
    m = cfg.moe
    if rules is None:
        return "tp"
    mode = rules.dispatch
    ep = rules.axis_size(rules.experts)
    if mode in ("auto", "xy", "x", "flat", "local"):
        if mode in ("xy", "x") and rules.seq is not None \
                and m.num_experts % rules.axis_size("model") == 0:
            return mode
        if m.num_experts % max(ep, 1) == 0 and ep > 1 and mode != "local":
            return "ep"
        if rules.axis_size(rules.ff) > 1:
            return "local"
        return "tp"
    if mode not in ("ep", "tp"):
        raise ValueError(f"unknown dispatch mode {mode!r}")
    return mode


def moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
              cfg: ModelConfig, rules=None, layout: Optional[Layout] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on (B, S, D) activations; returns (out, aux_loss).
    With ``rules``, ``x`` is this rank's block as ``layout`` places it,
    ``params`` this rank's expert weights, and the output the same
    block."""
    m = cfg.moe
    mode = moe_mode(cfg, rules)
    with obs.span("moe"):
        if rules is None:
            return _single(x, params, m)
        if mode in ("xy", "x"):
            return _moe_xy(x, params, m, rules, layout)
        if mode == "local":
            return _moe_local(x, params, m, rules, layout)
        if mode == "ep":
            return _moe_dense_layout(x, params, m, rules, layout,
                                     rules._clean(rules.experts), None)
        return _moe_dense_layout(x, params, m, rules, layout, None,
                                 rules.dim_axis(rules.ff, m.d_ff_expert))
