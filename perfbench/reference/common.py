"""The layers the references share, in fp32: RMSNorm, RoPE, causal GQA
attention (in blocks of queries), the SwiGLU MLP, the top-k MoE with its
capacity FIFO, the Mamba-2 mixer with a chunked SSD, and the head.

Every product of activations with a weight goes through ``linear(x, w)``
(x (T, in), w (in, out), w in the dtype it is served in).
:func:`fp32_linear` is the reference; :func:`fp8_linear` computes the same
product with both operands rounded to fp8 e4m3 (per-row and per-column
scales), the control that a comparison must refuse.  The router's weight
is fp32 in the configuration and stays fp32 in both.

**Paths.**  Only the last position's logits are served.  The routing
of the last ``suffix`` positions holds discrete decisions (an expert
among the top k or not; an assignment within its expert's capacity or
not) which bf16 rounding may take the other way where they lie within
rounding of a tie, and either way is right; through the convolution and
the short memory of the SSM, a neighbour's decision moves the last
position's logits nearly as much as its own.  With a ``rule``
(``Paths``), each such decision within the rule of its tie adds a
*path*: the last ``suffix`` positions with that decision taken the other
way, carried through the later layers against the context of the
positions before them (whose keys, values, convolution window, state
and expert loads are the reference's).  Every block takes the paths'
normed inputs ``hl`` (n, suffix, D) beside the sequence's and returns
their outputs beside its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0                      # largest finite float8_e4m3fn

Linear = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def exact_fp32():
    """Within the block, fp32 matrix products on the card are full fp32
    (TF32 off); the settings before it are restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp32_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(F32) @ w.to(F32)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale per slice along
    ``dim`` (the largest magnitude maps to 448), back in fp32."""
    t = t.to(F32)
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with x rounded to fp8 per row (token) and w per output
    column, accumulated in fp32: what an fp8 GEMM computes."""
    return _fp8(x, -1) @ _fp8(w, 0)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x / torch.sqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope(x: torch.Tensor, theta: float, start: int = 0) -> torch.Tensor:
    """Rotary embedding at positions start..start+S-1, the two halves of
    each head rotated as pairs.  x (S, heads, hd)."""
    S, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-2.0 * torch.arange(half, dtype=F32, device=x.device) / hd)
    ang = torch.outer(torch.arange(start, start + S, dtype=F32,
                                   device=x.device), inv)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(h: torch.Tensor, hl: torch.Tensor, wq, wk, wv, wo, cfg: Dict,
              linear: Linear, block: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal GQA self-attention with RoPE of h (S, D) -> (S, D), softmax
    over keys 0..i (and i - window < j with a window), query head h
    reading KV head h // (H / K); computed ``block`` queries at a time.
    The paths ``hl`` (n, m, D) sit at positions S-m..S-1, over the keys
    of positions 0..S-m-1 and their own."""
    S = h.shape[0]
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    window = cfg.get("sliding_window")
    q = rope(linear(h, wq).reshape(S, H, hd), cfg["rope_theta"])
    k = rope(linear(h, wk).reshape(S, K, hd), cfg["rope_theta"])
    v = linear(h, wv).reshape(S, K, hd)
    g = H // K

    def mask(qi, kj):
        ok = kj[None, :] <= qi[:, None]
        if window is not None:
            ok &= kj[None, :] > qi[:, None] - window
        return ok

    out = torch.empty((S, H, hd), dtype=F32, device=h.device)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        j0 = 0 if window is None else max(0, i0 - window + 1)
        qb = q[i0:i1].reshape(i1 - i0, K, g, hd)
        s = torch.einsum("qkgd,skd->kgqs", qb, k[j0:i1]) * hd ** -0.5
        s = s.masked_fill(~mask(torch.arange(i0, i1, device=h.device),
                                torch.arange(j0, i1, device=h.device)),
                          float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[i0:i1] = torch.einsum("kgqs,skd->qkgd", p,
                                  v[j0:i1]).reshape(i1 - i0, H, hd)
    out = linear(out.reshape(S, H * hd), wo)
    n, m = hl.shape[:2]
    if n == 0:
        return out, hl

    def at(x, heads):           # (n, m, heads*hd) -> RoPE at S-m..S-1
        x = x.reshape(n, m, heads, hd).transpose(0, 1)
        x = rope(x.reshape(m, n * heads, hd), cfg["rope_theta"], S - m)
        return x.reshape(m, n, heads, hd).transpose(0, 1)

    ql = at(linear(hl, wq), H).reshape(n, m, K, g, hd)
    kl = at(linear(hl, wk), K)
    vl = linear(hl, wv).reshape(n, m, K, hd)
    pos = torch.arange(S - m, S, device=h.device)
    j0 = 0 if window is None else max(0, S - m - window + 1)
    ctx = torch.arange(j0, S - m, device=h.device)
    s_ctx = torch.einsum("nikgd,skd->nkgis", ql, k[j0:S - m]) * hd ** -0.5
    s_own = torch.einsum("nikgd,njkd->nkgij", ql, kl) * hd ** -0.5
    s = torch.cat([s_ctx.masked_fill(~mask(pos, ctx), float("-inf")),
                   s_own.masked_fill(~mask(pos, pos), float("-inf"))], -1)
    p = torch.softmax(s, dim=-1)
    c = ctx.numel()
    ol = torch.einsum("nkgis,skd->nikgd", p[..., :c], v[j0:S - m]) \
        + torch.einsum("nkgij,njkd->nikgd", p[..., c:], vl)
    return out, linear(ol.reshape(n, m, H * hd), wo)


def swiglu(h: torch.Tensor, w_gate, w_up, w_down,
           linear: Linear) -> torch.Tensor:
    return linear(F.silu(linear(h, w_gate)) * linear(h, w_up), w_down)


def capacity(tokens: int, moe: Dict) -> int:
    """Rows of each expert's FIFO: floor(tokens x top_k x capacity_factor
    / experts) + 1, rounded up to a multiple of 8, at least 8."""
    raw = int(tokens * moe["top_k"] * moe["capacity_factor"]
              / moe["num_experts"]) + 1
    return max(8, 8 * -(-raw // 8))


@dataclasses.dataclass
class Route:
    """One position's routing in one MoE layer: its experts, their
    renormalised weights, and whether each assignment is kept."""
    experts: List[int]
    weights: List[float]
    kept: List[bool]


def _route(logits: torch.Tensor, k: int, load: torch.Tensor, cap: int,
           swap: bool = False) -> Route:
    """The top-k route of one position's router logits (E,) (with
    ``swap``, the k-th expert replaced by the next), each assignment kept
    while the expert's earlier ``load`` is under ``cap``."""
    order = torch.argsort(logits, descending=True).tolist()
    experts = order[:k - 1] + [order[k] if swap else order[k - 1]]
    probs = torch.softmax(logits, dim=-1)[experts]
    weights = (probs / probs.sum()).tolist()
    return Route(experts, weights, [int(load[e]) < cap for e in experts])


def _forks(logits: torch.Tensor, route: Route, k: int, load, cap: int,
           rule: Dict) -> List[Tuple[float, Route]]:
    """The routes one position may take besides ``route`` under the
    rule, each with how near its tie lies: the k-th and next experts
    swapped where their logits lie within ``rule["margin"]``; an
    assignment kept where it was dropped, or the reverse, where its
    expert's load lies within ``rule["slack"]`` of the capacity (as a
    share of it)."""
    out = []
    top = torch.topk(logits, min(k + 1, logits.numel())).values
    if logits.numel() > k:
        gap = float(top[k - 1] - top[k])
        if gap < rule["margin"]:
            out.append((gap / rule["margin"],
                        _route(logits, k, load, cap, swap=True)))
    for i, e in enumerate(route.experts):
        far = (abs(int(load[e]) - cap + 0.5) - 0.5) / cap
        if far < rule["slack"]:
            kept = list(route.kept)
            kept[i] = not kept[i]
            out.append((far / rule["slack"],
                        Route(route.experts, route.weights, kept)))
    return out


def moe(h: torch.Tensor, hl: torch.Tensor, router, w_gate, w_up, w_down,
        cfg: Dict, linear: Linear, stats: Optional[List[Dict]] = None,
        rule: Optional[Dict] = None, scores: Sequence[float] = ()):
    """Top-k MoE of h (T, D): softmax over the router's fp32 logits, the
    top_k weights renormalised; each expert keeps the first ``capacity``
    assignments that reach it in arrival order (token by token, then by
    rank k) and drops the rest; each kept assignment adds its weight times
    the expert's SwiGLU of the token.

    The paths ``hl`` (n, m, D) stand for the last m positions.  Returns
    (the output (T, D), the paths' (n, m, D), and with a ``rule`` the
    forks: (source, score, output (m, D)) for each other route of one of
    the last m positions of the sequence (source -1) or of a path
    (source i) that the rule allows, at most ``rule["most"]`` of them,
    the lowest scores first: a fork's score is its source's (0 for the
    sequence; the paths' ``scores``) plus how near its tie lies, in
    (0, 1), so that a path of fewer and nearer ties scores lower).

    With ``stats``, appends the layer's routing: the share of assignments
    dropped at capacity, and for the last token (the one whose logits are
    served) whether one of its assignments was dropped, its router
    margin (the k-th largest logit less the next) and its slack (the
    least distance, over its assignments, between its place in its
    expert's FIFO and the capacity, as a share of the capacity)."""
    m = cfg["moe"]
    T, k, E = h.shape[0], m["top_k"], m["num_experts"]
    logits = h.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)
    weight, expert = torch.topk(probs, k, dim=-1)
    weight = weight / weight.sum(-1, keepdim=True)
    expert, weight = expert.reshape(-1), weight.reshape(-1)
    token = torch.arange(T, device=h.device).repeat_interleave(k)
    # rank of each assignment among those of its expert, in arrival order
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(expert)
    rank[order] = torch.arange(expert.numel(), device=h.device) \
        - first[expert[order]]
    cap = capacity(T, m)
    kept = rank < cap
    if stats is not None:
        top = torch.topk(logits[-1], min(k + 1, E)).values
        last = rank[-k:]
        stats.append({"dropped": float((~kept).float().mean()),
                      "last_dropped": bool((~kept[-k:]).any()),
                      "last_margin": float(top[k - 1] - top[k])
                      if E > k else float("inf"),
                      "last_slack": float(torch.where(
                          last < cap, cap - 1 - last, last - cap).min())
                      / cap})
    out = torch.zeros((T, h.shape[1]), dtype=F32, device=h.device)
    for e in range(E):
        sel = kept & (expert == e)
        if not bool(sel.any()):
            continue
        t = token[sel]
        y = swiglu(h[t], w_gate[e], w_up[e], w_down[e], linear)
        out.index_add_(0, t, y * weight[sel][:, None])
    n, sm = hl.shape[:2]
    if n == 0 and rule is None:
        return out, hl, []

    # every assignment before the last sm positions holds a place in its
    # expert's FIFO, kept or not; each of those positions routes in turn
    load0 = torch.bincount(expert[:(T - sm) * k], minlength=E)

    def routes(lg, over=None):
        load, got = load0.clone(), []
        for i in range(sm):
            r = (over or {}).get(i) or _route(lg[i], k, load, cap)
            got.append((r, load.clone()))
            load[r.experts] += 1
        return got

    jobs: List[Tuple[int, int, torch.Tensor, int, float]] = []

    def apply(slot: int, x, rs) -> None:
        for i, (r, _) in enumerate(rs):
            for e, w, keep in zip(r.experts, r.weights, r.kept):
                if keep:
                    jobs.append((slot, i, x[i], e, w))

    sources = [(-1, h[T - sm:], logits[T - sm:])]
    sources += [(s, hl[s], hl[s].to(F32) @ router.to(F32))
                for s in range(n)]
    for s, x, lg in sources[1:]:
        apply(s, x, routes(lg))
    forks = []
    if rule is not None:
        cands = []
        for s, x, lg in sources:
            rs = routes(lg)
            for i, (r, load) in enumerate(rs):
                for near, alt in _forks(lg[i], r, k, load, cap, rule):
                    cands.append(((scores[s] if s >= 0 else 0.0) + near,
                                  s, i, alt))
        cands.sort(key=lambda c: c[0])
        for score, s, i, alt in cands[:rule["most"]]:
            x, lg = sources[s + 1][1], sources[s + 1][2]
            forks.append((s, score))
            apply(n + len(forks) - 1, x, routes(lg, {i: alt}))
    ys = torch.zeros((n + len(forks), sm, h.shape[1]), dtype=F32,
                     device=h.device)
    for e in sorted({j[3] for j in jobs}):
        mine = [j for j in jobs if j[3] == e]
        y = swiglu(torch.stack([j[2] for j in mine]), w_gate[e], w_up[e],
                   w_down[e], linear)
        for (slot, i, _, _, w), yj in zip(mine, y):
            ys[slot, i] += w * yj
    return out, ys[:n], [(s, score, y) for (s, score), y
                         in zip(forks, ys[n:])]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The selective state-space recurrence h_t = exp(dt_t A) h_{t-1} +
    dt_t B_t x_t^T, y_t = C_t h_t from a zero state, computed by chunks:
    within a chunk the quadratic form, across chunks the carried state.
    x (S, H, P), dt (S, H), A (H,), B/C (S, G, N) shared by H/G heads."""
    S, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    pad = (-S) % chunk
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    nc, Q = (S + pad) // chunk, chunk
    rep = H // G
    x = x.reshape(nc, Q, H, P)
    dt = dt.reshape(nc, Q, H)
    B = B.repeat_interleave(rep, dim=1).reshape(nc, Q, H, N)
    C = C.repeat_interleave(rep, dim=1).reshape(nc, Q, H, N)
    a = torch.cumsum(dt * A, dim=1)                     # (nc, Q, H)
    xdt = x * dt[..., None]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = a[:, :, None, :] - a[:, None, :, :]           # (nc, t, s, H)
    decay = torch.where(causal[None, :, :, None], seg,
                        float("-inf")).exp()
    scores = torch.einsum("cthn,cshn->ctsh", C, B) * decay
    y = torch.einsum("ctsh,cshp->cthp", scores, xdt)
    # each chunk's own contribution to the state at its end
    to_end = (a[:, -1:, :] - a).exp()                   # (nc, Q, H)
    local = torch.einsum("cshn,cshp->chnp", B * to_end[..., None], xdt)
    state = torch.zeros((H, N, P), dtype=F32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = a[c, -1].exp()[:, None, None] * state + local[c]
    entering = torch.stack(entering)                    # (nc, H, N, P)
    y = y + torch.einsum("cthn,chnp->cthp", C * a.exp()[..., None], entering)
    return y.reshape(nc * Q, H, P)[:S]


def conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution: out[t, c] = b[c] + sum_j w[j, c] x[t -
    (W-1) + j, c], zero before the start.  x (S, Cd), w (W, Cd)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    S = x.shape[0]
    return sum(xp[j:j + S] * w[j].to(F32) for j in range(W)) + b.to(F32)


def ssd_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor) -> torch.Tensor:
    """The state (H, N, P) of the recurrence in :func:`ssd` after all S
    positions, from a zero state: sum over t of exp(sum_{s>t} dt_s A)
    dt_t B_t x_t^T, the decays summed in fp64."""
    S, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    if S == 0:
        return x.new_zeros((H, N, P))
    a = torch.cumsum(dt.double() * A.double(), dim=0)          # (S, H)
    w = ((a[-1] - a).exp() * dt.double()).to(F32)             # (S, H)
    Bh = B.repeat_interleave(H // G, dim=1)                   # (S, H, N)
    return torch.einsum("sh,shn,shp->hnp", w, Bh, x)


def mamba2_mixer(h: torch.Tensor, hl: torch.Tensor,
                 lp: Dict[str, torch.Tensor], cfg: Dict, linear: Linear
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 mixer of h (S, D) -> (S, D): in_proj into z, x|B|C and
    dt; the causal convolution and SiLU over x|B|C; dt through softplus
    with its bias; the SSD with A = -exp(A_log) and the D skip; the output
    gated by SiLU(z), RMS-normed over d_inner, then out_proj.  The paths
    ``hl`` (n, m, D) sit at positions S-m..S-1, after the convolution
    window and the state of positions 0..S-m-1."""
    s = cfg["ssm"]
    S, D = h.shape
    di = s["expand"] * D
    P, N, G = s["head_dim"], s["state_dim"], s["num_groups"]
    nh = di // P
    conv_dim = di + 2 * G * N
    A = -lp["A_log"].to(F32).exp()

    def tail(y, xs, z):
        y = (y + xs * lp["D_skip"].to(F32)[:, None]).reshape(z.shape)
        return linear(rms_norm(y * F.silu(z), lp["gate_norm"],
                               cfg["norm_eps"]), lp["out_proj"])

    z, xbc_in, dt = linear(h, lp["in_proj"]).split([di, conv_dim, nh], dim=-1)
    xbc = F.silu(conv_causal(xbc_in, lp["conv_w"], lp["conv_b"]))
    xs, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
    xs = xs.reshape(S, nh, P)
    dt = F.softplus(dt + lp["dt_bias"].to(F32))
    y = ssd(xs, dt, A, Bm.reshape(S, G, N), Cm.reshape(S, G, N))
    out = tail(y, xs, z)
    n, m = hl.shape[:2]
    if n == 0:
        return out, hl
    S0 = S - m
    zl, xbcl, dtl = linear(hl, lp["in_proj"]).split([di, conv_dim, nh],
                                                    dim=-1)
    W = lp["conv_w"].shape[0]
    before = F.pad(xbc_in[max(0, S0 - W + 1):S0],
                   (0, 0, max(0, W - 1 - S0), 0))
    seq = torch.cat([before.expand(n, W - 1, conv_dim), xbcl], dim=1)
    w = lp["conv_w"].to(F32)
    xbcl = F.silu(sum(seq[:, j:j + m] * w[j] for j in range(W))
                  + lp["conv_b"].to(F32))
    xl, Bl, Cl = xbcl.split([di, G * N, G * N], dim=-1)
    xl = xl.reshape(n, m, nh, P)
    Bl = Bl.reshape(n, m, G, N).repeat_interleave(nh // G, dim=2)
    Cl = Cl.reshape(n, m, G, N).repeat_interleave(nh // G, dim=2)
    dtl = F.softplus(dtl + lp["dt_bias"].to(F32))            # (n, m, nh)
    state = ssd_state(xs[:S0], dt[:S0], A,
                      Bm.reshape(S, G, N)[:S0]).expand(n, nh, N, P)
    yl = []
    for i in range(m):
        d = dtl[:, i]
        state = (d * A).exp()[..., None, None] * state \
            + d[..., None, None] * Bl[:, i, :, :, None] * xl[:, i, :, None, :]
        yl.append(torch.einsum("nhk,nhkp->nhp", Cl[:, i], state))
    return out, tail(torch.stack(yl, 1), xl, zl)


def head(x_last: torch.Tensor, params: Dict[str, torch.Tensor], cfg: Dict,
         linear: Linear) -> torch.Tensor:
    """The logits (m, V) of last-position hidden states (m, D)."""
    return linear(rms_norm(x_last, params["final_norm"], cfg["norm_eps"]),
                  params["lm_head"])


class Paths:
    """The last positions' other paths (module doc): their residuals
    ``x`` (n, suffix, D) and ``scores`` (``moe``), at most ``rule["most"]``
    of them: past that, the lowest scores are kept."""

    def __init__(self, rule: Optional[Dict], x: torch.Tensor):
        self.rule = rule
        self.m = rule.get("suffix", 1) if rule else 1
        self.x = x.new_zeros((0, self.m, x.shape[1]))
        self.scores: List[float] = []

    def normed(self, scale: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(self.x, scale, eps)

    def add(self, x: torch.Tensor, block) -> torch.Tensor:
        """x plus a block's output for the sequence, the paths plus theirs,
        and a new path for each fork the block returns, from its source's
        residual before the block.  ``block`` is (out, out_l[, forks])."""
        out, out_l, forks = (tuple(block) + ([],))[:3]
        new = [(x[-self.m:] if src < 0 else self.x[src]) + y
               for src, _, y in forks]
        self.x = self.x + out_l
        if new:
            self.x = torch.cat([self.x, torch.stack(new)])
            self.scores += [score for _, score, _ in forks]
            keep = sorted(sorted(range(len(self.scores)),
                                 key=self.scores.__getitem__)
                          [:self.rule["most"]])
            self.x = self.x[keep]
            self.scores = [self.scores[i] for i in keep]
        return x + out

    def logits(self, x: torch.Tensor, params: Dict[str, torch.Tensor],
               cfg: Dict, linear: Linear) -> torch.Tensor:
        """(1 + n, V): the reference's own last logits, then each path's."""
        return head(torch.cat([x[-1:], self.x[:, -1]]), params, cfg, linear)


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor
          ) -> torch.Tensor:
    return params["embed"][tokens.long()].to(F32)


def layer_slice(params: Dict[str, torch.Tensor], prefix: str, names,
                *index) -> Dict[str, torch.Tensor]:
    """{name: params[prefix + name][index]} (views, not copies)."""
    return {k: params[prefix + k][index] for k in names}
