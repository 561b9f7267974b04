"""Operations and bytes of the prefill of one request of ``S`` tokens, per
kernel call and for the whole model step, from the configuration's sizes
alone (whatever implements them).

``cfg`` is a configuration file of ``perfbench/configs/`` as a dict (the
keys of the port's ``ModelConfig``).  Each input byte is counted read once
and each output byte written once; bf16 operands are 2 bytes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

BF16 = 2

Work = Tuple[float, float]          # (FLOPs, bytes)


def layer_kinds(cfg: Dict) -> List[Tuple[str, str]]:
    """(mixer, mlp) of every layer: mixer ``attention`` or ``mamba``, mlp
    ``moe``, ``dense`` or ``none``.  A hybrid's period of ``attn_period``
    layers holds mixers first and attention last; MoE closes every
    ``moe.every_n_layers`` layers."""
    out = []
    moe = cfg.get("moe")
    for i in range(cfg["num_layers"]):
        mixer = "attention"
        if cfg["family"] == "hybrid":
            p = cfg["attn_period"]
            mixer = "attention" if i % p == p - 1 else "mamba"
        if moe is not None and i % moe["every_n_layers"] == \
                moe["every_n_layers"] - 1:
            mlp = "moe"
        else:
            mlp = "dense" if cfg["d_ff"] > 0 else "none"
        out.append((mixer, mlp))
    return out


def causal_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal mask keeps over ``S`` positions, with
    an optional sliding ``window`` (query i sees keys i - window < j <= i)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def gmm_calls(cfg: Dict, S: int) -> List[Work]:
    """The expert FFN of one MoE layer as its three grouped products (gate,
    up, down) on the S x top_k assignments the router makes: 2 A D F
    FLOPs each; every expert's weights read once, the assigned rows read
    and written once.  Capacity padding is not work."""
    m = cfg["moe"]
    A, D, F, E = S * m["top_k"], cfg["d_model"], m["d_ff_expert"], \
        m["num_experts"]
    up = (2.0 * A * D * F, BF16 * (E * D * F + A * D + A * F))
    down = (2.0 * A * F * D, BF16 * (E * F * D + A * F + A * D))
    return [up, up, down]


def flash_call(cfg: Dict, S: int) -> Work:
    """Causal GQA attention of one layer: 4 hd FLOPs (QK^T and PV) for each
    kept (query, key) pair of each query head; q, k, v read and the output
    written once."""
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pairs = causal_pairs(S, cfg.get("sliding_window"))
    return (4.0 * hd * H * pairs,
            BF16 * (2 * H * S * hd + 2 * K * S * hd))


def ssd_chunk(cfg: Dict, S: int) -> int:
    """The chunk the chunked SSD algorithm runs at: the configured one,
    clamped to the next power of two >= S (at least 16)."""
    return min(cfg["ssm"]["chunk"], max(16, 1 << (S - 1).bit_length()))


def ssd_call(cfg: Dict, S: int) -> Work:
    """The SSD scan of one mixer: x, dt, B, C (bf16) and A (fp32) read
    once, y written once; the chunked algorithm's operations (C B^T over a
    chunk's lower triangle once per group, its product with dt x, the
    inter-chunk product and the state update per head)."""
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    P, N, G = s["head_dim"], s["state_dim"], s["num_groups"]
    H = di // P
    q = min(ssd_chunk(cfg, S), S)
    chunks = -(-S // q)
    tri = q * (q + 1) // 2
    flops = chunks * (G * 2 * tri * N + H * (2 * tri * P + 4 * q * N * P))
    nbytes = BF16 * (2 * H * S * P + H * S + 2 * G * S * N) + 4 * H
    return float(flops), float(nbytes)


def active_params(cfg: Dict) -> int:
    """Weights a token passes through outside the embedding and the head:
    every projection of the attention and Mamba mixers (the depthwise
    convolution included), the dense MLPs, and in each MoE layer the
    router and top_k experts.  Norm scales and the per-head SSM scalars do
    no matrix work and are left out."""
    D = cfg["d_model"]
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    n = 0
    for mixer, mlp in layer_kinds(cfg):
        if mixer == "attention":
            n += D * H * hd + 2 * D * K * hd + H * hd * D
        else:
            s = cfg["ssm"]
            di = s["expand"] * D
            nh = di // s["head_dim"]
            conv_dim = di + 2 * s["num_groups"] * s["state_dim"]
            n += D * (di + conv_dim + nh) + s["conv_width"] * conv_dim \
                + di * D
        if mlp == "dense":
            n += 3 * D * cfg["d_ff"]
        elif mlp == "moe":
            m = cfg["moe"]
            n += D * m["num_experts"] + m["top_k"] * 3 * D * m["d_ff_expert"]
    return n


def model_flops(cfg: Dict, S: int) -> float:
    """FLOPs of one last-token prefill of ``S`` tokens: 2 x the active
    parameters outside embedding and head x S, the head on the one
    position whose logits are served, and attention's QK^T and PV over
    the causal span of every attention layer."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    n_attn = sum(1 for mixer, _ in layer_kinds(cfg) if mixer == "attention")
    attn = 4.0 * cfg["head_dim"] * cfg["num_heads"] * \
        causal_pairs(S, cfg.get("sliding_window"))
    return 2.0 * active_params(cfg) * S + 2.0 * D * V + n_attn * attn


def step_calls(cfg: Dict, S: int) -> Dict[str, List[Work]]:
    """Every kernel call of one prefill of ``S`` tokens by kernel:
    ``gmm`` (three per MoE layer), ``flash`` (one per attention layer),
    ``ssd`` (one per Mamba mixer)."""
    out: Dict[str, List[Work]] = {"gmm": [], "flash": [], "ssd": []}
    for mixer, mlp in layer_kinds(cfg):
        if mixer == "attention":
            out["flash"].append(flash_call(cfg, S))
        else:
            out["ssd"].append(ssd_call(cfg, S))
        if mlp == "moe":
            out["gmm"].extend(gmm_calls(cfg, S))
    return out
