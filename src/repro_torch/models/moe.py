"""Mixture-of-Experts with capacity-provisioned FIFO dispatch (the port's
counterpart of ``repro.models.moe`` in its single-device ``tp`` layout).

Tokens are routed top-k in fp32, ranked per expert in arrival order
(token-major, k-minor: the order that decides which tokens an overflowing
expert drops), scattered into (E, capacity, D) buffers with dropped
assignments sent to a discarded sink row, run through the expert SwiGLU as
three grouped matmuls (the Hopper GMM kernel on a CUDA tensor, its plain
version on the CPU), and gathered back with the routing weights in fp32.
The expert-parallel and two-phase ``xy`` dispatch modes belong to the SPMD
slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels.ops import grouped_matmul

__all__ = ["capacity", "router_topk", "moe_block"]

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
    logits = x2d.to(F32) @ w_router.to(F32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    E = w_router.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).to(F32).mean(0)
    return idx, weights, E * (me * ce).sum()


def _fifo_slots(assign: torch.Tensor, num_experts: int, cap: int):
    """Slot of each assignment in its expert's FIFO, in arrival order:
    (slot, keep = slot < cap)."""
    onehot = F.one_hot(assign, num_experts)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    slot = ranks.gather(1, assign[:, None])[:, 0]
    return slot, slot < cap


def _dispatch(x2d, assign, slot, keep, num_experts: int, cap: int):
    """Scatter assignments into (E, cap, D) capacity buffers; dropped ones
    land in a sink row that is cut off."""
    T_k = assign.shape[0]
    token_of = torch.arange(T_k, device=x2d.device) // (T_k // x2d.shape[0])
    e_idx = torch.where(keep, assign, num_experts)
    buf = torch.zeros((num_experts + 1, cap, x2d.shape[1]), dtype=x2d.dtype,
                      device=x2d.device)
    buf.index_put_((e_idx, slot.clamp_max(cap - 1)), x2d[token_of],
                   accumulate=True)
    return buf[:num_experts]


def _combine(buf_out, assign, slot, keep, weights2d, T: int):
    """Gather expert outputs back to token order, weighted in fp32."""
    gathered = buf_out[torch.where(keep, assign, 0),
                       slot.clamp_max(buf_out.shape[1] - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    k = assign.shape[0] // T
    gathered = gathered.reshape(T, k, -1)
    return (gathered.to(F32) * weights2d[..., None]).sum(1)


def _expert_ffn(buf, w_gate, w_up, w_down):
    """(E, cap, D) -> (E, cap, D): the expert SwiGLU as three grouped
    matmuls."""
    g = grouped_matmul(buf, w_gate)
    u = grouped_matmul(buf, w_up)
    h = (F.silu(g.to(F32)) * u.to(F32)).to(buf.dtype)
    return grouped_matmul(h, w_down)


def moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on (B, S, D) activations; returns (out, aux_loss)."""
    m = cfg.moe
    Bsz, S, D = x.shape
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    idx, weights, aux = router_topk(x2d, params["router"], m.top_k)
    assign = idx.reshape(-1)
    cap = capacity(T, m)
    slot, keep = _fifo_slots(assign, m.num_experts, cap)
    buf = _dispatch(x2d, assign, slot, keep, m.num_experts, cap)
    out_buf = _expert_ffn(buf, params["w_gate"], params["w_up"],
                          params["w_down"])
    out = _combine(out_buf, assign, slot, keep, weights, T)
    return out.reshape(Bsz, S, D).to(x.dtype), aux
