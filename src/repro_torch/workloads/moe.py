"""MoE expert-parallel dispatch lowered to mesh traffic.

Models the all-to-all of ``repro/models/moe.py``: every tile holds a
shard of the token batch, the router assigns each token ``top_k``
experts, and the dispatch scatters tokens to their experts' home tiles
(the combine is the mirror-image gather on the reverse path — which the
simulator's response network carries for free, since every remote store
returns a credit and every remote load returns data).

The router's *load imbalance* — the thing capacity factors and aux losses
exist to fight — is the workload's key knob: ``imbalance`` is the excess
probability mass concentrated on expert 0 (the "hot expert"), on top of
the uniform floor.  ``imbalance=0`` is a balanced router; ``0.5`` sends
half of all tokens to one tile, turning the all-to-all into a hotspot.
``meta`` reports the realized per-expert token loads plus the capacity /
overflow numbers (same provisioning rule as
:func:`repro.models.moe.capacity`: ``ceil(tokens * top_k * cf / E)``
rounded up to a multiple of 8), so a run shows both the traffic *and* the
drop statistics a capacity-factor choice implies.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core.netsim import OP_STORE

from .base import Packet, Workload, program_from_packets
from .placement import Placement

__all__ = ["moe_all_to_all", "expert_capacity"]


def expert_capacity(assignments: int, n_experts: int,
                    capacity_factor: float = 1.25) -> int:
    """Slots provisioned per expert — the FIFO-provisioning rule of
    ``repro.models.moe.capacity`` (paper C2), kept dependency-light here:
    ``assignments`` is the total number of (token, expert) pairs."""
    raw = int(assignments * capacity_factor / n_experts) + 1
    return max(8, -(-raw // 8) * 8)


def moe_all_to_all(nx: int, ny: int, tokens_per_tile: int, *,
                   n_experts: Optional[int] = None, top_k: int = 1,
                   imbalance: float = 0.0, capacity_factor: float = 1.25,
                   placement: Optional[Placement] = None,
                   rate: float = 1.0, op: int = OP_STORE,
                   mem_words: int = 64, seed: int = 0,
                   start: int = 0) -> Workload:
    """Compile one MoE dispatch: every tile routes ``tokens_per_tile``
    tokens to ``top_k`` experts each.

    Experts live on the first ``n_experts`` tiles of ``placement``
    (default: row-major over the whole mesh, the paper's ``y*nx + x``
    homes).  With probability ``imbalance`` a token's first expert is the
    hot expert 0; otherwise experts are drawn uniformly (the extra
    ``top_k - 1`` choices are uniform over the remaining experts, like a
    balanced second choice).  ``rate`` paces injection exactly like the
    traffic library (token ``i`` not before ``floor(i / rate)``).
    """
    if not 0.0 <= imbalance < 1.0:
        raise ValueError(
            f"imbalance is the extra probability mass on the hot expert "
            f"and must be in [0, 1), got {imbalance}")
    if not 0.0 < rate <= 1.0:
        raise ValueError(
            f"injection rate must be in (0, 1], got {rate}")
    if tokens_per_tile < 1:
        raise ValueError(f"need at least one token per tile, "
                         f"got {tokens_per_tile}")
    pl = placement if placement is not None else Placement.grid(nx, ny)
    n_experts = pl.k if n_experts is None else int(n_experts)
    if not 1 <= n_experts <= pl.k:
        raise ValueError(
            f"n_experts={n_experts} experts do not fit the placement's "
            f"{pl.k} tiles")
    if not 1 <= top_k <= n_experts:
        raise ValueError(
            f"top_k={top_k} must be in [1, n_experts={n_experts}]")
    rng = np.random.default_rng(seed)
    n_tiles = nx * ny
    expert_load = np.zeros(n_experts, np.int64)
    packets = []
    for t in range(n_tiles):
        sy, sx = divmod(t, nx)
        for i in range(tokens_per_tile):
            if rng.random() < imbalance:
                first = 0
            else:
                first = int(rng.integers(n_experts))
            experts = [first]
            if top_k > 1:
                rest = [e for e in range(n_experts) if e != first]
                experts += list(rng.choice(rest, size=top_k - 1,
                                           replace=False))
            for j, e in enumerate(experts):
                ex, ey = pl.tile(e)
                expert_load[e] += 1
                packets.append(Packet(
                    src_x=sx, src_y=sy, dst_x=int(ex), dst_y=int(ey),
                    addr=(t * tokens_per_tile + i) % mem_words,
                    data=e, op=op,
                    not_before=start + math.floor((i * top_k + j) / rate)))
    assignments = n_tiles * tokens_per_tile * top_k
    cap = expert_capacity(assignments, n_experts, capacity_factor)
    overflow = int(np.maximum(expert_load - cap, 0).sum())
    return Workload(
        name=f"moe_a2a_e{n_experts}_t{tokens_per_tile}"
             f"_k{top_k}_i{imbalance:g}",
        family="moe", nx=nx, ny=ny,
        program=program_from_packets(nx, ny, packets),
        n_steps=1, n_packets=assignments, placement=pl,
        meta={"n_experts": n_experts, "tokens_per_tile": tokens_per_tile,
              "top_k": top_k, "imbalance": imbalance,
              "expert_load": expert_load.tolist(),
              "hot_expert_share": float(expert_load[0]) / assignments,
              "capacity": cap, "capacity_factor": capacity_factor,
              "overflow_tokens": overflow,
              "source": "models/moe.py router_topk dispatch "
                        "(EP homes over the model axis)"})
