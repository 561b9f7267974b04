"""Gradient-sync collectives lowered to mesh traffic.

These compilers model the communication of ``repro/parallel/sharding.py``:
the data-parallel gradient all-reduce (rows of the device grid — the
mesh's Y dimension — reduce gradients every step) and the parameter
broadcast that re-distributes updated weights (ZeRO-1: each shard's owner
broadcasts its slice).  Both are lowered as *ring* schedules over a snake
placement (consecutive ranks are mesh neighbors, see
:mod:`repro_torch.workloads.placement`), which is both the classic bandwidth-
optimal algorithm and the layout Celerity-style arrays actually use.

Ring all-reduce (k ranks, payload of ``words`` per rank):

* the payload splits into k chunks of ``ceil(words / k)`` words;
* **reduce-scatter** — k-1 steps, each rank sends one chunk to its ring
  successor (chunk ``(r - s) mod k`` at step ``s``);
* **all-gather** — k-1 more steps forwarding the reduced chunks around.

Every rank therefore injects exactly ``2 (k-1) * chunk`` packets — i.e.
``(k-1)/k`` of the (chunk-padded) payload crosses every ring hop in each
of the two phases, which is the conservation law the tests pin down and
the same ``2 (k-1)/k`` factor the roofline's analytic ring model uses
(:func:`repro.launch.roofline.parse_collectives` wire bytes).

The schedule is the serialization bound: step ``s`` injects at
``not_before = start + s * chunk`` (one word per cycle per rank).  The
simulator's backpressure then reveals the *congestion* on top — measured
``cycles_per_step >= chunk`` — which is exactly the signal
:class:`repro_torch.workloads.CongestionModel` fits.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.netsim import OP_STORE

from .base import Packet, Workload, program_from_packets
from .placement import Placement

__all__ = ["ring_all_reduce", "parameter_broadcast"]


def ring_all_reduce(nx: int, ny: int, words: int, *,
                    k: Optional[int] = None,
                    placement: Optional[Placement] = None,
                    op: int = OP_STORE, mem_words: int = 64,
                    start: int = 0) -> Workload:
    """Compile a k-rank ring all-reduce of ``words`` words per rank.

    ``placement`` defaults to the snake ring over the first ``k`` tiles
    (all tiles when ``k`` is None).  ``n_steps = 2 (k-1)`` ring steps.
    """
    pl = placement if placement is not None else Placement.ring(nx, ny, k)
    k = pl.k
    if k < 2:
        raise ValueError(f"ring all-reduce needs k >= 2 ranks, got k={k}")
    if words < 1:
        raise ValueError(f"payload must be at least one word, got {words}")
    chunk = math.ceil(words / k)
    tiles = [pl.tile(r) for r in range(k)]
    packets = []
    for s in range(2 * (k - 1)):
        phase_step = s if s < k - 1 else s - (k - 1)
        for r in range(k):
            sx, sy = tiles[r]
            dx, dy = tiles[(r + 1) % k]
            # reduce-scatter forwards chunk (r - s), all-gather re-forwards
            # the chunk reduced at rank r+1, i.e. (r + 1 - phase_step)
            cid = (r - phase_step) % k if s < k - 1 \
                else (r + 1 - phase_step) % k
            for w in range(chunk):
                packets.append(Packet(
                    src_x=sx, src_y=sy, dst_x=dx, dst_y=dy,
                    addr=(cid * chunk + w) % mem_words,
                    data=cid, op=op,
                    not_before=start + s * chunk))
    return Workload(
        name=f"allreduce_ring_k{k}_w{words}", family="allreduce",
        nx=nx, ny=ny, program=program_from_packets(nx, ny, packets),
        n_steps=2 * (k - 1), n_packets=2 * (k - 1) * chunk * k,
        placement=pl,
        meta={"k": k, "words": words, "chunk": chunk,
              "per_rank_injected": 2 * (k - 1) * chunk,
              "per_hop_words_per_phase": (k - 1) * chunk,
              "source": "parallel/sharding.py gradient all-reduce "
                        "(DP rows; ZeRO-1 zero1 axis)"})


def parameter_broadcast(nx: int, ny: int, words: int, *,
                        k: Optional[int] = None,
                        placement: Optional[Placement] = None,
                        op: int = OP_STORE, mem_words: int = 64,
                        start: int = 0) -> Workload:
    """Compile a ring-pipelined broadcast of ``words`` words from rank 0.

    Rank ``r`` (0..k-2) forwards the stream to rank ``r+1``; word ``w``
    leaves rank ``r`` at ``not_before = start + r + w`` — the broadcast
    wave one hop behind per rank, so the whole mesh carries the stream
    concurrently (the updated-parameter fan-out of ZeRO-1's shard owners
    in ``parallel/sharding.py``).
    """
    pl = placement if placement is not None else Placement.ring(nx, ny, k)
    k = pl.k
    if k < 2:
        raise ValueError(f"broadcast needs k >= 2 ranks, got k={k}")
    if words < 1:
        raise ValueError(f"payload must be at least one word, got {words}")
    packets = []
    for r in range(k - 1):
        sx, sy = pl.tile(r)
        dx, dy = pl.tile(r + 1)
        for w in range(words):
            packets.append(Packet(
                src_x=sx, src_y=sy, dst_x=dx, dst_y=dy,
                addr=w % mem_words, data=w, op=op,
                not_before=start + r + w))
    return Workload(
        name=f"param_broadcast_k{k}_w{words}", family="broadcast",
        nx=nx, ny=ny, program=program_from_packets(nx, ny, packets),
        n_steps=1, n_packets=(k - 1) * words, placement=pl,
        meta={"k": k, "words": words,
              "per_rank_injected": words,
              "source": "parallel/sharding.py ZeRO-1 parameter broadcast"})
