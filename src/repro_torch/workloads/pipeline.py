"""Pipeline-parallel point-to-point schedules lowered to mesh traffic.

Models ``repro/parallel/pipeline.py``'s rotating-buffer GPipe schedule:
``n_stages`` stages laid along a snake path (each forward hop is one mesh
hop), ``n_micro`` microbatches, one activation transfer of ``act_words``
words per (stage, microbatch) hop.  Microbatch ``m`` leaves stage ``s``
at tick ``m + s`` — the same diagonal wavefront as ``pipeline_apply``'s
``lax.scan``, where microbatch m is injected at tick m and surfaces at
tick ``m + S - 1``.  A tick is ``act_words`` cycles at the serialization
bound; backpressure stretches it to the measured value.

With ``backward=True`` the 1F1B-style reverse wave follows: after the
last forward tick, stage ``s`` sends gradient packets to stage ``s-1``
(the reverse path the paper's response network carries), mirroring what
``jax.grad`` of ``pipeline_apply`` produces.

``meta['bubble_fraction']`` is the GPipe bound ``(S-1)/(M+S-1)``
(:func:`repro.parallel.pipeline.bubble_fraction`).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.netsim import OP_STORE

from .base import Packet, Workload, program_from_packets
from .placement import Placement

__all__ = ["pipeline_p2p"]


def pipeline_p2p(nx: int, ny: int, *, n_stages: Optional[int] = None,
                 n_micro: int = 4, act_words: int = 8,
                 backward: bool = False,
                 placement: Optional[Placement] = None,
                 op: int = OP_STORE, mem_words: int = 64,
                 start: int = 0) -> Workload:
    """Compile the pipeline schedule's forward (and optionally backward)
    activation traffic.  ``n_steps`` is the tick count of the schedule:
    ``n_micro + n_stages - 1`` forward ticks (doubled with backward)."""
    pl = placement if placement is not None else \
        Placement.ring(nx, ny, n_stages)
    S = pl.k
    if S < 2:
        raise ValueError(f"a pipeline needs n_stages >= 2, got {S}")
    if n_micro < 1 or act_words < 1:
        raise ValueError(
            f"need n_micro >= 1 and act_words >= 1, got n_micro={n_micro}, "
            f"act_words={act_words}")
    ticks_fwd = n_micro + S - 1
    packets = []
    for m in range(n_micro):
        for s in range(S - 1):                       # stage s -> s + 1
            sx, sy = pl.tile(s)
            dx, dy = pl.tile(s + 1)
            t = m + s
            for w in range(act_words):
                packets.append(Packet(
                    src_x=sx, src_y=sy, dst_x=dx, dst_y=dy,
                    addr=(m * act_words + w) % mem_words,
                    data=m, op=op,
                    not_before=start + t * act_words))
    if backward:
        b0 = start + ticks_fwd * act_words
        for m in range(n_micro):
            for s in range(S - 1, 0, -1):            # stage s -> s - 1
                sx, sy = pl.tile(s)
                dx, dy = pl.tile(s - 1)
                t = m + (S - 1 - s)
                for w in range(act_words):
                    packets.append(Packet(
                        src_x=sx, src_y=sy, dst_x=dx, dst_y=dy,
                        addr=(m * act_words + w) % mem_words,
                        data=m, op=op,
                        not_before=b0 + t * act_words))
    n_steps = ticks_fwd * (2 if backward else 1)
    hops = n_micro * (S - 1) * (2 if backward else 1)
    return Workload(
        name=f"pipeline_s{S}_m{n_micro}_w{act_words}"
             f"{'_fwdbwd' if backward else ''}",
        family="pipeline", nx=nx, ny=ny,
        program=program_from_packets(nx, ny, packets),
        n_steps=n_steps, n_packets=hops * act_words, placement=pl,
        meta={"n_stages": S, "n_micro": n_micro, "act_words": act_words,
              "backward": backward,
              "bubble_fraction": (S - 1) / (n_micro + S - 1),
              "source": "parallel/pipeline.py pipeline_apply "
                        "(C6 token-queue channels)"})
