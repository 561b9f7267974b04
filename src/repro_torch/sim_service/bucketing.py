"""Shape bucketing: which requests may share one batch.

The port of ``repro/sim_service/bucketing.py``.  A batch's shape is
determined by the :class:`~repro_torch.netsim.measure.SweepKey` (config +
phase lengths + cycles per kernel call), the padded injection-program
length, the streaming cadence (``check_every`` fixes the block schedule)
and the padded batch width.  The first three form the :class:`BucketKey`
requests queue under; the width is chosen at batch-formation time.

Both pads are power-of-two quantized so the set of distinct shapes stays
small and revisits see a shape already run:

* **program length** pads with zero entries past each tile's ``length``
  counter along the last axis of ``Program.buf`` ``(B, 5, ny, nx, Lp)``
  — never injected, so dynamics are untouched; nearby loads therefore
  share one bucket;
* **batch width** pads by replicating lane 0 (dropped on read-back), so
  2, 3 or 4 concurrent requests all run as one width-4 batch.  The
  padded lanes are simulated like the others: on a card they cost router
  work (``chip_smoke.py`` ``[service]`` prints how much).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.netsim.measure import SweepKey
from repro_torch.netsim.sim import Program, stack_programs

from .request import LaneSpec

__all__ = ["BucketKey", "bucket_key", "next_pow2", "pad_program_length",
           "stack_lanes"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class BucketKey(NamedTuple):
    """Everything two requests must agree on to ride one batch (up to
    batch width, padded at formation time)."""
    key: SweepKey       # config + warmup/measure/drain + cycles per call
    prog_len: int       # pow2-padded injection-program length
    check_every: int    # streaming cadence (fixes the block schedule)


def bucket_key(key: SweepKey, prog: Program, check_every: int) -> BucketKey:
    return BucketKey(key=key, prog_len=next_pow2(prog.buf.shape[-1]),
                     check_every=int(check_every))


def pad_program_length(prog: Program, length: int) -> Program:
    """Pad the program's entry axis with zero entries up to ``length``.
    Zero entries sit past every tile's ``length`` counter, so the
    injector never reads them — identical dynamics, one shared shape."""
    cur = prog.buf.shape[-1]
    if cur == length:
        return prog
    if cur > length:
        raise ValueError(
            f"program length {cur} exceeds bucket length {length}")
    buf = torch.nn.functional.pad(prog.buf, (0, length - cur))
    return Program(buf=buf, length=prog.length)


def stack_lanes(lanes: Sequence[LaneSpec], prog_len: int, width: int
                ) -> Tuple[Program, np.ndarray, np.ndarray]:
    """Stack lanes into the batch arrays of one batched run, padded to
    ``width`` rows by replicating lane 0 (its extra rows are dropped on
    read-back).  Returns (programs, fifo_depths, max_credits), each with
    a leading ``width`` axis, on the programs' device (the host at
    submit); the knobs are int32 numpy arrays."""
    if not 1 <= len(lanes) <= width:
        raise ValueError(
            f"batch of {len(lanes)} lanes cannot pad to width {width}")
    progs: List[Program] = [pad_program_length(ln.program, prog_len)
                            for ln in lanes]
    depths = [ln.fifo_depth for ln in lanes]
    credits = [ln.max_credits for ln in lanes]
    while len(progs) < width:
        progs.append(progs[0])
        depths.append(depths[0])
        credits.append(credits[0])
    return (stack_programs(progs), np.asarray(depths, np.int32),
            np.asarray(credits, np.int32))
