"""The prefill replay: a closed loop of prefill steps, as one prefill
instance of a disaggregated deployment works a full queue.

The mix repeats one fixed multiset of prompt lengths (``lengths``) in
cycles, each cycle in its own order shuffled by the seed.  Each length
is one step of ``batch`` requests of that length, every request's token
ids drawn uniformly over the vocabulary from the seed.  Every window
then sees the same mix, so its tail measures the program and not the
draw.  A step is the program's ``prefill_step`` on the batch, ended when
each request's first token (the argmax of its last-position logits) is
on the host.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import traffic as tr
from perfbench.harness.window import Served

Step = List[tr.Request]


def cycles(traffic: Dict, seed: int, vocab: int, stream: int
           ) -> Iterator[List[Step]]:
    """The steps of a run, one cycle of the mix at a time."""
    mix, batch = tr.lengths(traffic), int(traffic["batch"])
    g = tr.rng(seed, stream)
    rid = 0
    while True:
        cycle = []
        for n in g.permutation(mix):
            cycle.append([tr.Request(rid + b, int(n),
                                     g.integers(0, vocab, int(n)))
                          for b in range(batch)])
            rid += batch
        yield cycle


def step(model, reqs: Step, device) -> List[Served]:
    from repro_torch.launch.step import prefill_step
    t0 = time.perf_counter()
    with record_function("perfbench: prefill_step"):
        tokens = torch.from_numpy(np.stack([r.tokens for r in reqs])
                                  ).to(device)
        logits = prefill_step(model, {"tokens": tokens})
    t1 = time.perf_counter()
    with record_function("perfbench: first token to the host"):
        first = logits.argmax(-1).tolist()
    t2 = time.perf_counter()
    return [Served(r, t0, t1, t2, int(tok), row)
            for r, tok, row in zip(reqs, first, logits)]
