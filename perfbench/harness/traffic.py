"""What every traffic mix shares: the seed's independent random streams,
a request, and a mix's prompt lengths.  What a mix does with them (its
requests, its steps) is its driver's, ``perfbench/drivers/<driver>.py``,
which the traffic file names (``spec.driver``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# independent random streams drawn from one seed
WEIGHTS, WINDOW, WARMUP, SAMPLE = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


@dataclasses.dataclass
class Request:
    rid: int
    length: int
    tokens: np.ndarray          # (length,) int64


def lengths(traffic: Dict) -> List[int]:
    """The mix's prompt lengths: ``lengths`` an explicit ``list``, or
    ``logspace`` [lo, hi, n] rounded to ``multiple_of``."""
    spec = traffic["lengths"]
    if "list" in spec:
        return [int(n) for n in spec["list"]]
    lo, hi, n = spec["logspace"]
    step = spec.get("multiple_of", 1)
    return [int(round(lo * (hi / lo) ** (i / (n - 1)) / step)) * step
            for i in range(n)]
