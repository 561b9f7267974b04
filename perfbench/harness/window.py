"""The measured window, whatever the mix: its driver
(``perfbench/drivers/<driver>.py``) makes the steps of each cycle
(``cycles``) and runs one step (``step``), returning a ``Served`` row for
each request it completed; the window runs whole cycles."""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Tuple

import torch

from .traffic import Request


@dataclasses.dataclass
class Served:
    request: Request
    start: float                 # host clock: the step takes the request
    enqueued: float              # the program's call has returned
    done: float                  # the first token is on the host
    token: int
    logits: torch.Tensor         # (V,) as the step produced them


def cycle(driver, model, steps, device) -> List[Served]:
    return [s for st in steps for s in driver.step(model, st, device)]


def warm(driver, model, steps, device) -> None:
    """Every step of one cycle, longest first, so that every shape the
    mix uses is built and the largest allocation comes first."""
    cycle(driver, model, sorted(steps, key=lambda st: -st[0].length),
          device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(driver, model, cycles: Iterator, seconds: float, device
        ) -> Tuple[List[Served], float]:
    """Whole cycles of the mix until ``seconds`` have passed: (the served
    requests, the window's length in seconds)."""
    served: List[Served] = []
    t0 = time.perf_counter()
    for steps in cycles:
        served += cycle(driver, model, steps, device)
        if time.perf_counter() - t0 >= seconds:
            break
    return served, time.perf_counter() - t0


def traced(driver, model, steps, device):
    """One more cycle under ``torch.profiler`` (host and device
    activities): (its served requests, the profiler, the cycle's length
    on the host clock)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        served = cycle(driver, model, steps, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        length = time.perf_counter() - t0
    return served, prof, length
