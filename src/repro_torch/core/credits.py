"""Credit-based flow control (paper C3; the port's counterpart of
``repro.core.credits``).

The standard endpoint tracks outstanding transactions with a credit
counter initialised to ``max_out_credits_p``; a *fence* waits for the
counter to return to its initial value, which proves every prior store
has **committed** at its destination.

:func:`bdp_credits` encodes the paper's sizing rule: *"set the number of
outstanding credits to the uncongested bandwidth-delay product of the
longest round-trip path"* (e.g. 1 word/cycle x 128-cycle RTT = 128
credits; or 20 hops x FIFO depth 4 = 80).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["CreditCounter", "make_credits", "issue", "ack", "fence_ok",
           "bdp_credits"]

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CreditCounter:
    """Credit counter (``out_credits_o``): 0-d int32 tensors."""

    available: torch.Tensor   # credits currently available
    max_credits: torch.Tensor  # max_out_credits_p

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def make_credits(max_out_credits: int, device=None) -> CreditCounter:
    m = torch.tensor(max_out_credits, dtype=I32, device=device)
    return CreditCounter(available=m, max_credits=m.clone())


def issue(c: CreditCounter, n) -> tuple:
    """Try to issue ``n`` transactions; returns ``(counter, granted)``.

    ``granted <= n`` — the endpoint must not send when out of credit, so
    the grant is clamped, never negative."""
    n = torch.as_tensor(n, dtype=I32, device=c.available.device)
    granted = torch.minimum(n, c.available)
    return c.replace(available=c.available - granted), granted


def ack(c: CreditCounter, n) -> CreditCounter:
    """Return ``n`` credits (reverse-network acknowledgements)."""
    n = torch.as_tensor(n, dtype=I32, device=c.available.device)
    return c.replace(available=torch.minimum(c.available + n,
                                             c.max_credits))


def fence_ok(c: CreditCounter) -> torch.Tensor:
    """Transaction fence predicate: every outstanding transaction has
    committed iff the counter is back at ``max_out_credits_p``."""
    return c.available == c.max_credits


def bdp_credits(round_trip_hops: int, fifo_depth: int = 4,
                issue_rate: float = 1.0) -> int:
    """Paper's sizing rule (Appendix A): ``hops x FIFO depth`` credits,
    i.e. the bandwidth-delay product at ``issue_rate`` words/cycle."""
    return max(1, int(round_trip_hops * fifo_depth * issue_rate))
