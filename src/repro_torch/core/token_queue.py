"""Token queues — credit-bounded virtual channels (paper C6, "Option 1";
the port's counterpart of ``repro.core.token_queue``).

A token queue virtualises a producer->consumer channel over the
load/store network: the producer holds ``depth`` send tokens; each send
consumes one, each consumer dequeue returns one (via the reverse
network).  The producer therefore never overruns the consumer's buffer.

The queue state is a ring buffer of tensors; in the distributed setting
the channel's ends are mesh neighbours joined by
:func:`repro_torch.core.routing.shift` (one ring hop).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.parallel.comm import Mesh
from .routing import shift

__all__ = ["TokenQueue", "tq_make", "tq_send", "tq_recv", "tq_can_send",
           "tq_can_recv", "channel_send", "channel_recv"]

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TokenQueue:
    """Ring-buffer token queue.

    buf:     (depth, *item_shape) payload storage
    head:    0-d int32 — next slot to dequeue
    count:   0-d int32 — occupied slots
    tokens:  0-d int32 — producer-side send tokens (credits)
    """

    buf: torch.Tensor
    head: torch.Tensor
    count: torch.Tensor
    tokens: torch.Tensor

    @property
    def depth(self) -> int:
        return self.buf.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def tq_make(depth: int, item_shape: Tuple[int, ...], dtype=torch.float32,
            device=None) -> TokenQueue:
    z = torch.zeros((), dtype=I32, device=device)
    return TokenQueue(
        buf=torch.zeros((depth,) + tuple(item_shape), dtype=dtype,
                        device=device),
        head=z, count=z.clone(),
        tokens=torch.tensor(depth, dtype=I32, device=device))


def tq_can_send(q: TokenQueue) -> torch.Tensor:
    return q.tokens > 0


def tq_can_recv(q: TokenQueue) -> torch.Tensor:
    return q.count > 0


def tq_send(q: TokenQueue, item: torch.Tensor, do=True) -> TokenQueue:
    """Enqueue ``item`` if ``do`` and a token is available (a masked no-op
    otherwise).  Consumes one send token."""
    do = torch.as_tensor(do, device=q.buf.device) & tq_can_send(q)
    tail = (q.head + q.count) % q.depth
    buf = q.buf.clone()
    if bool(do):
        buf[int(tail)] = item.to(buf.dtype)
    inc = do.to(I32)
    return q.replace(buf=buf, count=q.count + inc, tokens=q.tokens - inc)


def tq_recv(q: TokenQueue, do=True
            ) -> Tuple[TokenQueue, torch.Tensor, torch.Tensor]:
    """Dequeue; returns ``(queue, item, valid)``.  The freed slot's token
    returns to the producer."""
    do = torch.as_tensor(do, device=q.buf.device) & tq_can_recv(q)
    item = q.buf[int(q.head % q.depth)]
    dec = do.to(I32)
    q = q.replace(head=(q.head + dec) % q.depth, count=q.count - dec,
                  tokens=q.tokens + dec)
    return q, item, do


# ---------------------------------------------------------------------------
# Distributed channel: neighbour-to-neighbour token queue over one mesh
# axis.  Every rank runs both roles; the payload moves one hop down the
# ring, the token (credit) one hop up.
# ---------------------------------------------------------------------------

def channel_send(item: torch.Tensor, mesh: Mesh,
                 axis_name: str) -> torch.Tensor:
    """Forward path: push ``item`` to the next stage along ``axis_name``."""
    return shift(item, mesh, axis_name, +1)


def channel_recv(token: torch.Tensor, mesh: Mesh,
                 axis_name: str) -> torch.Tensor:
    """Reverse path: return a credit/token to the previous stage."""
    return shift(token, mesh, axis_name, -1)
