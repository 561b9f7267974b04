"""The standard endpoint (paper C5; the port's counterpart of
``repro.core.endpoint``) — plug-and-play mesh integration.

``bsg_manycore_endpoint_standard`` hides the network's flow-control rules
behind a master/slave interface.  :class:`EndpointState` plays the same
role for a rank: it owns the credit counter, and :func:`master_store` /
:func:`master_load` run the PGAS delivery under the two protocol rules:

1. incoming requests are absorbed at line rate (the slave side is applied
   to the whole inbound batch — it cannot block);
2. the reverse path is a sink (responses land in pre-allocated buffers).

The endpoint's special config registers (freeze / arbiter priority) are
fields of the state.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.parallel.comm import Mesh
from . import credits as cr
from . import pgas

__all__ = ["EndpointState", "make_endpoint", "master_store", "master_load",
           "fence", "freeze", "unfreeze", "CFG_FREEZE_ADDR", "CFG_ARB_ADDR"]

# Paper: "Special Local Address Map" — MSB set selects the config region.
CFG_FREEZE_ADDR = 0x0
CFG_ARB_ADDR = 0x4


@dataclasses.dataclass(frozen=True)
class EndpointState:
    """Per-tile endpoint state."""

    mem: torch.Tensor              # local memory region
    credits: cr.CreditCounter      # out_credits_o
    frozen: torch.Tensor           # freeze_r_o (freeze_init_p semantics)
    arb_priority: torch.Tensor     # reverse_arb_pr_o toggle

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def make_endpoint(mem_words: int, max_out_credits: int,
                  dtype=torch.float32, freeze_init: bool = False,
                  device=None) -> EndpointState:
    return EndpointState(
        mem=torch.zeros((mem_words,), dtype=dtype, device=device),
        credits=cr.make_credits(max_out_credits, device),
        frozen=torch.tensor(freeze_init, device=device),
        arb_priority=torch.tensor(False, device=device))


def master_store(state: EndpointState, pkts: pgas.PacketBatch, mesh: Mesh,
                 x_axis: str, y_axis: str
                 ) -> Tuple[EndpointState, torch.Tensor]:
    """Issue a batch of remote stores under credit flow control.

    Packets beyond the available credit are masked off (the core "should
    avoid sending when out of credit"); returns the per-destination count
    of packets actually sent, so callers can retry the remainder."""
    want = pkts.mask.sum().to(torch.int32)
    counter, granted = cr.issue(state.credits, want)
    # grant in (dest, slot) order: a prefix of the flattened valid packets
    order = torch.cumsum(pkts.mask.reshape(-1).to(torch.int32), 0)
    grant_mask = (order <= granted).reshape(pkts.mask.shape) & pkts.mask
    sendable = dataclasses.replace(pkts, mask=grant_mask & ~state.frozen)
    mem, credits_back = pgas.remote_store(state.mem, sendable, mesh, x_axis,
                                          y_axis)
    counter = cr.ack(counter, credits_back.sum())
    sent = sendable.mask.sum(1).to(torch.int32)
    return state.replace(mem=mem, credits=counter), sent


def master_load(state: EndpointState, pkts: pgas.PacketBatch, mesh: Mesh,
                x_axis: str, y_axis: str
                ) -> Tuple[EndpointState, torch.Tensor, torch.Tensor]:
    """Issue remote loads; returns ``(state, data, valid)``.  The response
    path has no handshake ("the core must accept the data"): ``data`` is a
    dense pre-allocated buffer, the sink property."""
    data, valid = pgas.remote_load(state.mem, pkts, mesh, x_axis, y_axis)
    return state, data, valid


def fence(state: EndpointState) -> torch.Tensor:
    """Transaction fence: true iff every outstanding store has committed
    (the credit counter back at ``max_out_credits_p``)."""
    return cr.fence_ok(state.credits)


def freeze(state: EndpointState) -> EndpointState:
    """Config-register write: Freeze Register := 1 (stop the tile)."""
    return state.replace(frozen=torch.tensor(True,
                                             device=state.frozen.device))


def unfreeze(state: EndpointState) -> EndpointState:
    """Config-register write: Freeze Register := 0 (start the tile)."""
    return state.replace(frozen=torch.tensor(False,
                                             device=state.frozen.device))
