"""PGAS remote memory operations over a mesh of ranks (paper C1; the
port's counterpart of ``repro.core.pgas``).

Each tile (rank) owns a local ``memory region``; tiles issue
``remote_store`` / ``remote_load`` / ``remote_cas`` packets addressed by
``<X, Y, local>``.  A "packet batch" is a dense, destination-major buffer:
every source tile provisions ``slots`` packet slots toward every
destination tile (the paper's FIFO-provisioning rule made a static
shape).  Delivery is the dimension-ordered all-to-all
(:func:`repro_torch.core.routing.xy_all_to_all`), the X-then-Y route of the
hardware.

Ordering, as the paper's *Transaction ordering* section and the reference:

* packets from one source to one destination commit in slot order;
* packets from *different* sources have no ordering guarantee — except for
  ``remote_cas``, arbitrated deterministically in (source id, slot) order
  (the round-robin arbiter's role).

All functions run inside a rank on the (y_axis, x_axis) mesh.  The reply
path (credits for stores, data for loads) is the independent reverse
network: a second all-to-all into pre-allocated buffers (the "sink"
property).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.parallel.comm import Mesh
from .routing import xy_all_to_all

__all__ = ["PacketBatch", "make_packet_batch", "remote_store", "remote_load",
           "remote_cas", "tile_linear_index"]


@dataclasses.dataclass(frozen=True)
class PacketBatch:
    """Outgoing packets from one tile, destination-major.

    Fields (``T`` = number of tiles, ``S`` = slots per destination):
      addr:  (T, S) int32   local word address at the destination
      data:  (T, S) payload (ignored for loads)
      mask:  (T, S) bool    slot valid ("out_v_li")
    """

    addr: torch.Tensor
    data: torch.Tensor
    mask: torch.Tensor

    @property
    def num_tiles(self) -> int:
        return self.addr.shape[0]

    @property
    def slots(self) -> int:
        return self.addr.shape[1]


def make_packet_batch(num_tiles: int, slots: int, dtype=torch.float32,
                      device=None) -> PacketBatch:
    """An empty (all-invalid) packet batch — the idle endpoint."""
    return PacketBatch(
        addr=torch.zeros((num_tiles, slots), dtype=torch.int32,
                         device=device),
        data=torch.zeros((num_tiles, slots), dtype=dtype, device=device),
        mask=torch.zeros((num_tiles, slots), dtype=torch.bool,
                         device=device))


def tile_linear_index(mesh: Mesh, x_axis: str, y_axis: str) -> int:
    """This tile's row-major id ``y * nx + x`` (paper Fig. 1)."""
    return mesh.index(y_axis) * mesh.axis_size(x_axis) + mesh.index(x_axis)


def _deliver(pkts: PacketBatch, mesh: Mesh, x_axis: str,
             y_axis: str) -> PacketBatch:
    """Route a packet batch: afterwards row ``s`` of each field holds the
    packets *from* source tile ``s`` addressed to this tile."""
    return PacketBatch(
        *(xy_all_to_all(t, mesh, x_axis, y_axis, split_axis=0)
          for t in (pkts.addr, pkts.data, pkts.mask)))


def remote_store(mem: torch.Tensor, pkts: PacketBatch, mesh: Mesh,
                 x_axis: str, y_axis: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Issue remote stores; returns ``(new_mem, credits_returned)``.

    ``credits_returned[t]`` counts this tile's stores acknowledged by tile
    ``t`` — the reverse-network credit packets, sent after the commit, so
    a credit is a *commit* acknowledgement."""
    inbound = _deliver(pkts, mesh, x_axis, y_axis)
    # commit in slot order: same-source writes ordered; cross-source
    # writes within a slot land in one scatter (unordered, per the paper)
    for s in range(inbound.slots):
        mem = _masked_scatter(mem, inbound.addr[:, s], inbound.data[:, s],
                              inbound.mask[:, s])
    acks = inbound.mask.sum(1).to(torch.int32)               # per source
    credits = xy_all_to_all(acks[:, None], mesh, x_axis, y_axis,
                            split_axis=0)
    return mem, credits[:, 0]


def remote_load(mem: torch.Tensor, pkts: PacketBatch, mesh: Mesh,
                x_axis: str, y_axis: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Issue remote loads; returns ``(data, valid)`` both (T, S), row ``t``
    the responses of destination tile ``t`` in slot (request) order — the
    ``returned_data_r_o`` port of the endpoint."""
    inbound = _deliver(pkts, mesh, x_axis, y_axis)
    addr = inbound.addr.clamp(0, mem.shape[0] - 1).long()
    loaded = torch.where(inbound.mask, mem[addr],
                         torch.zeros((), dtype=mem.dtype, device=mem.device))
    data = xy_all_to_all(loaded, mesh, x_axis, y_axis, split_axis=0)
    valid = xy_all_to_all(inbound.mask, mesh, x_axis, y_axis, split_axis=0)
    return data, valid


def remote_cas(mem: torch.Tensor, pkts: PacketBatch, compare: torch.Tensor,
               mesh: Mesh, x_axis: str, y_axis: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remote compare-and-swap (``ePacketOp_remote_swap_*``).

    ``pkts.data`` carries the swap value, ``compare`` (T, S) the expected
    value.  Returns ``(new_mem, old_values)``, ``old_values[t, s]`` what
    the CAS at destination ``t`` slot ``s`` observed (the mutex winner sees
    the unlocked value).  Arbitration is sequential in (source, slot)
    order, as the reference's ``fori_loop``: a single winner per word."""
    inbound = _deliver(pkts, mesh, x_axis, y_axis)
    cmp_in = xy_all_to_all(compare, mesh, x_axis, y_axis, split_axis=0)
    T, S = inbound.addr.shape
    addr = inbound.addr.reshape(-1).clamp(0, mem.shape[0] - 1).tolist()
    data = inbound.data.reshape(-1)
    cmp = cmp_in.reshape(-1)
    mask = inbound.mask.reshape(-1).tolist()
    mem = mem.clone()
    old = torch.zeros(T * S, dtype=mem.dtype, device=mem.device)
    for i in range(T * S):
        if not mask[i]:
            continue
        a = addr[i]
        cur = mem[a].clone()
        old[i] = cur
        if bool(cur == cmp[i]):
            mem[a] = data[i].to(mem.dtype)
    old = xy_all_to_all(old.reshape(T, S), mesh, x_axis, y_axis,
                        split_axis=0)
    return mem, old


def _masked_scatter(mem: torch.Tensor, addr: torch.Tensor,
                    data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scatter ``data`` into ``mem`` at ``addr`` where ``mask``; invalid
    slots go to a sacrificial row past the end and are dropped."""
    n = mem.shape[0]
    idx = torch.where(mask, addr.clamp(0, n - 1), n).long()
    out = torch.cat([mem, mem.new_zeros((1,) + tuple(mem.shape[1:]))])
    out[idx] = data.to(mem.dtype)
    return out[:n]
