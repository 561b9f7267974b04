"""Packet-based synchronisation primitives (paper C8; the port's
counterpart of ``repro.core.sync``).

"Other high-level primitives like mutex, barrier and spin-lock can layer
on top of the built-in atomic compare-and-swap" — built here exactly so,
on :func:`repro_torch.core.pgas.remote_cas` and ``remote_store``.
:func:`spmd_barrier` is the collective analogue of the credit-drain
barrier: a sum of one token per rank.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.comm import Mesh
from . import pgas

__all__ = ["mutex_try_acquire", "mutex_release", "barrier_arrive",
           "barrier_done", "spmd_barrier", "MUTEX_UNLOCKED"]

MUTEX_UNLOCKED = 0


def _onehot(num_tiles: int, tile: int, device) -> torch.Tensor:
    return (torch.arange(num_tiles, device=device) == tile)[:, None]


def mutex_try_acquire(mem: torch.Tensor, owner_tile: int, lock_addr: int,
                      mesh: Mesh, x_axis: str, y_axis: str, num_tiles: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every tile attempts ``CAS(lock, UNLOCKED -> my_id+1)`` on the lock
    word at ``owner_tile``; returns ``(mem, acquired)``, exactly one tile
    observing ``acquired``."""
    me = pgas.tile_linear_index(mesh, x_axis, y_axis)
    dev = mem.device
    pkts = pgas.PacketBatch(
        addr=torch.full((num_tiles, 1), lock_addr, dtype=torch.int32,
                        device=dev),
        data=torch.full((num_tiles, 1), me + 1, dtype=mem.dtype, device=dev),
        mask=_onehot(num_tiles, owner_tile, dev))
    compare = torch.full((num_tiles, 1), MUTEX_UNLOCKED, dtype=mem.dtype,
                         device=dev)
    mem, old = pgas.remote_cas(mem, pkts, compare, mesh, x_axis, y_axis)
    # old[owner, 0]: what the CAS this tile sent observed
    return mem, old[owner_tile, 0] == MUTEX_UNLOCKED


def mutex_release(mem: torch.Tensor, owner_tile: int, lock_addr: int,
                  holding: torch.Tensor, mesh: Mesh, x_axis: str,
                  y_axis: str, num_tiles: int) -> torch.Tensor:
    """The holder stores UNLOCKED back to the lock word (a remote store)."""
    dev = mem.device
    pkts = pgas.PacketBatch(
        addr=torch.full((num_tiles, 1), lock_addr, dtype=torch.int32,
                        device=dev),
        data=torch.full((num_tiles, 1), MUTEX_UNLOCKED, dtype=mem.dtype,
                        device=dev),
        mask=_onehot(num_tiles, owner_tile, dev) & holding)
    mem, _ = pgas.remote_store(mem, pkts, mesh, x_axis, y_axis)
    return mem


def barrier_arrive(mem: torch.Tensor, root_tile: int, counter_addr: int,
                   mesh: Mesh, x_axis: str, y_axis: str,
                   num_tiles: int) -> torch.Tensor:
    """Multi-node barrier via remote stores: each tile stores a 1 into its
    own slot of the root tile's arrival vector."""
    me = pgas.tile_linear_index(mesh, x_axis, y_axis)
    dev = mem.device
    pkts = pgas.PacketBatch(
        addr=torch.full((num_tiles, 1), counter_addr + me,
                        dtype=torch.int32, device=dev),
        data=torch.ones((num_tiles, 1), dtype=mem.dtype, device=dev),
        mask=_onehot(num_tiles, root_tile, dev))
    mem, _ = pgas.remote_store(mem, pkts, mesh, x_axis, y_axis)
    return mem


def barrier_done(mem: torch.Tensor, counter_addr: int,
                 num_tiles: int) -> torch.Tensor:
    """Root-side check: all arrival slots set."""
    return (mem[counter_addr:counter_addr + num_tiles] != 0).all()


def spmd_barrier(mesh: Mesh, x_axis: str, y_axis: str) -> torch.Tensor:
    """Collective barrier across steps: every rank contributes a token;
    returns the tile count (``nx * ny`` when everyone arrived)."""
    one = torch.ones((), dtype=torch.int32, device=mesh.device)
    return comm.all_reduce(comm.all_reduce(one, mesh, x_axis), mesh, y_axis)
