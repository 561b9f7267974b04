"""Dimension-ordered (XY) routing as collectives over a mesh of ranks
(paper C4; the port's counterpart of ``repro.core.routing``).

The BaseJump router moves a packet all the way along X, then along Y.
Every long-range pattern is written as per-axis phases:

* ``xy_all_to_all``      — all-to-all over the combined (X, Y) group as an
                           X-phase all-to-all followed by a Y-phase one;
* ``xy_all_reduce``      — reduce along X rows, then along Y columns;
* ``xy_reduce_scatter`` / ``xy_all_gather`` — the matching two-phase forms;
* ``shift``              — single-hop ring neighbour exchange.

Every function runs inside a rank on its local tensor and takes the
:class:`~repro_torch.parallel.comm.Mesh` and axis names, as the
reference's run inside ``shard_map`` on named axes.  The hop-count cost
model (:func:`a2a_phase_cost`, :func:`allreduce_cost`) is the reference's,
copied as is.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.comm import Mesh

__all__ = ["shift", "ring_neighbors", "xy_all_to_all", "xy_all_reduce",
           "xy_reduce_scatter", "xy_all_gather", "axis_all_to_all",
           "a2a_phase_cost", "allreduce_cost"]


def ring_neighbors(axis_size: int, shift_by: int = 1) -> list:
    """Source->dest pairs for a ring shift along one axis."""
    return [(i, (i + shift_by) % axis_size) for i in range(axis_size)]


def shift(x: torch.Tensor, mesh: Mesh, axis_name: str,
          shift_by: int = 1) -> torch.Tensor:
    """Move ``x`` to the ``shift_by``-hop neighbour along ``axis_name``
    (one ring hop; token queues are built from it)."""
    return comm.ppermute(x, mesh, axis_name,
                         ring_neighbors(mesh.axis_size(axis_name), shift_by))


def axis_all_to_all(x: torch.Tensor, mesh: Mesh, axis_name: str,
                    split_axis: int, concat_axis: int) -> torch.Tensor:
    """One routing phase: a tiled all-to-all along a single mesh axis,
    ``x``'s ``split_axis`` cut into one block per group rank and the
    received blocks concatenated along ``concat_axis`` in source order."""
    if split_axis == concat_axis:
        return comm.all_to_all(x, mesh, axis_name, split_axis)
    n = mesh.axis_size(axis_name)
    blocks = torch.stack(x.chunk(n, split_axis), 0)
    got = comm.all_to_all(blocks, mesh, axis_name, 0)
    return torch.cat(got.unbind(0), concat_axis)


def xy_all_to_all(x: torch.Tensor, mesh: Mesh, x_axis: str, y_axis: str, *,
                  split_axis: int = 0) -> torch.Tensor:
    """All-to-all over the combined (x_axis x y_axis) group, routed
    dimension-ordered: X phase first, then Y phase.

    Layout contract (the reference's): ``split_axis`` is ordered as
    ``(Y_dest, X_dest, blk)`` — destination = row-major ``(y, x)`` tile
    id, ``GridSpec.tile_id`` — and must divide by ``|X| * |Y|``.  Each
    rank ends up with the blocks destined to it from every other rank,
    source-major in the same order, as a flat all-to-all over the product
    group gives."""
    nx, ny = mesh.axis_size(x_axis), mesh.axis_size(y_axis)
    n = x.shape[split_axis]
    if n % (nx * ny):
        raise ValueError(f"split dim {n} not divisible by mesh {nx}x{ny}")
    blk = n // (nx * ny)
    xs = x.movedim(split_axis, 0)
    rest = tuple(xs.shape[1:])
    # phase 1 (X): blocks for (y_d, x_d) travel to column x_d in this row
    xs = xs.reshape((ny, nx, blk) + rest).transpose(0, 1)
    xs = comm.all_to_all(xs.reshape((nx, ny * blk) + rest), mesh, x_axis, 0)
    # phase 2 (Y): within each column, deliver to the right row
    xs = xs.reshape((nx, ny, blk) + rest).transpose(0, 1)
    xs = comm.all_to_all(xs.reshape((ny, nx * blk) + rest), mesh, y_axis, 0)
    return xs.reshape((n,) + rest).movedim(0, split_axis)


def xy_all_reduce(x: torch.Tensor, mesh: Mesh, x_axis: str,
                  y_axis: str) -> torch.Tensor:
    """Hierarchical all-reduce: along the rows (X), then the columns (Y)."""
    return comm.all_reduce(comm.all_reduce(x, mesh, x_axis), mesh, y_axis)


def xy_reduce_scatter(x: torch.Tensor, mesh: Mesh, x_axis: str, y_axis: str,
                      scatter_dim: int = 0) -> torch.Tensor:
    """Two-phase reduce-scatter (X phase then Y phase) along
    ``scatter_dim``."""
    x = comm.reduce_scatter(x, mesh, x_axis, scatter_dim)
    return comm.reduce_scatter(x, mesh, y_axis, scatter_dim)


def xy_all_gather(x: torch.Tensor, mesh: Mesh, x_axis: str, y_axis: str,
                  gather_dim: int = 0) -> torch.Tensor:
    """Two-phase all-gather: Y phase then X phase (the reverse path)."""
    x = comm.all_gather(x, mesh, y_axis, gather_dim)
    return comm.all_gather(x, mesh, x_axis, gather_dim)


# ---------------------------------------------------------------------------
# Cost model (the reference's, as is).  Link bandwidth in bytes/s.
# ---------------------------------------------------------------------------

def a2a_phase_cost(bytes_per_device: float, axis_size: int,
                   link_bw: float, *, torus: bool = True) -> float:
    """Seconds for one all-to-all phase along a ring/torus axis.

    Uniform all-to-all on a ring of ``k`` devices moves ``B*(k-1)/k`` bytes
    off each device; the bisection-limited time on a (bidirectional) torus
    ring is ``B * k / (8 if torus else 4) / link_bw`` (paper's bisection
    argument: traffic crossing the median limits throughput).
    """
    k = axis_size
    if k <= 1:
        return 0.0
    cut = 4 * link_bw if torus else 2 * link_bw  # 2 links x 2 dirs (torus)
    # bytes crossing one bisection: each of k devices sends B*(k/2)/k ~ B/2
    # across the cut on average => k*B/4 each way.
    return (bytes_per_device * k / 4.0) / cut


def allreduce_cost(bytes_per_device: float, axis_size: int,
                   link_bw: float, *, torus: bool = True) -> float:
    """Seconds for a ring all-reduce along one axis (2(k-1)/k * B / links)."""
    k = axis_size
    if k <= 1:
        return 0.0
    lanes = 2 * link_bw if torus else link_bw  # both ring directions usable
    return 2.0 * (k - 1) / k * bytes_per_device / lanes
