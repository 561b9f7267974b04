"""Mapping logical workload ranks onto mesh tiles.

A workload is written against *logical ranks* (ring position, pipeline
stage, expert id, PGAS tile id); a :class:`Placement` pins each rank to a
physical ``(x, y)`` tile of the mesh.  Two canonical embeddings:

* :meth:`Placement.ring` — boustrophedon ("snake") order, so consecutive
  ranks are mesh neighbors and a logical ring hop is one physical mesh
  hop everywhere except the single wrap-around link.  This is the natural
  embedding for ring all-reduce and pipeline chains (the same embedding
  Celerity used to lay collective chains over its 16x31 array).
* :meth:`Placement.grid` — row-major order, the paper's ``y * nx + x``
  tile id (:func:`repro.core.pgas.tile_linear_index`), used for PGAS and
  expert homes.

Placements are plain numpy and validate themselves: every rank must land
on a distinct tile inside the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Placement", "snake_order", "row_major_order"]


def row_major_order(nx: int, ny: int) -> np.ndarray:
    """(nx*ny, 2) array of (x, y), rank r at tile (r % nx, r // nx)."""
    r = np.arange(nx * ny)
    return np.stack([r % nx, r // nx], axis=1)


def snake_order(nx: int, ny: int) -> np.ndarray:
    """(nx*ny, 2) array of (x, y) in boustrophedon order: row 0 left to
    right, row 1 right to left, ... — consecutive ranks are always mesh
    neighbors (Manhattan distance 1)."""
    coords = []
    for y in range(ny):
        xs = range(nx) if y % 2 == 0 else range(nx - 1, -1, -1)
        coords.extend((x, y) for x in xs)
    return np.asarray(coords, np.int64)


@dataclasses.dataclass(frozen=True)
class Placement:
    """``coords[r] = (x, y)`` — the tile of logical rank ``r``."""

    nx: int
    ny: int
    coords: np.ndarray

    def __post_init__(self):
        c = np.asarray(self.coords, np.int64).reshape(-1, 2)
        object.__setattr__(self, "coords", c)
        if len(c) == 0:
            raise ValueError("a placement needs at least one rank")
        if (c[:, 0] < 0).any() or (c[:, 0] >= self.nx).any() or \
                (c[:, 1] < 0).any() or (c[:, 1] >= self.ny).any():
            raise ValueError(
                f"placement has ranks outside the {self.nx}x{self.ny} mesh")
        if len({(int(x), int(y)) for x, y in c}) != len(c):
            raise ValueError("placement maps two ranks to the same tile")

    # -- constructors ---------------------------------------------------
    @classmethod
    def ring(cls, nx: int, ny: int, k: Optional[int] = None) -> "Placement":
        """First ``k`` ranks of the snake order (default: all tiles)."""
        order = snake_order(nx, ny)
        k = len(order) if k is None else int(k)
        if not 1 <= k <= len(order):
            raise ValueError(
                f"ring size k={k} does not fit a {nx}x{ny} mesh "
                f"({len(order)} tiles)")
        return cls(nx, ny, order[:k])

    @classmethod
    def grid(cls, nx: int, ny: int, k: Optional[int] = None) -> "Placement":
        """First ``k`` ranks of the row-major order (default: all tiles)."""
        order = row_major_order(nx, ny)
        k = len(order) if k is None else int(k)
        if not 1 <= k <= len(order):
            raise ValueError(
                f"k={k} ranks do not fit a {nx}x{ny} mesh "
                f"({len(order)} tiles)")
        return cls(nx, ny, order[:k])

    # -- queries --------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.coords)

    def tile(self, rank: int) -> Tuple[int, int]:
        x, y = self.coords[rank % self.k]
        return int(x), int(y)

    def ring_hop_length(self, rank: int, topology=None) -> int:
        """Routed distance of the ring link rank -> rank+1 (mod k):
        Manhattan on the mesh, ring distance on wrapped dimensions when a
        :class:`repro_torch.mesh.topology.Topology` is given (on a torus the
        snake ring's long wrap-around link collapses to the wraparound
        hop)."""
        x0, y0 = self.tile(rank)
        x1, y1 = self.tile((rank + 1) % self.k)
        if topology is None:
            return abs(x1 - x0) + abs(y1 - y0)
        return int(topology.hops(x0, y0, x1, y1, self.nx, self.ny))
