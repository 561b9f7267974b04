"""PGAS coordinates and global addressing (paper C1).

The BaseJump network addresses the whole machine as
``<X cord, Y cord, local address>``.  We reproduce that addressing scheme
exactly: a :class:`GridSpec` defines the logical 2D grid (X grows east, Y
grows south, I/O attaches on the south edge per the paper's routing
constraints), and :func:`encode_address` / :func:`decode_address` pack the
three fields into a single integer word the way
``bsg_manycore_packet.vh`` does.

On a mesh of ranks the same grid is laid over the process groups: grid X
maps to the ``model`` mesh axis and grid Y to the ``data`` mesh axis (so
that a row of tiles shares weights — a TP group — and a column shares data
shards).  The port's own copy of ``repro.core.coords``, which is numpy
only.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

__all__ = [
    "GridSpec",
    "encode_address",
    "decode_address",
    "manhattan_hops",
    "xy_route",
]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Logical 2D manycore grid.

    Mirrors the paper's parameters: ``x_cord_width_p`` / ``y_cord_width_p``
    define coordinate field widths, ``addr_width`` the per-tile local
    address space ("memory region", in words).
    """

    nx: int
    ny: int
    addr_width: int = 20  # paper default: 20-bit word addresses per tile
    data_width: int = 32  # paper default word size

    def __post_init__(self):
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"grid dims must be positive, got {self.nx}x{self.ny}")

    @property
    def x_cord_width(self) -> int:
        return max(1, int(np.ceil(np.log2(max(self.nx, 2)))))

    @property
    def y_cord_width(self) -> int:
        # Paper: extra Y coordinates multiply up space at the periphery
        # ("virtual mesh"), so the Y field must hold ny (south I/O row
        # included by the caller if needed).
        return max(1, int(np.ceil(np.log2(max(self.ny, 2)))))

    @property
    def num_tiles(self) -> int:
        return self.nx * self.ny

    @property
    def region_words(self) -> int:
        """Size of each tile's local memory region in words."""
        return 1 << self.addr_width

    def tile_id(self, x: int, y: int) -> int:
        """Row-major tile index (used to map tiles onto mesh devices)."""
        self._check(x, y)
        return y * self.nx + x

    def tile_xy(self, tid: int) -> Tuple[int, int]:
        return tid % self.nx, tid // self.nx

    def tiles(self) -> Iterator[Tuple[int, int]]:
        for y in range(self.ny):
            for x in range(self.nx):
                yield (x, y)

    def _check(self, x, y) -> None:
        if not (0 <= x < self.nx and 0 <= y < self.ny):
            raise ValueError(f"tile ({x},{y}) outside {self.nx}x{self.ny} grid")

    # --- bisection geometry (paper: "16 links crossing the bisection") ---
    def bisection_links(self, axis: str = "x") -> int:
        """Number of unidirectional links crossing the median cut.

        An ``nx x ny`` mesh cut across the X dimension has ``ny`` links in
        each direction; the paper counts both directions (8x8 mesh -> 16).
        """
        if axis == "x":
            return 2 * self.ny
        if axis == "y":
            return 2 * self.nx
        raise ValueError(axis)


def encode_address(spec: GridSpec, x: int, y: int, local: int) -> int:
    """Pack ``<X, Y, local>`` into one integer (paper C1 address format)."""
    spec._check(x, y)
    if not (0 <= local < spec.region_words):
        raise ValueError(f"local address {local:#x} exceeds region ({spec.addr_width} bits)")
    return (((y << spec.x_cord_width) | x) << spec.addr_width) | local


def decode_address(spec: GridSpec, addr: int) -> Tuple[int, int, int]:
    """Unpack a global address into ``(x, y, local)``."""
    local = addr & (spec.region_words - 1)
    rest = addr >> spec.addr_width
    x = rest & ((1 << spec.x_cord_width) - 1)
    y = rest >> spec.x_cord_width
    spec._check(x, y)
    return x, y, local


def manhattan_hops(src: Tuple[int, int], dst: Tuple[int, int]) -> int:
    """Hop count under XY dimension-ordered routing (== Manhattan distance)."""
    return abs(dst[0] - src[0]) + abs(dst[1] - src[1])


def xy_route(src: Tuple[int, int], dst: Tuple[int, int]) -> list:
    """The exact sequence of tiles an XY-routed packet traverses (paper C4).

    X first, then Y.  The N->E and N->W turns are structurally impossible in
    routes produced here, matching the router's reduced crossbar.
    """
    (sx, sy), (dx, dy) = src, dst
    path = [(sx, sy)]
    step = 1 if dx >= sx else -1
    for x in range(sx + step, dx + step, step) if dx != sx else []:
        path.append((x, sy))
    step = 1 if dy >= sy else -1
    for y in range(sy + step, dy + step, step) if dy != sy else []:
        path.append((dx, y))
    return path
