"""Synthetic traffic-pattern workload library for the mesh simulators.

Standard NoC evaluation battery (the patterns used by the Epiphany-V and
Ring-Mesh evaluations, and by Dally & Towles): uniform random, transpose,
bit-complement, tornado, hotspot, nearest-neighbor.  Every generator
returns an *injection program* — a dict of ``(ny, nx, length)`` int64
arrays with the exact schema of ``MeshSim.load_program`` — so one program
drives :func:`repro_torch.netsim.sim.load_program` and the
:class:`repro_torch.mesh.Simulator` facade.

The injection *rate* r (packets/cycle/tile, 0 < r <= 1) is enforced with
the ``not_before`` field: entry ``i`` may not inject before cycle
``floor(i / r)``.  Offered load is open-loop up to the credit limit; the
endpoints' credit flow control then back-pressures naturally, exactly as
in hardware.

This is the port's own copy of ``repro/mesh/traffic.py``: both draw from
numpy's ``default_rng``, so the same seed gives the same program
(``tests/test_torch_mesh.py`` holds them byte-identical).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.netsim import OP_LOAD, OP_STORE  # noqa: F401 (re-export)

__all__ = ["PATTERNS", "PROG_KEYS", "empty_program", "make_traffic",
           "uniform_random", "transpose", "bit_complement", "tornado",
           "hotspot", "nearest_neighbor"]

PROG_KEYS = ("dst_x", "dst_y", "addr", "data", "cmp", "op", "not_before")


def empty_program(nx: int, ny: int, length: int = 1) -> Dict[str, np.ndarray]:
    """All-padding program (``op`` = -1 everywhere); arrays are
    (ny, nx, length) as the simulators expect.
    """
    prog = {k: np.zeros((ny, nx, length), np.int64) for k in PROG_KEYS}
    prog["op"][:] = -1
    return prog


def _base(nx: int, ny: int, length: int, rate: float, op: int,
          mem_words: int, seed: int) -> Tuple[Dict[str, np.ndarray],
                                              np.random.Generator]:
    if not 0.0 < rate <= 1.0:
        raise ValueError(
            f"injection rate must be in (0, 1] packets/cycle/tile, "
            f"got {rate}")
    prog = empty_program(nx, ny, length)
    i = np.arange(length)
    prog["op"][:] = op
    prog["addr"][:] = i % mem_words
    prog["data"][:] = np.arange(ny * nx * length).reshape(ny, nx, length)
    prog["not_before"][:] = np.floor(i / rate).astype(np.int64)
    return prog, np.random.default_rng(seed)


# ----------------------------------------------------------------------
# the patterns: each fills dst_x / dst_y of a base program
# ----------------------------------------------------------------------
def uniform_random(nx: int, ny: int, length: int, *, rate: float = 1.0,
                   op: int = OP_STORE, mem_words: int = 64,
                   seed: int = 0, topology=None) -> Dict[str, np.ndarray]:
    """Every packet targets a uniformly random *other* tile (the pattern
    itself is topology-independent; ``topology`` is accepted so every
    generator has a uniform signature)."""
    prog, rng = _base(nx, ny, length, rate, op, mem_words, seed)
    n = ny * nx
    src = np.arange(n).reshape(ny, nx, 1)
    # uniform over the n-1 other tiles: src + U[1, n) mod n is never self
    dst = (src + rng.integers(1, n, (ny, nx, length))) % n
    prog["dst_y"], prog["dst_x"] = np.divmod(dst, nx)
    return prog


def transpose(nx: int, ny: int, length: int, *, rate: float = 1.0,
              op: int = OP_STORE, mem_words: int = 64,
              seed: int = 0, topology=None) -> Dict[str, np.ndarray]:
    """(x, y) -> (y, x).  Only defined on square arrays — on a non-square
    array the transposed coordinate falls off the edge (wraparound does
    not help: the transpose of a valid coordinate must itself be a valid
    coordinate, so the constraint is the same on every topology)."""
    if nx != ny:
        raise ValueError(
            f"transpose traffic is undefined on a non-square mesh "
            f"(got nx={nx}, ny={ny}); use a square mesh or another pattern")
    prog, _ = _base(nx, ny, length, rate, op, mem_words, seed)
    ys, xs = np.mgrid[0:ny, 0:nx]
    prog["dst_x"][:] = ys[..., None]
    prog["dst_y"][:] = xs[..., None]
    return prog


def bit_complement(nx: int, ny: int, length: int, *, rate: float = 1.0,
                   op: int = OP_STORE, mem_words: int = 64,
                   seed: int = 0, topology=None) -> Dict[str, np.ndarray]:
    """(x, y) -> (nx-1-x, ny-1-y): every packet crosses both bisections."""
    prog, _ = _base(nx, ny, length, rate, op, mem_words, seed)
    ys, xs = np.mgrid[0:ny, 0:nx]
    prog["dst_x"][:] = (nx - 1 - xs)[..., None]
    prog["dst_y"][:] = (ny - 1 - ys)[..., None]
    return prog


def _tornado_shift(k: int, wrap: bool) -> int:
    """Tornado offset along one dimension of extent ``k``.

    The classic tornado pattern is torus-relative: shift ``floor(k/2)``
    with wraparound, so minimal routes all march the same way around the
    ring and saturate it.  On a non-wrapped dimension that offset cannot
    wrap, so the adversarial offset is the near-half-way
    ``ceil(k/2) - 1`` (Dally & Towles §3.2) — which is also what keeps
    the mesh tornado baselines bit-identical to the pre-topology code.
    """
    return (k // 2) if wrap else max(math.ceil(k / 2) - 1, 0)


def tornado(nx: int, ny: int, length: int, *, rate: float = 1.0,
            op: int = OP_STORE, mem_words: int = 64,
            seed: int = 0, topology=None) -> Dict[str, np.ndarray]:
    """Each dimension shifts by the tornado offset (see
    :func:`_tornado_shift`): ``floor(k/2)`` with wraparound on wrapped
    (ring/torus) dimensions, ``ceil(k/2) - 1`` on mesh dimensions."""
    prog, _ = _base(nx, ny, length, rate, op, mem_words, seed)
    wrap_x = topology is not None and topology.wrap_x
    wrap_y = topology is not None and topology.wrap_y
    ys, xs = np.mgrid[0:ny, 0:nx]
    prog["dst_x"][:] = ((xs + _tornado_shift(nx, wrap_x)) % nx)[..., None]
    prog["dst_y"][:] = ((ys + _tornado_shift(ny, wrap_y)) % ny)[..., None]
    return prog


def hotspot(nx: int, ny: int, length: int, *, rate: float = 1.0,
            op: int = OP_STORE, mem_words: int = 64, seed: int = 0,
            spot: Optional[Tuple[int, int]] = None,
            fraction: float = 0.5, topology=None) -> Dict[str, np.ndarray]:
    """A ``fraction`` of packets hammer one hot tile (default: the center);
    the rest are uniform random over the other tiles."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"hotspot fraction must be in (0, 1] (the share of packets "
            f"aimed at the hot tile), got {fraction}")
    hx, hy = spot if spot is not None else (nx // 2, ny // 2)
    if not (0 <= hx < nx and 0 <= hy < ny):
        raise ValueError(
            f"hotspot coordinate must lie inside the {nx}x{ny} mesh, "
            f"got spot=({hx}, {hy})")
    prog, rng = _base(nx, ny, length, rate, op, mem_words, seed)
    uni = uniform_random(nx, ny, length, rate=rate, op=op,
                         mem_words=mem_words, seed=seed + 1)
    hot = rng.random((ny, nx, length)) < fraction
    prog["dst_x"] = np.where(hot, hx, uni["dst_x"])
    prog["dst_y"] = np.where(hot, hy, uni["dst_y"])
    return prog


def nearest_neighbor(nx: int, ny: int, length: int, *, rate: float = 1.0,
                     op: int = OP_STORE, mem_words: int = 64,
                     seed: int = 0, topology=None) -> Dict[str, np.ndarray]:
    """Each tile streams to its east neighbour (wrapping at the edge) — the
    paper's line-rate one-to-one pattern at array scale."""
    prog, _ = _base(nx, ny, length, rate, op, mem_words, seed)
    ys, xs = np.mgrid[0:ny, 0:nx]
    prog["dst_x"][:] = ((xs + 1) % nx)[..., None]
    prog["dst_y"][:] = ys[..., None]
    return prog


PATTERNS: Dict[str, Callable[..., Dict[str, np.ndarray]]] = {
    "uniform": uniform_random,
    "transpose": transpose,
    "bit_complement": bit_complement,
    "tornado": tornado,
    "hotspot": hotspot,
    "neighbor": nearest_neighbor,
}


def make_traffic(pattern: str, nx: int, ny: int, length: int,
                 **kw) -> Dict[str, np.ndarray]:
    """Dispatch by pattern name (see :data:`PATTERNS`); keyword arguments
    are forwarded to the generator (``rate``, ``op``, ``seed``, ...).

    Every generator accepts ``topology=`` (a
    :class:`repro_torch.mesh.topology.Topology`); patterns whose classic
    definition is topology-relative (tornado) use it, the rest accept and
    ignore it so callers can thread one topology through uniformly.

    Raises :class:`ValueError` — one clear error per invalid combination —
    for unknown patterns, an injection rate outside ``(0, 1]``, invalid
    hotspot parameters (a ``spot`` outside the mesh or a ``fraction``
    outside ``(0, 1]``), a topology that cannot be laid onto the array
    (multi-chip with indivisible ``nx``), or an array on which the
    pattern is undefined (e.g. transpose on a non-square mesh).
    """
    try:
        fn = PATTERNS[pattern]
    except KeyError:
        raise ValueError(
            f"unknown pattern {pattern!r}; known: {sorted(PATTERNS)}") from None
    topo = kw.get("topology")
    if topo is not None:
        topo.validate_for(nx, ny)
    return fn(nx, ny, length, **kw)
