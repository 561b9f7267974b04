"""Pluggable network topologies for the mesh simulators.

The paper's network is a 2-D mesh, but the datapath generalizes: BSG Ten
extends the same mesh over off-chip links to an FPGA (two sub-meshes
joined by narrower, higher-latency boundary links), and the related-work
Ring-Mesh (Mazumdar & Scionti 2019) and torus variants differ from the
mesh only in *where each output port leads* and *which way a packet
turns*.  :class:`Topology` captures exactly those two degrees of freedom:

* **Connectivity** — whether the X and/or Y dimension wraps around
  (``wrap_x`` / ``wrap_y``), and, for the multi-chip topology, which
  column-to-column links are chip-boundary links and how much narrower
  they are (``chips_x`` / ``boundary_period``).
* **Routing** — :meth:`route`, the per-packet output-port decision.  It
  is written against a caller-supplied array namespace (``xp=numpy`` for
  host code, ``xp=torch`` for the plain PyTorch step) using only
  arithmetic and ``where``; the CUDA router kernel repeats the same
  expression in C++ (with a floor modulo where C's ``%`` would differ).

This is the port's own copy of ``repro/mesh/topology.py``;
``tests/test_torch_mesh.py`` holds its routing equal to the original's.

Routing stays dimension-ordered (X then Y) on every topology, which
preserves the paper's reduced-crossbar invariant — the N input never
requests E or W — because the Y phase never re-enters X.  On wrapped
dimensions the router takes the minimal ring direction; the exact-half
tie on even rings is broken by coordinate parity so the two ring
directions stay load-balanced (a fixed tie-break would cost ~11% of
uniform throughput).

**Deadlock freedom.** A wrapped dimension is a ring, and rings deadlock
under plain dimension-ordered routing.  The simulators avoid this with
*local bubble flow control* (Carara/Bubble ring rule): a packet may
ENTER a ring (from the P port or from the orthogonal dimension) only if
the target FIFO has **two** free slots, while a packet CONTINUING around
the ring needs the usual one.  Ring occupancy only grows via entering
packets, each of which leaves a free slot behind, so every ring always
keeps at least one bubble and the continuing traffic can always make
progress.  On non-wrapped topologies the rule is compiled out and the
datapath is bit-identical to the original mesh.

**Multi-chip boundary links.**  ``Topology.multi_chip(chips_x=C,
boundary_period=S)`` splits the mesh into C equal-width sub-meshes along
X.  The E/W links crossing a chip boundary model BSG Ten's off-chip hop
as an S× narrower channel: they accept a flit only on cycles where
``cycle % S == 0`` — 1/S throughput and 0..S-1 cycles of added latency,
with no extra state (so all three backends stay trivially bit-identical).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.netsim import E, N, P, S, W

__all__ = ["Topology", "KINDS"]

KINDS = ("mesh", "torus", "ring_mesh", "multi_chip")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Network topology: connectivity + routing function.  Frozen and
    hashable, so it rides inside the static (jit) simulator configs.

    Use the constructors — :meth:`mesh`, :meth:`torus`, :meth:`ring_mesh`,
    :meth:`multi_chip` — rather than spelling the fields out.
    """
    kind: str = "mesh"
    wrap_x: bool = False         # X dimension is a ring
    wrap_y: bool = False         # Y dimension is a ring
    chips_x: int = 1             # sub-meshes along X (multi_chip only)
    boundary_period: int = 1     # boundary link accepts 1 flit / S cycles

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown topology kind {self.kind!r}; known: {KINDS}")
        if self.chips_x < 1 or self.boundary_period < 1:
            raise ValueError(
                f"chips_x and boundary_period must be >= 1, got "
                f"chips_x={self.chips_x}, boundary_period={self.boundary_period}")
        want = {"mesh": (False, False, 1), "torus": (True, True, 1),
                "ring_mesh": (True, False, 1),
                "multi_chip": (False, False, self.chips_x)}[self.kind]
        if (self.wrap_x, self.wrap_y) != want[:2] or self.chips_x != want[2] \
                or (self.kind != "multi_chip" and
                    (self.chips_x != 1 or self.boundary_period != 1)):
            raise ValueError(
                f"inconsistent topology fields for kind {self.kind!r}: "
                f"wrap_x={self.wrap_x}, wrap_y={self.wrap_y}, "
                f"chips_x={self.chips_x}, "
                f"boundary_period={self.boundary_period}; use the "
                f"Topology.{self.kind}() constructor")
        if self.kind == "multi_chip" and self.chips_x < 2:
            raise ValueError(
                f"multi_chip needs chips_x >= 2, got {self.chips_x}")

    # -- constructors ---------------------------------------------------
    @classmethod
    def mesh(cls) -> "Topology":
        """The paper's plain 2-D mesh (the default everywhere)."""
        return cls("mesh")

    @classmethod
    def torus(cls) -> "Topology":
        """Both dimensions wrap around (2-D torus)."""
        return cls("torus", wrap_x=True, wrap_y=True)

    @classmethod
    def ring_mesh(cls) -> "Topology":
        """Ring-Mesh hybrid (Mazumdar & Scionti): rows are rings
        (X wraps), columns remain a plain mesh."""
        return cls("ring_mesh", wrap_x=True)

    @classmethod
    def multi_chip(cls, chips_x: int = 2,
                   boundary_period: int = 4) -> "Topology":
        """``chips_x`` equal-width sub-meshes joined along X by boundary
        links that accept one flit every ``boundary_period`` cycles
        (BSG Ten's narrower, higher-latency off-chip hop)."""
        return cls("multi_chip", chips_x=int(chips_x),
                   boundary_period=int(boundary_period))

    # -- string form (sweep specs, cache keys, JSON artifacts) ----------
    @classmethod
    def parse(cls, spec) -> "Topology":
        """A :class:`Topology` from its string form: one of the plain
        kinds (``"mesh"``, ``"torus"``, ``"ring_mesh"``) or
        ``"multi_chip[:chips_x[:boundary_period]]"``.  A ``Topology`` is
        passed through, so declarative sweep specs can mix both forms."""
        if isinstance(spec, cls):
            return spec
        if not isinstance(spec, str):
            raise TypeError(
                f"cannot interpret {spec!r} as a topology; pass a "
                f"Topology or one of {KINDS} (multi_chip optionally as "
                f"'multi_chip:chips_x:boundary_period')")
        kind, _, rest = spec.partition(":")
        if kind != "multi_chip":
            if rest:
                raise ValueError(
                    f"topology {kind!r} takes no ':' parameters, "
                    f"got {spec!r}")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown topology kind {kind!r}; known: {KINDS}")
            return {"mesh": cls.mesh, "torus": cls.torus,
                    "ring_mesh": cls.ring_mesh}[kind]()
        try:
            params = [int(p) for p in rest.split(":")] if rest else []
        except ValueError:
            raise ValueError(
                f"multi_chip parameters must be ints, got {spec!r}") from None
        if len(params) > 2:
            raise ValueError(
                f"multi_chip takes at most chips_x:boundary_period, "
                f"got {spec!r}")
        return cls.multi_chip(*params)

    @property
    def spec(self) -> str:
        """The string :meth:`parse` round-trips (``"torus"``,
        ``"multi_chip:2:4"``, ...)."""
        if self.kind == "multi_chip":
            return f"multi_chip:{self.chips_x}:{self.boundary_period}"
        return self.kind

    @property
    def min_router_fifo(self) -> int:
        """Smallest valid router FIFO depth: wrapped (ring) dimensions
        need 2 slots for the bubble flow control, plain meshes 1."""
        return 2 if (self.wrap_x or self.wrap_y) else 1

    # -- validation -----------------------------------------------------
    def validate_for(self, nx: int, ny: int) -> None:
        """Raise ``ValueError`` when this topology cannot be laid onto an
        ``nx`` x ``ny`` array (multi-chip needs equal-width chips)."""
        if self.chips_x > 1 and (nx % self.chips_x != 0 or
                                 nx // self.chips_x < 1):
            raise ValueError(
                f"multi_chip topology with chips_x={self.chips_x} needs nx "
                f"divisible into equal-width chips, got nx={nx}")

    # -- routing --------------------------------------------------------
    def route(self, dst_x, dst_y, x, y, nx: int, ny: int, xp=np):
        """Output port (P/W/E/N/S) for a packet at ``(x, y)`` heading to
        ``(dst_x, dst_y)``.  Pure elementwise arithmetic in the array
        namespace ``xp`` (numpy or torch); the CUDA router kernel's
        ``route`` is its line-for-line C++ twin.

        Dimension-ordered X-then-Y on every topology.  Wrapped dimensions
        take the minimal ring direction; the even-ring half-way tie is
        broken by the parity of ``x + y + dst_x + dst_y`` (stable along a
        route: the tie can only occur at one position, after which the
        minimal direction is strict).
        """
        if not self.wrap_x and not self.wrap_y:
            return xp.where(dst_x > x, E, xp.where(dst_x < x, W,
                   xp.where(dst_y > y, S, xp.where(dst_y < y, N, P))))
        tie = ((x + y + dst_x + dst_y) % 2) == 0
        if self.wrap_x:
            dx = (dst_x - x) % nx
            go_e = (2 * dx < nx) | ((2 * dx == nx) & tie)
            xstep = xp.where(go_e, E, W)
            x_need = dx != 0
        else:
            xstep = xp.where(dst_x > x, E, W)
            x_need = dst_x != x
        if self.wrap_y:
            dy = (dst_y - y) % ny
            go_s = (2 * dy < ny) | ((2 * dy == ny) & tie)
            ystep = xp.where(go_s, S, N)
            y_need = dy != 0
        else:
            ystep = xp.where(dst_y > y, S, N)
            y_need = dst_y != y
        return xp.where(x_need, xstep, xp.where(y_need, ystep, P))

    # -- distances ------------------------------------------------------
    def hops(self, src_x, src_y, dst_x, dst_y, nx: int, ny: int):
        """Routed hop count (Manhattan on mesh dims, ring distance on
        wrapped dims).  Elementwise; works on scalars or arrays."""
        ax = np.abs(np.asarray(dst_x) - np.asarray(src_x))
        ay = np.abs(np.asarray(dst_y) - np.asarray(src_y))
        hx = np.minimum(ax, nx - ax) if self.wrap_x else ax
        hy = np.minimum(ay, ny - ay) if self.wrap_y else ay
        return hx + hy

    def diameter(self, nx: int, ny: int) -> int:
        """Longest minimal route on an ``nx`` x ``ny`` array."""
        return int((nx // 2 if self.wrap_x else nx - 1)
                   + (ny // 2 if self.wrap_y else ny - 1))

    # -- multi-chip boundary --------------------------------------------
    @property
    def gated(self) -> bool:
        """True when some links are cycle-gated boundary links."""
        return self.chips_x > 1 and self.boundary_period > 1

    def chip_width(self, nx: int) -> int:
        self.validate_for(nx, 1)
        return nx // self.chips_x

    def boundary_cols(self, nx: int) -> Tuple[int, ...]:
        """Column indices ``c`` such that the link between columns
        ``c - 1`` and ``c`` crosses a chip boundary (E output gated at
        column ``c - 1``, W output gated at column ``c``)."""
        if self.chips_x <= 1:
            return ()
        w = self.chip_width(nx)
        return tuple(b * w for b in range(1, self.chips_x))

    # -- analytic capacity ----------------------------------------------
    def uniform_saturation_bound(self, nx: int, ny: int) -> float:
        """Analytic per-tile injection-rate bound under uniform-random
        traffic (the bisection/channel-load bound the saturation
        benchmarks compare against).

        Walks the *actual* :meth:`route` for every (src, dst) pair and
        accumulates per-channel crossing counts C(l); a channel of
        capacity ``cap`` (1 flit/cycle, or 1/boundary_period on a
        chip-boundary link) then bounds the rate at
        ``cap * (N - 1) / C(l)``.  Because the walk uses the real routing
        function, the bound accounts for the ring tie-break exactly.  On
        the plain mesh this recovers the classic 4/k bisection bound
        (2k/N with XY routing); the torus doubles it to 8/k.
        """
        self.validate_for(nx, ny)
        n = nx * ny
        if n < 2:
            return 1.0
        ys, xs = np.mgrid[0:ny, 0:nx]
        fx, fy = xs.reshape(-1), ys.reshape(-1)
        sx, sy = np.repeat(fx, n), np.repeat(fy, n)
        dx, dy = np.tile(fx, n), np.tile(fy, n)
        sel = (sx != dx) | (sy != dy)
        px, py, dx, dy = sx[sel].copy(), sy[sel].copy(), dx[sel], dy[sel]
        cross = np.zeros((ny, nx, 5), np.int64)
        for _ in range(self.diameter(nx, ny) + 1):
            d = self.route(dx, dy, px, py, nx, ny, xp=np)
            alive = d != P
            if not alive.any():
                break
            np.add.at(cross, (py[alive], px[alive], d[alive]), 1)
            px = np.where(d == E, (px + 1) % nx,
                          np.where(d == W, (px - 1) % nx, px))
            py = np.where(d == S, (py + 1) % ny,
                          np.where(d == N, (py - 1) % ny, py))
        cap = np.ones((ny, nx, 5))
        for c in self.boundary_cols(nx):
            cap[:, c - 1, E] = 1.0 / self.boundary_period
            cap[:, c, W] = 1.0 / self.boundary_period
        used = cross > 0
        rate = float((cap[used] * (n - 1) / cross[used]).min()) \
            if used.any() else 1.0
        return min(rate, 1.0)
