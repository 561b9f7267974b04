"""The unified telemetry record of a mesh simulation.

The port's own copy of ``repro/mesh/telemetry.py``.  The simulator
accumulates cycle-exact counters in ``SimState``; :class:`Telemetry` is
the one normalized view — ``Simulator.telemetry()`` returns it with every
field as int64 numpy, so a record of the port and one of the JAX package
compare directly (``tests/test_torch_facade.py`` asserts them equal).

``out_of_credit_cycles`` is deliberately NOT part of the record: it
counts cycles where a tile had *pending but unissuable* work, which is
well defined for injection programs but not observable for reactive
endpoints (the simulator cannot know whether an endpoint "would have"
offered), so it cannot be made backend-identical for bridged endpoint
runs.  It stays available on the program path via the backend object.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Telemetry", "TELEMETRY_ARRAY_FIELDS", "PORT_NAMES",
           "render_heatmap"]

TELEMETRY_ARRAY_FIELDS = ("completed", "lat_sum", "completed_per_cycle",
                          "link_util_fwd", "link_util_rev",
                          "fifo_hwm_fwd", "fifo_hwm_rev", "ep_hwm",
                          "lat_hist")

# bsg_noc_pkg port order (P = ejection to the endpoint)
PORT_NAMES = ("P", "W", "E", "N", "S")

_SHADES = " .:-=+*#%@"


def render_heatmap(util: np.ndarray, *, title: str = "",
                   per_port: bool = False) -> str:
    """ASCII rendering of a ``(ny, nx, ports)`` utilization array
    (fractions of cycles, as returned by :meth:`Telemetry.link_heatmap`).

    The default view shades each tile by its *busiest* output port
    (`` .:-=+*#%@`` over utilization 0..max) and annotates the peak link;
    ``per_port=True`` adds one grid per port.  Rows print north to south,
    so the figure matches the paper's Fig. 1 orientation.
    """
    util = np.asarray(util, float)
    if util.ndim != 3:
        raise ValueError(
            f"expected a (ny, nx, ports) utilization array, "
            f"got shape {util.shape}")
    peak = float(util.max())
    scale = peak if peak > 0 else 1.0

    def grid(u2d: np.ndarray) -> str:
        rows = []
        for y in range(u2d.shape[0]):
            cells = [_SHADES[min(int(u2d[y, x] / scale * (len(_SHADES) - 1)),
                                 len(_SHADES) - 1)]
                     for x in range(u2d.shape[1])]
            rows.append("    " + " ".join(cells))
        return "\n".join(rows)

    ny, nx, _ = util.shape
    hy, hx, hp = np.unravel_index(int(util.argmax()), util.shape)
    lines = []
    if title:
        lines.append(title)
    lines.append(grid(util.max(axis=-1)))
    lines.append(f"    scale: ' '=0 .. '@'={peak:.3f} pkts/cycle; "
                 f"peak link ({hx},{hy}) port "
                 f"{PORT_NAMES[hp % len(PORT_NAMES)]}")
    if per_port:
        for p in range(util.shape[-1]):
            lines.append(f"  port {PORT_NAMES[p % len(PORT_NAMES)]}:")
            lines.append(grid(util[..., p]))
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True, eq=False)
class Telemetry:
    """Normalized simulation telemetry (all arrays int64 numpy)."""

    cycles: int                        # total cycles simulated
    completed: np.ndarray              # (ny, nx) responses received per tile
    lat_sum: np.ndarray                # (ny, nx) summed round-trip latency
    completed_per_cycle: np.ndarray    # (cycles,) completion trace
    link_util_fwd: np.ndarray          # (ny, nx, 5) pkts out of each port
    link_util_rev: np.ndarray          # (ny, nx, 5)
    fifo_hwm_fwd: np.ndarray           # (ny, nx, 5) FIFO occupancy HWMs
    fifo_hwm_rev: np.ndarray           # (ny, nx, 5)
    ep_hwm: np.ndarray                 # (ny, nx) endpoint-FIFO HWM
    lat_hist: np.ndarray               # (LAT_BINS,) RTT histogram (windowed)

    @classmethod
    def of(cls, sim) -> "Telemetry":
        """Build from anything oracle-shaped (``TorchMeshSim`` or the
        :class:`repro_torch.mesh.Simulator` facade).

        Every array is **copied** (``np.array(copy=True)``, not
        ``asarray``): the sources are live simulator counters — tensors that
        the drivers and the CUDA kernel update in place on the next
        ``run``.  ``asarray`` into the same dtype is a zero-copy view of
        exactly those buffers, so a snapshot taken at the facade boundary
        would silently mutate later; an explicit copy makes the record a
        true point-in-time snapshot."""
        return cls(cycles=int(sim.cycle),
                   **{f: np.array(getattr(sim, f), dtype=np.int64, copy=True)
                      for f in TELEMETRY_ARRAY_FIELDS})

    def assert_bit_identical(self, other: "Telemetry") -> None:
        """Assert exact equality of every field (the cross-backend
        contract); raises AssertionError naming the first mismatch."""
        assert self.cycles == other.cycles, \
            f"telemetry mismatch: cycles {self.cycles} != {other.cycles}"
        for f in TELEMETRY_ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(self, f),
                                          getattr(other, f),
                                          err_msg=f"telemetry mismatch: {f}")

    def __eq__(self, other) -> bool:
        if not isinstance(other, Telemetry):
            return NotImplemented
        return self.cycles == other.cycles and all(
            np.array_equal(getattr(self, f), getattr(other, f))
            for f in TELEMETRY_ARRAY_FIELDS)

    # quick derived views -----------------------------------------------
    def link_heatmap(self, network: str = "fwd",
                     cycles: Optional[int] = None) -> np.ndarray:
        """Per-link utilization as a float ``(ny, nx, 5)`` array: packets
        sent out of each router output port per cycle (``P`` = ejection
        to the endpoint; bsg_noc_pkg port order, see :data:`PORT_NAMES`).

        ``network`` picks the physical network (``"fwd"`` requests /
        ``"rev"`` responses); ``cycles`` overrides the normalization
        window (e.g. a measurement-window length) — default is the full
        run."""
        if network not in ("fwd", "rev"):
            raise ValueError(
                f"network must be 'fwd' or 'rev', got {network!r}")
        util = self.link_util_fwd if network == "fwd" else self.link_util_rev
        denom = self.cycles if cycles is None else int(cycles)
        return np.asarray(util, np.float64) / max(denom, 1)

    def hotspots(self, network: str = "fwd", top: int = 5
                 ) -> List[Tuple[float, int, int, str]]:
        """The ``top`` busiest links as ``(utilization, x, y, port)``,
        most loaded first — the congestion culprits a workload report
        names."""
        hm = self.link_heatmap(network)
        flat = hm.reshape(-1)
        order = np.argsort(flat)[::-1][:max(top, 0)]
        out = []
        for idx in order:
            y, x, p = np.unravel_index(int(idx), hm.shape)
            out.append((float(flat[idx]), int(x), int(y), PORT_NAMES[p]))
        return out

    def heatmap_str(self, network: str = "fwd", *, title: str = "",
                    per_port: bool = False) -> str:
        """:func:`render_heatmap` of :meth:`link_heatmap`."""
        return render_heatmap(self.link_heatmap(network), title=title,
                              per_port=per_port)

    def mean_latency(self) -> float:
        done = int(self.completed.sum())
        return float(self.lat_sum.sum()) / max(done, 1)

    def throughput(self, warmup: int = 0) -> float:
        per = self.completed_per_cycle[warmup:]
        return float(per.sum()) / max(len(per), 1)
