"""Pareto-frontier extraction over (buffer area, saturation throughput).

The DSE's deliverable: of all swept (fifo_depth, credits) configurations
of one topology, which are *undominated* — no cheaper configuration
delivers at least the same saturated throughput?  Minimizes the x key,
maximizes the y key; ties on x keep only the best y, so the frontier is
strictly increasing in throughput as area grows (asserted by
:func:`frontier_is_monotone`, which CI gates on).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

__all__ = ["pareto_front", "frontier_is_monotone", "ascii_frontier"]


def _getter(key) -> Callable[[Dict], float]:
    return key if callable(key) else (lambda r: float(r[key]))


def pareto_front(records: Sequence[Dict], x_key="area_mm2",
                 y_key="throughput") -> List[Dict]:
    """The undominated subset of ``records`` (minimize ``x_key``,
    maximize ``y_key``), sorted by ascending x.  Keys may be dict keys
    or callables.  Records with missing/None metric values are excluded
    (a point that never saturated has no throughput to trade)."""
    gx, gy = _getter(x_key), _getter(y_key)

    def metrics(r):
        try:
            x, y = gx(r), gy(r)
        except (KeyError, TypeError):
            return None
        if x is None or y is None or not np.isfinite(x) or not np.isfinite(y):
            return None
        return x, y

    scored = [(m[0], m[1], r) for r in records
              if (m := metrics(r)) is not None]
    scored.sort(key=lambda t: (t[0], -t[1]))
    front: List[Dict] = []
    best = -np.inf
    for x, y, r in scored:
        if y > best:
            front.append(r)
            best = y
    return front


def frontier_is_monotone(front: Sequence[Dict], x_key="area_mm2",
                         y_key="throughput") -> bool:
    """Is ``front`` a well-formed Pareto frontier?  Nondecreasing in x
    AND strictly increasing in y (every extra mm² must buy throughput —
    anything else is a dominated point that should have been dropped).
    An empty frontier is NOT well formed: the sweep produced nothing."""
    if not front:
        return False
    gx, gy = _getter(x_key), _getter(y_key)
    xs = [gx(r) for r in front]
    ys = [gy(r) for r in front]
    return all(b >= a for a, b in zip(xs, xs[1:])) and \
        all(b > a for a, b in zip(ys, ys[1:]))


def ascii_frontier(records: Sequence[Dict], front: Sequence[Dict],
                   x_key="area_mm2", y_key="throughput",
                   width: int = 56, height: int = 14,
                   x_label: str = "buffer area [mm^2]",
                   y_label: str = "sat throughput") -> str:
    """Scatter figure of a sweep: ``*`` marks frontier points, ``.``
    dominated ones, with the axes annotated — the terminal twin of the
    JSON artifact, in the style of ``measure.ascii_curve``."""
    gx, gy = _getter(x_key), _getter(y_key)

    def xy(r):
        try:
            x, y = gx(r), gy(r)
        except (KeyError, TypeError):
            return None
        return None if x is None or y is None else (x, y)

    pts = [p for r in records if (p := xy(r)) is not None]
    if not pts:
        return "    (no points)"
    fset = {p for r in front if (p := xy(r)) is not None}
    xs, ys = zip(*pts)
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    sx = (width - 1) / max(x1 - x0, 1e-12)
    sy = (height - 1) / max(y1 - y0, 1e-12)
    grid = [[" "] * width for _ in range(height)]
    for x, y in pts:  # dominated first so frontier marks overwrite them
        if (x, y) not in fset:
            grid[int((y - y0) * sy)][int((x - x0) * sx)] = "."
    for x, y in fset:
        grid[int((y - y0) * sy)][int((x - x0) * sx)] = "*"
    rows = []
    for i in range(height - 1, -1, -1):
        edge = f"{y1:8.3f} +" if i == height - 1 else (
            f"{y0:8.3f} +" if i == 0 else "         |")
        rows.append(edge + "".join(grid[i]))
    rows.append("         +" + "-" * width)
    rows.append(f"          {x0:<12.4f}{x_label:^{max(width - 24, 8)}}"
                f"{x1:>12.4f}")
    rows.append(f"          ({len(front)} frontier / {len(pts)} points, "
                f"y = {y_label})")
    return "\n".join(rows)
