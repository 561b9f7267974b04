"""Deciding ``correct``: the served answers of a sample of the window's
requests against the plain fp32 reference.

The sample is drawn from the seed among the requests the window served,
with a longest one in it.  For each, the reference computes the fp32
logits of the prompt's last position from the same weights and tokens,
and a side (the program, or the control) reads

* ``gap``: how far its first token's reference logit lies below the
  reference's best (0 where it is the reference's argmax);
* ``rel_err``: the relative L2 distance of its logits row from the
  reference's.

The reference also reports how near the served token's own routing lies
to a tie: its smallest router margin over the MoE layers (the k-th
largest logit less the next) and its smallest capacity slack (how far
its place in an expert's FIFO lies from the capacity, as a share of it).
Within rounding of a tie, the bf16 program may take either branch of a
discrete decision, and either is right: under ``limits["paths"]`` the
reference also computes the last position's other paths
(``reference/common.py``), and a side's reading is taken against the
path nearest its row (``paths`` counts them).

:func:`summary` reduces a side's rows to the numbers
``perfbench/limits/<cell>.json`` may compare, each a maximum over every
row, so that one wrong answer fails the run.  The control reads the same
numbers with the reference in fp8 (``reference/common.py::fp8_linear``)
put in the program's place, its first logit served: a reading the
limits must refuse.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import traffic as tr
from .window import Served

SIDES = ("program", "control")


def sample(served: Sequence[Served], n: int, seed: int) -> List[Served]:
    """``n`` of the served requests, drawn from the seed, a longest first."""
    longest = max(range(len(served)), key=lambda i: served[i].request.length)
    rest = [i for i in range(len(served)) if i != longest]
    g = tr.rng(seed, tr.SAMPLE)
    pick = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [served[longest]] + [served[rest[int(i)]] for i in sorted(pick)]


def reading(paths: torch.Tensor, logits: torch.Tensor) -> Dict[str, float]:
    """The reading of a served row against the nearest of the reference's
    paths (1 + n, V)."""
    logits = logits.float()
    err = (logits[None] - paths).norm(dim=-1) / paths.norm(dim=-1)
    i = int(err.argmin())
    return {"gap": float(paths[i].max() - paths[i][int(logits.argmax())]),
            "rel_err": float(err[i]), "path": i}


def readings(conf: Dict, ref_mod, params, chosen: Sequence[Served], device,
             rule: Dict, control: bool = False) -> List[Dict]:
    """A row for each chosen request: its ``rid`` and ``length``, the
    reference's routing of its last token (``margin``, ``slack``,
    ``dropped``: whether an assignment of it was dropped at capacity;
    ``drop_share``: the mean share of all assignments dropped), how many
    ``paths`` the reference took under ``rule``, and each side's
    reading."""
    from perfbench.reference.common import exact_fp32, fp8_linear
    rows = []
    with exact_fp32():
        for s in chosen:
            tokens = torch.from_numpy(s.request.tokens).to(device)
            stats: List[Dict] = []
            ref = ref_mod.last_logits(conf, params, tokens, stats=stats,
                                      rule=rule).float()
            row = {"rid": s.request.rid, "length": s.request.length,
                   "paths": ref.shape[0],
                   "margin": min((st["last_margin"] for st in stats),
                                 default=float("inf")),
                   "slack": min((st["last_slack"] for st in stats),
                                default=float("inf")),
                   "dropped": any(st["last_dropped"] for st in stats),
                   "drop_share": sum(st["dropped"] for st in stats)
                   / max(1, len(stats)),
                   "program": reading(ref, s.logits)}
            if control:
                row["control"] = reading(ref, ref_mod.last_logits(
                    conf, params, tokens, fp8_linear)[0])
            rows.append(row)
    return rows


def summary(rows: Sequence[Dict], side: str = "program") -> Dict[str, float]:
    """A side's numbers over every row: ``max_gap`` and ``max_rel_err``."""
    return {"max_gap": max(r[side]["gap"] for r in rows),
            "max_rel_err": max(r[side]["rel_err"] for r in rows)}


def decide(rows: Sequence[Dict], limits: Dict, side: str = "program"):
    """(every compared number within its limit, {name: {value, limit}})."""
    found = summary(rows, side)
    checks = {k: {"value": found[k], "limit": v["limit"]}
              for k, v in limits["numbers"].items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
