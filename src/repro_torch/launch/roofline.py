"""Roofline analysis of a dry run (the port's counterpart of
``repro.launch.roofline``; no card needed).

Three terms per (arch x shape x mesh), in seconds:

* compute    = FLOPs per device / peak FLOP/s
* memory     = bytes accessed per device / HBM bandwidth
* collective = collective operand bytes per device / link bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and its
collectives from the post-optimisation HLO text (``parse_collectives``).
The port has neither: ``launch/costing.py`` counts FLOPs and bytes on a
dry mesh's ``meta`` run, and :func:`collectives_from_records` turns the
dry mesh's record of each collective call (``parallel.comm.listing_calls``:
op, dtype, operand bytes, group size) into the reference's dict, keyed
by its op names, with the same ring wire model.

Hardware constants: NVIDIA H100 SXM (``launch/mesh.py::HW``).  MODEL_FLOPS
is the reference's: 6·N·D for train (2·N·D forward-only for
prefill/decode), N = active params for MoE; the ratio MODEL_FLOPS /
counted FLOPs exposes remat and redundancy.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
from pathlib import Path
from typing import Dict, Iterable, Mapping

from .mesh import HW

__all__ = ["collectives_from_records", "roofline", "RooflineReport",
           "model_flops", "DTYPE_BYTES", "NETWORK_MODES",
           "default_congestion_model", "markdown_table", "COLLECTIVE_NAMES"]

# collective-term pricing: "analytic" divides wire bytes by the nominal
# link bandwidth; "netsim" prices them with cycles measured on the
# cycle-level mesh simulator (a fitted repro_torch.workloads.CongestionModel)
NETWORK_MODES = ("analytic", "netsim")

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

# ``comm``'s counted op -> the reference's HLO op name; a backward
# (``<op>.bwd``) is its forward's transpose and goes under that op's name
COLLECTIVE_NAMES = {
    "all_gather": "all-gather", "all_gather.bwd": "reduce-scatter",
    "reduce_scatter": "reduce-scatter", "reduce_scatter.bwd": "all-gather",
    "all_reduce_sum": "all-reduce", "all_reduce_sum.bwd": "all-reduce",
    "all_reduce_max": "all-reduce",
    "all_to_all": "all-to-all", "all_to_all.bwd": "all-to-all",
    "ppermute": "collective-permute", "ppermute.bwd": "collective-permute",
}


def _wire(op: str, obytes: float, g: int) -> float:
    """Ring-schedule bytes crossing links per device for one call of HLO
    op ``op`` on ``obytes`` operand bytes over a group of ``g`` (the
    reference's ``parse_collectives`` formulas)."""
    g = max(g, 1)
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * obytes
    if op == "all-gather":
        return (g - 1) / g * (obytes * g)      # of the result
    if op in ("reduce-scatter", "all-to-all"):
        return (g - 1) / g * obytes
    return obytes                              # collective-permute: one hop


def collectives_from_records(calls: Iterable[Mapping]
                             ) -> Dict[str, Dict[str, float]]:
    """Per-op-type {'bytes': operand bytes per device, 'count': n,
    'wire_bytes': ring estimate} of a rank's collective calls
    (``comm.listing_calls()``: each with ``op``, ``bytes``, ``group``),
    keyed by the reference's HLO op names (:data:`COLLECTIVE_NAMES`)."""
    out: Dict[str, Dict[str, float]] = {}
    for c in calls:
        op = COLLECTIVE_NAMES[c["op"]]
        d = out.setdefault(op, {"bytes": 0.0, "count": 0, "wire_bytes": 0.0})
        d["bytes"] += float(c["bytes"])
        d["count"] += 1
        d["wire_bytes"] += _wire(op, float(c["bytes"]), int(c["group"]))
    return out


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params for MoE."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per sequence


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float          # counted 'bytes accessed'
    bytes_adj_per_device: float      # 'bytes adjusted' (= raw in the port)
    coll_bytes_per_device: float
    coll_wire_bytes_per_device: float
    coll_detail: Dict[str, Dict[str, float]]
    compute_s: float
    memory_s: float                  # raw
    memory_adj_s: float              # from 'bytes adjusted'
    collective_s: float
    bottleneck: str                  # argmax(compute, memory_adj, collective)
    model_flops: float
    useful_ratio: float
    peak_step_s: float
    roofline_frac: float             # compute_s / peak_step_s
    network: str = "analytic"        # how collective_s was priced

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"{self.arch:>22s} {self.shape:<12s} {self.mesh:<9s} "
                f"compute {self.compute_s:9.3e}s  mem(adj) {self.memory_adj_s:9.3e}s  "
                f"coll {self.collective_s:9.3e}s  -> {self.bottleneck:<10s} "
                f"roofline {self.roofline_frac:5.1%} useful {self.useful_ratio:6.1%}")


@functools.lru_cache(maxsize=None)
def default_congestion_model(nx: int = 8, ny: int = 8):
    """The congestion model ``network="netsim"`` falls back to when the
    caller does not supply one: the standard calibration battery on an
    ``nx x ny`` mesh, the port's numpy oracle, cached per mesh size
    (calibration runs the simulator, so it costs seconds the first
    time)."""
    from repro_torch.workloads import calibrate
    return calibrate(nx, ny, backend="numpy")


def roofline(cfg, shape, mesh_name: str, chips: int,
             cost: Dict[str, float], colls, *,
             network: str = "analytic",
             congestion=None) -> RooflineReport:
    """``colls``: a collectives dict (:func:`collectives_from_records`'
    schema).

    ``network="netsim"`` replaces the analytic collective term
    (bytes / nominal link bandwidth) with cycles from a
    :class:`repro_torch.workloads.CongestionModel` — pass one as
    ``congestion`` or the cached :func:`default_congestion_model` is fit
    on first use.  Each ``coll_detail`` entry then also carries
    ``sim_cycles`` / ``sim_s`` / ``family``.
    """
    if network not in NETWORK_MODES:
        raise ValueError(f"network must be one of {NETWORK_MODES}, "
                         f"got {network!r}")
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    bytes_adj = float(cost.get("bytes adjusted", bytes_dev))
    coll_dev = sum(d["bytes"] for d in colls.values())
    wire_dev = sum(d["wire_bytes"] for d in colls.values())

    compute_s = flops_dev / HW.PEAK_FLOPS_BF16
    memory_s = bytes_dev / HW.HBM_BW
    memory_adj_s = bytes_adj / HW.HBM_BW
    if network == "netsim":
        if congestion is None:
            congestion = default_congestion_model()
        sim = congestion.collective_times(colls)
        colls = {op: {**d, **sim.get(op, {})} for op, d in colls.items()}
        collective_s = sum(d["sim_s"] for d in sim.values())
    else:
        collective_s = coll_dev / HW.ICI_BW
    terms = {"compute": compute_s, "memory": memory_adj_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total_flops = flops_dev * chips
    peak = max(terms.values())
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        bytes_adj_per_device=bytes_adj,
        coll_bytes_per_device=coll_dev, coll_wire_bytes_per_device=wire_dev,
        coll_detail=colls,
        compute_s=compute_s, memory_s=memory_s, memory_adj_s=memory_adj_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=mf,
        useful_ratio=(mf / total_flops) if total_flops else 0.0,
        peak_step_s=peak,
        roofline_frac=(compute_s / peak) if peak else 0.0,
        network=network,
    )


# ---------------------------------------------------------------------------
# markdown table from the dry-run JSON directory
# ---------------------------------------------------------------------------

def _advice(rec: dict) -> str:
    """One sentence: what would move the dominant term down."""
    rl = rec["roofline"]
    b = rl["bottleneck"]
    colls = rl.get("coll_detail", {})
    ag = colls.get("all-gather", {}).get("bytes", 0)
    ar = colls.get("all-reduce", {}).get("bytes", 0)
    a2a = colls.get("all-to-all", {}).get("bytes", 0)
    kind = rec["shape"].split("_")[0]
    if b == "collective":
        if a2a > max(ag, ar):
            return ("shrink a2a payload: bf16 wire format + lower MoE "
                    "capacity factor")
        if ag >= ar:
            return ("TP act all-gathers dominate: overlap with matmuls, "
                    "bf16 boundaries, or trade TP for more DP/EP")
        return ("all-reduce bound: 2D-shard params (ZeRO-2/3 style) so "
                "grads reduce-scatter instead of all-reduce")
    if b == "memory":
        if kind in ("decode", "long"):
            return ("decode reads weights+KV once per token: quantize KV "
                    "to int8 / batch more sequences per step")
        return ("HBM-bound: fuse elementwise chains (Pallas), keep "
                "activations bf16, selective remat instead of full")
    return "compute-bound: already at the roof; raise per-chip batch"


def markdown_table(json_dir: Path) -> str:
    rows = []
    for f in sorted(Path(json_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") == "ok" and "roofline" in rec:
            rl = rec["roofline"]
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rl['compute_s']:.3e} "
                f"| {rl['memory_adj_s']:.3e} | {rl['memory_s']:.3e} "
                f"| {rl['collective_s']:.3e} | **{rl['bottleneck']}** "
                f"| {rl['model_flops']:.2e} | {rl['useful_ratio']:.1%} "
                f"| {rl['roofline_frac']:.1%} | {_advice(rec)} |")
        elif rec.get("status") == "skipped":
            rows.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | — "
                        f"| skipped | — | — | — | {rec['reason'][:60]} |")
    head = ("| arch | shape | compute (s) | memory adj (s) | memory raw (s) "
            "| collective (s) | bottleneck | MODEL_FLOPS | useful | roofline "
            "| what would move the dominant term |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch/pod")
    args = ap.parse_args()
    print(markdown_table(Path(args.dir)))


if __name__ == "__main__":
    main()
