"""One run of one cell: set-up (weights on the device, the model, one
warm-up cycle of every shape the mix uses), the measured window, the
metrics, then ``correct``."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import judge, spec, traffic as tr, weights, window
from . import trace as trace_mod


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    conf: Dict                       # the configuration file
    served: List[window.Served]      # every request of the window
    traced: List[window.Served]      # the traced cycle's, after it
    window_s: float
    setup_s: float
    peak_bytes: Optional[int]
    trace: Optional[trace_mod.Trace]


@dataclasses.dataclass
class Setup:
    model: object                    # the port's model, warm
    params: Dict[str, torch.Tensor]  # its weights, as drawn
    driver: object                   # the mix's driver module
    cycles: object                   # the window's cycles of steps


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup(conf: Dict, traffic: Dict, seed: int, device,
          bench_dir: Path = spec.BENCH) -> Setup:
    """The weights drawn on ``device`` from the seed, the port's model on
    them, the mix's driver, and one warm-up cycle of every step shape."""
    from repro_torch.models import get_model
    cfg = spec.port_config(conf)
    cls = get_model(cfg)
    params = weights.draw(cls.param_table(cfg),
                          lambda n: cls.param_dtype(cfg, n),
                          int(tr.rng(seed, tr.WEIGHTS).integers(2**63)),
                          device, cfg.num_layers)
    model = cls(cfg, device, params=params)
    drv = spec.driver(traffic, bench_dir)
    window.warm(drv, model,
                next(drv.cycles(traffic, seed, cfg.vocab_size, tr.WARMUP)),
                device)
    return Setup(model, params, drv,
                 drv.cycles(traffic, seed, cfg.vocab_size, tr.WINDOW))


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench: Optional[Dict] = None,
        conf: Optional[Dict] = None, traffic: Optional[Dict] = None,
        limits: Optional[Dict] = None, bench_dir: Path = spec.BENCH) -> Dict:
    """Run ``cell_name`` once and return its result line's fields
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and,
    traced, ``breakdown``; ``checks`` last).  The parts default to the
    files the cell names; a test passes smaller ones."""
    bench = bench if bench is not None else spec.benchmark(bench_dir.parent)
    cell = spec.workload(bench, cell_name)
    conf = conf if conf is not None else spec.part("configs", cell["config"],
                                                   bench_dir)
    traffic = traffic if traffic is not None else \
        spec.part("traffic", cell["traffic"], bench_dir)
    limits = limits if limits is not None else \
        spec.part("limits", cell_name, bench_dir)
    cuda = torch.device(device).type == "cuda"

    su = setup(conf, traffic, seed, device, bench_dir)
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s")

    served, window_s = window.run(su.driver, su.model, su.cycles, seconds,
                                  device)
    peak = max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count())) if cuda else None
    _log(f"window {window_s:.3f} s, {len(served)} requests")
    tr_read, in_trace = None, []
    if trace:
        in_trace, prof, length = window.traced(su.driver, su.model,
                                               next(su.cycles), device)
        tr_read = trace_mod.read(prof, length)
        del prof
    failed = sum(1 for s in served
                 if not bool(torch.isfinite(s.logits.float()).all()))

    ctx = Context(conf, served, in_trace, window_s, setup_s, peak, tr_read)
    out_metrics = {}
    for m in spec.metrics(bench, cell, trace):
        value = spec.reader(m["name"], bench_dir).read(ctx)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- correct: the program's state freed, its answers kept --------------
    params = su.params
    del su
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = judge.readings(conf, spec.reference(conf), params,
                          judge.sample(served, limits["sample"], seed),
                          device, limits.get("paths"))
    for r in rows:
        _log("reference: " + ", ".join(
            f"{k} {v}" for k, v in r.items()))
    _log(f"reference {time.perf_counter() - t0:.3f} s")
    correct, checks = judge.decide(rows, limits)
    correct = correct and failed == 0

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(served), "failed": failed,
              "metrics": out_metrics, "device": dev}
    if tr_read is not None:
        dev["busy_s"] = tr_read.busy_s()
        dev["window_s"] = tr_read.window_s
        result["breakdown"] = trace_mod.breakdown(tr_read)
    if rows and "drop_share" in rows[0]:
        result["routing"] = {
            "drop_share": sum(r["drop_share"] for r in rows) / len(rows),
            "last_token_dropped": sum(r["dropped"] for r in rows),
            "paths": sum(r["paths"] for r in rows)}
    result["checks"] = checks
    return result
