"""The readings a cell's limits are set from, on the chip at the cell's
own sizes: for each seed, a run's set-up (``cell.setup``), one cycle of
the cell's mix served by the program, and the judge's rows
(``judge.readings``) for a sample drawn as a run draws it, with the
control (the reference in fp8 in the program's place) on the first
``--control`` seeds.  All seeds in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ...

One JSON line per seed: the rows, and each side's ``judge.summary``.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=4)
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from perfbench.harness import cell, judge, spec, window

    cell_ = spec.workload(spec.benchmark(ROOT), args.workload)
    conf = spec.part("configs", cell_["config"])
    traffic = spec.part("traffic", cell_["traffic"])
    limits = spec.part("limits", args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        su = cell.setup(conf, traffic, seed, "cuda")
        served, cycle_s = window.run(su.driver, su.model, su.cycles, 0.0,
                                     "cuda")
        params = su.params
        del su
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rows = judge.readings(conf, spec.reference(conf), params,
                              judge.sample(served, limits["sample"], seed),
                              "cuda", limits.get("paths"),
                              control=i < args.control)
        line = {"seed": seed, "cycle_s": cycle_s,
                "reference_s": time.perf_counter() - t1,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "rows": rows}
        for side in judge.SIDES:
            if side in rows[0]:
                line[side] = judge.summary(rows, side)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del params, served
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
