"""Run one cell of ``BENCHMARK.json`` once and print its result as the
last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  It exits non-zero, printing no result, where CUDA or the chips are
missing, where the program (``src/repro_torch``) is not beside it, and
where the JAX package or JAX itself was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the run must not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(code: int, msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not (ROOT / "BENCHMARK.json").is_file():
        fail(2, f"no BENCHMARK.json in {ROOT}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, f"the program is missing: no {ROOT / 'src' / 'repro_torch'}")
    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from perfbench.harness import cell, spec

    bench = spec.benchmark(ROOT)
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available():
        fail(3, "CUDA is not available")
    if torch.cuda.device_count() < chips:
        fail(3, f"the cell needs {chips} devices; "
                f"{torch.cuda.device_count()} visible")

    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, bench=bench)
    found = forbidden_modules()
    if found:
        fail(4, f"modules of JAX or of the JAX package were loaded: {found}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
