"""Multi-pod dry run: build and run every (architecture x input shape)
cell on a dry production mesh, one rank's share on the ``meta`` device,
and extract its memory and roofline terms (the port's counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell over 512 placeholder host
devices.  The port needs no devices: a dry mesh (``comm.Mesh.dry``)
holds one rank's coordinates of the 16x16 or 2x16x16 mesh, every
collective on it returns an empty output of the right shape, and the
step runs on ``meta`` tensors, so nothing is allocated or computed.  It
sets no ``XLA_FLAGS`` and imports no JAX.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod --no-cost
Outputs one JSON per cell under experiments/dryrun_torch/<mesh>/, with
the reference's keys: ``memory`` is null (there is no compiled artifact
to analyse) and ``build_s``/``run_s`` stand where ``lower_s``/
``compile_s`` stand.  The exit code is 1 if any cell failed.
"""
import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import costing
from repro_torch.launch import roofline as rl
from repro_torch.launch import step as step_mod
from repro_torch.launch.mesh import make_production_mesh

OUT_ROOT = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def run_cell(arch: str, shape_name: str, mesh_name: str,
             strategy: str = "baseline", verbose: bool = True,
             with_cost: bool = True, rank: int = 0,
             **rule_overrides) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = step_mod.cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                dry=True, rank=rank)
    chips = mesh.size
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "strategy": strategy, "chips": chips, "rank": rank}
    try:
        cell = step_mod.build_cell(cfg, shape, mesh, strategy,
                                   **rule_overrides)
        t1 = time.time()
        if with_cost:
            got = costing.count_cost(cell.run)
        else:
            cell.run()
        t2 = time.time()
        rec.update(
            status="ok", build_s=round(t1 - t0, 2), run_s=round(t2 - t1, 2),
            memory=None,
            memory_analytic=costing.analytic_memory(cfg, shape, cell.rules,
                                                    chips))
        if with_cost:
            rep = rl.roofline(cfg, shape, mesh_name, chips, got.cost,
                              got.collectives)
            rec.update(cost=got.cost, roofline=rep.to_json())
            if verbose:
                print(rep.summary(), flush=True)
        elif verbose:
            print(f"{arch:>22s} {shape_name:<12s} {mesh_name:<9s} "
                  f"ran on meta in {t2 - t1:.1f}s", flush=True)
        if verbose:
            print(f"  per-device bytes (analytic): "
                  f"{rec['memory_analytic']['total']:.3e}", flush=True)
    except Exception as e:  # a failure here is a bug in the port's sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"{arch:>22s} {shape_name:<12s} {mesh_name:<9s} "
                  f"FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod"), default="pod")
    ap.add_argument("--strategy", default="baseline")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh whose share is costed")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="run and memory model only (the multipod pass)")
    ap.add_argument("--tag", default="",
                    help="suffix for the output dir (variants)")
    args = ap.parse_args()

    outdir = OUT_ROOT / (args.mesh + (f"-{args.tag}" if args.tag else ""))
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    n_ok = n_skip = n_err = 0
    for arch, shape in cells:
        path = outdir / f"{arch}__{shape}.json"
        if args.skip_existing and path.exists():
            rec = json.loads(path.read_text())
            if rec.get("status") == "ok":
                n_ok += 1
                continue
        rec = run_cell(arch, shape, args.mesh, args.strategy,
                       with_cost=not args.no_cost, rank=args.rank)
        path.write_text(json.dumps(rec, indent=1))
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skipped"
        n_err += rec["status"] == "error"
    print(f"\ndry-run [{args.mesh}]: {n_ok} ok, {n_skip} skipped, "
          f"{n_err} failed", flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
