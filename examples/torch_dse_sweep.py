"""Design-space exploration walkthrough on the PyTorch port: sweep the
router buffer sizing and print the Pareto frontier of buffer area vs.
saturation throughput (the counterpart of ``examples/dse_sweep.py``).

Declares a :class:`repro_torch.dse.SweepSpec` over fifo depth x credit
allowance x offered load x topology, runs it through the bucketed,
batched service (each bucket's points the lanes of one batched run on the
card, through the Hopper router kernel), extracts per-topology frontiers
priced by the lumos-style cost model, and writes the JSON artifact.
Results cache on disk — re-running with the same spec (or re-pricing
with different --sram-um2-per-bit) simulates nothing.

  PYTHONPATH=src python examples/torch_dse_sweep.py
  PYTHONPATH=src python examples/torch_dse_sweep.py --nx 8 --ny 8 \\
      --topologies mesh torus --devices 2

Runs on the card unless ``--device cpu`` is given; with no card it raises.
``--devices N`` fans the buckets out over N cards.
"""
import argparse
from pathlib import Path

from repro_torch.dse import (CostModel, SweepSpec, frontier_artifact,
                             frontier_ascii, run_sweep, write_frontier)
from repro_torch.mesh.traffic import PATTERNS

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4)
    ap.add_argument("--ny", type=int, default=4)
    ap.add_argument("--fifo-depths", nargs="+", type=int,
                    default=[2, 4, 8])
    ap.add_argument("--credits", nargs="+", type=int, default=[4, 16, 64])
    ap.add_argument("--pattern", default="uniform",
                    choices=sorted(PATTERNS))
    ap.add_argument("--loads", nargs="+", type=float,
                    default=[0.05, 0.15, 0.25, 0.35, 0.45])
    ap.add_argument("--topologies", nargs="+",
                    default=["mesh", "torus"],
                    help='e.g. mesh torus ring_mesh multi_chip:2:4')
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--measure", type=int, default=200)
    ap.add_argument("--drain", type=int, default=200)
    ap.add_argument("--devices", type=int, default=None,
                    help="fan the buckets out over N cards (default: one)")
    ap.add_argument("--cache", type=Path,
                    default=ROOT / "experiments" / "torch_dse_cache",
                    help="result-cache directory (resumable re-runs)")
    ap.add_argument("--sram-um2-per-bit", type=float, default=0.525,
                    help="cost-model knob: SRAM cell area per bit")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "experiments" / "torch_dse_example.json")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)

    spec = SweepSpec(nx=args.nx, ny=args.ny,
                     fifo_depths=tuple(args.fifo_depths),
                     credits=tuple(args.credits),
                     patterns=(args.pattern,), loads=tuple(args.loads),
                     topologies=tuple(args.topologies),
                     warmup=args.warmup, measure=args.measure,
                     drain=args.drain, name="example")
    result = run_sweep(spec, cache_dir=args.cache, devices=args.devices,
                       progress=print, device=args.device)
    print(f"\n{result.n_points} points: {result.simulated} simulated, "
          f"{result.cache_hits} from cache, {result.buckets} bucket(s), "
          f"{result.compiles} compile(s), {result.wall_s}s")

    cost = CostModel(sram_um2_per_bit=args.sram_um2_per_bit)
    artifact = frontier_artifact(result, cost=cost)
    print()
    print(frontier_ascii(artifact))
    for topo, f in artifact["frontiers"].items():
        print(f"\n  {topo} frontier (monotone={f['monotone']}):")
        for p in f["frontier"]:
            print(f"    fifo={p['fifo_depth']:3d} credits={p['credits']:4d}"
                  f"  area={p['area_mm2']:.4f} mm^2"
                  f"  sat-throughput={p['throughput']:.3f}"
                  f"  knee={p['saturation_rate']}"
                  f"  {p['energy_pj_per_packet']:.1f} pJ/pkt")
    path = write_frontier(args.out, artifact)
    print(f"\nwrote {path}")
    return artifact


if __name__ == "__main__":
    main()
