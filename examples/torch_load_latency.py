"""Reproduce the load–latency saturation-curve figure for the mesh NoC on the
PyTorch port (the counterpart of ``examples/load_latency.py``).

Runs the phased warmup -> measurement-window -> drain methodology over a
grid of offered loads for each traffic pattern, every load one lane of a
single batched run per pattern (on the card, through the Hopper router
kernel), prints the curves as an ASCII figure and writes the raw data to
``experiments/torch_load_latency.json``, in the reference's record shape.

  PYTHONPATH=src python examples/torch_load_latency.py
  PYTHONPATH=src python examples/torch_load_latency.py --nx 8 --ny 8 \\
      --patterns uniform transpose --measure 500 --device cpu

Runs on the card unless ``--device cpu`` is given; with no card it raises.
"""
import argparse
import json
from pathlib import Path

from repro_torch.mesh import PATTERNS, Simulator, make_traffic
from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES, ascii_curve,
                                        curve_record, load_latency_sweep,
                                        sweep_config)

DEFAULT_OUT = (Path(__file__).resolve().parents[1] / "experiments"
               / "torch_load_latency.json")


def saturation_heatmap(pattern: str, cfg, rate: float,
                       cycles: int = 400, seed: int = 0) -> str:
    """Link-utilization heatmap at one offered load: rerun the pattern for
    a fixed window on the numpy oracle and render the telemetry."""
    sim = Simulator(cfg, backend="numpy")
    length = int(rate * cycles) + 1
    sim.attach(make_traffic(pattern, cfg.nx, cfg.ny, length,
                            rate=rate, seed=seed))
    sim.run(cycles)
    return sim.telemetry().heatmap_str(
        "fwd", title=f"    link utilization at rate {rate:.2f} "
                     f"(fwd network, {cycles} cycles):")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--patterns", nargs="+", default=sorted(PATTERNS),
                    choices=sorted(PATTERNS))
    ap.add_argument("--rates", nargs="+", type=float,
                    default=list(DEFAULT_SWEEP_RATES))
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--measure", type=int, default=500)
    ap.add_argument("--drain", type=int, default=500)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)

    cfg = sweep_config(args.nx, args.ny)
    results = {}
    print(f"== load–latency curves, {args.nx}x{args.ny} mesh "
          f"(warmup {args.warmup} / measure {args.measure} / "
          f"drain {args.drain} cycles) ==")
    for name in args.patterns:
        try:
            out = load_latency_sweep(name, args.nx, args.ny, args.rates,
                                     warmup=args.warmup,
                                     measure=args.measure,
                                     drain=args.drain, cfg=cfg, seed=0,
                                     device=args.device)
        except ValueError as e:        # e.g. transpose on a non-square mesh
            print(f"\n  {name}: skipped ({e})")
            continue
        sat = out["saturation_index"]
        print(f"\n  {name}: zero-load {out['zero_load_latency']:.1f} cycles, "
              f"saturation rate {out['saturation_rate']}, peak accepted "
              f"{out['saturation_throughput']:.3f} pkts/cycle/tile")
        print("    rate  | mean round-trip latency (log scale, cycles)")
        print(ascii_curve(out["rates"], out["lat_mean"], sat))
        # where the congestion lives: per-link heatmap at the knee (or the
        # highest swept load if the pattern never saturated)
        hm_rate = out["saturation_rate"] if sat is not None \
            else float(out["rates"][-1])
        print(saturation_heatmap(name, cfg, hm_rate,
                                 cycles=args.measure, seed=0))
        results[name] = curve_record(out)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    # the reference's record shape (and per-curve schema, via curve_record)
    record = {"name": "load_latency_curves", "mesh": f"{args.nx}x{args.ny}",
              "curves": results}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"\nwrote {args.out}")
    return record


if __name__ == "__main__":
    main()
