"""Quickstart on the PyTorch port: the unified mesh API (facade + traffic-
pattern library), the counterpart of ``examples/netsim_traffic.py``.

Runs every synthetic traffic pattern through the torch backend of the
:class:`repro_torch.mesh.Simulator` facade (default: Celerity scale,
16x32 = 512 cores; on the card every cycle goes through the Hopper router
kernel), checks one pattern's telemetry bit-for-bit between the torch and
numpy backends on a small mesh, and sweeps the credit allowance as one
lane-batched run: one state of 7 lanes, one credit allowance a lane
(``init_state(cfg, max_credits=<(7,) tensor>)``).

  PYTHONPATH=src python examples/torch_netsim_traffic.py
  PYTHONPATH=src python examples/torch_netsim_traffic.py --nx 4 --ny 4 \\
      --cycles 200 --device cpu

Runs on the card unless ``--device cpu`` is given; with no card it raises.
"""
import argparse
import time

import torch

from repro_torch.mesh import MeshConfig, PATTERNS, Simulator, make_traffic
from repro_torch.netsim import (init_state, load_program, simulate,
                                stack_programs)


def pattern_sweep(nx: int, ny: int, cycles: int, device=None) -> dict:
    """{pattern: accepted ops/cycle after the first third}."""
    cfg = MeshConfig(nx=nx, ny=ny, max_out_credits=32)
    print(f"== traffic patterns on the {nx}x{ny} ({nx * ny}-core) array ==")
    out = {}
    for name in sorted(PATTERNS):
        try:
            entries = make_traffic(name, nx, ny, cycles, seed=0)
        except ValueError as e:        # e.g. transpose on a non-square mesh
            print(f"  {name:16s} skipped ({e})")
            continue
        sim = Simulator(cfg, device=device).attach(entries)
        t0 = time.perf_counter()
        sim.run(cycles)
        thr = sim.telemetry().throughput(warmup=cycles // 3)
        print(f"  {name:16s} {thr:8.2f} ops/cycle   "
              f"({time.perf_counter() - t0:.2f}s wall)")
        out[name] = thr
    return out


def backend_parity_check(nx: int = 4, ny: int = 4, device=None) -> int:
    """Same program, both backends, one facade: telemetry bit-identical.
    Returns the drain cycle."""
    cfg = MeshConfig(nx=nx, ny=ny)
    entries = make_traffic("uniform", nx, ny, 8, rate=0.5, seed=1)
    oracle = Simulator(cfg, backend="numpy").attach(
        {k: v.copy() for k, v in entries.items()})
    fast = Simulator(cfg, device=device).attach(entries)
    c0, c1 = oracle.run_until_drained(), fast.run_until_drained()
    assert c0 == c1
    oracle.telemetry().assert_bit_identical(fast.telemetry())
    print(f"== backend parity == drain cycle {c0}, telemetry bit-identical")
    return c0


def credit_program(hops: int, cycles: int) -> dict:
    """One long-haul store stream from tile (0, 0) to (hops, 0)."""
    entries = make_traffic("neighbor", hops + 1, 1, cycles + 200)
    entries["op"][:] = -1
    entries["op"][0, 0, :] = 1
    entries["dst_x"][0, 0, :] = hops
    return entries


def credit_sweep(hops: int = 8, cycles: int = 400, device=None):
    """One lane-batched run: the same program in 7 lanes of one state,
    each lane its own credit allowance.  Returns (credits, throughput per
    lane)."""
    nx = hops + 1
    cfg = MeshConfig(nx=nx, ny=1, max_out_credits=64,
                     router_fifo=32).to_sim()
    rtt = 2 * hops + 5
    credits = torch.tensor([1, 2, 4, 8, 16, rtt, 32])
    prog = load_program(credit_program(hops, cycles), device=device)
    state = init_state(cfg, max_credits=credits, device=device)
    _, per = simulate(cfg, stack_programs([prog] * len(credits)), state,
                      cycles)
    per = per.cpu().numpy()
    print(f"== credit sweep (one run, {len(credits)} lanes; "
          f"RTT = {rtt} cycles) ==")
    thr = [float(row[cycles // 4:].mean()) for row in per]
    for c, t in zip(credits, thr):
        print(f"  credits={int(c):3d}  throughput={t:.3f} stores/cycle")
    return credits.tolist(), thr


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--cycles", type=int, default=800)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    return {"patterns": pattern_sweep(args.nx, args.ny, args.cycles,
                                      args.device),
            "parity_drain": backend_parity_check(device=args.device),
            "credits": credit_sweep(device=args.device)}


if __name__ == "__main__":
    main()
