"""Attach user designs to the mesh on the PyTorch port — the paper's
integration story (the counterpart of ``examples/mesh_endpoints.py``).

Two *reactive* user designs plug into the array through the
:class:`repro_torch.mesh.Endpoint` protocol:

* a **remote-store DMA engine** streaming a buffer into a far tile's
  memory with a bounded outstanding-store window, and
* a **request/reply memory-controller client** pointer-chasing a linked
  ring seeded in the controller tile's memory — each request depends on
  the previous reply, so the traffic cannot be precomputed.

Both run natively on the numpy backend and, on the torch backend, through
the trace-to-program bridge: the oracle calls the endpoints and records
every injection, and the traced program replays through the router
kernel on the card — with bit-identical telemetry, which this script
asserts.

  PYTHONPATH=src python examples/torch_mesh_endpoints.py
  PYTHONPATH=src python examples/torch_mesh_endpoints.py --nx 4 --ny 4 \\
      --device cpu

Runs on the card unless ``--device cpu`` is given; with no card it raises.
"""
import argparse

import numpy as np

from repro_torch.mesh import (DmaEndpoint, MemoryControllerEndpoint,
                              MeshConfig, Simulator)

BACKENDS = ("numpy", "torch")


def build(cfg: MeshConfig, backend: str, device=None) -> Simulator:
    """One scenario, constructible on either backend: endpoints are
    stateful, so each backend gets fresh instances."""
    nx, ny, mw = cfg.nx, cfg.ny, cfg.mem_words
    on = {"device": device} if backend == "torch" else {}
    sim = Simulator(cfg, backend=backend, **on)

    # seed a pointer ring in the memory-controller tile (far corner):
    # mem[a] = (a + 3) % mw, so the chase hops addresses 5, 8, 11, ...
    mem = np.zeros((ny, nx, mw), np.int64)
    mem[ny - 1, nx - 1, :] = (np.arange(mw) + 3) % mw
    sim.set_mem(mem)

    sim.attach(DmaEndpoint(dst_x=nx - 1, dst_y=0,
                           data=[100 + i for i in range(12)],
                           max_inflight=4), at=(0, 0))
    sim.attach(MemoryControllerEndpoint(dst_x=nx - 1, dst_y=ny - 1,
                                        start_addr=5, n_requests=8,
                                        mem_words=mw), at=(0, ny - 1))
    return sim


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--ny", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    cfg = MeshConfig(nx=args.nx, ny=args.ny, mem_words=32)

    print(f"== reactive endpoints on the {cfg.nx}x{cfg.ny} mesh ==")
    sims, cycles = {}, {}
    for backend in BACKENDS:
        sim = build(cfg, backend, args.device)
        cycles[backend] = sim.run_until_drained()
        sims[backend] = sim
        print(f"  [{backend:5s}] drained at cycle {cycles[backend]}")

    # the facade contract: one Telemetry record, bit-identical across
    # backends — including for endpoint-driven (bridged) scenarios
    t_np = sims["numpy"].telemetry()
    t_torch = sims["torch"].telemetry()
    t_np.assert_bit_identical(t_torch)
    assert cycles["numpy"] == cycles["torch"]
    assert np.array_equal(np.asarray(sims["numpy"].mem),
                          np.asarray(sims["torch"].mem))
    print("  telemetry bit-identical across backends")

    dma = sims["numpy"].endpoints[(0, 0)]
    landed = np.asarray(sims["numpy"].mem)[0, cfg.nx - 1, :12]
    print(f"\n  DMA: {dma.sent} stores sent, {dma.acked} acked, "
          f"peak window {dma.peak_inflight}")
    print(f"       destination memory now {landed.tolist()}")

    mc = sims["numpy"].endpoints[(0, cfg.ny - 1)]
    print(f"\n  memory-controller client: chased {mc.visited} "
          f"({len(mc.latencies)} replies, "
          f"round-trip {min(mc.latencies)}..{max(mc.latencies)} cycles)")

    # endpoint scenarios still export as injection programs -> lane fodder
    prog = sims["numpy"].injection_trace_program()
    n = int((prog["op"] >= 0).sum())
    print(f"\n  exported injection-trace program: {n} packets, "
          f"replayable as lanes of a batched run on the card")
    return {"cycle": cycles["numpy"], "telemetry": t_torch,
            "mem": np.asarray(sims["torch"].mem),
            "dma": (dma.sent, dma.acked, dma.peak_inflight),
            "chaser": (list(mc.visited), list(mc.latencies)),
            "packets": n}


if __name__ == "__main__":
    main()
