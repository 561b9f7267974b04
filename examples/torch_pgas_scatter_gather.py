"""PGAS example on the PyTorch port: remote scatter/gather + a CAS mutex
over a mesh of 8 ranks (the counterpart of
``examples/pgas_scatter_gather.py``).

The paper's core programming model — every tile owns a memory region in
one global <X, Y, local> address space — exercised directly on a 2x4
mesh of ranks (``repro_torch.launch.mesh.spawn``, gloo; on the card the 8
ranks share it): a random scatter (remote stores), a gather-back (remote
loads), and a distributed mutex built on remote compare-and-swap.

The same scatter is ALSO compiled to cycle-level mesh traffic
(``repro_torch.workloads.pgas_from_batches``) and replayed packet by
packet on the numpy oracle; the example asserts the simulator's end-state
memory matches the ranks' ``remote_store`` result word for word.

  PYTHONPATH=src python examples/torch_pgas_scatter_gather.py
  PYTHONPATH=src python examples/torch_pgas_scatter_gather.py --device cpu

Runs on the card unless ``--device cpu`` is given; with no card it raises.
"""
import argparse

import numpy as np
import torch

NY, NX = 2, 4
T = NY * NX
WORDS = 32
SLOTS = 4


def pgas_rank(rank, device):
    """One tile's island on the (y 2, x 4) mesh: (memory after the CAS,
    memory after the scatter, store credits, gather sum, fence ok, CAS
    winners), numpy."""
    from repro_torch.core import pgas
    from repro_torch.launch.mesh import make_test_mesh, rank_device
    from repro_torch.parallel import comm
    device = rank_device(device)
    mesh = make_test_mesh((NY, NX), ("y", "x"), device)
    mem = torch.zeros(WORDS, device=device)      # the local region
    me = pgas.tile_linear_index(mesh, "x", "y")

    # --- random scatter: each tile stores me*100+s to tile (me+s+1)%T ----
    pkts = pgas.make_packet_batch(T, SLOTS, device=device)
    for s in range(SLOTS):
        dst = (me + s + 1) % T
        pkts.addr[dst, s] = s
        pkts.data[dst, s] = me * 100.0 + s
        pkts.mask[dst, s] = True
    mem, credits = pgas.remote_store(mem, pkts, mesh, "x", "y")
    fence_ok = bool(credits.sum() == SLOTS)      # all stores committed
    scatter_mem = mem.clone()                    # snapshot before the CAS

    # --- gather back: read word s of tile (me+s+1)%T ---------------------
    lpk = pgas.make_packet_batch(T, SLOTS, device=device)
    for s in range(SLOTS):
        dst = (me + s + 1) % T
        lpk.addr[dst, s] = s
        lpk.mask[dst, s] = True
    data, valid = pgas.remote_load(mem, lpk, mesh, "x", "y")
    got = float(torch.where(valid, data, 0.0).sum())

    # --- CAS mutex at tile 0, word 0: exactly one winner -----------------
    mask = torch.zeros((T, 1), dtype=torch.bool, device=device)
    mask[0, 0] = True
    cpk = pgas.PacketBatch(
        addr=torch.zeros((T, 1), dtype=torch.int32, device=device),
        data=torch.full((T, 1), float(me + 1), device=device), mask=mask)
    mem[0] = 0.0                                 # unlock
    mem, old = pgas.remote_cas(mem, cpk, torch.zeros((T, 1), device=device),
                               mesh, "x", "y")
    i_won = (old[0, 0] == 0.0).to(torch.int32)
    winners = int(comm.all_reduce(i_won, mesh, ("y", "x")))
    return (mem.cpu().numpy(), scatter_mem.cpu().numpy(),
            credits.cpu().numpy(), got, fence_ok, winners)


def scatter_batches():
    """The global (T_src, T_dst, S) view of the islands' store batches:
    source t stores t*100+s to word s of tile (t+s+1)%T."""
    addr = np.zeros((T, T, SLOTS), np.int64)
    data = np.zeros((T, T, SLOTS), np.int64)
    mask = np.zeros((T, T, SLOTS), bool)
    for t in range(T):
        for s in range(SLOTS):
            dst = (t + s + 1) % T
            addr[t, dst, s] = s
            data[t, dst, s] = t * 100 + s
            mask[t, dst, s] = True
    return addr, data, mask


def report(results) -> dict:
    """Print the ranks' results, assert the reference's checks, and replay
    the scatter packet by packet on the numpy oracle."""
    from repro_torch.mesh import MeshConfig, Simulator
    from repro_torch.workloads import expected_memory, pgas_from_batches
    mem = np.stack([r[0] for r in results])
    scatter_mem = np.stack([r[1] for r in results])
    credits = np.stack([r[2] for r in results])
    got = [r[3] for r in results]
    fence = all(r[4] for r in results)
    winners = results[0][5]
    print("memory regions after scatter (tile, first 4 words):")
    for t in range(T):
        print(f"  tile {t}: {mem[t, :SLOTS]}")
    print("store credits per tile:", credits.tolist())
    print("fence ok (credits == issued):", fence)
    print("gather sums per tile:", np.round(got, 1).tolist())
    print("CAS mutex winners (must be 1):", winners)
    assert fence
    assert winners == 1 and all(r[5] == 1 for r in results)

    # --- the same scatter, packet by packet through the mesh ------------
    addr, data, mask = scatter_batches()
    w = pgas_from_batches(addr, data, mask, NX, NY, mem_words=WORDS)
    sim = Simulator(MeshConfig(nx=NX, ny=NY, mem_words=WORDS),
                    backend="numpy")
    sim.attach({k: v.copy() for k, v in w.program.items()})
    drain = sim.run_until_drained(20_000)
    sim_mem = np.asarray(sim.mem).reshape(T, WORDS)   # row-major == tile id
    np.testing.assert_array_equal(
        sim_mem, scatter_mem.astype(np.int64),
        err_msg="cycle-level scatter disagrees with the ranks' remote_store")
    np.testing.assert_array_equal(
        sim_mem, expected_memory(addr, data, mask, NX, NY,
                                 mem_words=WORDS).reshape(T, WORDS),
        err_msg="simulator memory disagrees with the analytic image")
    print(f"cycle-level replay: {w.n_packets} store packets drained at "
          f"cycle {drain}; simulator memory == remote_store memory")
    print("OK")
    return {"mem": mem, "scatter_mem": scatter_mem, "winners": winners,
            "drain": drain}


def main(argv=None) -> dict:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    return report(spawn(pgas_rank, T, "gloo", device=device,
                        args=(device,)))


if __name__ == "__main__":
    main()
