"""Meshes of ranks and the one way the port starts them (the port's
counterpart of ``repro.launch.mesh``).

``make_production_mesh`` and ``make_test_mesh`` build a
:class:`~repro_torch.parallel.comm.Mesh` over the ranks of the initialised
process group, with the reference's shapes and axis names: ``model`` is
the mesh's X dimension (TP / expert columns), ``data`` its Y dimension
(DP rows), ``pod`` the off-chip link between pods.  :class:`HW` holds
the constants the roofline reads (``launch/roofline.py``), under the
reference's names, for an NVIDIA H100 SXM where the reference's hold a
TPU v5e's.

:func:`spawn` starts ``world`` ranks and returns their results; the tests,
``chip_smoke.py`` and the serve CLI all start ranks through it:

* the ``spawn`` start method (a rank imports only what its function's
  module imports: no JAX);
* rendezvous through a ``file://`` store in a fresh temporary directory,
  never a TCP port (several test processes run at once);
* the backend is the caller's explicit choice: ``gloo`` on the CPU; on
  the card ``nccl`` when each rank has a card of its own, else ``gloo``
  over CUDA tensors (ranks sharing one card);
* on the CPU each rank runs one thread; on the card rank ``r`` uses card
  ``r % device_count``;
* a rank that raises or dies fails the whole run: :func:`spawn` stops the
  other ranks and raises with the rank's traceback.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.parallel.comm import Mesh

__all__ = ["make_production_mesh", "make_test_mesh", "spawn", "rank_device",
           "BACKENDS", "HW"]

BACKENDS = ("gloo", "nccl")


class HW:
    """NVIDIA H100 SXM constants used by the roofline (per card): NVIDIA's
    data sheet, dense rates (no sparsity) at the full 700 W power limit.

    ``ICI_BW`` is the link rate the analytic collective term charges. It
    is InfiniBand, not NVLink: NVLink joins the 8 cards of one host, and
    every 16-wide axis of the production meshes (``make_production_mesh``)
    spans two or more hosts, so a ring along it crosses one 400 Gb/s NDR
    port per card, as in a DGX H100.  ``NVLINK_BW`` is kept for the
    record; no term reads it (PERF.md §7)."""
    PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 dense (data sheet, SXM)
    HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet, SXM)
    HBM_BYTES = 80e9             # capacity, 80 GB (data sheet)
    SMEM_BYTES = 228 * 2**10     # an SM's shared memory, 228 KiB
    NVLINK_BW = 450e9            # bytes/s each way, NVLink 4 within a host
    ICI_BW = 50e9                # bytes/s, one 400 Gb/s NDR port per card
    DCN_BW = 50e9                # bytes/s, the same fabric between pods


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         dry: bool = False, rank: int = 0) -> Mesh:
    """The 16x16 pod or the 2x16x16 multipod over the process group's
    ranks; with ``dry`` a dry mesh of it holding rank ``rank``'s
    coordinates (``comm.Mesh.dry``: no process group, the ``meta``
    device), which the costing tools run a cell on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return Mesh.dry(shape, axes, rank)
    return Mesh(shape, axes, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device=None,
                   ranks=None) -> Mesh:
    """A small mesh over the ranks of the process group (or over
    ``ranks`` of it; collective over the whole group either way)."""
    return Mesh(shape, axes, device, ranks)


def rank_device(device) -> str:
    """The device of a rank that :func:`spawn` started with ``device``:
    ``"cpu"``, or the card it set for the rank (``cuda:<index>``)."""
    return "cpu" if str(device) == "cpu" else \
        f"cuda:{torch.cuda.current_device()}"


def _rank_main(fn, rank, world, backend, device, store, args_file,
               results):
    import torch.distributed as dist
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        out = fn(rank, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], world: int, backend: str,
          device: str = "cpu", args: Sequence[Any] = (),
          timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned ranks of one process
    group on ``backend``; returns the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  Raises ``RuntimeError`` when a rank raises, dies
    or the run outlasts ``timeout`` seconds; every rank is stopped
    first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        # the arguments go through a file: a process's start blocks until
        # the child has read what it is handed, which it does only after
        # importing its modules, so large arguments would serialise the
        # ranks' start-up
        args_file = os.path.join(tmp, "args")
        with open(args_file, "wb") as f:
            pickle.dump(tuple(args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, store,
                                   args_file, results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failed = {}, None
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world and failed is None:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        # a message may still be in flight from a rank
                        # that just exited
                        try:
                            rank, ok, out = results.get(timeout=5.0)
                        except queue.Empty:
                            failed = (f"rank {dead[0]} exited with code "
                                      f"{procs[dead[0]].exitcode} and no "
                                      f"result")
                            break
                    elif time.monotonic() > deadline:
                        failed = f"ranks timed out after {timeout} s"
                        break
                    else:
                        continue
                if ok:
                    got[rank] = out
                else:
                    failed = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if failed is not None and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return [got[r] for r in range(world)]
