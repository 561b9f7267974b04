"""Meshes of ranks and the one way the port starts them (the port's
counterpart of ``repro.launch.mesh``).

``make_production_mesh`` and ``make_test_mesh`` build a
:class:`~repro_torch.parallel.comm.Mesh` over the ranks of the initialised
process group, with the reference's shapes and axis names: ``model`` is
the mesh's X dimension (TP / expert columns), ``data`` its Y dimension
(DP rows), ``pod`` the off-chip link between pods.  The reference's
``HW`` class holds TPU v5e constants and has no counterpart here.

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

__all__ = ["make_production_mesh", "make_test_mesh", "spawn", "BACKENDS"]

BACKENDS = ("gloo", "nccl")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device=None,
                   ranks=None) -> Mesh:
    """A small mesh over the ranks of the process group (or over
    ``ranks`` of it; collective over the whole group either way)."""
    return Mesh(shape, axes, device, ranks)


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
