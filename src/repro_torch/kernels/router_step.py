"""The mesh router cycle as a hand-written Hopper kernel.

Replaces the TPU kernel ``repro/kernels/router_step.py::router_step_call``
(one ``pl.pallas_call`` whose body ``_router_kernel`` traces
``repro/netsim_jax/sim.py::_step_core`` and advances ``C`` mesh cycles
with the whole state resident in VMEM).  The Hopper kernel is
``csrc/router_step.cu``, built with ``nvcc`` for ``sm_90a`` and bound with
``ctypes`` (:mod:`repro_torch.kernels.build`).

What bounds it on an H100.  A cycle is an integer state machine with
cross-tile data flow and almost no arithmetic (about 500 integer
operations per tile and lane), so it is bound by memory and by launches,
never by compute.  The least traffic a cycle needs
(:func:`cycle_bytes`) is each tile's small per-tile state read and
written once plus the ten head packets, the endpoint's head packet, one
memory word and one program entry: ~0.78 KB per tile and lane, 4.8 MB for
12 lanes of a 16x32 mesh, 1.4 us at 3.35 TB/s.  The kernel takes 2
launches per cycle (arbitrate, then advance; see the source), and a
launch costs a few microseconds, so the launch latency bounds it above
the bytes.  Measured on an H100, neither is the limit yet: a cycle takes
34 us, 31 us of it inside the two kernels (``PERF.md``), whose loads of
the reference's layout are uncoalesced (neighbouring tiles are
``5 x cap`` words apart) and whose 48 blocks leave most SMs idle.

What the design does about it.  The state stays in device memory, where
12 lanes (~23 MB) fit the 50 MB L2; one thread per (lane, tile) makes the
per-cycle work wide (6144 threads at 12 lanes of 16x32) and the lane axis
grows it further; a call issues its ``C`` cycles back to back on the
current stream with no host sync, so Python overhead is paid once per
call.  One persistent launch per call with a grid-wide barrier, or a CUDA
graph of the ``2C`` launches, would remove the launch latency and is left
for later work.

Beside the kernel: :func:`router_step_plain`, the plain PyTorch version
(``C`` calls of :func:`repro_torch.netsim.sim.step_core`), which the CPU
tests use and ``chip_smoke.py`` compares the kernel against.  The wrapper
:func:`router_step_call` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.  ``router_step_call.launches``
counts the calls that launched the kernel (each call is ``2C`` CUDA
launches).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.netsim import LAT_BINS, NUM_DIRS
from repro_torch.kernels import build
from repro_torch.kernels.backend import require_hopper
from repro_torch.netsim.sim import (BOOL_LEAVES, F, PROG_FIELDS, STATE_LEAVES,
                                    Program, SimConfig, SimState, drained,
                                    flatten_state, step_core)

__all__ = ["router_step_call", "router_step_plain", "leaf_shapes",
           "kernel_dims", "cycle_bytes", "DIM_FIELDS", "ARG_FIELDS",
           "SCRATCH_WORDS"]

I32 = torch.int32

# scratch record per (lane, tile, network, output): winner + its packet
SCRATCH_WORDS = 1 + F

# the kernel's two argument structs (csrc/router_step.cu: RouterDims,
# RouterArgs); field order is the C layout
DIM_FIELDS = ("B", "ny", "nx", "cap", "ep_fifo", "mem_words", "L", "Lp",
              "wrap_x", "wrap_y", "chip_w", "period")
ARG_FIELDS = STATE_LEAVES + ("prog_buf", "prog_len", "scratch", "cyc_snap",
                             "done", "busy")


class _Dims(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in DIM_FIELDS]


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ARG_FIELDS]


def leaf_shapes(cfg: SimConfig, lanes: int) -> Dict[str, Tuple[int, ...]]:
    """Shape of every state leaf as the kernel indexes it (contiguous,
    row-major, lane axis first)."""
    B, ny, nx, L = lanes, cfg.ny, cfg.nx, cfg.resp_latency
    tile, port = (B, ny, nx), (B, 2, ny, nx, NUM_DIRS)
    return {"net_buf": (B, F, 2, ny, nx, NUM_DIRS, cfg.router_fifo),
            "net_head": port, "net_count": port,
            "ep_buf": (B, F, ny, nx, 1, cfg.ep_fifo),
            "ep_head": tile + (1,), "ep_count": tile + (1,),
            "resp_valid": (B, L, ny, nx), "resp_buf": (B, F, L, ny, nx),
            "mem": tile + (cfg.mem_words,), "credits": tile, "rr": port,
            "prog_ptr": tile, "reg_valid": tile, "reg_buf": (B, F, ny, nx),
            "completed": tile, "lat_sum": tile, "out_of_credit_cycles": tile,
            "cycle": (B,), "fifo_depth": (B,), "max_credits": (B,),
            "link_util": port, "fifo_hwm": port, "ep_hwm": tile,
            "lat_hist": (B, LAT_BINS), "measure_start": (B,),
            "measure_stop": (B,)}


def kernel_dims(cfg: SimConfig, lanes: int, prog_len: int) -> Dict[str, int]:
    """The kernel's ``RouterDims``: shapes plus the topology flags (the
    boundary gate as chip width and period; width 0 means no gate)."""
    topo = cfg.topology
    return {"B": lanes, "ny": cfg.ny, "nx": cfg.nx, "cap": cfg.router_fifo,
            "ep_fifo": cfg.ep_fifo, "mem_words": cfg.mem_words,
            "L": cfg.resp_latency, "Lp": prog_len,
            "wrap_x": int(topo.wrap_x), "wrap_y": int(topo.wrap_y),
            "chip_w": topo.chip_width(cfg.nx) if topo.gated else 0,
            "period": topo.boundary_period}


def cycle_bytes(cfg: SimConfig, lanes: int) -> int:
    """Least bytes one cycle must move: every per-tile pointer, counter
    and flag read once and written once, plus the reads of the ten router
    head packets, the endpoint head packet, one response slot, one memory
    word and one program entry (and its length) per tile and lane.  FIFO,
    memory and program slots that the cycle does not touch are not
    counted, and neither are the data-dependent pushes, so this is a lower
    bound."""
    L = cfg.resp_latency
    per_tile_rw = 4 * (4 * 2 * NUM_DIRS      # net head, count, rr, link_util
                       + 2 * NUM_DIRS        # fifo_hwm
                       + 2 + 1 + 1           # ep head/count, credits, prog_ptr
                       + F + 3 + 1) + L + 1  # reg_buf, 3 counters, ep_hwm; flags
    per_tile_read = 4 * (2 * NUM_DIRS * F    # head packets
                         + F + F + 1         # ep head packet, response slot, mem
                         + len(PROG_FIELDS) + 1)
    return lanes * cfg.nx * cfg.ny * (2 * per_tile_rw + per_tile_read)


def router_step_plain(cfg: SimConfig, prog: Program, st: SimState, C: int
                      ) -> Tuple[SimState, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``C`` calls of
    :func:`repro_torch.netsim.sim.step_core`.  Returns ``(state', done
    (B, C), drained (B, C))`` as int32: ``done[:, j]`` is the completion
    count of cycle j and ``drained[:, j]`` the drain fence after it."""
    dones, drains = [], []
    for _ in range(C):
        st, d = step_core(cfg, prog, st)
        dones.append(d)
        drains.append(drained(st, prog).to(I32))
    return st, torch.stack(dones, 1), torch.stack(drains, 1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("router_step")
    lib.router_step_launch.argtypes = [ctypes.POINTER(_Args),
                                       ctypes.POINTER(_Dims), ctypes.c_int,
                                       ctypes.c_void_p]
    lib.router_step_launch.restype = ctypes.c_int
    lib.router_step_abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.router_step_abi.restype = None
    lib.router_step_error_string.argtypes = [ctypes.c_int]
    lib.router_step_error_string.restype = ctypes.c_char_p
    sizes = (ctypes.c_int * 2)()
    lib.router_step_abi(sizes)
    want = (ctypes.sizeof(_Args), ctypes.sizeof(_Dims))
    if tuple(sizes) != want:
        raise RuntimeError(f"router_step.cu's argument structs are "
                           f"{tuple(sizes)} bytes, the wrapper's {want}")
    return lib


def _check_operands(cfg: SimConfig, prog: Program, st: SimState,
                    device: torch.device) -> None:
    """Device, dtype, contiguity and shape of every operand."""
    B = st.cycle.shape[0]
    shapes = leaf_shapes(cfg, B)
    for name, t in zip(STATE_LEAVES, flatten_state(st)):
        want = torch.bool if name in BOOL_LEAVES else I32
        if t.device != device or t.dtype != want or not t.is_contiguous() \
                or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"state leaf {name}: expected a contiguous {want} tensor of "
                f"shape {shapes[name]} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    nprog = len(PROG_FIELDS)
    if prog.buf.dim() != 5 or tuple(prog.buf.shape[:4]) != (B, nprog, cfg.ny,
                                                            cfg.nx):
        raise ValueError(f"program buffer must be (B={B}, {nprog}, "
                         f"{cfg.ny}, {cfg.nx}, Lp), got "
                         f"{tuple(prog.buf.shape)}")
    for name, t in (("program buffer", prog.buf),
                    ("program length", prog.length)):
        if t.device != device or t.dtype != I32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor "
                             f"on {device}, got {t.dtype} on {t.device}")
    if tuple(prog.length.shape) != (B, cfg.ny, cfg.nx):
        raise ValueError(f"program length must be (B={B}, {cfg.ny}, "
                         f"{cfg.nx}), got {tuple(prog.length.shape)}")


def _launch(cfg: SimConfig, prog: Program, st: SimState, C: int
            ) -> Tuple[SimState, torch.Tensor, torch.Tensor]:
    dev = st.cycle.device
    B = st.cycle.shape[0]
    lib = _library()
    scratch = torch.empty((B, cfg.ny, cfg.nx, 2, NUM_DIRS, SCRATCH_WORDS),
                          dtype=I32, device=dev)
    cyc_snap = torch.empty((B,), dtype=I32, device=dev)
    done = torch.zeros((B, C), dtype=I32, device=dev)
    busy = torch.zeros((B, C), dtype=I32, device=dev)
    operands = flatten_state(st) + [prog.buf, prog.length, scratch, cyc_snap,
                                    done, busy]
    args = _Args(*[t.data_ptr() for t in operands])
    dims = _Dims(**kernel_dims(cfg, B, prog.buf.shape[-1]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.router_step_launch(ctypes.byref(args), ctypes.byref(dims),
                                     C, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"router_step kernel launch failed: "
                           f"{lib.router_step_error_string(err).decode()}")
    router_step_call.launches += 1
    return st, done, (busy == 0).to(I32)


def router_step_call(cfg: SimConfig, prog: Program, st: SimState,
                     cycles_per_call: int
                     ) -> Tuple[SimState, torch.Tensor, torch.Tensor]:
    """Run ``cycles_per_call`` mesh cycles of every lane.

    Returns ``(state', done (B, C), drained (B, C))``: ``done[:, j]`` is
    the completion count of cycle j and ``drained[:, j]`` the drain fence
    after it (int32 0/1).  On CUDA tensors the kernel updates ``st`` in
    place and returns it (do not reuse the argument); on CPU tensors this
    is :func:`router_step_plain`.  Any other device raises."""
    C = int(cycles_per_call)
    if C < 1:
        raise ValueError(f"cycles_per_call must be >= 1, got {C}")
    dev = st.cycle.device
    if dev.type == "cpu":
        if prog.buf.device != dev:
            raise ValueError(f"program on {prog.buf.device}, state on {dev}")
        return router_step_plain(cfg, prog, st, C)
    if dev.type != "cuda":
        raise ValueError(f"router_step_call takes CPU or CUDA tensors, "
                         f"got {dev}")
    require_hopper(dev)
    _check_operands(cfg, prog, st, dev)
    return _launch(cfg, prog, st, C)


router_step_call.launches = 0
