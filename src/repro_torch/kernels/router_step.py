"""The mesh router cycle as a hand-written Hopper kernel.

Replaces the TPU kernel ``repro/kernels/router_step.py::router_step_call``
(one ``pl.pallas_call`` whose body ``_router_kernel`` traces
``repro/netsim_jax/sim.py::_step_core`` and advances ``C`` mesh cycles
with the whole state resident in VMEM).  The Hopper kernel is
``csrc/router_step.cu``, built with ``nvcc`` for ``sm_90a`` and bound with
``ctypes`` (:mod:`repro_torch.kernels.build`).

What bounds it on an H100.  A cycle is an integer state machine with
cross-tile data flow and almost no arithmetic (about 500 integer
operations per tile and lane), so it is never bound by compute.  The
least traffic a cycle needs (:func:`cycle_bytes`) is each tile's small
per-tile state read and written once plus the ten head packets, the
endpoint's head packet, one memory word and one program entry: ~0.78 KB
per tile and lane, 4.8 MB for 12 lanes of a 16x32 mesh, 1.4 us at
3.35 TB/s.  Measured on an H100 (``PERF.md``), what holds a cycle above
that is one thread's chain of instructions and dependent loads in each
phase: a cycle costs about as much with one lane of 4x4 as with 12 lanes
of 16x32.

What the design does about it (the source note of ``csrc/router_step.cu``
has the detail).  Each phase issues all its loads before its first store,
so a thread waits on L2 a few times a cycle rather than once a load, and
the phases run one thread per (lane, network, tile) and per (lane, tile)
in small blocks, which fills the card from a few lanes up: two launches a
cycle.  Two variants of the same phases differ in layout, chosen before
the launch from the configuration, the lanes and the cycles per call
alone (:func:`router_variant`):
``packed`` runs on working copies of :data:`PACKED_LEAVES` with the tile
index innermost (:func:`pack_state`; :func:`unpack_state` writes them
back at the end of the call; on the card one launch of the kernel's own
transpose each way), so neighbouring threads touch neighbouring words;
``direct`` runs on the state's own leaves and packs nothing.  A loaded
card's cycle is cheaper packed, but the pack and its host work are paid
per call, so only long calls on many lanes x tiles (a sweep's phases) go
``packed``; a drain that checks its fence every cycle goes ``direct``.

Beside the kernel: :func:`router_step_plain`, the plain PyTorch version
(``C`` calls of :func:`repro_torch.netsim.sim.step_core`), which the CPU
tests use and ``chip_smoke.py`` compares the kernel against.  The wrapper
:func:`router_step_call` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.  ``router_step_call.launches``
counts the calls that launched the kernel and
``router_step_call.launches_by_variant`` the same calls by variant.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.netsim import LAT_BINS, NUM_DIRS
from repro_torch.kernels import build
from repro_torch.kernels.backend import require_hopper
from repro_torch.netsim.sim import (BOOL_LEAVES, F, PROG_FIELDS, STATE_LEAVES,
                                    Program, SimConfig, SimState, drained,
                                    flatten_state, step_core)

__all__ = ["router_step_call", "router_step_plain", "leaf_shapes",
           "packed_shapes", "pack_state", "unpack_state", "router_variant",
           "kernel_dims", "cycle_bytes", "DIM_FIELDS", "ARG_FIELDS",
           "SCRATCH_WORDS", "PORT_LEAVES", "PACKED_LEAVES", "VARIANTS",
           "PACKED_MIN_CYCLES", "PACKED_MIN_TILES"]

I32 = torch.int32

# scratch record per (lane, network, output, tile): winner + its packet
SCRATCH_WORDS = 1 + F

# the leaves the wrapper packs into the kernel's working layout
PORT_LEAVES = ("net_head", "net_count", "rr", "link_util", "fifo_hwm")
PACKED_LEAVES = ("net_buf",) + PORT_LEAVES

# the kernel's variants, by their code in RouterDims.variant
VARIANTS = ("direct", "packed")

# where ``packed`` runs (chip_smoke.py's [router cut-over] lines): calls
# of at least this many cycles, on at least this many lanes x tiles
PACKED_MIN_CYCLES = 256
PACKED_MIN_TILES = 4096

# the kernel's two argument structs (csrc/router_step.cu: RouterDims,
# RouterArgs); field order is the C layout
DIM_FIELDS = ("B", "ny", "nx", "cap", "ep_fifo", "mem_words", "L", "Lp",
              "wrap_x", "wrap_y", "chip_w", "period", "variant")
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


def packed_shapes(cfg: SimConfig, lanes: int
                  ) -> Dict[str, Tuple[int, ...]]:
    """Shape of every packed leaf in the kernel's working layout (the tile
    index ``T = ny * nx`` innermost), and of the scratch."""
    B, T = lanes, cfg.ny * cfg.nx
    port = (B, 2, NUM_DIRS, T)
    shapes = {"net_buf": (B, F, 2, NUM_DIRS, cfg.router_fifo, T)}
    shapes.update(dict.fromkeys(PORT_LEAVES, port))
    shapes["scratch"] = (B, 2, NUM_DIRS, SCRATCH_WORDS, T)
    return shapes


def _as_matrices(name: str, leaf: torch.Tensor) -> torch.Tensor:
    """A public packed leaf as the batch of (T, K) matrices the pack
    transposes: the axes before the tile axes (ny, nx), the tiles, the
    axes after: net_buf (B F 2, T, 5 cap), a port leaf (B 2, T, 5)."""
    a = 3 if name == "net_buf" else 2
    s = leaf.shape
    return leaf.view(math.prod(s[:a]), s[a] * s[a + 1], math.prod(s[a + 2:]))


def _public_leaves(st: SimState):
    leaves = dict(zip(STATE_LEAVES, flatten_state(st)))
    return [(name, leaves[name]) for name in PACKED_LEAVES]


def pack_state(st: SimState) -> Dict[str, torch.Tensor]:
    """The kernel's working copies of :data:`PACKED_LEAVES`, in plain
    PyTorch: ``net_buf`` and the five port leaves (stacked, one tensor
    ``(5, B, 2, 5, T)`` under ``"ports"``).  Each leaf's (T, K) matrices
    are transposed to (K, T); on the card the kernel's own pack does the
    same (``csrc/router_step.cu``: pack_kernel)."""
    out = {}
    for name, leaf in _public_leaves(st):
        out[name] = _as_matrices(name, leaf).transpose(1, 2).contiguous()
    B, T = st.cycle.shape[0], st.net.head.shape[2] * st.net.head.shape[3]
    cap = st.net.buf.shape[-1]
    return {"net_buf": out["net_buf"].view(B, F, 2, NUM_DIRS, cap, T),
            "ports": torch.stack([out[n].view(B, 2, NUM_DIRS, T)
                                  for n in PORT_LEAVES])}


def unpack_state(packed: Dict[str, torch.Tensor], st: SimState) -> None:
    """Write the working copies of :func:`pack_state` back into ``st``'s
    leaves, in place."""
    srcs = [packed["net_buf"]] + list(packed["ports"])
    for (name, leaf), src in zip(_public_leaves(st), srcs):
        m = _as_matrices(name, leaf)
        m.copy_(src.reshape(m.shape[0], m.shape[2], m.shape[1])
                .transpose(1, 2))


def router_variant(cfg: SimConfig, lanes: int, cycles_per_call: int) -> str:
    """The kernel variant for a call of ``cycles_per_call`` cycles on
    ``lanes`` lanes of ``cfg``, chosen before the launch from these alone:
    ``packed`` where the card is loaded (at least
    :data:`PACKED_MIN_TILES` lanes x tiles) and the call long (at least
    :data:`PACKED_MIN_CYCLES` cycles), so that its cheaper cycles repay
    the pack, the unpack and their host work; ``direct`` otherwise."""
    if lanes * cfg.nx * cfg.ny >= PACKED_MIN_TILES \
            and cycles_per_call >= PACKED_MIN_CYCLES:
        return "packed"
    return "direct"


def kernel_dims(cfg: SimConfig, lanes: int, prog_len: int,
                variant: str = "direct") -> Dict[str, int]:
    """The kernel's ``RouterDims``: shapes, the topology flags (the
    boundary gate as chip width and period; width 0 means no gate) and
    the variant's code."""
    topo = cfg.topology
    return {"B": lanes, "ny": cfg.ny, "nx": cfg.nx, "cap": cfg.router_fifo,
            "ep_fifo": cfg.ep_fifo, "mem_words": cfg.mem_words,
            "L": cfg.resp_latency, "Lp": prog_len,
            "wrap_x": int(topo.wrap_x), "wrap_y": int(topo.wrap_y),
            "chip_w": topo.chip_width(cfg.nx) if topo.gated else 0,
            "period": topo.boundary_period,
            "variant": VARIANTS.index(variant)}


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


def _library() -> ctypes.CDLL:
    """The router library of the current build directory
    (:func:`repro_torch.kernels.build.build_dir`), bound and checked once
    per directory: a directory set later is used, not ignored."""
    return _library_in(build.build_dir())


@functools.lru_cache(maxsize=None)
def _library_in(directory) -> ctypes.CDLL:
    lib = build.load("router_step", directory)
    lib.router_step_launch.argtypes = [ctypes.POINTER(_Args),
                                       ctypes.POINTER(_Dims), ctypes.c_int,
                                       ctypes.c_void_p]
    lib.router_step_launch.restype = ctypes.c_int
    lib.router_step_abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.router_step_abi.restype = None
    lib.router_step_error_string.argtypes = [ctypes.c_int]
    lib.router_step_error_string.restype = ctypes.c_char_p
    lib.router_pack_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.router_pack_launch.restype = ctypes.c_int
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
    big = [n for n, t in zip(STATE_LEAVES + ("program buffer",),
                             flatten_state(st) + [prog.buf])
           if t.numel() >= 2 ** 31]
    if big:
        raise ValueError(f"router_step kernel indexes with 32-bit offsets; "
                         f"{big} hold 2**31 words or more: run fewer lanes "
                         f"a call")
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


def _pack_call(lib: ctypes.CDLL, st: SimState, packed):
    """The kernel's pack between ``st``'s packed leaves and ``packed``
    (:func:`pack_state`, or with ``unpack`` :func:`unpack_state`, as one
    launch), a function of (unpack, stream) with its arguments built
    once."""
    mats = [_as_matrices(n, leaf) for n, leaf in _public_leaves(st)]
    dsts = [packed["net_buf"]] + list(packed["ports"])
    n = len(mats)
    pub = (ctypes.c_void_p * n)(*[m.data_ptr() for m in mats])
    pk = (ctypes.c_void_p * n)(*[t.data_ptr() for t in dsts])
    batch = (ctypes.c_int * n)(*[m.shape[0] for m in mats])
    cols = (ctypes.c_int * n)(*[m.shape[2] for m in mats])
    T = mats[0].shape[1]

    def call(unpack: bool, stream: int) -> None:
        err = lib.router_pack_launch(pub, pk, batch, cols, n, T, int(unpack),
                                     ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"router_step pack kernel launch failed: "
                               f"{lib.router_step_error_string(err).decode()}")
    return call


def _launch(cfg: SimConfig, prog: Program, st: SimState, C: int,
            variant: str) -> Tuple[SimState, torch.Tensor, torch.Tensor]:
    """Run ``C`` cycles of ``variant`` (``packed``: pack, run, unpack), all
    on the current stream with no host sync."""
    dev = st.cycle.device
    B = st.cycle.shape[0]
    lib = _library()
    shapes = packed_shapes(cfg, B)
    leaves = flatten_state(st)
    pack = None
    if variant == "packed":
        packed = {"net_buf": torch.empty(shapes["net_buf"], dtype=I32,
                                         device=dev),
                  "ports": torch.empty((len(PORT_LEAVES),) +
                                       shapes["net_head"], dtype=I32,
                                       device=dev)}
        pack = _pack_call(lib, st, packed)
        leaves[0] = packed["net_buf"]
        for name, t in zip(PORT_LEAVES, packed["ports"]):
            leaves[STATE_LEAVES.index(name)] = t
    scratch = torch.empty(shapes["scratch"], dtype=I32, device=dev)
    cyc_snap = torch.empty((B,), dtype=I32, device=dev)
    done = torch.zeros((B, C), dtype=I32, device=dev)
    busy = torch.zeros((B, C), dtype=I32, device=dev)
    operands = leaves + [prog.buf, prog.length, scratch, cyc_snap, done,
                         busy]
    args = _Args(*[t.data_ptr() for t in operands])
    dims = _Dims(**kernel_dims(cfg, B, prog.buf.shape[-1], variant))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pack:
            pack(False, stream)
        err = lib.router_step_launch(ctypes.byref(args), ctypes.byref(dims),
                                     C, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(
                f"router_step kernel launch failed ({variant}): "
                f"{lib.router_step_error_string(err).decode()}")
        if pack:
            pack(True, stream)
    router_step_call.launches += 1
    router_step_call.launches_by_variant[variant] += 1
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
    B = st.cycle.shape[0]
    return _launch(cfg, prog, st, C, router_variant(cfg, B, C))


router_step_call.launches = 0
router_step_call.launches_by_variant = dict.fromkeys(VARIANTS, 0)
