"""The Mamba-2 SSD chunked scan as a hand-written Hopper kernel.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan`` (one
``pl.pallas_call`` over (batch, head, chunk) whose body ``_ssd_kernel``
carries the fp32 (N, P) state in VMEM across the sequential chunks).  The
Hopper kernel is ``csrc/ssd_scan.cu``, built with ``nvcc`` for ``sm_90a``
and bound with ``ctypes``.

Same layout as the Pallas kernel: x (b, h, S, P), dt (b, h, S), B/C
(b, g, S, N) in one dtype, A (h,) fp32, head ``hh`` reading group
``hh // (h / g)``.  Unlike the Pallas kernel it takes any S: steps past
the end are dt = 0 inside the kernel (exact), so nothing is padded.

What bounds it on an H100.  At Jamba's widths a call reads and writes
~135 MB against ~11 GFLOP (:func:`ssd_bound`): bound by bytes, ~40 us,
as long as the products run on the tensor cores (on the CUDA cores alone
the work takes >= 0.16 ms).  What the design does about it (the source
note of ``csrc/ssd_scan.cu`` has the detail): the chunks run in parallel
in three launches (each chunk's own state, a short pass carrying the
state across chunks, each chunk's output), and for bf16 the chunk's
products are ``wgmma``s, with the decay-weighted ``C B^T`` and ``B o w``
as bf16 hi + lo and x, exact, loaded by TMA.  :func:`ssd_variant` chooses
the ``tensor_core`` or the ``cuda_core`` variant from the dtype and the
shapes alone, and :func:`cuda_core_chunk` the chunk ``cuda_core`` runs
at: the configured one, halved until its shared memory fits a block (at
Mamba-2 370M's N = 128 and P = 64, 128 in place of 256).  The chunked
algorithm is exact at any chunk, so this changes the order of fp32 sums,
not what is computed.

:func:`ssd_scan` takes the plain version
(:func:`repro_torch.kernels.ref.ssd_scan_ref`, the token-by-token
recurrence, which has no chunk) only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  ``ssd_scan.launches`` counts its calls
(three CUDA launches each) and ``ssd_scan.launches_by_variant`` the same
calls by variant.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_bound", "ssd_variant", "cuda_core_chunk",
           "VARIANTS", "MAX_CHUNK", "MAX_HEAD_DIM", "SMEM_BYTES", "TC_ROWS",
           "TC_MAX_N"]

VARIANTS = ("tensor_core", "cuda_core")
_VARIANT_CODE = {"cuda_core": 0, "tensor_core": 1}   # csrc/ssd_scan.cu
MAX_CHUNK = 256          # cuda_core: one thread per step of a chunk
MAX_HEAD_DIM = 64        # P: one 128-byte row of bf16; cuda_core registers
TC_ROWS = 64             # tensor_core: wgmma's rows; chunks are a multiple
TC_MAX_N = 128           # tensor_core: C and B rows in two 128-byte blocks
SMEM_BYTES = 232448      # shared memory a Hopper block may use


@functools.lru_cache(maxsize=None)
def _library():
    return _cuda.bind("ssd_scan", "p" * 8 + "i" * 9 + "p")


def _smem_bytes(chunk: int, p: int, n: int) -> int:
    """The cuda_core variant's larger pass (3): dt x, B, C (padded), cum,
    the state and the scan's partials, in floats."""
    return 4 * (chunk * p + chunk * n + chunk * (n + 1) + chunk + n * p + 32)


def cuda_core_chunk(chunk: int, p: int, n: int) -> int:
    """The chunk the ``cuda_core`` variant runs at: ``chunk``, halved
    (rounding down) until :func:`_smem_bytes` fits ``SMEM_BYTES``.  A pure
    function of the shape, chosen before the launch."""
    while chunk > 1 and _smem_bytes(chunk, p, n) > SMEM_BYTES:
        chunk //= 2
    return chunk


def ssd_variant(dtype: torch.dtype, chunk: int, n: int, p: int,
                aligned: bool = True) -> str:
    """``tensor_core`` for bf16 when the chunk is a multiple of 64 (up to
    256), N a multiple of 16 (up to 128), P a multiple of 8 (up to 64) and
    x, B and C are 16-byte ``aligned`` (TMA and the 16-byte loads need
    it); ``cuda_core`` for everything else.  A pure function of these."""
    if dtype == torch.bfloat16 and aligned and chunk % TC_ROWS == 0 \
            and 0 < chunk <= MAX_CHUNK and n % 16 == 0 and 0 < n <= TC_MAX_N \
            and p % 8 == 0 and 0 < p <= MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core"


def ssd_bound(x: torch.Tensor, B: torch.Tensor, chunk: int
              ) -> Tuple[int, int]:
    """(bytes, FLOPs) one call needs: x, dt, B, C and A read once and y
    written once; the chunked algorithm's operations.  ``C B^T`` over a
    chunk's lower triangle is shared by the heads of a group (they differ
    only in the decay mask and dt), so it counts once per group and chunk;
    its product with dt x, the inter-chunk product and the state update
    count per head and chunk."""
    b, h, s, p = x.shape
    g, n = B.shape[1], B.shape[3]
    es = x.element_size()
    nbytes = es * (2 * b * h * s * p + b * h * s + 2 * b * g * s * n) + 4 * h
    q = min(chunk, s)
    chunks = -(-s // q)
    tri = q * (q + 1) // 2
    per_group = 2 * tri * n
    per_head = 2 * tri * p + 2 * q * n * p * 2
    return nbytes, b * chunks * (g * per_group + h * per_head)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *, chunk: int = 256
             ) -> torch.Tensor:
    """SSD over a whole sequence, zero initial state.

    x (b, h, S, P), dt (b, h, S), B/C (b, g, S, N), A (h,) -> y like x.
    CPU tensors: the plain recurrence; CUDA tensors (contiguous, x/dt/B/C
    fp32 or bf16 in one dtype, A fp32, P <= 64, chunk <= 256): the
    kernel, its variant chosen by :func:`ssd_variant` (x, B or C not
    16-byte aligned take ``cuda_core``), ``cuda_core`` at
    :func:`cuda_core_chunk`.
    """
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_ref(x, dt, B, C, A)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got {dev}")
    require_hopper(dev)
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan: expected x (b, h, S, P) and B/C "
                         f"(b, g, S, N), got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    b, h, s, p = x.shape
    g, n = B.shape[1], B.shape[3]
    chunk = int(chunk)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, B, C))
    variant = ssd_variant(x.dtype, chunk, n, p, aligned)
    if g == 0 or h % g or p > MAX_HEAD_DIM or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(
            f"ssd_scan: needs g | h, P <= {MAX_HEAD_DIM} and 1 <= chunk <= "
            f"{MAX_CHUNK}; got h={h}, g={g}, P={p}, N={n}, chunk={chunk}")
    if variant == "cuda_core":
        chunk = cuda_core_chunk(chunk, p, n)
    dtypes = tuple(_cuda.DTYPE_CODE)
    _cuda.check_operand("ssd_scan", "x", x, dev, dtypes, (b, h, s, p))
    _cuda.check_operand("ssd_scan", "dt", dt, dev, (x.dtype,), (b, h, s))
    for name, t in (("B", B), ("C", C)):
        _cuda.check_operand("ssd_scan", name, t, dev, (x.dtype,), (b, g, s, n))
    _cuda.check_operand("ssd_scan", "A", A, dev, (torch.float32,), (h,))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    nc = -(-s // chunk)
    states = torch.empty((b, h, nc, n, p), dtype=torch.float32, device=dev)
    decay = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
    _cuda.launch(_library(), "ssd_scan", dev, x.data_ptr(), dt.data_ptr(),
                 B.data_ptr(), C.data_ptr(), A.data_ptr(), y.data_ptr(),
                 states.data_ptr(), decay.data_ptr(), b, h, g, s, p, n, chunk,
                 _cuda.DTYPE_CODE[x.dtype], _VARIANT_CODE[variant])
    ssd_scan.launches += 1
    ssd_scan.launches_by_variant[variant] += 1
    return y


ssd_scan.launches = 0
ssd_scan.launches_by_variant = dict.fromkeys(VARIANTS, 0)
