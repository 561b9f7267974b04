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

What bounds it on an H100, and what the design does about it: see the
source note of ``csrc/ssd_scan.cu``.  :func:`ssd_bound` gives the bound
of one call.

:func:`ssd_scan` takes the plain version
(:func:`repro_torch.kernels.ref.ssd_scan_ref`, the token-by-token
recurrence, which has no chunk) only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  ``ssd_scan.launches`` counts its launches.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_bound", "MAX_CHUNK", "MAX_HEAD_DIM",
           "SMEM_BYTES"]

MAX_CHUNK = 256          # one thread per step of a chunk
MAX_HEAD_DIM = 64        # P: output columns a thread keeps in registers
SMEM_BYTES = 232448      # shared memory a Hopper block may use


@functools.lru_cache(maxsize=None)
def _library():
    return _cuda.bind("ssd_scan", "pppppp" + "i" * 8 + "p")


def _smem_bytes(chunk: int, p: int, n: int) -> int:
    return 4 * (chunk * p + chunk * n + chunk * (n + 1) + 2 * chunk
                + n * p + 32)


def ssd_bound(x: torch.Tensor, B: torch.Tensor, chunk: int
              ) -> Tuple[int, int]:
    """(bytes, FLOPs) one call needs: x, dt, B, C and A read once and y
    written once; the chunked algorithm's operations (per head and chunk:
    C B^T and its product with dt x over the lower triangle, the
    inter-chunk product and the state update)."""
    b, h, s, p = x.shape
    g, n = B.shape[1], B.shape[3]
    es = x.element_size()
    nbytes = es * (2 * b * h * s * p + b * h * s + 2 * b * g * s * n) + 4 * h
    q = min(chunk, s)
    tri = q * (q + 1) // 2
    per_chunk = 2 * tri * (n + p) + 2 * q * n * p * 2
    return nbytes, b * h * (-(-s // q)) * per_chunk


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *, chunk: int = 256
             ) -> torch.Tensor:
    """SSD over a whole sequence, zero initial state.

    x (b, h, S, P), dt (b, h, S), B/C (b, g, S, N), A (h,) -> y like x.
    CPU tensors: the plain recurrence; CUDA tensors (contiguous, x/dt/B/C
    fp32 or bf16 in one dtype, A fp32, P <= 64, chunk <= 256): the kernel.
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
    if g == 0 or h % g or p > MAX_HEAD_DIM or not 1 <= chunk <= MAX_CHUNK \
            or _smem_bytes(chunk, p, n) > SMEM_BYTES:
        raise ValueError(
            f"ssd_scan: needs g | h, P <= {MAX_HEAD_DIM}, 1 <= chunk <= "
            f"{MAX_CHUNK} and {_smem_bytes(chunk, p, n)} <= {SMEM_BYTES} "
            f"bytes of shared memory; got h={h}, g={g}, P={p}, N={n}, "
            f"chunk={chunk}")
    dtypes = tuple(_cuda.DTYPE_CODE)
    _cuda.check_operand("ssd_scan", "x", x, dev, dtypes, (b, h, s, p))
    _cuda.check_operand("ssd_scan", "dt", dt, dev, (x.dtype,), (b, h, s))
    for name, t in (("B", B), ("C", C)):
        _cuda.check_operand("ssd_scan", name, t, dev, (x.dtype,), (b, g, s, n))
    _cuda.check_operand("ssd_scan", "A", A, dev, (torch.float32,), (h,))
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _cuda.launch(_library(), "ssd_scan", dev, x.data_ptr(), dt.data_ptr(),
                 B.data_ptr(), C.data_ptr(), A.data_ptr(), y.data_ptr(), b, h,
                 g, s, p, n, chunk, _cuda.DTYPE_CODE[x.dtype])
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
