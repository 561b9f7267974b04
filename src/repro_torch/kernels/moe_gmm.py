"""The grouped (expert) matmul as a hand-written Hopper kernel.

Replaces the TPU kernel ``repro/kernels/moe_gmm.py::grouped_matmul_pallas``
(one ``pl.pallas_call`` over (expert, row block, column block, k block)
with an fp32 VMEM accumulator).  The Hopper kernel is ``csrc/moe_gmm.cu``,
built with ``nvcc`` for ``sm_90a`` and bound with ``ctypes``.

In the JAX model, ``moe._expert_ffn`` calls ``grouped_matmul`` with
``impl=None``, the XLA einsum ``ref.grouped_matmul_ref``; the Pallas kernel
is reached only through ``impl="pallas"``.  Both compute the same function,
so the port's expert FFN runs this kernel on the card, in prefill and in
every decode step.

What bounds it on an H100, and what the design does about it: see the
source note of ``csrc/moe_gmm.cu``.  bf16 runs one of three tile
configurations, chosen by :func:`gmm_variant` from the shape and the
operands' alignment alone: ``tma`` (M > 64, the prefill: TMA ring and
``wgmma``), ``decode`` (M <= 64: "swap AB", the weights streamed once)
or ``ragged`` (rows TMA cannot describe: WMMA).  fp32 runs its own CUDA-
core kernel (``f32``).  The kernel computes its own grid, TMA boxes and
shared memory from the constants of its source; :func:`gmm_plan` gives
what the wrapper passes it, :func:`gmm_bound` the bound of one call.

:func:`grouped_matmul` takes the plain version
(:func:`repro_torch.kernels.ref.grouped_matmul_ref`) only for CPU tensors;
for CUDA tensors it launches the chosen kernel or raises: no variant
falls back to another.  On ``meta`` tensors (the costing tools' dry run)
it checks the operands as for the card, plans the variant the card would
run (``aligned=True``: a meta tensor has no address), records the call
(:mod:`repro_torch.kernels.record`) and returns an empty output; it never
runs the plain version there.  On the CPU it records the call it stands
in for too.  ``grouped_matmul.launches`` counts its launches
and ``grouped_matmul.launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch import own_work
from repro_torch.kernels import _cuda, record
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import grouped_matmul_ref

__all__ = ["grouped_matmul", "gmm_bound", "gmm_variant", "gmm_plan",
           "VARIANTS", "DECODE_MAX_M"]

VARIANTS = ("tma", "decode", "ragged", "f32")
_VARIANT_CODE = {"ragged": 0, "tma": 1, "decode": 2}
DECODE_MAX_M = 64               # wgmma's N side in the swapped product


@functools.lru_cache(maxsize=None)
def _library():
    return _cuda.bind("moe_gmm", "pppiiiiiiip")


def gmm_variant(m: int, k: int, n: int, aligned: bool = True) -> str:
    """The bf16 tile configuration of an (E, m, k) @ (E, k, n) product:
    ``ragged`` when TMA cannot describe the operands (a row of k or n bf16
    values not a multiple of 16 bytes, or an operand not 16-byte
    ``aligned``), else ``decode`` for m <= 64 and ``tma`` above.  A pure
    function of shape and alignment: never of a failure."""
    if (2 * k) % 16 or (2 * n) % 16 or not aligned:
        return "ragged"
    return "decode" if m <= DECODE_MAX_M else "tma"


def gmm_plan(lhs: torch.Tensor, rhs: torch.Tensor,
             aligned: Optional[bool] = None) -> Tuple[str, int]:
    """What :func:`grouped_matmul` passes to the kernel for these
    operands: the variant (``f32`` for fp32, else :func:`gmm_variant` of
    the shape and of the operands' 16-byte alignment, ``aligned`` where
    given) and, for ``decode``, MP (0 otherwise).  The output is
    allocated aligned."""
    if lhs.dtype == torch.float32:
        return "f32", 0
    _, m, k = lhs.shape
    n = rhs.shape[-1]
    if aligned is None:
        aligned = lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
    variant = gmm_variant(m, k, n, aligned)
    if variant != "decode":
        return variant, 0
    return variant, next(p for p in (8, 16, 32, 64) if p >= m)


def gmm_bound(lhs: torch.Tensor, rhs: torch.Tensor) -> Tuple[int, int]:
    """(bytes, FLOPs) one call needs: each operand read once, the output
    written once; 2 E M K N operations."""
    e, m, k = lhs.shape
    n = rhs.shape[-1]
    es = lhs.element_size()
    return es * (e * m * k + e * k * n + e * m * n), 2 * e * m * k * n


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in ``lhs``'s dtype, fp32
    accumulation.  CPU tensors: the plain version; CUDA tensors (contiguous,
    fp32 or bf16, one dtype): the kernel; meta tensors (checked as CUDA
    ones): a record and an empty output."""
    dev = lhs.device
    if dev.type == "cpu":
        if lhs.numel() and rhs.numel() and record.active():
            record.record("moe_gmm", gmm_plan(lhs, rhs)[0], (lhs, rhs),
                          gmm_bound(lhs, rhs))
        with own_work.inside():
            return grouped_matmul_ref(lhs, rhs)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"grouped_matmul takes CPU, CUDA or meta tensors, "
                         f"got {dev}")
    if dev.type == "cuda":
        require_hopper(dev)
    if lhs.dim() != 3 or rhs.dim() != 3:
        raise ValueError(f"grouped_matmul: expected (E, M, K) and (E, K, N), "
                         f"got {tuple(lhs.shape)} and {tuple(rhs.shape)}")
    e, m, k = lhs.shape
    n = rhs.shape[-1]
    dtypes = tuple(_cuda.DTYPE_CODE)
    _cuda.check_operand("grouped_matmul", "lhs", lhs, dev, dtypes, (e, m, k))
    _cuda.check_operand("grouped_matmul", "rhs", rhs, dev, (lhs.dtype,),
                        (e, k, n))
    if dev.type == "meta":
        with own_work.inside():
            out = torch.empty((e, m, n), dtype=lhs.dtype, device=dev)
        if out.numel() and k and record.active():
            record.record("moe_gmm", gmm_plan(lhs, rhs, aligned=True)[0],
                          (lhs, rhs), gmm_bound(lhs, rhs))
        return out
    out = torch.empty((e, m, n), dtype=lhs.dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    return _launch(lhs, rhs, out, *gmm_plan(lhs, rhs))


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, out: torch.Tensor,
            variant: str, mp: int) -> torch.Tensor:
    """Launch ``variant`` (with MP ``mp`` for ``decode``) on operands
    :func:`grouped_matmul` has checked, and count the launch.  Only
    ``chip_smoke.py``'s measurement of the decode/tma cut-over calls it
    with a variant other than :func:`gmm_plan`'s."""
    e, m, k = lhs.shape
    _cuda.launch(_library(), "moe_gmm", lhs.device, lhs.data_ptr(),
                 rhs.data_ptr(), out.data_ptr(), e, m, k, rhs.shape[-1],
                 _cuda.DTYPE_CODE[lhs.dtype], _VARIANT_CODE.get(variant, 0),
                 mp)
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_variant[variant] += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
