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

:func:`grouped_swiglu` is the expert SwiGLU's first half, ``silu(lhs @
w_gate) * (lhs @ w_up)``, in one launch of the ``tma`` kernel with a
SwiGLU epilogue (variant ``tma_swiglu``, the kernel
``gmm_tma_kernel<true>``): each block's 256 wgmma columns are 128 of
``w_gate`` and the same 128 of ``w_up``, and the epilogue rounds g and u
to bf16 (as two ``tma`` calls' outputs are rounded), computes
``g / (1 + exp(-g)) * u`` in fp32 and rounds once to bf16, so g and u
never reach device memory.  It takes what :func:`swiglu_plan` accepts:
bf16 operands that :func:`gmm_plan` runs as ``tma``.  Its bound
(:func:`swiglu_bound`): 2 x 2 E M K N FLOPs; lhs and both weights read
once, h written once.  Its plain version is the unfused chain
(:func:`repro_torch.kernels.ref.grouped_swiglu_ref`), bit for bit.

:func:`grouped_matmul` takes the plain version
(:func:`repro_torch.kernels.ref.grouped_matmul_ref`) only for CPU tensors;
for CUDA tensors it launches the chosen kernel or raises: no variant
falls back to another.  On ``meta`` tensors (the costing tools' dry run)
it checks the operands as for the card, plans the variant the card would
run (``aligned=True``: a meta tensor has no address), records the call
(:mod:`repro_torch.kernels.record`) and returns an empty output; it never
runs the plain version there.  On the CPU it records the call it stands
in for too.  ``grouped_matmul.launches`` counts its launches
and ``grouped_matmul.launches_by_variant`` splits them by variant;
:func:`grouped_swiglu` counts its launches there too (``tma_swiglu``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch import own_work
from repro_torch.kernels import _cuda, record
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import grouped_matmul_ref, grouped_swiglu_ref

__all__ = ["grouped_matmul", "grouped_swiglu", "gmm_bound", "gmm_variant",
           "gmm_plan", "swiglu_plan", "swiglu_bound", "VARIANTS",
           "DECODE_MAX_M"]

VARIANTS = ("tma", "decode", "ragged", "f32", "tma_swiglu")
_VARIANT_CODE = {"ragged": 0, "tma": 1, "decode": 2, "tma_swiglu": 3}
DECODE_MAX_M = 64               # wgmma's N side in the swapped product


@functools.lru_cache(maxsize=None)
def _library():
    return _cuda.bind("moe_gmm", "ppppiiiiiiip")


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


def swiglu_plan(lhs: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor) -> Optional[str]:
    """``tma_swiglu`` where :func:`grouped_swiglu` takes these operands:
    all bf16, (E, M, K) and two weights of one (E, K, N) shape, which
    :func:`gmm_plan` runs as ``tma`` (all three 16-byte aligned; on
    ``meta``, which has no addresses, as the card would plan); else
    None."""
    if lhs.dim() != 3 or w_gate.dim() != 3 \
            or w_up.shape != w_gate.shape \
            or lhs.shape[0] != w_gate.shape[0] \
            or lhs.shape[2] != w_gate.shape[1] \
            or not lhs.dtype == w_gate.dtype == w_up.dtype == torch.bfloat16:
        return None
    aligned = lhs.device.type == "meta" or all(
        t.data_ptr() % 16 == 0 for t in (lhs, w_gate, w_up))
    if gmm_plan(lhs, w_gate, aligned)[0] != "tma":
        return None
    return "tma_swiglu"


def swiglu_bound(lhs: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor) -> Tuple[int, int]:
    """(bytes, FLOPs) one :func:`grouped_swiglu` call needs: lhs and both
    weights read once, h written once; 2 x 2 E M K N operations."""
    e, m, k = lhs.shape
    n = w_gate.shape[-1]
    es = lhs.element_size()
    return (es * (e * m * k + 2 * e * k * n + e * m * n),
            2 * 2 * e * m * k * n)


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


def grouped_swiglu(lhs: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor) -> torch.Tensor:
    """silu(lhs @ w_gate) * (lhs @ w_up): (E, M, K) and two (E, K, N) ->
    (E, M, N) bf16, each product rounded to bf16 before the fp32 SwiGLU,
    as the unfused chain rounds it.  Takes only operands
    :func:`swiglu_plan` accepts (raises on others, on every device).  No
    backward on the card (the kernel's output carries no autograd graph),
    so a model calls it only where ``ops.fuses_swiglu`` holds.  CPU
    tensors: the plain version (the chain); CUDA tensors (contiguous): one
    ``tma_swiglu`` launch; meta tensors (checked as CUDA ones): a record
    and an empty output."""
    dev = lhs.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"grouped_swiglu takes CPU, CUDA or meta tensors, "
                         f"got {dev}")
    if swiglu_plan(lhs, w_gate, w_up) is None:
        raise ValueError(
            f"grouped_swiglu: expected bf16 (E, M, K) and two (E, K, N) "
            f"operands that the tma variant takes (M > {DECODE_MAX_M}, K "
            f"and N multiples of 8, 16-byte aligned); got "
            f"{lhs.dtype} {tuple(lhs.shape)}, {w_gate.dtype} "
            f"{tuple(w_gate.shape)}, {w_up.dtype} {tuple(w_up.shape)}")
    e, m, k = lhs.shape
    n = w_gate.shape[-1]
    if dev.type == "cpu":
        if record.active():
            record.record("moe_gmm", "tma_swiglu", (lhs, w_gate, w_up),
                          swiglu_bound(lhs, w_gate, w_up))
        with own_work.inside():
            return grouped_swiglu_ref(lhs, w_gate, w_up)
    if dev.type == "cuda":
        require_hopper(dev)
    _cuda.check_operand("grouped_swiglu", "lhs", lhs, dev, (torch.bfloat16,),
                        (e, m, k))
    for what, w in (("w_gate", w_gate), ("w_up", w_up)):
        _cuda.check_operand("grouped_swiglu", what, w, dev,
                            (torch.bfloat16,), (e, k, n))
    if dev.type == "meta":
        with own_work.inside():
            out = torch.empty((e, m, n), dtype=lhs.dtype, device=dev)
        if out.numel() and k and record.active():
            record.record("moe_gmm", "tma_swiglu", (lhs, w_gate, w_up),
                          swiglu_bound(lhs, w_gate, w_up))
        return out
    out = torch.empty((e, m, n), dtype=lhs.dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:                      # silu(0) * 0
        return out.zero_()
    return _launch(lhs, w_gate, out, "tma_swiglu", 0, w_up)


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, out: torch.Tensor,
            variant: str, mp: int,
            rhs_up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``variant`` (with MP ``mp`` for ``decode``; ``rhs_up``, the
    second weight, for ``tma_swiglu``) on operands its caller has checked,
    and count the launch.  Only ``chip_smoke.py``'s measurement of the
    decode/tma cut-over calls it with a variant other than
    :func:`gmm_plan`'s."""
    e, m, k = lhs.shape
    _cuda.launch(_library(), "moe_gmm", lhs.device, lhs.data_ptr(),
                 rhs.data_ptr(), None if rhs_up is None else rhs_up.data_ptr(),
                 out.data_ptr(), e, m, k, rhs.shape[-1],
                 _cuda.DTYPE_CODE[lhs.dtype], _VARIANT_CODE.get(variant, 0),
                 mp)
    grouped_matmul.launches += 1
    grouped_matmul.launches_by_variant[variant] += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
