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
source note of ``csrc/moe_gmm.cu`` (tensor cores through WMMA for bf16,
one block per 128 x 128 output tile looping over K, ragged edges masked in
the kernel).  :func:`gmm_bound` gives the bound of one call.

:func:`grouped_matmul` takes the plain version
(:func:`repro_torch.kernels.ref.grouped_matmul_ref`) only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
``grouped_matmul.launches`` counts its launches.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import grouped_matmul_ref

__all__ = ["grouped_matmul", "gmm_bound"]


@functools.lru_cache(maxsize=None)
def _library():
    return _cuda.bind("moe_gmm", "pppiiiiip")


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
    fp32 or bf16, one dtype): the kernel."""
    dev = lhs.device
    if dev.type == "cpu":
        return grouped_matmul_ref(lhs, rhs)
    if dev.type != "cuda":
        raise ValueError(f"grouped_matmul takes CPU or CUDA tensors, got {dev}")
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
    out = torch.empty((e, m, n), dtype=lhs.dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    _cuda.launch(_library(), "moe_gmm", dev, lhs.data_ptr(), rhs.data_ptr(),
                 out.data_ptr(), e, m, k, n, _cuda.DTYPE_CODE[lhs.dtype])
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
