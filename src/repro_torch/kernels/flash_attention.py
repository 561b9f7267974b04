"""Flash attention (forward) as a hand-written Hopper kernel.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(one ``pl.pallas_call`` over (batch, head, q block, kv block) whose body
``_flash_kernel`` carries the online-softmax statistics in VMEM across the
sequential KV blocks).  The Hopper kernel is ``csrc/flash_attention.cu``,
built with ``nvcc`` for ``sm_90a`` and bound with ``ctypes``.

Same layout as the Pallas kernel: q (B, H, Sq, hd), k/v (B, K, Sk, hd),
K | H, query head ``h`` reading KV head ``h // (H / K)`` (GQA without
repeating KV).  Unlike the Pallas kernel it takes any Sq, Sk and
hd <= 128: the kernel masks the ragged tails itself, so nothing is padded.

What bounds it on an H100, and what the design does about it: see the
source note of ``csrc/flash_attention.cu``.  bf16 runs on the tensor cores
(``wgmma``, P split into bf16 hi + lo), its tiles loaded by TMA
(``wgmma_tma``) or, where TMA cannot describe the rows, by the threads of
its producer warp (``wgmma_loads``); fp32 runs on the CUDA cores
(``f32``).  :func:`flash_variant` chooses from dtype, head_dim and
alignment alone.  :func:`flash_bound` gives the bound of one call.

:func:`flash_attention` takes the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`) only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
``flash_attention.launches`` counts its launches and
``flash_attention.launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.backend import require_hopper
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_bound", "flash_variant",
           "MAX_HEAD_DIM", "VARIANTS"]

MAX_HEAD_DIM = 128
VARIANTS = ("wgmma_tma", "wgmma_loads", "f32")


@functools.lru_cache(maxsize=None)
def _library():
    return _cuda.bind("flash_attention", "pppp" + "i" * 9 + "fii" + "p")


def flash_variant(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """Which kernel a call runs: ``f32`` for fp32; for bf16 the tensor-core
    kernel, with TMA loads when a row of hd values is a multiple of 16
    bytes and q, k, v are 16-byte ``aligned`` (``wgmma_tma``), else with
    thread loads (``wgmma_loads``)."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma_tma" if hd % 8 == 0 and aligned else "wgmma_loads"


def flash_bound(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                window: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, FLOPs) one call needs: q, k, v read once and the output
    written once; 4 hd FLOPs (QK^T and PV) for every (query, key) pair the
    masks keep."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    nbytes = q.element_size() * (2 * b * h * sq * hd + 2 * b * kh * sk * hd)
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(sk)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window is not None:
        keep &= kj > qi - window
    return nbytes, 4 * hd * b * h * int(keep.sum())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, K, Sk, hd) -> (B, H, Sq, hd) in q's
    dtype.  ``kv_len`` masks keys at and beyond it; ``sm_scale`` defaults
    to ``hd ** -0.5``.  CPU tensors: the plain version; CUDA tensors
    (contiguous, fp32 or bf16, one dtype, hd <= 128): the kernel."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len, sm_scale=sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{dev}")
    require_hopper(dev)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: expected q (B, H, Sq, hd) and "
                         f"k/v (B, K, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if kh == 0 or h % kh or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs K | H and hd <= "
                         f"{MAX_HEAD_DIM}, got H={h}, K={kh}, hd={hd}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    dtypes = tuple(_cuda.DTYPE_CODE)
    _cuda.check_operand("flash_attention", "q", q, dev, dtypes, (b, h, sq, hd))
    for name, t in (("k", k), ("v", v)):
        _cuda.check_operand("flash_attention", name, t, dev, (q.dtype,),
                            (b, kh, sk, hd))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = hd ** -0.5 if sm_scale is None else float(sm_scale)
    variant = flash_variant(q.dtype, hd, all(t.data_ptr() % 16 == 0
                                             for t in (q, k, v)))
    _cuda.launch(_library(), "flash_attention", dev, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh, sq, sk,
                 hd, sk if kv_len is None else int(kv_len), int(causal),
                 0 if window is None else int(window), scale,
                 _cuda.DTYPE_CODE[q.dtype], int(variant == "wgmma_tma"))
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
