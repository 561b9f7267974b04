"""Public wrappers around the model kernels, at the layouts the models use
(the port's counterpart of ``repro.kernels.ops``, forward only).

* :func:`flash_attention_op` — q (B, S, H, hd), k/v (B, S, K, hd);
* :func:`ssd_scan_op` — x (b, S, H, P), dt (b, S, H), B/C (b, S, G, N),
  A (H,);
* :func:`grouped_matmul` — (E, M, K) @ (E, K, N).

Each transposes into its kernel's layout as the reference does
(``ops.py``'s ``_flash_fwd_impl`` and ``_ssd_fwd_impl``) and back, and
dispatches on the tensors' device: the plain version on the CPU, the
Hopper kernel on a CUDA tensor.  The reference also pads head_dim, the
sequence and the GMM dimensions to its TPU tile sizes; the port's kernels
mask their ragged edges themselves, so nothing is padded here.  The
reference's ``custom_vjp``s (recompute through the plain versions for
flash and SSD, two more grouped matmuls for the GMM) belong to the
training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import grouped_matmul
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention_op", "ssd_scan_op", "grouped_matmul",
           "ssd_chunk"]


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True,
                       window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) -> (B, S, H, hd), scaled by
    the head_dim's ``hd ** -0.5``."""
    hd = q.shape[-1]
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=causal,
                          window=window, kv_len=k.shape[1],
                          sm_scale=hd ** -0.5)
    return out.transpose(1, 2)


def ssd_chunk(chunk: int, s: int) -> int:
    """The chunk a sequence of ``s`` steps runs with: the configured one,
    clamped to the next power of two >= s (at least 16), as the reference
    clamps it."""
    return min(chunk, max(16, 1 << (s - 1).bit_length()))


def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor,
                chunk: int = 256) -> torch.Tensor:
    """x: (b, S, H, P); dt: (b, S, H); B/C: (b, S, G, N); A: (H,) ->
    y (b, S, H, P)."""
    y = ssd_scan(x.transpose(1, 2).contiguous(),
                 dt.transpose(1, 2).contiguous(),
                 B.transpose(1, 2).contiguous(),
                 C.transpose(1, 2).contiguous(),
                 A.to(torch.float32).contiguous(),
                 chunk=ssd_chunk(chunk, x.shape[1]))
    return y.transpose(1, 2)
