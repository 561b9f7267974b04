"""Gradient compression for slow (cross-pod) links, with error feedback
(the port's counterpart of ``repro.optim.compress``).

The pod axis crosses the off-chip link ("the mesh extends over off-chip
links to an FPGA" — BSG Ten); it is the bandwidth-poorest hop of the
production mesh, so the cross-pod gradient reduction is where compression
pays.  Two codecs, the reference's arithmetic:

* ``bf16``  — round-to-nearest bf16 (2x), error feedback optional;
* ``int8``  — per-chunk scaled int8 (4x) with error feedback: chunks of
  ``_CHUNK`` elements (the flat tensor zero-padded to a whole chunk), a
  scale of ``max|x| / 127`` per chunk, clamped at 1e-12 in the division,
  and round half to even (``torch.round`` rounds so, as ``jnp.round``
  does); the quantization residual is carried to the next step, so the
  compression bias telescopes instead of accumulating (Seide et al.
  1-bit SGD lineage).

The error state is fp32; a result is cast back to the gradient's dtype.

:func:`cross_pod_psum` is the compressed all-reduce over ``axis`` of a
:class:`~repro_torch.parallel.comm.Mesh`, called inside a rank as the
reference's runs inside a ``shard_map`` island whose manual axis is the
pod axis.  As in the reference, the wire carries the dequantized fp32
values and the reduction sums them (the sum of dequantized int8 is exact
in fp32): what is lossy is the codec, not the bytes moved.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import comm

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "cross_pod_psum", "init_error_state"]

_CHUNK = 1024  # int8 scale granularity (elements)
F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8.  Returns (q (n_chunks, _CHUNK) int8,
    scales (n_chunks, 1) fp32)."""
    flat = x.to(F32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _CHUNK))
    chunks = flat.reshape(-1, _CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(chunks / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int], dtype: torch.dtype
                    ) -> torch.Tensor:
    flat = (q.to(F32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def init_error_state(params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Error-feedback residuals, one per parameter (fp32 zeros)."""
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def compress_decompress(g: torch.Tensor, mode: str,
                        err: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize-then-dequantize ``g`` (the lossy channel), optionally
    carrying the residual in ``err`` (error feedback).  Returns (the
    result in ``g``'s dtype, the new residual or None)."""
    gf = g.to(F32)
    if err is not None:
        gf = gf + err
    if mode == "none":
        out = gf
    elif mode == "bf16":
        out = gf.to(torch.bfloat16).to(F32)
    elif mode == "int8":
        q, s = quantize_int8(gf)
        out = dequantize_int8(q, s, gf.shape, F32)
    else:
        raise ValueError(f"unknown compression mode {mode!r}")
    new_err = (gf - out) if err is not None else None
    return out.to(g.dtype), new_err


def cross_pod_psum(g: torch.Tensor, mesh: comm.Mesh, axis: comm.Axes,
                   mode: str, err: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Compressed all-reduce of ``g`` over the (slow) ``axis`` of
    ``mesh``: each rank's :func:`compress_decompress` result, summed over
    the group (``comm.all_reduce``, counted there).  Returns (the sum,
    this rank's new residual or None)."""
    wire, new_err = compress_decompress(g, mode, err)
    return comm.all_reduce(wire, mesh, axis), new_err
