"""Public wrappers around the model kernels, at the layouts the models use
(the port's counterpart of ``repro.kernels.ops``), differentiable.

* :func:`flash_attention_op` — q (B, S, H, hd), k/v (B, S, K, hd);
* :func:`ssd_scan_op` — x (b, S, H, P), dt (b, S, H), B/C (b, S, G, N),
  A (H,);
* :func:`grouped_matmul` — (E, M, K) @ (E, K, N).

Each transposes into its kernel's layout as the reference does
(``ops.py``'s ``_flash_fwd_impl`` and ``_ssd_fwd_impl``) and back, and
dispatches on the tensors' device: the plain version on the CPU, the
Hopper kernel on a CUDA tensor.  The reference also pads head_dim, the
sequence and the GMM dimensions to its TPU tile sizes; the port's kernels
mask their ragged edges themselves, so nothing is padded here.

**Autodiff.**  Each op is a ``torch.autograd.Function`` with the
reference's ``custom_vjp`` design: the forward is always the kernel (on a
CUDA tensor it launches the Hopper kernel or raises, never a plain
version), and

* flash's backward recomputes the attention through the differentiable
  plain version (``ref.flash_attention_ref``, materialised fp32 scores) and
  takes its VJP, as ``_flash_vjp_bwd`` does; GQA's dk/dv sum over each
  query group, as autograd through ``repeat_interleave`` does;
* the SSD's backward recomputes y through the chunked algorithm
  (``models/mamba2.py::ssd_chunked``, the reference's default
  ``ssd_impl="chunked"``) and takes its VJP.  The reference's
  ``_ssd_vjp_bwd`` recomputes through the token-by-token
  ``ssd_scan_ref``: the same function, but on the card a Python loop of S
  steps (688.9 ms for one 1 x 4096 forward at Mamba-2's widths), so a
  step of 48 layers would take minutes; the chunked algorithm computes
  the same y in a few dozen batched operations;
* the GMM's backward is exact and two more GMMs, ``d_lhs = gmm(g, rhsᵀ)``
  and ``d_rhs = gmm(lhsᵀ, g)`` (``_gmm_vjp_bwd``): on a CUDA tensor two
  more launches of the Hopper kernel, each transposed operand first made
  contiguous (one copy each).

The recompute is the reference's design for its backward (it has no
backward kernel for flash or the SSD), not a plain version standing in
for a kernel: every forward of an op on a CUDA tensor (under
``remat="full"`` its second forward too) launches the kernel, and each
kernel wrapper raises rather than falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import grouped_matmul as _gmm_kernel
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention_op", "ssd_scan_op", "grouped_matmul",
           "ssd_chunk"]


def _t(t: torch.Tensor) -> torch.Tensor:
    """Axes 1 and 2 swapped, contiguous: the models' layouts into the
    kernels' (B, S, H, .) -> (B, H, S, .), and a GMM operand transposed."""
    return t.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        out = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, kv_len=k.shape[1],
                              sm_scale=q.shape[-1] ** -0.5)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.flash_attention_ref(
                *(t.transpose(1, 2) for t in leaves), causal=ctx.causal,
                window=ctx.window).transpose(1, 2)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True,
                       window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) -> (B, S, H, hd), scaled by
    the head_dim's ``hd ** -0.5``; differentiable in q, k and v."""
    return _Flash.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_chunk(chunk: int, s: int) -> int:
    """The chunk a sequence of ``s`` steps runs with: the configured one,
    clamped to the next power of two >= s (at least 16), as the reference
    clamps it."""
    return min(chunk, max(16, 1 << (s - 1).bit_length()))


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, B, C, A, chunk):
        ctx.save_for_backward(x, dt, B, C, A)
        ctx.chunk = chunk
        y = ssd_scan(_t(x), _t(dt), _t(B), _t(C),
                     A.to(torch.float32).contiguous(), chunk=chunk)
        return y.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.mamba2 import ssd_chunked   # imports ops
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = ssd_chunked(*leaves, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None)


def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A: torch.Tensor,
                chunk: int = 256) -> torch.Tensor:
    """x: (b, S, H, P); dt: (b, S, H); B/C: (b, S, G, N); A: (H,) ->
    y (b, S, H, P); differentiable in x, dt, B, C and A."""
    return _SSD.apply(x, dt, B, C, A, ssd_chunk(chunk, x.shape[1]))


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

class _GMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs):
        ctx.save_for_backward(lhs, rhs)
        return _gmm_kernel(lhs, rhs)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs = ctx.saved_tensors
        g = g.contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = _gmm_kernel(g, _t(rhs)).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            d_rhs = _gmm_kernel(_t(lhs), g).to(rhs.dtype)
        return d_lhs, d_rhs


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in ``lhs``'s dtype, fp32
    accumulation; differentiable, its backward two more grouped
    matmuls."""
    return _GMM.apply(lhs, rhs)
