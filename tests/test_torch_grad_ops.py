"""The gradients of the port's kernel ops (``repro_torch.kernels.ops``)
against the JAX package's ``custom_vjp``s on the CPU.

On the CPU each op's forward is its kernel's plain version and its
backward the port's: flash recomputes through the differentiable plain
attention, the SSD through the chunked algorithm
(``models/mamba2.py::ssd_chunked``), the GMM runs two more grouped
matmuls.  Each is held against ``jax.grad`` through
``repro.kernels.ops.flash_attention_op``, ``ssd_scan_op`` and
``_gmm_op`` (the Pallas kernels in interpret mode forward, the
reference's recompute through ``repro.kernels.ref`` backward: its SSD
token by token, so the port's chunked recompute is checked against
another algorithm), as ``tests/test_kernels.py`` takes them: the
gradient of a fixed random projection of the output, ``sum(out * R)``,
inputs and R made with numpy from a seed.

Tolerances: fp32 1e-4 (``tests/test_kernels.py``'s for the flash
gradient; both sides sum in other orders, the SSD's through another
algorithm) and 1e-5 for the exact GMM.  ``gradcheck`` holds each backward
to finite differences of its own forward in float64; the plain versions
compute in fp32 whatever their inputs, so it takes eps 1e-3 and
tolerances 1e-3 (fp32 rounding over an eps of 1e-3 is ~1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import ops

F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _both(a):
    a = np.ascontiguousarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy()).requires_grad_()


def _grads_port(fn, tensors, proj):
    out = fn(*tensors)
    (out * torch.from_numpy(proj)).sum().backward()
    return [t.grad.numpy() for t in tensors], out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, Sq, Sk, H, K, hd, causal, window)
    (1, 64, 64, 2, 2, 32, True, None),     # causal
    (2, 48, 48, 4, 2, 32, True, 16),       # windowed, GQA
    (1, 40, 40, 8, 2, 16, True, None),     # GQA 4 queries per KV head
    (2, 24, 40, 4, 2, 32, False, None),    # Sq != Sk, non-causal (cross)
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_gradient_matches_the_reference(case):
    B, Sq, Sk, H, K, hd, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    (jq, q), (jk, k), (jv, v) = (_both(rng.standard_normal(s)) for s in (
        (B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    proj = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)

    def j_loss(q_, k_, v_):
        return (j_ops.flash_attention_op(q_, k_, v_, causal, window)
                * proj).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
    got, out = _grads_port(lambda *t: ops.flash_attention_op(
        *t, causal=causal, window=window), (q, k, v), proj)
    assert out.shape == (B, Sq, H, hd)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_CASES = [
    # (b, S, H, P, G, N, chunk)
    (1, 64, 2, 16, 1, 16, 16),     # four chunks
    (2, 40, 4, 8, 2, 8, 16),       # G < H, a ragged last chunk
]


def _ssd_inputs(rng, b, S, H, P, G, N):
    return (rng.standard_normal((b, S, H, P)) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, S, H)))) * 0.1,
            rng.standard_normal((b, S, G, N)) * 0.5,
            rng.standard_normal((b, S, G, N)) * 0.5,
            -np.linspace(1.0, 4.0, H))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_gradient_matches_the_reference(case):
    b, S, H, P, G, N, chunk = case
    rng = np.random.default_rng(sum(case))
    pairs = [_both(a) for a in _ssd_inputs(rng, b, S, H, P, G, N)]
    proj = rng.standard_normal((b, S, H, P)).astype(np.float32)

    def j_loss(*a):
        return (j_ops.ssd_scan_op(*a, chunk) * proj).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*(j for j, _ in pairs))
    got, _ = _grads_port(lambda *t: ops.ssd_scan_op(*t, chunk=chunk),
                         [t for _, t in pairs], proj)
    for g, w, name in zip(got, want, ("x", "dt", "B", "C", "A")):
        np.testing.assert_allclose(g, np.asarray(w), **F32_TOL,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (3, 13, 40, 20)])
def test_gmm_gradient_matches_the_reference(shape):
    """Exact two-GMM backward; M 13 is ragged against every tile."""
    e, m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    (jl, lhs), (jr, rhs) = _both(rng.standard_normal((e, m, k))), \
        _both(rng.standard_normal((e, k, n)))
    proj = rng.standard_normal((e, m, n)).astype(np.float32)
    want = jax.grad(lambda a, b_: (j_ops._gmm_op(a, b_) * proj).sum(),
                    argnums=(0, 1))(jl, jr)
    got, _ = _grads_port(ops.grouped_matmul, (lhs, rhs), proj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_gmm_backward_runs_two_more_grouped_matmuls(monkeypatch):
    """The backward is d_lhs = gmm(g, rhsᵀ) and d_rhs = gmm(lhsᵀ, g),
    each through the kernel wrapper (which counts a launch on the card),
    with contiguous operands."""
    calls = []
    kernel = ops._gmm_kernel

    def counting(a, b):
        assert a.is_contiguous() and b.is_contiguous()
        calls.append((tuple(a.shape), tuple(b.shape)))
        return kernel(a, b)

    monkeypatch.setattr(ops, "_gmm_kernel", counting)
    lhs = torch.randn(2, 5, 6, requires_grad=True)
    rhs = torch.randn(2, 6, 3, requires_grad=True)
    ops.grouped_matmul(lhs, rhs).sum().backward()
    assert calls == [((2, 5, 6), (2, 6, 3)), ((2, 5, 3), (2, 3, 6)),
                     ((2, 6, 5), (2, 5, 3))]


# ---------------------------------------------------------------------------
# gradcheck, float64, the CPU path
# ---------------------------------------------------------------------------

GRADCHECK = dict(eps=1e-3, atol=1e-3, rtol=1e-3)


def _f64(rng, *shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("causal,window,sk", [(True, None, 6), (True, 3, 6),
                                               (False, None, 9)])
def test_flash_gradcheck(causal, window, sk):
    rng = np.random.default_rng(0)
    q = _f64(rng, 1, 6, 4, 8)
    k, v = _f64(rng, 1, sk, 2, 8), _f64(rng, 1, sk, 2, 8)
    assert torch.autograd.gradcheck(lambda *t: ops.flash_attention_op(
        *t, causal=causal, window=window), (q, k, v), **GRADCHECK)


def test_ssd_gradcheck():
    rng = np.random.default_rng(1)
    x = _f64(rng, 1, 20, 2, 4, scale=0.5)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((1, 20, 2))))
                      * 0.2, dtype=torch.float64, requires_grad=True)
    B, C = _f64(rng, 1, 20, 1, 3, scale=0.5), _f64(rng, 1, 20, 1, 3,
                                                   scale=0.5)
    A = torch.tensor([-1.0, -2.5], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *t: ops.ssd_scan_op(
        *t, chunk=16), (x, dt, B, C, A), **GRADCHECK)


def test_gmm_gradcheck():
    rng = np.random.default_rng(2)
    assert torch.autograd.gradcheck(
        ops.grouped_matmul, (_f64(rng, 2, 3, 5), _f64(rng, 2, 5, 4)),
        **GRADCHECK)
