"""The port's model kernels (flash attention, SSD scan, grouped matmul).

On the CPU each wrapper runs its kernel's plain version.  Here every plain
version is held, on the shapes of ``tests/test_kernels.py`` (odd lengths
that the reference pads, GQA and MQA, causal with and without a window,
several SSD chunks, grouped B/C, bf16 dt, ragged GMM dimensions), against
both the JAX package's Pallas kernel run through ``repro.kernels.ops`` in
interpret mode and its pure-jnp oracle in ``repro.kernels.ref``.  Inputs
are made with numpy from a seed and handed to both packages.

Tolerances: fp32 2e-5 (``tests/test_kernels.py``'s; the two sides sum in
other orders).  bf16: both sides read the same bf16 inputs, compute in
fp32 and round once, so they may differ by one bf16 ulp of the result
(relative 2**-8 to 2**-7): rtol 2**-7, and atol 1e-5 for results near 0.

The kernels themselves run only on a card: the ``gpu`` tests skip here.
The JAX package is imported inside the tests that use it, so the card
tests run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_model_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models.mamba2 import ssd_chunked

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _pair(a, dtype):
    """numpy fp32 array -> (jax array, torch tensor) of ``dtype``, equal
    values (bf16 rounding happens once, on the torch side)."""
    import jax.numpy as jnp
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype)), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    # (B, S, H, K, hd)
    (1, 64, 2, 2, 128),    # aligned, MHA
    (2, 96, 4, 2, 48),     # padded seq + padded hd + GQA
    (1, 128, 8, 1, 64),    # MQA
    (1, 300, 4, 4, 80),    # stablelm-like hd=80
    (2, 48, 4, 2, 128),    # seq < block
]
FLASH_CASES = [("float32", True, None), ("float32", False, None),
               ("bfloat16", True, None), ("float32", True, 32)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(shape, dtype, causal, window):
    from repro.kernels import flash_attention_op as j_flash
    from repro.kernels import ref as jref
    B, S, H, K, hd = shape
    rng = np.random.default_rng(sum(shape))
    jq, q = _pair(rng.standard_normal((B, S, H, hd)), dtype)
    jk, k = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    jv, v = _pair(rng.standard_normal((B, S, K, hd)), dtype)
    out = ops.flash_attention_op(q, k, v, causal=causal, window=window)
    assert out.shape == (B, S, H, hd) and out.dtype == q.dtype
    pallas = j_flash(jq, jk, jv, causal, window, 64, 64)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    want = jref.flash_attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal=causal,
        window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


@pytest.mark.parametrize("shape", [
    # (B, Sq, Sk, H, K, hd): cross-attention, decoder tokens against
    # encoder frames (Whisper's hd 64), Sk ragged against the blocks
    (2, 7, 45, 4, 4, 64), (1, 24, 100, 2, 2, 64), (2, 33, 20, 4, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_at_cross_attention_shapes(shape, dtype):
    """Non-causal with Sq != Sk, as Whisper's cross-attention calls it."""
    from repro.kernels import flash_attention_op as j_flash
    from repro.kernels import ref as jref
    B, Sq, Sk, H, K, hd = shape
    rng = np.random.default_rng(sum(shape))
    jq, q = _pair(rng.standard_normal((B, Sq, H, hd)), dtype)
    jk, k = _pair(rng.standard_normal((B, Sk, K, hd)), dtype)
    jv, v = _pair(rng.standard_normal((B, Sk, K, hd)), dtype)
    out = ops.flash_attention_op(q, k, v, causal=False)
    assert out.shape == (B, Sq, H, hd) and out.dtype == q.dtype
    pallas = j_flash(jq, jk, jv, False, None, 64, 64)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    want = jref.flash_attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal=False).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


def test_flash_plain_kv_len_masks_the_tail():
    """``kv_len`` (the padded-tail mask of the kernel layout) equals
    attention over the first ``kv_len`` keys only."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(3)
    jq, q = _pair(rng.standard_normal((1, 2, 40, 32)), "float32")
    jk, k = _pair(rng.standard_normal((1, 1, 40, 32)), "float32")
    jv, v = _pair(rng.standard_normal((1, 1, 40, 32)), "float32")
    out = fa_mod.flash_attention(q, k, v, causal=False, kv_len=29)
    cut = ref.flash_attention_ref(q, k[:, :, :29], v[:, :, :29],
                                  causal=False)
    np.testing.assert_allclose(_np(out), _np(cut), **F32_TOL)
    want = jref.flash_attention_ref(jq, jk, jv, causal=False, kv_len=29)
    np.testing.assert_allclose(_np(out), _np(want), **F32_TOL)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_SHAPES = [
    # (b, s, h, p, g, n, chunk)
    (1, 64, 2, 16, 1, 16, 16),
    (2, 96, 4, 16, 2, 24, 32),    # padded seq, grouped B/C
    (1, 128, 2, 64, 1, 128, 64),  # mamba2-370m-like head
    (1, 33, 2, 8, 1, 8, 16),      # ragged seq
    (1, 300, 2, 64, 1, 128, 256),  # mamba2-370m's N and chunk, ragged seq
]


def _ssd_inputs(shape, dtype, seed):
    b, s, h, p, g, n, _chunk = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    Bm = rng.standard_normal((b, s, g, n)) * 0.5
    Cm = rng.standard_normal((b, s, g, n)) * 0.5
    A = -np.abs(rng.standard_normal((h,)))
    pairs = [_pair(a, dtype) for a in (x, dt, Bm, Cm)]
    jA, tA = _pair(A, "float32")
    return [p[0] for p in pairs] + [jA], [p[1] for p in pairs] + [tA]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_pallas_and_ref(shape, dtype):
    """x, dt, B and C all in ``dtype`` (the model casts dt to x's dtype,
    so bf16 runs carry a bf16 dt)."""
    from repro.kernels import ref as jref
    from repro.kernels import ssd_scan_op as j_ssd
    chunk = shape[-1]
    jin, tin = _ssd_inputs(shape, dtype, sum(shape))
    y = ops.ssd_scan_op(*tin, chunk=chunk)
    assert y.shape == tin[0].shape and y.dtype == tin[0].dtype
    pallas = j_ssd(*jin, chunk)
    np.testing.assert_allclose(_np(y), _np(pallas), **_tol(dtype))
    jx, jdt, jB, jC, jA = jin
    want = jref.ssd_scan_ref(jx.transpose(0, 2, 1, 3), jdt.transpose(0, 2, 1),
                             jB.transpose(0, 2, 1, 3),
                             jC.transpose(0, 2, 1, 3),
                             jA).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(y), _np(want), **_tol(dtype))


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_matches_reference_chunked_and_plain(chunk):
    """The port's chunked algorithm equals the reference's
    (``mamba2.ssd_chunked``) and the token-by-token plain version."""
    from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
    shape = (2, 40, 4, 8, 2, 8, chunk)
    jin, tin = _ssd_inputs(shape, "float32", 5)
    y = ssd_chunked(*tin, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(j_ssd_chunked(*jin, chunk=chunk)),
                               **F32_TOL)
    np.testing.assert_allclose(_np(y), _np(ops.ssd_scan_op(*tin, chunk)),
                               **F32_TOL)


def test_ssd_chunk_is_clamped_as_the_reference_clamps_it():
    assert [ops.ssd_chunk(256, s) for s in (1, 10, 16, 17, 100, 4096)] == \
        [16, 16, 16, 32, 128, 256]
    assert ops.ssd_chunk(64, 1000) == 64


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

GMM_SHAPES = [
    (1, 8, 16, 8), (3, 24, 40, 56), (4, 128, 128, 128), (2, 130, 257, 64),
]


@pytest.mark.parametrize("shape", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_pallas_and_ref(shape, dtype):
    from repro.kernels import grouped_matmul as j_gmm
    from repro.kernels import ref as jref
    e, m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    jl, lhs = _pair(rng.standard_normal((e, m, k)), dtype)
    jr, rhs = _pair(rng.standard_normal((e, k, n)), dtype)
    out = ops.grouped_matmul(lhs, rhs)
    assert out.shape == (e, m, n) and out.dtype == lhs.dtype
    np.testing.assert_allclose(_np(out), _np(j_gmm(jl, jr, impl="pallas")),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jref.grouped_matmul_ref(jl, jr)),
                               **_tol(dtype))


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------

class _FakeCudaTensor:
    device = torch.device("cuda")


@pytest.mark.parametrize("mod,fn,plain,args", [
    (fa_mod, "flash_attention", "flash_attention_ref", 3),
    (ssd_mod, "ssd_scan", "ssd_scan_ref", 5),
    (gmm_mod, "grouped_matmul", "grouped_matmul_ref", 2)])
def test_cuda_tensor_without_card_raises_and_does_not_fall_back(
        monkeypatch, mod, fn, plain, args):
    """A CUDA tensor reaches the kernel or raises: with no card each
    wrapper raises, never runs its plain version, counts nothing."""
    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(mod, plain, plain_must_not_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wrapper = getattr(mod, fn)
    wrapper.launches = 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wrapper(*[_FakeCudaTensor()] * args)
    assert wrapper.launches == 0


def test_cpu_calls_count_no_launches():
    for w in (fa_mod.flash_attention, ssd_mod.ssd_scan,
              gmm_mod.grouped_matmul):
        w.launches = 0
    q = torch.randn(1, 2, 5, 8)
    fa_mod.flash_attention(q, q, q)
    ssd_mod.ssd_scan(q, q[..., 0], q[:, :1], q[:, :1], -torch.ones(2))
    gmm_mod.grouped_matmul(q[0], q[0].transpose(1, 2))
    assert (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches,
            gmm_mod.grouped_matmul.launches) == (0, 0, 0)


def test_bounds_count_bytes_and_operations():
    """The bounds chip_smoke.py reports: bytes of each operand once, and
    the operations the masks keep (causal: the lower triangle)."""
    q = torch.empty(1, 4, 10, 16, dtype=torch.bfloat16)
    k = torch.empty(1, 2, 10, 16, dtype=torch.bfloat16)
    nbytes, flops = fa_mod.flash_bound(q, k, causal=True)
    assert nbytes == 2 * (2 * 4 * 10 * 16 + 2 * 2 * 10 * 16)
    assert flops == 4 * 16 * 4 * 55
    assert fa_mod.flash_bound(q, k, causal=False)[1] == 4 * 16 * 4 * 100
    lhs = torch.empty(3, 5, 7)
    assert gmm_mod.gmm_bound(lhs, torch.empty(3, 7, 11)) == (
        4 * (3 * 5 * 7 + 3 * 7 * 11 + 3 * 5 * 11), 2 * 3 * 5 * 7 * 11)
    x = torch.empty(1, 2, 32, 4)
    nbytes, flops = ssd_mod.ssd_bound(x, torch.empty(1, 1, 32, 3), chunk=16)
    assert nbytes == 4 * (2 * 2 * 32 * 4 + 2 * 32 + 2 * 32 * 3) + 4 * 2
    # 2 chunks of 16 (136 pairs): C B^T once for the one group, the rest
    # for each of the 2 heads
    assert flops == 2 * (2 * 136 * 3 + 2 * (2 * 136 * 4 + 4 * 16 * 3 * 4))


@pytest.mark.parametrize("h,g,s,p,n,chunk,flops", [
    # Mamba-2 370M's prefill: 16 chunks of 256 (32,896 pairs), one group
    (32, 1, 4096, 64, 128, 256,
     16 * (2 * 32896 * 128 + 32 * (2 * 32896 * 64 + 4 * 256 * 128 * 64))),
    # two groups of two heads, a last chunk cut short (3 chunks of 8)
    (4, 2, 20, 8, 16, 8, 3 * (2 * 2 * 36 * 16
                              + 4 * (2 * 36 * 8 + 4 * 8 * 16 * 8))),
])
def test_ssd_bound_counts_cb_once_per_group(h, g, s, p, n, chunk, flops):
    """The heads of a group share C and B, so C B^T counts once per group
    and chunk; the bound of Mamba-2's shape is then the bytes (35.9 MB at
    3.35 TB/s ~ 10.7 us against ~6.6 GFLOP at 989 TFLOP/s ~ 6.7 us)."""
    x = torch.empty(1, h, s, p, dtype=torch.bfloat16, device="meta")
    B = torch.empty(1, g, s, n, dtype=torch.bfloat16, device="meta")
    nbytes, got = ssd_mod.ssd_bound(x, B, chunk)
    assert got == flops
    assert nbytes == 2 * (2 * h * s * p + h * s + 2 * g * s * n) + 4 * h


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 (no CUDA device visible)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card_tol(dtype):
    # fp32: other summation orders; bf16: one bf16 ulp of the result plus
    # the fp32 reordering of sums of up to a few hundred terms
    return dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(dtype):
    _need_card()
    g = torch.Generator("cuda").manual_seed(0)
    # (B, Sq, Sk, H, K, hd): the last four Sq != Sk (cross-attention) at
    # hd 64, Sk ragged against the 64-key tiles (1500 = 23 x 64 + 28)
    for (B, S, Sk, H, K, hd), causal, window in (
            ((2, 96, 96, 4, 2, 48), True, None),
            ((1, 300, 300, 4, 4, 80), False, None),
            ((1, 200, 200, 8, 2, 128), True, 37),
            ((2, 33, 33, 2, 1, 32), True, None),
            ((2, 448, 1500, 4, 4, 64), False, None),
            ((3, 100, 37, 2, 2, 64), False, None),
            ((1, 130, 70, 4, 2, 64), True, None),
            ((2, 64, 64, 4, 4, 64), False, None)):
        q = torch.randn(B, H, S, hd, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, K, Sk, hd, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, K, Sk, hd, generator=g, device="cuda").to(dtype)
        before = fa_mod.flash_attention.launches
        variant = "f32" if dtype == torch.float32 else "wgmma_tma"
        by = fa_mod.flash_attention.launches_by_variant[variant]
        out = fa_mod.flash_attention(q, k, v, causal=causal, window=window,
                                     kv_len=Sk - 3)
        torch.cuda.synchronize()
        assert fa_mod.flash_attention.launches == before + 1
        assert fa_mod.flash_attention.launches_by_variant[variant] == by + 1
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       kv_len=Sk - 3)
        torch.testing.assert_close(out.float(), want.float(),
                                   **_card_tol(dtype))


def _launched(wrapper, fn):
    """Run ``fn``, synchronise, and return the variants of ``wrapper`` it
    launched, with the result."""
    before = dict(wrapper.launches_by_variant)
    out = fn()
    torch.cuda.synchronize()
    return [k for k, v in wrapper.launches_by_variant.items()
            if v != before[k]], out


@pytest.mark.gpu
def test_flash_tensor_core_variants_on_card():
    """The bf16 kernel at the main path's shape (Jamba's prefill, causal,
    GQA 32/8, hd 128: ``wgmma_tma``) and where TMA cannot describe the rows
    (hd 33, and q not 16-byte aligned: ``wgmma_loads``)."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    cases = [(rnd(1, 32, 4096, 128), rnd(1, 8, 4096, 128),
              rnd(1, 8, 4096, 128), True, None, "wgmma_tma"),
             (rnd(1, 2, 70, 33), rnd(1, 1, 70, 33), rnd(1, 1, 70, 33), True,
              None, "wgmma_loads"),
             (rnd(2 * 64 * 64 + 8)[1:1 + 2 * 64 * 64].view(1, 2, 64, 64),
              rnd(1, 2, 64, 64), rnd(1, 2, 64, 64), False, 20,
              "wgmma_loads")]
    for q, k, v, causal, window, variant in cases:
        ran, out = _launched(fa_mod.flash_attention, lambda: fa_mod
                             .flash_attention(q, k, v, causal=causal,
                                              window=window))
        assert ran == [variant]
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out.float(), want.float(),
                                   **_card_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_on_card(dtype):
    """Both variants against the plain version: bf16 shapes with the chunk
    a multiple of 64, N of 16 and P of 8 run ``tensor_core`` (S ragged
    against the chunk, G < H, N 16 to 128, P 8 to 64), the rest, x one
    element off 16-byte alignment, and all of fp32 ``cuda_core`` (at
    N = 128, P = 64 on a chunk of 128 in place of 256)."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(1)
    for b, s, h, p, gr, n, chunk, off in ((1, 64, 2, 16, 1, 16, 16, 0),
                                          (2, 96, 4, 16, 2, 24, 32, 0),
                                          (1, 128, 2, 64, 1, 128, 64, 0),
                                          (1, 300, 4, 64, 1, 16, 256, 0),
                                          (1, 33, 2, 8, 1, 8, 16, 0),
                                          (2, 200, 4, 32, 2, 32, 64, 0),
                                          (1, 131, 6, 8, 3, 64, 128, 0),
                                          (1, 700, 2, 64, 1, 48, 192, 0),
                                          (1, 4096, 8, 64, 1, 16, 256, 0),
                                          (1, 300, 4, 64, 1, 128, 256, 0),
                                          (1, 1000, 4, 64, 1, 96, 256, 0),
                                          (1, 300, 4, 64, 1, 16, 256, 1)):
        x = (torch.randn(b, h, s, p, generator=g, device="cuda") * 0.5)
        dt = torch.nn.functional.softplus(
            torch.randn(b, h, s, generator=g, device="cuda")) * 0.1
        Bm = torch.randn(b, gr, s, n, generator=g, device="cuda") * 0.5
        Cm = torch.randn(b, gr, s, n, generator=g, device="cuda") * 0.5
        A = -torch.rand(h, generator=g, device="cuda") - 0.1
        x, dt, Bm, Cm = (t.to(dtype) for t in (x, dt, Bm, Cm))
        if off:      # the same x, a contiguous view off elements in
            x = torch.cat([x.new_zeros(off), x.reshape(-1)])[off:] \
                .view(b, h, s, p)
        aligned = x.data_ptr() % 16 == 0
        assert aligned == (off == 0)
        before = ssd_mod.ssd_scan.launches
        ran, y = _launched(ssd_mod.ssd_scan, lambda: ssd_mod.ssd_scan(
            x, dt, Bm, Cm, A, chunk=chunk))
        assert ssd_mod.ssd_scan.launches == before + 1
        assert ran == [ssd_mod.ssd_variant(dtype, chunk, n, p, aligned)]
        assert ran == ["tensor_core" if dtype == torch.bfloat16 and aligned
                       and chunk % 64 == 0 and n % 16 == 0 and n <= 128
                       and p % 8 == 0 else "cuda_core"]
        torch.testing.assert_close(y.float(),
                                   ref.ssd_scan_ref(x, dt, Bm, Cm, A).float(),
                                   **_card_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain_on_card(dtype):
    _need_card()
    g = torch.Generator("cuda").manual_seed(2)
    for (e, m, k, n), variant in (((1, 8, 16, 8), "decode"),
                                  ((3, 24, 40, 56), "decode"),
                                  ((2, 130, 257, 64), "ragged"),
                                  ((4, 200, 512, 384), "tma"),
                                  ((2, 8, 1000, 136), "decode")):
        lhs = torch.randn(e, m, k, generator=g, device="cuda").to(dtype)
        rhs = (torch.randn(e, k, n, generator=g, device="cuda")
               * k ** -0.5).to(dtype)
        before = gmm_mod.grouped_matmul.launches
        ran, out = _launched(gmm_mod.grouped_matmul,
                             lambda: gmm_mod.grouped_matmul(lhs, rhs))
        assert gmm_mod.grouped_matmul.launches == before + 1
        assert ran == ["f32" if dtype == torch.float32 else variant]
        torch.testing.assert_close(out.float(),
                                   ref.grouped_matmul_ref(lhs, rhs).float(),
                                   **_card_tol(dtype))


@pytest.mark.gpu
def test_gmm_variants_at_main_path_shapes_on_card():
    """bf16 at Jamba's shapes: the prefill gate/up product through ``tma``,
    a decode tick's (4 slots, 8 capacity rows) gate/up and down through
    ``decode``; and an operand that does not start on 16 bytes through
    ``ragged``."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(4)

    def pair(e, m, k, n):
        return (torch.randn(e, m, k, generator=g, device="cuda").bfloat16(),
                (torch.randn(e, k, n, generator=g, device="cuda")
                 * k ** -0.5).bfloat16())

    base = torch.randn(2 * 72 * 128 + 8, generator=g, device="cuda")
    cases = [(*pair(16, 648, 4096, 14336), "tma"),
             (*pair(16, 8, 4096, 14336), "decode"),
             (*pair(16, 8, 14336, 4096), "decode"),
             (base.bfloat16()[1:1 + 2 * 72 * 128].view(2, 72, 128),
              pair(2, 72, 128, 64)[1], "ragged")]
    for lhs, rhs, variant in cases:
        ran, out = _launched(gmm_mod.grouped_matmul,
                             lambda: gmm_mod.grouped_matmul(lhs, rhs))
        assert ran == [variant]
        torch.testing.assert_close(out.float(),
                                   ref.grouped_matmul_ref(lhs, rhs).float(),
                                   **_card_tol(torch.bfloat16))
        del out


@pytest.mark.gpu
def test_kernels_refuse_wrong_dtype_or_layout_on_card():
    """A wrong dtype, a non-contiguous tensor or mixed dtypes on the card
    raise before any launch."""
    _need_card()
    q = torch.randn(1, 2, 16, 32, device="cuda")
    q_t = torch.randn(1, 2, 32, 16, device="cuda").transpose(2, 3)
    x = torch.randn(1, 2, 16, 8, device="cuda")
    x_t = torch.randn(1, 2, 8, 16, device="cuda").transpose(2, 3)
    A = -torch.ones(2, device="cuda")
    lhs = torch.randn(2, 8, 16, device="cuda")
    launches = (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches,
                gmm_mod.grouped_matmul.launches)
    for bad in (lambda: fa_mod.flash_attention(q.half(), q.half(), q.half()),
                lambda: fa_mod.flash_attention(q_t, q, q),
                lambda: fa_mod.flash_attention(q, q.bfloat16(), q),
                lambda: ssd_mod.ssd_scan(x.double(), x[..., 0].double(),
                                         x.double(), x.double(), A),
                lambda: ssd_mod.ssd_scan(x, x[..., 0], x, x, A.bfloat16()),
                lambda: ssd_mod.ssd_scan(x_t, x[..., 0], x, x, A),
                lambda: gmm_mod.grouped_matmul(lhs.half(),
                                               lhs.half().transpose(1, 2)),
                lambda: gmm_mod.grouped_matmul(lhs, lhs.transpose(1, 2)),
                lambda: gmm_mod.grouped_matmul(lhs, lhs.transpose(1, 2)
                                               .contiguous().bfloat16())):
        with pytest.raises(ValueError):
            bad()
    assert launches == (fa_mod.flash_attention.launches,
                        ssd_mod.ssd_scan.launches,
                        gmm_mod.grouped_matmul.launches)


@pytest.mark.gpu
def test_reduced_jamba_on_card_matches_cpu():
    """The reduced Jamba (fp32) through the kernels on the card against
    the plain versions on the CPU: forward logits within 2e-4 (the
    tolerance of tests/test_models.py), every kernel launched, and the
    ``Server``'s greedy tokens identical."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_params
    cfg = reduced_config(get_config("jamba-v0.1-52b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = {k: v.cuda() for k, v in cpu_params.items()}
    Model = get_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    before = (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches,
              gmm_mod.grouped_matmul.launches)
    on_card, _ = Model(cfg, "cuda", params=card_params)(tokens.cuda())
    torch.cuda.synchronize()
    after = (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches,
             gmm_mod.grouped_matmul.launches)
    assert all(a > b for a, b in zip(after, before))
    on_cpu, _ = Model(cfg, "cpu", params=cpu_params)(tokens)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=2e-4, atol=2e-4)
    outs = []
    for dev, params in (("cuda", card_params), ("cpu", cpu_params)):
        server = Server(cfg, slots=2, max_seq=32, device=dev, params=params)
        for i in range(3):
            server.submit(Request(rid=i, max_new=5, prompt=np.arange(
                3 + i, dtype=np.int32) * 7 + i))
        server.run(tick_limit=100)
        outs.append([r.out for r in sorted(server.completed,
                                           key=lambda r: r.rid)])
    assert outs[0] == outs[1] and all(len(o) == 5 for o in outs[0])


@pytest.mark.gpu
def test_flash_window_and_head_dims_of_this_slice_on_card():
    """bf16 flash with a sliding window at a query length that is not a
    multiple of the 128-row block or the 64-key tile (the window's left
    edge skips whole KV tiles and masks inside others), and at StableLM's
    hd = 80 (two 64-column blocks, zero-filled past hd): ``wgmma_tma``
    against the plain version."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    for (H, K, S, hd), window in (((8, 2, 1000, 128), 300),
                                  ((4, 1, 777, 128), 64),
                                  ((4, 4, 513, 80), None),
                                  ((4, 2, 700, 80), 129)):
        q, k, v = rnd(1, H, S, hd), rnd(1, K, S, hd), rnd(1, K, S, hd)
        ran, out = _launched(fa_mod.flash_attention, lambda: fa_mod
                             .flash_attention(q, k, v, causal=True,
                                              window=window))
        assert ran == ["wgmma_tma"]
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.testing.assert_close(out.float(), want.float(),
                                   **_card_tol(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_at_mamba2_widths_on_card(dtype):
    """Mamba-2 370M's SSD call at full width (x (1, 32, 4096, 64), N =
    128, chunk 256): ``tensor_core`` in bf16, ``cuda_core`` in fp32."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(6)
    h, s, p, n = 32, 4096, 64, 128
    x = (torch.randn(1, h, s, p, generator=g, device="cuda") * 0.5).to(dtype)
    dt = (torch.nn.functional.softplus(torch.randn(
        1, h, s, generator=g, device="cuda")) * 0.1).to(dtype)
    Bm = (torch.randn(1, 1, s, n, generator=g, device="cuda") * 0.5).to(dtype)
    Cm = (torch.randn(1, 1, s, n, generator=g, device="cuda") * 0.5).to(dtype)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    ran, y = _launched(ssd_mod.ssd_scan, lambda: ssd_mod.ssd_scan(
        x, dt, Bm, Cm, A, chunk=256))
    assert ran == ["tensor_core" if dtype == torch.bfloat16 else "cuda_core"]
    torch.testing.assert_close(y.float(),
                               ref.ssd_scan_ref(x, dt, Bm, Cm, A).float(),
                               **_card_tol(dtype))


@pytest.mark.gpu
def test_gmm_at_mixtral_and_moonshot_shapes_on_card():
    """bf16 GMM at Mixtral's E = 8 (a 1 x 8192 prefill's 2568 capacity
    rows, the last 128-row tile ragged, through ``tma``; a decode tick's
    8 rows through ``decode``) and Moonshot's E = 64 with N = 1408, whose
    last 256-wide tile is partial."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(7)

    def pair(e, m, k, n):
        return (torch.randn(e, m, k, generator=g, device="cuda").bfloat16(),
                (torch.randn(e, k, n, generator=g, device="cuda")
                 * k ** -0.5).bfloat16())

    for shape, variant in (((8, 2568, 4096, 14336), "tma"),
                           ((8, 2568, 14336, 4096), "tma"),
                           ((8, 8, 4096, 14336), "decode"),
                           ((64, 200, 2048, 1408), "tma"),
                           ((64, 200, 1408, 2048), "tma"),
                           ((64, 8, 2048, 1408), "decode")):
        lhs, rhs = pair(*shape)
        ran, out = _launched(gmm_mod.grouped_matmul,
                             lambda: gmm_mod.grouped_matmul(lhs, rhs))
        assert ran == [variant]
        torch.testing.assert_close(out.float(),
                                   ref.grouped_matmul_ref(lhs, rhs).float(),
                                   **_card_tol(torch.bfloat16))
        del lhs, rhs, out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-vl-72b",
                                  "mamba2-370m"])
def test_reduced_models_on_card_match_cpu(arch):
    """The reduced Mixtral (window 16, 50 tokens: teacher-forced decode
    wraps its cache three times), Qwen2-VL (distinct (3, B, S) positions) and
    Mamba-2 LM, fp32, through the kernels on the card against the plain
    versions on the CPU: forward logits within 2e-4, every kernel of the
    model launched; decode on the card against its forward."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_params
    cfg = reduced_config(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    Model = get_model(cfg)
    card = Model(cfg, "cuda", params={k: v.cuda()
                                      for k, v in cpu_params.items()})
    S = 50
    tokens = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(1))
    pos = None
    if cfg.mrope_sections is not None:
        pos = torch.stack([torch.arange(S) // 4, torch.arange(S) // 2,
                           torch.arange(S)])[:, None].expand(3, 2, S)
    wrappers = {"flash": fa_mod.flash_attention, "ssd": ssd_mod.ssd_scan,
                "gmm": gmm_mod.grouped_matmul}
    want = {"flash": cfg.family != "ssm", "ssd": cfg.family == "ssm",
            "gmm": cfg.moe is not None}
    before = {k: w.launches for k, w in wrappers.items()}
    on_card, _ = card(tokens.cuda(), positions=None if pos is None
                      else pos.cuda())
    torch.cuda.synchronize()
    assert {k: w.launches > before[k] for k, w in wrappers.items()} == want
    on_cpu, _ = Model(cfg, "cpu", params=cpu_params)(tokens, positions=pos)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=2e-4, atol=2e-4)
    if pos is None:
        cache = card.init_cache(2, S)
        steps = []
        for i in range(S):
            lg, cache = card.decode_step(cache, tokens[:, i].cuda())
            steps.append(lg)
        torch.testing.assert_close(torch.stack(steps, 1), on_card,
                                   rtol=2e-4, atol=2e-4)


def _plain_op(kind, *a, **kw):
    """The op of ``kind`` through its kernel's plain version, in the
    models' layouts, differentiable by autograd alone."""
    t = lambda x: x.transpose(1, 2)   # noqa: E731
    if kind == "flash":
        q, k, v = a
        return t(ref.flash_attention_ref(t(q), t(k), t(v), **kw))
    if kind == "ssd":
        x, dt, B, C, A = a
        return t(ref.ssd_scan_ref(t(x), t(dt), t(B), t(C), A))
    return ref.grouped_matmul_ref(*a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_ops_kernel_against_plain_on_card(dtype):
    """Each op's gradient of a fixed random projection of its output,
    through the kernel-backed op (forward: the kernel; backward: the
    recompute, or for the GMM two more kernel launches) and through the
    plain version by autograd, on the same card tensors: causal, windowed
    GQA and Sq != Sk flash; an SSD of several chunks with G < H; a ragged
    GMM.  fp32 within 1e-3 of the gradient's largest magnitude (the SSD's
    recompute is another algorithm than the token-by-token plain
    version); bf16 within 2e-2 of it (bf16 rounds the op's output and the
    gradients)."""
    _need_card()
    g = torch.Generator("cuda").manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                ).to(dtype).requires_grad_()

    cases = [
        ("flash", fa_mod.flash_attention,
         (rnd(1, 200, 4, 64), rnd(1, 200, 2, 64), rnd(1, 200, 2, 64)),
         dict(causal=True, window=None), 0),
        ("flash", fa_mod.flash_attention,
         (rnd(2, 96, 8, 128), rnd(2, 96, 2, 128), rnd(2, 96, 2, 128)),
         dict(causal=True, window=40), 0),
        ("flash", fa_mod.flash_attention,
         (rnd(2, 48, 4, 64), rnd(2, 130, 4, 64), rnd(2, 130, 4, 64)),
         dict(causal=False, window=None), 0),
        ("ssd", ssd_mod.ssd_scan,
         (rnd(1, 160, 4, 64, scale=0.5),
          (torch.nn.functional.softplus(torch.randn(
              1, 160, 4, generator=g, device="cuda")) * 0.1).to(dtype)
          .requires_grad_(),
          rnd(1, 160, 2, 128, scale=0.5), rnd(1, 160, 2, 128, scale=0.5),
          (-torch.linspace(1.0, 8.0, 4, device="cuda")).requires_grad_()),
         dict(chunk=64), 0),
        ("gmm", gmm_mod.grouped_matmul,
         (rnd(4, 100, 256), rnd(4, 256, 192, scale=1 / 16)), {}, 2),
    ]
    for kind, wrapper, args, kw, bwd_launches in cases:
        out_shape = _plain_op(kind, *args, **{k: v for k, v in kw.items()
                                              if k != "chunk"}).shape
        proj = torch.randn(out_shape, generator=g, device="cuda").to(dtype)
        op = {"flash": ops.flash_attention_op, "ssd": ops.ssd_scan_op,
              "gmm": ops.grouped_matmul}[kind]
        before = wrapper.launches
        out = op(*args, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, kind
        got = torch.autograd.grad((out.float() * proj.float()).sum(), args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1 + bwd_launches, kind
        want = torch.autograd.grad(
            (_plain_op(kind, *args, **{k: v for k, v in kw.items()
                                       if k != "chunk"}).float()
             * proj.float()).sum(), args)
        rel = 1e-3 if dtype == torch.float32 else 2e-2
        for a, b in zip(got, want):
            scale = float(b.float().abs().max())
            torch.testing.assert_close(a.float(), b.float(), rtol=rel,
                                       atol=rel * scale)
