"""The tensor-core variants of the port's flash-attention, grouped-matmul
and SSD-scan kernels, as far as the CPU can hold them.

The kernels (``csrc/flash_attention.cu``, ``csrc/moe_gmm.cu``,
``csrc/ssd_scan.cu``) run only on
a card (``tests/test_torch_model_kernels.py``'s ``gpu`` tests and
``chip_smoke.py``).  Here:

* the GMM variant is a pure function of shape and alignment, and the main
  path's shapes (Jamba's prefill, its down projection and decode at 1, 4
  and 8 slots) select ``tma`` and ``decode``, while rows TMA cannot
  describe select ``ragged``;
* the tiles, TMA boxes, stage bytes and shared memory of the CUDA
  sources, evaluated from their own constants, fit the card;
* the 128-byte swizzle TMA writes and the wgmma descriptors the kernels
  build describe the same tile;
* a plain PyTorch emulation of the flash kernel's arithmetic (64-row query
  tiles, 64-key tiles, online softmax in fp32, P as bf16 hi + lo, fp32
  accumulation) meets the card tolerance against the plain version and the
  Pallas kernel in interpret mode, and misses it with P rounded to bf16
  alone: why the kernel splits P;
* the SSD variant is a pure function of dtype and shape, and a plain
  PyTorch emulation of the tensor-core variant's three chunk-parallel
  passes (B o w and W as bf16 hi + lo against exact bf16 x) meets the card
  tolerance against the plain version and the Pallas kernel in interpret
  mode.

The card tolerance is ``chip_smoke.py``'s for bf16: one bf16 ulp of the
reference plus 1e-3 of its RMS.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.moe import capacity

CSRC = Path(gmm_mod.__file__).resolve().parent / "csrc"
JAMBA = get_config("jamba-v0.1-52b")


SMEM_PER_BLOCK = 232448     # 227 KB: what a block may ask for on an H100
SMEM_PER_SM = 233472        # 228 KB an SM, 1 KB of it reserved per block


def _constants(name):
    """The ``constexpr int`` constants of ``csrc/<name>`` that are integer
    expressions of earlier ones."""
    text = (CSRC / name).read_text()
    out = {}
    for decl in re.findall(r"constexpr int ([^;{]+);", text):
        for m in re.finditer(r"(\w+) = ([\w\s*+()/-]+)", decl):
            try:
                out[m.group(1)] = int(eval(m.group(2), {}, dict(out)))
            except NameError:          # a template parameter
                pass
    return out


def _functions(name):
    """The one-line ``constexpr int f(int x) { return ...; }`` functions
    of ``csrc/<name>``, as Python functions of x over its constants."""
    text = (CSRC / name).read_text()
    consts = _constants(name)
    return {f: (lambda expr, arg: lambda x: int(eval(
        expr, {}, {**consts, arg: x})))(expr, arg)
        for f, arg, expr in re.findall(
            r"constexpr int (\w+)\(int (\w+)\) \{\s*return ([^;]+);",
            text)}


# ---------------------------------------------------------------------------
# GMM: which variant
# ---------------------------------------------------------------------------

def _main_path_gmms():
    """(what, E, M, K, N) of the expert FFN's two products in a prefill of
    1 x 4096 tokens and in a decode tick at 1, 4 and 8 slots."""
    e, d, f = JAMBA.moe.num_experts, JAMBA.d_model, JAMBA.moe.d_ff_expert
    out = []
    for what, tokens in (("prefill", 4096), ("decode 1 slot", 1),
                         ("decode 4 slots", 4), ("decode 8 slots", 8)):
        m = capacity(tokens, JAMBA.moe)
        out += [(f"{what} gate/up", e, m, d, f), (f"{what} down", e, m, f, d)]
    return out


@pytest.mark.parametrize("what,e,m,k,n", _main_path_gmms())
def test_main_path_gmms_take_the_tma_variants(what, e, m, k, n):
    """A prefill's products run ``tma`` (its gate/up pair fused as
    ``tma_swiglu``), a decode tick's ``decode`` (never fused)."""
    want = "tma" if what.startswith("prefill") else "decode"
    assert gmm_mod.gmm_variant(m, k, n) == want
    lhs = torch.empty(e, m, k, dtype=torch.bfloat16)
    rhs = torch.empty(e, k, n, dtype=torch.bfloat16)
    variant, mp = gmm_mod.gmm_plan(lhs, rhs)
    assert variant == want
    assert mp == (8 if want == "decode" else 0)
    if what.endswith("gate/up"):
        assert gmm_mod.swiglu_plan(lhs, rhs, rhs) == (
            "tma_swiglu" if want == "tma" else None)


@pytest.mark.parametrize("shape,want", [
    ((2, 130, 257, 64), "ragged"),   # a row of K = 257 bf16 is 514 bytes
    ((3, 24, 41, 56), "ragged"),     # K = 41: 82 bytes
    ((2, 200, 64, 100), "ragged"),   # N = 100: 200 bytes
    ((1, 8, 16, 8), "decode"),       # 32- and 16-byte rows: TMA takes them
    ((3, 24, 40, 56), "decode"),     # 80- and 112-byte rows, ragged tiles
    ((4, 200, 512, 384), "tma"),
    ((2, 64, 128, 64), "decode"),    # M = 64: the widest swapped product
    ((2, 65, 128, 128), "tma"),
])
def test_gmm_variant_follows_shape(shape, want):
    """A row of K or N bf16 values must be a multiple of 16 bytes for a
    TMA map; the tiles themselves may be ragged (TMA zero-fills at each
    expert's own edge)."""
    e, m, k, n = shape
    assert gmm_mod.gmm_variant(m, k, n) == want


def test_gmm_unaligned_operands_take_the_ragged_variant():
    """An operand that does not start on 16 bytes (a view with a storage
    offset) cannot be a TMA map's base: ``ragged``, whatever the shape."""
    e, m, k, n = 2, 648, 128, 256
    base = torch.empty(e * m * k + 8, dtype=torch.bfloat16)
    lhs = base[1:1 + e * m * k].view(e, m, k)
    rhs = torch.empty(e, k, n, dtype=torch.bfloat16)
    assert lhs.data_ptr() % 16 != 0
    assert gmm_mod.gmm_plan(lhs, rhs) == ("ragged", 0)
    assert gmm_mod.gmm_plan(lhs.clone(), rhs)[0] == "tma"
    assert gmm_mod.gmm_variant(m, k, n, aligned=False) == "ragged"
    assert gmm_mod.gmm_plan(lhs.float(), rhs.float()) == ("f32", 0)


@pytest.mark.parametrize("m,mp", [(1, 8), (8, 8), (9, 16), (16, 16),
                                  (17, 32), (33, 64), (64, 64)])
def test_decode_pads_m_to_the_next_wgmma_width(m, mp):
    lhs = torch.empty(2, m, 64, dtype=torch.bfloat16)
    rhs = torch.empty(2, 64, 64, dtype=torch.bfloat16)
    assert gmm_mod.gmm_plan(lhs, rhs) == ("decode", mp)


# ---------------------------------------------------------------------------
# GMM: the kernel source's tiles fit the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,mp", [("tma", 0), ("decode", 8),
                                        ("decode", 16), ("decode", 32),
                                        ("decode", 64)])
def test_gmm_kernel_constants_fit_the_card(variant, mp):
    """The tiles of csrc/moe_gmm.cu, as its launchers use them: every TMA
    box 64 bf16 wide (128 bytes, the swizzle span) and at most 256 rows,
    stages that keep 1024-byte alignment, a producer warp beside the
    consumer warpgroups, and the shared memory a block asks for within
    the card's 227 KB; the rhs tile splits evenly over a cluster, and two
    decode blocks fit an SM at MP = 8.  ``tma_swiglu`` (the same kernel)
    splits the tile into halves of whole boxes, one a weight, and block c
    of the cluster loads weight c's half."""
    c = _constants("moe_gmm.cu")
    if variant == "tma":
        assert c["T_BK"] == 64 and c["T_BM"] <= 256
        assert c["T_BN"] % (64 * c["T_CLUSTER"]) == 0
        assert c["T_BN"] // 2 % 64 == 0 and c["T_CLUSTER"] == 2
        assert c["T_THREADS"] == 128 * c["T_CONSUMERS"] + 32
        assert c["T_BM"] == 64 * c["T_CONSUMERS"]
        assert (c["T_A_BYTES"] + c["T_B_BYTES"]) % 1024 == 0
        assert c["T_SMEM"] <= SMEM_PER_BLOCK
    else:
        d_smem = _functions("moe_gmm.cu")["d_smem"]
        assert c["D_BK"] == 64 and c["D_BN"] % 64 == 0 and mp <= 256
        assert c["D_THREADS"] == 128 + 32
        assert (c["D_W_BYTES"] + mp * c["D_BK"] * 2) % 1024 == 0
        assert d_smem(mp) <= SMEM_PER_BLOCK
        if mp == 8:
            assert 2 * (d_smem(mp) + 1024) <= SMEM_PER_SM


# ---------------------------------------------------------------------------
# 128-byte swizzle and wgmma descriptors
# ---------------------------------------------------------------------------

def _swizzle(addr):
    """Swizzle<3,4,3>: the 16-byte chunk bits 4-6 of an address XOR its
    bits 7-9, as TMA writes with CU_TENSOR_MAP_SWIZZLE_128B."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_write(smem, base, tile):
    """A box of (rows, 64) bf16 (as element ids) written by TMA at byte
    ``base`` (1024-aligned)."""
    rows, cols = tile.shape
    for r in range(rows):
        for c in range(cols):
            smem[_swizzle(base + r * 128 + 2 * c)] = tile[r, c]


def _read_k_major(smem, start, sbo, mn, k=16):
    """A wgmma operand slice (mn x 16) read through a K-major 128-byte
    swizzle descriptor: rows 128 bytes apart within an 8-row atom, atoms
    ``sbo`` apart, k contiguous."""
    return np.array([[smem[_swizzle(start + (i % 8) * 128 + (i // 8) * sbo
                                    + 2 * j)] for j in range(k)]
                     for i in range(mn)])


def _read_mn_major(smem, start, lbo, sbo, mn, k=16):
    """A wgmma operand slice (mn x 16) read through an MN-major
    ("transposed") descriptor: mn contiguous in 64-wide blocks ``lbo``
    apart, k rows 128 bytes apart within an 8-row atom, atoms ``sbo``
    apart."""
    return np.array([[smem[_swizzle(start + 2 * (i % 64) + (i // 64) * lbo
                                    + (j % 8) * 128 + (j // 8) * sbo)]
                      for j in range(k)] for i in range(mn)])


def test_descriptors_read_the_tiles_tma_wrote():
    """The offsets csrc/moe_gmm.cu and csrc/flash_attention.cu give wgmma:
    a K-major operand's k-th 16-wide slice starts 32 k bytes in (SBO 1024);
    an MN-major operand's starts 2048 k bytes in (SBO 1024, LBO one 64-wide
    column block)."""
    rng = np.random.default_rng(0)
    # lhs / Q tile: 128 rows x 64 k, K-major; a warpgroup's 64 rows start
    # 64 x 128 bytes in
    a = rng.permutation(128 * 64).reshape(128, 64)
    smem = {}
    _tma_write(smem, 0, a)
    for wg in range(2):
        for kk in range(4):
            got = _read_k_major(smem, wg * 64 * 128 + 32 * kk, 1024, 64)
            assert np.array_equal(got, a[64 * wg:64 * wg + 64,
                                         16 * kk:16 * kk + 16])
    # rhs / V tile: 64 k rows x 256 n in four boxes of 64 columns, 8 KB
    # apart; the operand is (n x k), n contiguous
    b = rng.permutation(64 * 256).reshape(64, 256)
    smem = {}
    for j in range(4):
        _tma_write(smem, j * 64 * 128, b[:, 64 * j:64 * j + 64])
    for kk in range(4):
        got = _read_mn_major(smem, 2048 * kk, 64 * 128, 1024, 256)
        assert np.array_equal(got, b[16 * kk:16 * kk + 16, :].T)
    # decode's lhs tile: MP = 8 rows of 64 k, one atom, K-major
    x = rng.permutation(8 * 64).reshape(8, 64)
    smem = {}
    _tma_write(smem, 0, x)
    for kk in range(4):
        assert np.array_equal(_read_k_major(smem, 32 * kk, 1024, 8),
                              x[:, 16 * kk:16 * kk + 16])


# ---------------------------------------------------------------------------
# flash: variant, tiles, arithmetic
# ---------------------------------------------------------------------------

def test_flash_variant_and_shared_memory():
    assert fa_mod.flash_variant(torch.float32, 128) == "f32"
    assert fa_mod.flash_variant(torch.bfloat16, 128) == "wgmma_tma"
    assert fa_mod.flash_variant(torch.bfloat16, 80) == "wgmma_tma"
    assert fa_mod.flash_variant(torch.bfloat16, 33) == "wgmma_loads"
    assert fa_mod.flash_variant(torch.bfloat16, 64, aligned=False) == \
        "wgmma_loads"
    # the kernel's shared memory at hd <= 64 (one 64-column block) and
    # hd <= 128 (two), as its launcher asks for it
    w_smem = _functions("flash_attention.cu")["w_smem"]
    c = _constants("flash_attention.cu")
    assert c["W_BM"] == c["W_BQ"] * c["W_WG"] == 128
    assert c["W_THREADS"] == 128 * c["W_WG"] + 32
    assert w_smem(1) < w_smem(2) <= SMEM_PER_BLOCK


def _emulate(q, k, v, causal=True, window=None, kv_len=None, split=True):
    """The bf16 kernel's arithmetic in plain PyTorch: per (batch, head) and
    64-row query tile, 64-key tiles (wholly masked ones skipped), S = Q K^T
    in fp32 scaled in fp32, -1e30 masking, the online softmax in fp32, P
    as bf16 hi (+ bf16 lo = P - hi when ``split``) against bf16 V with fp32
    sums, l floored at 1e-30, one rounding to bf16 at the end."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    lim = min(sk, sk if kv_len is None else kv_len)
    out = torch.empty(b, h, sq, hd)
    neg = torch.tensor(-1e30)
    for bi in range(b):
        for hi_ in range(h):
            qh = q[bi, hi_].float()
            kf = k[bi, hi_ // (h // kh)].float()
            vf = v[bi, hi_ // (h // kh)].float()
            for q0 in range(0, sq, 64):
                qt = qh[q0:q0 + 64]
                rows = torch.arange(q0, q0 + len(qt))[:, None]
                m = torch.full((len(qt),), -1e30)
                l = torch.zeros(len(qt))
                acc = torch.zeros(len(qt), hd)
                for k0 in range(0, sk, 64):
                    keys = torch.arange(k0, min(sk, k0 + 64))[None, :]
                    ok = keys < lim
                    if causal:
                        ok = ok & (keys <= rows)
                    if window is not None:
                        ok = ok & (keys > rows - window)
                    if not bool(ok.any()):
                        continue
                    s = torch.where(ok, (qt @ kf[k0:k0 + 64].T) * scale, neg)
                    m_new = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(s - m_new[:, None]),
                                    torch.tensor(0.0))
                    l = l * alpha + p.sum(1)
                    m = m_new
                    p_hi = p.bfloat16().float()
                    vt = vf[k0:k0 + 64]
                    pv = p_hi @ vt
                    if split:
                        pv = pv + (p - p_hi).bfloat16().float() @ vt
                    acc = acc * alpha[:, None] + pv
                out[bi, hi_, q0:q0 + 64] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _misses(got, want):
    """Outputs beyond one bf16 ulp of ``want`` plus 1e-3 of its RMS."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    tol = ulp + 1e-3 * float(w.square().mean().sqrt())
    return int(((g - w).abs() > tol).sum())


def _bf16_inputs(b, h, kh, sq, sk, hd, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).bfloat16()

    return t(b, h, sq, hd), t(b, kh, sk, hd), t(b, kh, sk, hd)


FLASH_CASES = [
    # (B, H, K, S, hd), causal, window, kv_len cut
    ((1, 2, 1, 256, 64), True, None, 0),
    ((2, 4, 2, 96, 48), True, None, 3),
    ((1, 4, 4, 300, 80), False, None, 3),
    ((1, 8, 2, 200, 128), True, 37, 3),
    ((2, 2, 1, 33, 32), True, None, 0),
]


@pytest.mark.parametrize("shape,causal,window,cut", FLASH_CASES)
def test_flash_emulation_meets_the_card_tolerance(shape, causal, window, cut):
    b, h, kh, s, hd = shape
    q, k, v = _bf16_inputs(b, h, kh, s, s, hd, seed=s + hd)
    kv_len = s - cut
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
    got = _emulate(q, k, v, causal=causal, window=window, kv_len=kv_len)
    assert _misses(got, want) == 0


def test_flash_emulation_with_p_in_bf16_alone_misses_it():
    """Why the kernel splits P: with P rounded to bf16 once before the PV
    product, outputs fall outside one bf16 ulp + 1e-3 RMS of the fp32
    plain version, here at 256 keys (and at Jamba's 4096 many more)."""
    q, k, v = _bf16_inputs(1, 2, 1, 256, 256, 64, seed=0)
    want = flash_attention_ref(q, k, v, causal=True)
    assert _misses(_emulate(q, k, v, split=True), want) == 0
    assert _misses(_emulate(q, k, v, split=False), want) > 100


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 2, 1, 128, 64), True, None), ((1, 4, 2, 96, 48), False, 40)])
def test_flash_emulation_matches_pallas_interpret(shape, causal, window):
    """The emulation against the JAX package's Pallas kernel run in
    interpret mode (its ops.py wrapper pads hd and the sequence), same bf16
    inputs, the card tolerance."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention_op as j_flash
    b, h, kh, s, hd = shape
    q, k, v = _bf16_inputs(b, h, kh, s, s, hd, seed=7)

    def to_jax(t):            # (B, H, S, hd) -> (B, S, H, hd)
        return jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3)).astype(
            jnp.bfloat16)

    pallas = j_flash(to_jax(q), to_jax(k), to_jax(v), causal, window, 64, 64)
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32))
                              ).permute(0, 2, 1, 3).bfloat16()
    assert _misses(_emulate(q, k, v, causal=causal, window=window),
                   pallas) == 0


# ---------------------------------------------------------------------------
# SSD: variant, tiles, arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,chunk,n,p,aligned,want", [
    (torch.bfloat16, 256, 16, 64, True, "tensor_core"),   # Jamba's prefill
    (torch.bfloat16, 64, 32, 8, True, "tensor_core"),
    (torch.bfloat16, 192, 48, 16, True, "tensor_core"),
    (torch.bfloat16, 128, 64, 40, True, "tensor_core"),
    (torch.float32, 256, 16, 64, True, "cuda_core"),      # fp32 stays fp32
    (torch.float32, 16, 16, 64, True, "cuda_core"),       # the reduced Jamba
    (torch.bfloat16, 16, 16, 64, True, "cuda_core"),      # chunk below 64
    (torch.bfloat16, 96, 16, 64, True, "cuda_core"),
    (torch.bfloat16, 256, 24, 64, True, "cuda_core"),     # N not a multiple of 16
    (torch.bfloat16, 64, 128, 64, True, "tensor_core"),   # N in two 128-byte rows
    (torch.bfloat16, 256, 128, 64, True, "tensor_core"),  # Mamba-2 370M's prefill
    (torch.bfloat16, 256, 144, 64, True, "cuda_core"),    # N beyond two rows
    (torch.bfloat16, 256, 16, 12, True, "cuda_core"),     # P not a multiple of 8
    (torch.bfloat16, 256, 16, 64, False, "cuda_core"),    # x, B or C misaligned
])
def test_ssd_variant_follows_shape(dtype, chunk, n, p, aligned, want):
    assert ssd_mod.ssd_variant(dtype, chunk, n, p, aligned) == want


def test_ssd_main_path_takes_the_tensor_core_variant():
    """The full-width prefill's SSD calls (1 x 4096 tokens, bf16, Jamba's
    SSM widths and the chunk ``ops.ssd_chunk`` gives them) select
    ``tensor_core``; the reduced Jamba's (fp32) ``cuda_core``."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import ops
    s = JAMBA.ssm
    chunk = ops.ssd_chunk(s.chunk, 4096)
    assert ssd_mod.ssd_variant(torch.bfloat16, chunk, s.state_dim,
                               s.head_dim) == "tensor_core"
    r = reduced_config(JAMBA).ssm
    assert ssd_mod.ssd_variant(torch.float32, ops.ssd_chunk(r.chunk, 40),
                               r.state_dim, r.head_dim) == "cuda_core"


def test_mamba2_prefill_takes_the_tensor_core_variant():
    """Mamba-2 370M's prefill SSD (1 x 4096, bf16, N = 128, chunk 256)
    selects ``tensor_core`` at its own chunk; fp32 at that shape, which
    raised before the variant took N = 128, runs ``cuda_core`` on the
    largest halving of the chunk whose shared memory fits (128)."""
    from repro_torch.kernels import ops
    s = get_config("mamba2-370m").ssm
    chunk = ops.ssd_chunk(s.chunk, 4096)
    assert (chunk, s.state_dim, s.head_dim) == (256, 128, 64)
    assert ssd_mod.ssd_variant(torch.bfloat16, chunk, s.state_dim,
                               s.head_dim) == "tensor_core"
    assert ssd_mod.ssd_variant(torch.float32, chunk, s.state_dim,
                               s.head_dim) == "cuda_core"
    assert ssd_mod._smem_bytes(256, 64, 128) > ssd_mod.SMEM_BYTES
    assert ssd_mod.cuda_core_chunk(256, 64, 128) == 128
    assert ssd_mod._smem_bytes(128, 64, 128) <= ssd_mod.SMEM_BYTES


@pytest.mark.parametrize("chunk,p,n,want", [
    (256, 64, 16, 256), (16, 64, 16, 16), (256, 64, 128, 128),
    (200, 64, 128, 100), (256, 64, 256, 64), (64, 64, 128, 64)])
def test_cuda_core_chunk_halves_until_it_fits(chunk, p, n, want):
    got = ssd_mod.cuda_core_chunk(chunk, p, n)
    assert got == want
    assert ssd_mod._smem_bytes(got, p, n) <= ssd_mod.SMEM_BYTES
    assert got == chunk or ssd_mod._smem_bytes(chunk, p, n) > \
        ssd_mod.SMEM_BYTES


def _two_arg_functions(name):
    """The one-line ``constexpr int f(int a, int b) { return ...; }``
    functions of ``csrc/<name>``, as Python functions over its constants
    (C's integer division of non-negative ints as ``//``)."""
    text = (CSRC / name).read_text()
    consts = _constants(name)
    return {f: (lambda expr, a1, a2: lambda u, v: int(eval(
        expr.replace("/", "//"), {}, {**consts, a1: u, a2: v})))(expr, a1, a2)
        for f, a1, a2, expr in re.findall(
            r"constexpr int (\w+)\(int (\w+), int (\w+)\) "
            r"\{\s*return ([^;]+);", text)}


@pytest.mark.parametrize("chunk", [64, 128, 192, 256])
def test_ssd_kernel_constants_fit_the_card(chunk):
    """The tensor-core passes' shared memory, evaluated from
    csrc/ssd_scan.cu's own functions and constants at every chunk it takes
    and the largest state (N = 128, P = 64): within a block's 227 KB; two
    blocks of pass 3 fit an SM at Jamba's widths (N 16, P 64, chunk 256);
    x rows are one 128-byte swizzle span, C and B rows up to two; pass 3
    is two warpgroups, pass 1 one."""
    c = _constants("ssd_scan.cu")
    f = _two_arg_functions("ssd_scan.cu")
    assert c["MAX_P"] * 2 == 128 and c["MAX_N"] * 2 == 2 * 128
    assert c["MAX_N"] == ssd_mod.TC_MAX_N
    assert c["TC_ROWS"] == ssd_mod.TC_ROWS == 64
    assert c["MAX_CHUNK"] == ssd_mod.MAX_CHUNK and chunk % c["TC_ROWS"] == 0
    assert c["OUT_THREADS"] == 2 * 128 and c["STATE_THREADS"] == 128
    assert f["out_tc_smem"](chunk, c["MAX_N"]) <= SMEM_PER_BLOCK
    assert f["state_tc_smem"](chunk, c["MAX_N"]) <= SMEM_PER_BLOCK
    # C and B take a second 128-byte column block only past N = 64
    assert f["out_tc_smem"](chunk, 80) - f["out_tc_smem"](chunk, 64) == \
        2 * chunk * 128 + 2 * 16 * 128
    jamba = f["out_tc_smem"](256, JAMBA.ssm.state_dim)
    assert 2 * (jamba + 1024) <= SMEM_PER_SM
    # the cuda_core variant at the shapes it takes on the main path and in
    # the card tests
    for q, p, n in ((256, 64, 16), (16, 64, 16), (64, 64, 128), (32, 16, 24)):
        assert ssd_mod._smem_bytes(q, p, n) <= ssd_mod.SMEM_BYTES


def _ssd_emulate(x, dt, B, C, A, chunk, split=True):
    """The tensor-core variant's arithmetic in plain PyTorch, chunk by
    chunk as its three passes run: the in-chunk prefix of dt A in fp32;
    pass 1 S_c^T = x^T (B o w) with B o w as bf16 hi (+ lo when ``split``)
    against exact bf16 x, fp32 sums; pass 2 the fp32 recurrence of the
    state entering each chunk; pass 3 the inter-chunk term C h with h as
    bf16 hi (+ lo), scaled by exp(cum_i), plus W x with S = C B^T in fp32
    (exact products of bf16), W = S o exp(cum_i - cum_j) o dt_j below the
    diagonal (factored through each 64-column tile's last step off the
    diagonal tile) as bf16 hi (+ lo) against bf16 x; one rounding to bf16
    at the end.  Steps past S are dt = 0 and are not written."""
    b, h, s, p = x.shape
    g, n = B.shape[1], B.shape[3]
    nc = -(-s // chunk)
    out = torch.empty(b, h, s, p)
    zero = torch.tensor(0.0)

    def bf(t):
        return t.bfloat16().float()

    def split2(t):                     # the operand as hi (+ lo)
        hi = bf(t)
        return (hi, bf(t - hi)) if split else (hi,)

    rows = torch.arange(chunk)
    rb, jt = rows[:, None] // 64, rows[None, :] // 64
    end = rows // 64 * 64 + 63            # each column's tile end
    for bi in range(b):
        for hh in range(h):
            gg = hh // (h // g)
            a = float(A[hh])
            hstate = torch.zeros(n, p)
            for c in range(nc):
                c0, c1 = c * chunk, min(s, (c + 1) * chunk)

                def take(t):
                    z = torch.zeros((chunk,) + t.shape[1:])
                    z[:c1 - c0] = t[c0:c1].float()
                    return z

                dtc, xc = take(dt[bi, hh]), take(x[bi, hh])
                Bc, Cc = take(B[bi, gg]), take(C[bi, gg])
                cum = torch.cumsum(dtc * a, 0)
                # pass 1
                bw = Bc * (dtc * torch.exp(cum[-1] - cum))[:, None]
                state_c = sum(xc.T @ part for part in split2(bw)).T
                # pass 3
                y = torch.exp(cum)[:, None] * sum(Cc @ part
                                                  for part in split2(hstate))
                S = Cc @ Bc.T
                off = torch.exp(cum[:, None] - cum[end][None, :]) * (
                    torch.exp(cum[end] - cum) * dtc)[None, :]
                low = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
                on = torch.exp(torch.where(low, cum[:, None] - cum[None, :],
                                           zero)) * dtc[None, :]
                w = torch.where(rb > jt, S * off,
                                torch.where((rb == jt) & low, S * on, zero))
                y = y + sum(part @ xc for part in split2(w))
                out[bi, hh, c0:c1] = y[:c1 - c0]
                # pass 2
                hstate = torch.exp(cum[-1]) * hstate + state_c
    return out.to(x.dtype)


def _ssd_bf16_inputs(b, h, g, s, p, n, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.5):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).bfloat16()

    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (b, h, s)))).astype(np.float32) * 0.1).bfloat16()
    A = -torch.from_numpy(np.linspace(1.0, 4.0, h).astype(np.float32))
    return t(b, h, s, p), dt, t(b, g, s, n), t(b, g, s, n), A


SSD_EMULATION_CASES = [
    # (b, h, g, S, P, N, chunk): S ragged against the chunk, G < H
    (1, 4, 2, 150, 8, 16, 64),
    (2, 2, 1, 200, 16, 32, 64),
    (1, 4, 1, 300, 64, 16, 128),
    (1, 2, 2, 97, 64, 48, 64),
    (1, 2, 1, 300, 64, 128, 256),       # Mamba-2 370M's N and chunk
]


@pytest.mark.parametrize("shape", SSD_EMULATION_CASES)
def test_ssd_emulation_meets_the_card_tolerance(shape):
    """The tensor-core variant's arithmetic against the plain version
    (the token-by-token recurrence) within chip_smoke.py's bf16
    tolerance."""
    b, h, g, s, p, n, chunk = shape
    assert ssd_mod.ssd_variant(torch.bfloat16, chunk, n, p) == "tensor_core"
    x, dt, B, C, A = _ssd_bf16_inputs(b, h, g, s, p, n, seed=s + p)
    want = ssd_mod.ssd_scan_ref(x, dt, B, C, A)
    assert _misses(_ssd_emulate(x, dt, B, C, A, chunk), want) == 0


@pytest.mark.parametrize("shape", SSD_EMULATION_CASES[:2])
def test_ssd_emulation_matches_pallas_interpret(shape):
    """The emulation against the JAX package's Pallas SSD kernel run in
    interpret mode (through its ops.py wrapper, in the models' layout),
    same bf16 inputs, the card tolerance."""
    import jax.numpy as jnp
    from repro.kernels import ssd_scan_op as j_ssd
    b, h, g, s, p, n, chunk = shape
    x, dt, B, C, A = _ssd_bf16_inputs(b, h, g, s, p, n, seed=1)

    def to_jax(t, perm):
        return jnp.asarray(t.float().numpy().transpose(perm)).astype(
            jnp.bfloat16)

    pallas = j_ssd(to_jax(x, (0, 2, 1, 3)), to_jax(dt, (0, 2, 1)),
                   to_jax(B, (0, 2, 1, 3)), to_jax(C, (0, 2, 1, 3)),
                   jnp.asarray(A.numpy()), chunk)
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32))
                              ).permute(0, 2, 1, 3).bfloat16()
    assert _misses(_ssd_emulate(x, dt, B, C, A, chunk), pallas) == 0


def test_ssd_emulation_without_the_split_misses_it():
    """Why the kernel splits W, B o w and h: with each rounded to bf16 once,
    thousands of outputs fall outside one bf16 ulp + 1e-3 RMS of the plain
    version at a 300-step, 128-chunk head."""
    x, dt, B, C, A = _ssd_bf16_inputs(1, 4, 1, 300, 64, 16, seed=364)
    want = ssd_mod.ssd_scan_ref(x, dt, B, C, A)
    assert _misses(_ssd_emulate(x, dt, B, C, A, 128), want) == 0
    assert _misses(_ssd_emulate(x, dt, B, C, A, 128, split=False), want) > 1000
