"""The port's cross-pod gradient compression (``repro_torch.optim.
compress``) against ``repro.optim.compress`` on the CPU.

* the reference's three tests of ``tests/test_optim.py`` on the port: the
  codecs' error bound (hypothesis), error feedback telescoping, and
  ``cross_pod_psum`` in int8 over ``data`` on 8 gloo ranks (data 2,
  model 4) against the exact sum;
* ``compress_decompress`` array for array against the reference over
  seeds, sizes that are not multiples of the 1024-element chunk, fp32 and
  bf16 inputs, with and without an error state: bit-identical (the
  division by the clamped scale and round half to even are the same in
  both);
* ``quantize_int8`` / ``dequantize_int8`` likewise, and
  ``init_error_state``;
* ``cross_pod_psum`` on the ranks in int8 and bf16 with error feedback
  over two rounds against the reference's inside ``shard_map`` on the
  conftest's ``mesh_dm``: sums and residuals bit-identical (a sum of two
  fp32 terms has one rounding in either order); the wire carries the
  gradient's dtype (fp32 here), one ``all_reduce_sum`` a call.

One spawn runs the rank cases, in a thread while JAX computes its side.
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

import torch_spmd_ranks as ranks
from repro import optim as j_optim
from repro.compat import shard_map
from repro_torch import optim
from repro_torch.launch.mesh import spawn

ROUND_SHAPE = (3, 700)        # 2,100 elements: three chunks, the last short


def _rounds():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((8,) + ROUND_SHAPE) *
             rng.uniform(0.01, 3, (8, 1, 1))).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def runs(mesh_dm):
    """(the reference's results, the ranks')."""
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    rounds = _rounds()
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.spmd_compress, 8, "gloo",
                                args=(x, rounds))
        want = {}
        for mode in ("int8", "bf16"):
            def island(g, e, mode=mode):
                s, new = j_optim.cross_pod_psum(g[0], "data", mode, e[0])
                return s[None], new[None]
            err = jnp.zeros((8,) + ROUND_SHAPE, jnp.float32)
            for i, g in enumerate(rounds):
                s, err = shard_map(
                    island, mesh=mesh_dm,
                    in_specs=(P(("data", "model")), P(("data", "model"))),
                    out_specs=(P(("data", "model")), P(("data", "model"))),
                    axis_names={"data", "model"})(jnp.asarray(g), err)
                want[(mode, i)] = (np.asarray(s), np.asarray(err))
        results = ranks_run.result()
    return x, want, results


# ---------------------------------------------------------------------------
# the reference's tests, on the port
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from(["bf16", "int8"]))
def test_compression_bounded_error(seed, mode):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(300).astype(np.float32) *
                         np.float32(rng.uniform(0.01, 10)))
    out, _ = optim.compress_decompress(g, mode)
    scale = float(g.abs().max())
    tol = scale / 100 if mode == "int8" else scale / 64
    assert float((out - g).abs().max()) <= tol


def test_error_feedback_telescopes():
    """With error feedback, the running SUM of compressed grads tracks the
    true sum (bias telescopes instead of accumulating)."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64, np.float32)
    ef_sum = np.zeros(64, np.float32)
    plain_sum = np.zeros(64, np.float32)
    err = torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                             * np.float32(0.01))
        true_sum += g.numpy()
        out_ef, err = optim.compress_decompress(g, "int8", err)
        ef_sum += out_ef.numpy()
        out_plain, _ = optim.compress_decompress(g, "int8")
        plain_sum += out_plain.numpy()
    ef_err = np.abs(ef_sum - true_sum).max()
    plain_err = np.abs(plain_sum - true_sum).max()
    assert ef_err <= plain_err + 1e-6
    assert ef_err < 0.01 * np.abs(true_sum).max() + 1e-3


def test_cross_pod_psum_error_feedback(runs):
    """Compressed psum over ``data`` matches the exact psum closely."""
    x, _want, results = runs
    want = x.sum(0, keepdims=True)
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["psum int8"], want, atol=0.05,
                                   err_msg=f"rank {rank}")


# ---------------------------------------------------------------------------
# array for array against the reference
# ---------------------------------------------------------------------------

CASES = [(seed, n, dtype, with_err)
         for seed, n in ((0, 300), (1, 1024), (2, 2500), (3, 4097))
         for dtype in ("float32", "bfloat16") for with_err in (False, True)]


@pytest.mark.parametrize("mode", ["int8", "bf16", "none"])
@pytest.mark.parametrize("seed,n,dtype,with_err", CASES)
def test_compress_decompress_matches_the_reference(seed, n, dtype, with_err,
                                                   mode):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * rng.uniform(1e-3, 30)).astype(np.float32)
    g[rng.integers(0, n, 3)] = 0.0
    err = (rng.standard_normal(n) * 1e-2).astype(np.float32) \
        if with_err else None
    jg = jnp.asarray(g).astype(dtype)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    want, want_err = j_optim.compress_decompress(
        jg, mode, None if err is None else jnp.asarray(err))
    got, got_err = optim.compress_decompress(
        tg, mode, None if err is None else torch.from_numpy(err))
    assert got.dtype == tg.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if with_err:
        assert got_err.dtype == torch.float32
        np.testing.assert_array_equal(got_err.numpy(), np.asarray(want_err))
    else:
        assert got_err is None and want_err is None


@pytest.mark.parametrize("n", [5, 1024, 3000])
def test_quantize_int8_matches_the_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n,)) * 4).astype(np.float32)
    jq, js = j_optim.quantize_int8(jnp.asarray(x))
    q, s = optim.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        optim.dequantize_int8(q, s, (n,), torch.float32).numpy(),
        np.asarray(j_optim.dequantize_int8(jq, js, (n,), jnp.float32)))


def test_rounding_is_half_to_even_in_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    q, _ = optim.quantize_int8(torch.from_numpy(x))
    jq, _ = j_optim.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.numpy()[0, :6].tolist() == [0, 2, 2, 0, -2, 127]


def test_init_error_state_is_fp32_zeros():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.ones(2)}
    err = optim.init_error_state(params)
    want = j_optim.init_error_state({k: jnp.ones(tuple(v.shape))
                                     for k, v in params.items()})
    for k, e in err.items():
        assert e.dtype == torch.float32 and tuple(e.shape) == want[k].shape
        assert not e.any()


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown compression mode"):
        optim.compress_decompress(torch.ones(3), "fp8")


# ---------------------------------------------------------------------------
# cross_pod_psum on the ranks, with error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_cross_pod_psum_with_error_feedback_matches_shard_map(runs, mode):
    _x, want, results = runs
    for i in range(2):
        s_want, e_want = want[(mode, i)]
        for rank, res in enumerate(results):
            s, e = res[(mode, i)]
            np.testing.assert_array_equal(s, s_want[rank],
                                          err_msg=f"{mode} {i} rank {rank}")
            np.testing.assert_array_equal(e, e_want[rank],
                                          err_msg=f"{mode} {i} rank {rank}")


def test_cross_pod_psum_wire_is_the_gradients_dtype(runs):
    _x, _want, results = runs
    n = int(np.prod(ROUND_SHAPE))
    for res in results:
        assert res["stats"] == {"all_reduce_sum": {"calls": 1,
                                                   "bytes": 4 * n}}


def test_compress_ranks_import_nothing_of_jax_or_repro(runs):
    assert all(r["modules"] == [] for r in runs[2])
