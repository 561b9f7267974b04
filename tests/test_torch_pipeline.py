"""The port's pipeline schedule (``repro_torch.parallel.pipeline``)
against ``repro.parallel.pipeline`` on the CPU: 8 gloo ranks (data 2,
model 4), stages over ``model``, rows over ``data``, against the
reference's ``pipeline_apply`` on the conftest's ``mesh_dm``.

* ``tests/test_pipeline.py``'s two tests on the port: the tanh MLP (8
  layers, 2 a stage, 6 microbatches of 4 rows) against the reference's
  pipeline (outputs within 2e-5) and against the sequential layers, and
  the gradient of the outputs' sum against ``jax.grad`` of the
  reference's (1e-4): one ``ppermute`` a tick forward and one
  ``ppermute.bwd`` a tick but the last (the last hop reaches no output);
* ``bubble_fraction`` and the in-flight bound;
* a pipeline of a tiny MoE transformer's own layers (``layer_apply``,
  the kernels' plain versions; 4 layers, 1 a stage) against the
  reference's ``_layer_body`` applied microbatch by microbatch, outputs
  and every layer's gradient (fp32: 2e-5 and 1e-4 of each gradient's
  largest magnitude).

One spawn runs the rank cases, in a thread while JAX computes its side.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import transformer as jt
from repro.models.api import get_model as j_get_model
from repro.parallel.pipeline import pipeline_apply as j_pipeline_apply
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import spawn
from repro_torch.parallel.pipeline import (bubble_fraction,
                                           stage_params_spec)

L, D, N_MICRO, MB = 8, 16, 6, 4
TF_MICRO, TF_MB, TF_SEQ = 3, 2, 16


def _body(lp, x):
    def one(h, w):
        return jnp.tanh(h @ w), None
    y, _ = jax.lax.scan(one, x, lp)
    return y


def _reference(w_all, x):
    return _body(w_all, x)


def _tf_cfgs():
    j = j_reduced_config(j_get_config("mixtral-8x7b"), num_layers=4)
    t = reduced_config(get_config("mixtral-8x7b"), num_layers=4)
    return j, t


@pytest.fixture(scope="module")
def runs(mesh_dm):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    jcfg, tcfg = _tf_cfgs()
    jp = j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(4))
    params = {k: np.asarray(v) for k, v in jp.items()}
    tx = rng.standard_normal((TF_MICRO, TF_MB, TF_SEQ, jcfg.d_model)
                             ).astype(np.float32)
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.spmd_pipelines, 8, "gloo",
                                args=(w, x, (tcfg, params, tx)))
        n_stages = mesh_dm.shape["model"]
        w_staged = jnp.asarray(w).reshape(n_stages, -1, D, D)
        want = {}
        want["pipeline"] = np.asarray(j_pipeline_apply(
            _body, w_staged, jnp.asarray(x), mesh_dm, stage_axis="model",
            batch_axis="data"))
        want["sequential"] = np.asarray(jax.vmap(
            lambda xm: _reference(jnp.asarray(w), xm))(jnp.asarray(x)))

        def loss(ws, xm):
            return j_pipeline_apply(_body, ws, xm, mesh_dm,
                                    stage_axis="model",
                                    batch_axis="data").sum()
        want["grad"] = np.asarray(jax.grad(loss)(
            w_staged, jnp.asarray(x))).reshape(L, D, D)
        want["tf"] = _tf_reference(jcfg, jp, tx)
        results = ranks_run.result()
    return want, results


def _tf_reference(jcfg, jp, tx):
    """The reference's layers applied microbatch by microbatch: (outputs,
    d(sum of outputs)/d(each layers/ parameter))."""
    _glob, layers = jt._split_layers(jp)
    pos = jnp.broadcast_to(jnp.arange(TF_SEQ, dtype=jnp.int32),
                           (TF_MB, TF_SEQ))
    body = functools.partial(jt._layer_body, cfg=jcfg, rules=None)

    def run(lay, xm):
        def one(h, lp):
            return body(h, lp, pos)[0], None
        return jax.lax.scan(one, xm, lay)[0]

    def total(lay, x):
        return sum(run(lay, x[m]).sum() for m in range(x.shape[0]))
    xs = jnp.asarray(tx)
    out = jnp.stack([run(layers, xs[m]) for m in range(xs.shape[0])])
    grads = jax.grad(total)(layers, xs)
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def _rows(a, d):
    mb = a.shape[1] // 2
    return a[:, d * mb:(d + 1) * mb]


def test_pipeline_matches_sequential(runs):
    want, results = runs
    for rank, res in enumerate(results):
        got = res["tanh"][0]
        for ref in ("pipeline", "sequential"):
            np.testing.assert_allclose(got, _rows(want[ref], rank // 4),
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"{ref} rank {rank}")


def test_pipeline_grads_flow(runs):
    want, results = runs
    g_ref = want["grad"].reshape(4, -1, D, D)
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["tanh"][1], g_ref[rank % 4],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {rank}")


def test_one_hop_a_tick_each_way(runs):
    _want, results = runs
    ticks = N_MICRO + 4 - 1
    for res in results:
        assert res["tanh"][2] == {"ppermute": ticks,
                                  "ppermute.bwd": ticks - 1}


def test_bubble_fraction():
    assert bubble_fraction(1, 4) == pytest.approx(3 / 4)
    assert bubble_fraction(12, 4) == pytest.approx(3 / 15)
    assert bubble_fraction(100, 2) < 0.01
    assert stage_params_spec("model") == ("model",)


def test_inflight_bound_is_stage_count():
    """The schedule keeps at most n_stages microbatches in flight — the
    token-queue depth = BDP rule (C3/C6): microbatch m enters at tick m
    and leaves at tick m + S - 1."""
    S = 4
    for t in range(20):
        inflight = [m for m in range(16) if m <= t < m + S]
        assert len(inflight) <= S


def test_transformer_layers_pipeline_matches_the_sequential_model(runs):
    want, results = runs
    out, grads = want["tf"]
    for rank, res in enumerate(results):
        got, got_grads = res["transformer"]
        np.testing.assert_allclose(got, _rows(out, rank // 4), rtol=2e-5,
                                   atol=2e-5, err_msg=f"rank {rank}")
        s = rank % 4
        for k, g in got_grads.items():
            ref = grads[k][s:s + 1]
            scale = float(np.abs(grads[k]).max())
            np.testing.assert_allclose(g, ref, rtol=1e-3,
                                       atol=1e-4 * scale + 1e-9,
                                       err_msg=f"{k} rank {rank}")


def test_pipeline_ranks_import_nothing_of_jax_or_repro(runs):
    assert all(r["modules"] == [] for r in runs[1])


def test_batch_axis_must_not_be_the_stage_axis():
    import torch
    from repro_torch.parallel.pipeline import pipeline_apply

    class OneAxis:
        shape = {"model": 1}

        def names(self, axes):
            return (axes,) if isinstance(axes, str) else tuple(axes or ())
    with pytest.raises(ValueError, match="stage axis"):
        pipeline_apply(lambda p, x: x, None, torch.zeros(1, 1), OneAxis(),
                       "model", "model")
