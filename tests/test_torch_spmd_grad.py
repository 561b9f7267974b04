"""The port's SPMD backward against JAX on the CPU: each collective's
backward against ``jax.vjp`` of its ``lax`` primitive inside
``shard_map``, and the transformer's loss and every parameter's gradient
on 8 gloo ranks (data 2, model 4) against ``jax.value_and_grad`` of the
reference's ``loss_fn`` under its rules on the conftest's ``mesh_dm``.

* the collectives on ``mesh2x4`` (y 2, x 4): all-gather (one axis and
  both), psum-scatter, psum (both axes and one), the tiled
  ``all_to_all`` (two axes and dims), ``ppermute`` with a partial
  permutation (x 3 gets nothing); the JAX side runs with replication
  checking off, where a psum's transpose is a psum (each device its own
  cotangent: the sum-of-local-losses convention of
  ``repro_torch.parallel.comm``); integers pass through ``all_to_all``
  exactly; the backward calls counted as ``<op>.bwd``;
* the loss and the gradients, reduced configs in fp32: Megatron TP with
  ``manual_tp`` True and False on qwen2-72b, qwen1.5-32b (``qkv_bias``),
  qwen2-vl (M-RoPE, (3, B, S) positions), moonshot in the ``tp``,
  ``ep``, ``local``, ``xy`` and ``x`` dispatch modes (4 experts, top-2,
  capacity factor 8, as ``tests/test_parallel_equiv.py``: nothing
  drops), the ``no_sp`` (activations not sequence-sharded) and
  ``flat_a2a`` (``dispatch="flat"``) strategies' rules, and
  ``cell_rules`` of a training cell whose batch (3) does not divide the
  data axis (every data row holds every row; each token still counts
  once); each with ``remat`` "none" and "full" on the port's side;
  and ``remat="dots"`` (the reference's
  ``checkpoint_dots_with_no_batch_dims``) in the rules of both sides for
  qwen2's manual TP and moonshot's ``xy``;
* a world of one rank equals the single-card port.

The batches are the reference's ``synthetic_batch`` (masked at document
joins).  Bars of ``tests/test_torch_train.py``: the loss within
``rtol=1e-5, atol=1e-6``; each gradient within ``rtol=1e-3`` and
``1e-4`` of its largest magnitude.  One spawn runs every case.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

import torch_spmd_ranks as ranks
from repro.compat import shard_map
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import synthetic_batch as j_synthetic_batch
from repro.launch.step import cell_rules as j_cell_rules
from repro.models.api import get_model as j_get_model
from repro.parallel.sharding import Rules as JRules
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import spawn

MOE = "moonshot-v1-16b-a3b"
SEQ = 32
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (arch, capacity factor or None, rule overrides, batch rows,
#          via cell_rules)
CASES = {
    "qwen2 manual_tp": ("qwen2-72b", None, dict(manual_tp=True), 4, False),
    "qwen2 gspmd": ("qwen2-72b", None, dict(manual_tp=False), 4, False),
    "qwen1.5 qkv_bias": ("qwen1.5-32b", None, dict(manual_tp=True), 4,
                         False),
    "qwen2-vl mrope": ("qwen2-vl-72b", None, dict(manual_tp=True), 4,
                       False),
    "moe tp": (MOE, 8.0, dict(dispatch="tp"), 4, False),
    "moe ep": (MOE, 8.0, dict(dispatch="ep"), 4, False),
    "moe local": (MOE, 8.0, dict(dispatch="local"), 4, False),
    "moe xy": (MOE, 8.0, dict(dispatch="xy"), 4, False),
    "moe x": (MOE, 8.0, dict(dispatch="x"), 4, False),
    "qwen2 batch 3 (cell_rules)": ("qwen2-72b", None, {}, 3, True),
    "qwen2 no_sp": ("qwen2-72b", None, dict(seq=None), 4, False),
    "moe flat_a2a": (MOE, 8.0, dict(dispatch="flat"), 4, False),
}
REMATS = ("none", "full")
# the same cases with ``remat="dots"`` in the rules of both packages
DOTS_CASES = ("qwen2 manual_tp", "moe xy")


def _cfgs(arch, cf=None):
    j = j_reduced_config(j_get_config(arch))
    t = reduced_config(get_config(arch))
    if cf is not None:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_experts=4, top_k=2, capacity_factor=cf))
            for c in (j, t))
    return j, t


def _batch(jcfg, rows):
    b = j_synthetic_batch(jcfg, JShapeConfig("t", SEQ, rows, "train"), 0)
    b = {k: np.asarray(v) for k, v in b.items()}
    if jcfg.mrope_sections is not None:
        t = np.arange(SEQ)
        b["positions"] = np.broadcast_to(
            np.stack([t, t // 4 + (t // 2) % 2, t // 4 + t % 2])[:, None],
            (3, rows, SEQ)).astype(np.int32).copy()
    return b


TILES = ("y", "x")
PERM = [(0, 1), (1, 2), (2, 0)]
PRIMS = {
    "all_gather": (lambda l: lax.all_gather(l, "x", axis=1, tiled=True),
                   (2, 3), (2, 12)),
    "all_gather yx": (lambda l: lax.all_gather(l, TILES, axis=0, tiled=True),
                      (2, 3), (16, 3)),
    "psum_scatter": (lambda l: lax.psum_scatter(l, "x", scatter_dimension=0,
                                                tiled=True), (8, 3), (2, 3)),
    "psum": (lambda l: lax.psum(l, TILES), (2, 3), (2, 3)),
    "psum y": (lambda l: lax.psum(l, "y"), (2, 3), (2, 3)),
    "all_to_all": (lambda l: lax.all_to_all(l, "x", 0, 0, tiled=True),
                   (8, 3), (8, 3)),
    "all_to_all y": (lambda l: lax.all_to_all(l, "y", 1, 1, tiled=True),
                     (3, 4), (3, 4)),
    "ppermute": (lambda l: lax.ppermute(l, "x", PERM), (2, 3), (2, 3)),
}



def _vjp_inputs():
    rng = np.random.default_rng(0)
    inputs = {case: (rng.standard_normal((8,) + xs, np.float32),
                     rng.standard_normal((8,) + ys, np.float32))
              for case, (_, xs, ys) in PRIMS.items()}
    inputs["ints"] = rng.integers(-2**30, 2**30, (8, 8, 2), np.int32)
    return inputs


def _jax_vjps(mesh, inputs):
    want = {}
    spec = P(TILES)
    for case, (prim, _xs, _ys) in PRIMS.items():
        def f(l, c, prim=prim):
            y, vjp = jax.vjp(prim, l[0])
            return y[None], vjp(c[0])[0][None]
        y, g = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec), check_vma=False))(
            *inputs[case])
        want[case] = (np.asarray(y), np.asarray(g))
    want["ints"] = np.asarray(jax.jit(shard_map(
        lambda l: lax.all_to_all(l[0], "x", 0, 0, tiled=True)[None],
        mesh=mesh, in_specs=spec, out_specs=spec))(inputs["ints"]))
    return want




@pytest.fixture(scope="module")
def runs(mesh_dm, mesh2x4):
    """{"vjp": (JAX's, the ranks'), "grads": (the reference's (loss,
    metrics, grads) per case, the ranks')}.  One spawn runs both groups,
    in a thread of its own while JAX compiles its side."""
    jobs, cases, params = [], [], {}
    for name, (arch, cf, kw, rows, via_cell) in CASES.items():
        jcfg, tcfg = _cfgs(arch, cf)
        if (arch, cf) not in params:
            params[(arch, cf)] = j_get_model(jcfg).init_params(
                jcfg, jax.random.key(0))
        p = params[(arch, cf)]
        batch = _batch(jcfg, rows)
        if via_cell:
            rules = j_cell_rules(mesh_dm, jcfg,
                                 JShapeConfig("t", SEQ, rows, "train"), **kw)
            case_rules = ("cell", (SEQ, rows), kw)
        else:
            rules = JRules(mesh=mesh_dm, **kw)
            case_rules = ("rules", kw)
        jobs.append((name, jcfg, rules, p, batch))
        cases.append((name, tcfg, {k: np.asarray(v) for k, v in p.items()},
                      batch, case_rules))
        if name in DOTS_CASES:
            dots = dict(kw, remat="dots")
            jobs.append((name + " dots", jcfg,
                         JRules(mesh=mesh_dm, **dots), p, batch))
            cases.append((name + " dots", tcfg, cases[-1][2], batch,
                          ("rules", dots), ("dots",)))
    inputs = _vjp_inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.backward_checks, 8, "gloo",
                                args=(inputs, cases))
        vjps = _jax_vjps(mesh2x4, inputs)
        want = {}
        for name, jcfg, rules, p, batch in jobs:
            model = j_get_model(jcfg)
            with mesh_dm:
                (loss, metrics), grads = jax.jit(jax.value_and_grad(
                    lambda q, b, m=model, c=jcfg, r=rules: m.loss_fn(
                        q, b, c, r), has_aux=True))(
                    p, {k: jnp.asarray(v) for k, v in batch.items()})
            want[name] = (float(loss),
                          {k: float(v) for k, v in metrics.items()},
                          {k: np.asarray(v, np.float32) for k, v in
                           grads.items()})
        results = ranks_run.result()
    return {"vjp": (vjps, [r["vjp"] for r in results]),
            "grads": (want, [r["grads"] for r in results])}


@pytest.fixture(scope="module")
def grad_runs(runs):
    return runs["grads"]


@pytest.fixture(scope="module")
def vjp_runs(runs):
    return runs["vjp"]


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_value_and_grad(grad_runs, name, remat):
    want, results = grad_runs
    loss, metrics, grads = want[name]
    for rank, res in enumerate(results):
        got_loss, got_metrics, _, drops, _ = res[(name, remat)]
        np.testing.assert_allclose(got_loss, loss, err_msg=f"rank {rank}",
                                   **LOSS_TOL)
        np.testing.assert_allclose(got_metrics["ce"], metrics["ce"],
                                   err_msg=f"rank {rank}", **LOSS_TOL)
        np.testing.assert_allclose(got_metrics["moe_aux"],
                                   metrics["moe_aux"], rtol=1e-5, atol=1e-6)
        assert drops == 0
    got = results[0][(name, remat)][2]
    assert set(got) == set(grads)
    for k, g in grads.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[k], g, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-9, err_msg=k)


@pytest.mark.parametrize("name", DOTS_CASES)
def test_dots_loss_and_gradients_match_value_and_grad(grad_runs, name):
    want, results = grad_runs
    loss, metrics, grads = want[name + " dots"]
    for rank, res in enumerate(results):
        got_loss, got_metrics, _, drops, _ = res[(name + " dots", "dots")]
        np.testing.assert_allclose(got_loss, loss, err_msg=f"rank {rank}",
                                   **LOSS_TOL)
        np.testing.assert_allclose(got_metrics["moe_aux"],
                                   metrics["moe_aux"], rtol=1e-5, atol=1e-6)
        assert drops == 0
    got = results[0][(name + " dots", "dots")][2]
    assert set(got) == set(grads)
    for k, g in grads.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[k], g, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-9, err_msg=k)


def test_backward_collectives_are_counted(grad_runs):
    _want, results = grad_runs
    bwd = results[0][("moe xy", "full")][4]
    assert {"all_gather.bwd", "reduce_scatter.bwd",
            "all_to_all.bwd"} <= set(bwd), bwd


def test_grad_ranks_import_nothing_of_jax_or_repro(grad_runs):
    _want, results = grad_runs
    assert all(r["modules"] == [] for r in results), results[0]["modules"]


# ---------------------------------------------------------------------------
# each collective's backward against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PRIMS))
def test_collective_backward_matches_jax_vjp(vjp_runs, case):
    want, results = vjp_runs
    y, g = want[case]
    got_y = np.stack([r[case][0] for r in results])
    got_g = np.stack([r[case][1] for r in results])
    np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_g, g, rtol=0, atol=1e-6)


def test_integers_pass_through_all_to_all_exactly(vjp_runs):
    want, results = vjp_runs
    got = np.stack([r["ints"] for r in results])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want["ints"])


def test_backward_calls_are_counted(vjp_runs):
    _want, results = vjp_runs
    stats = results[0]["stats"]
    for op, n in (("all_gather", 2), ("reduce_scatter", 1),
                  ("all_reduce_sum", 2), ("all_to_all", 3),
                  ("ppermute", 1)):
        assert stats[op]["calls"] == n, (op, stats)
    for op, n in (("all_gather.bwd", 2), ("reduce_scatter.bwd", 1),
                  ("all_reduce_sum.bwd", 2), ("all_to_all.bwd", 2),
                  ("ppermute.bwd", 1)):
        assert stats[op]["calls"] == n, (op, stats)


# ---------------------------------------------------------------------------
# a world of one rank
# ---------------------------------------------------------------------------

def test_one_rank_world_equals_the_single_card_port(tmp_path):
    """A process group of one rank (here, in this process) on a 1 x 1
    mesh: the mesh loss and gradients equal the single-card port's."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.sharding import Rules
    jcfg, tcfg = _cfgs(MOE, 8.0)
    params = {k: np.asarray(v) for k, v in j_get_model(jcfg).init_params(
        jcfg, jax.random.key(0)).items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 2).items()}
    full = params_from_jax(tcfg, params, "cpu")
    got = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        rules = Rules(mesh=make_test_mesh((1, 1), ("data", "model")))
        for on_mesh in (False, True):
            model = get_model(tcfg)(tcfg, "cpu", params={
                k: v.clone() for k, v in full.items()},
                rules=rules if on_mesh else None)
            model.requires_grad_(True)
            loss, _ = model.loss(batch, remat="full")
            loss.backward()
            got[on_mesh] = (float(loss.detach()), {
                k: p.grad.numpy() for k, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got[True][0], got[False][0], **LOSS_TOL)
    for k, g in got[False][1].items():
        np.testing.assert_allclose(got[True][1][k], g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-9,
                                   err_msg=k)
