"""Mamba-2, Jamba and Whisper trained on a mesh against the JAX package:
the loss and every parameter's gradient on 8 gloo ranks (data 2, model
4) against ``jax.value_and_grad`` of the reference's ``loss_fn`` under
its rules on the conftest's ``mesh_dm``, and three ``train_step``s
against the reference's ``build_cell(...).jitted()``; the reduced
configs in fp32, the batches the reference's ``synthetic_batch``.

* the gradients: Mamba-2 (the head-parallel mixer island: the gathered
  ``in_proj``/``conv`` weights' backward is a reduce-scatter, the gate
  norm's all-reduce its own transpose), with ``manual_tp=False`` (the
  mixer's weights gathered) and under FSDP (every parameter banked over
  ``data`` too); Jamba at capacity factor 8 (nothing drops) under ``xy``
  and, with FSDP, ``ep``; Whisper on frames, and under FSDP.  Each with
  ``remat`` "none" and "full" on the port's side (the reference's rules
  remat "full"), and Mamba-2 with ``remat="dots"`` in the rules of both;
* three steps of AdamW: Mamba-2 under ``baseline``, Whisper under
  ``fsdp`` (Jamba's training cell takes longer to compile than this
  module's budget leaves; its gradients are held above): each step's
  loss, ``grad_norm`` and ``lr``, then every gathered parameter and
  ``master`` / ``m`` / ``v`` leaf, ``step`` exactly.

Bars of ``tests/test_torch_spmd_grad.py`` and
``tests/test_torch_spmd_optim.py``: the loss within ``rtol=1e-5,
atol=1e-6``; each gradient within ``rtol=1e-3`` and ``1e-4`` of its
largest magnitude; the steps' leaves within ``rtol=1e-5`` with a floor
of ``1e-5`` of the leaf's largest magnitude, an element whose step-1
gradient is within a few Adam eps of zero excused up to ``2 * lr_peak``
(``test_torch_spmd_optim.py``'s docstring says why).  The parameters
(and masters) have one floor more, ``UPDATE_TOL`` of ``lr_peak`` a step:
the mixers' ``dt_bias`` and ``conv_b`` start at zero and hold nothing
but three AdamW updates, each the gradient over its own running
magnitude, so a gradient's rounding (the sharded reductions sum in
another order; the gradients agree within ``rtol=1e-3``) moves them by
that fraction of ``lr`` a step, where the leaf's own floor (``1e-5`` of
~``3 * lr``) is ~1e-8 (seen: one ``dt_bias`` element of 32, 1.1e-8
off).  One spawn runs every case, in a thread beside JAX's compiles.
"""
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_ranks as ranks
from repro import optim as j_optim
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import synthetic_batch as j_synthetic_batch
from repro.launch import step as j_step
from repro.models.api import get_model as j_get_model
from repro.parallel.sharding import Rules as JRules
from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import spawn
from repro_torch.launch.step import cell_rules
from repro_torch.models import get_model

MAMBA, JAMBA, WHISPER = "mamba2-370m", "jamba-v0.1-52b", "whisper-large-v3"
SEQ = 32
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
JSHAPE = JShapeConfig("t", seq_len=SEQ, global_batch=8, kind="train")
OPT = dict(warmup_steps=2, total_steps=10)
OPT_CFG = optim.OptConfig(**OPT)
LEAF_TOL = 1e-5
EPS_EXCUSE = 4      # Adam eps a step-1 gradient may be from zero
UPDATE_TOL = 1e-4   # of lr_peak a step, for the parameters and masters

# name -> (arch, capacity factor or None, rule overrides)
CASES = {
    "mamba2": (MAMBA, None, {}),
    "mamba2 gspmd": (MAMBA, None, dict(manual_tp=False)),
    "mamba2 fsdp": (MAMBA, None, dict(fsdp=True)),
    "jamba xy": (JAMBA, 8.0, dict(dispatch="xy")),
    "jamba ep fsdp": (JAMBA, 8.0, dict(dispatch="ep", fsdp=True)),
    "whisper": (WHISPER, None, {}),
    "whisper fsdp": (WHISPER, None, dict(fsdp=True)),
}
REMATS = ("none", "full")
# the same cases with ``remat="dots"`` in the rules of both packages
DOTS_CASES = ("mamba2",)
# name -> (arch, capacity factor or None, strategy)
STEPS = {"mamba2 baseline": (MAMBA, None, "baseline"),
         "whisper fsdp": (WHISPER, None, "fsdp")}


def _cfgs(arch, cf=None):
    j = j_reduced_config(j_get_config(arch))
    t = reduced_config(get_config(arch))
    if cf is not None:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (j, t))
    return j, t


def _batch(jcfg, rows, step=0):
    return {k: np.asarray(v) for k, v in j_synthetic_batch(
        jcfg, JShapeConfig("t", SEQ, rows, "train"), step).items()}


def _value_and_grad(mesh, jcfg, rules, p, batch):
    model = j_get_model(jcfg)
    with mesh:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda q, b: model.loss_fn(q, b, jcfg, rules), has_aux=True))(
            p, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v, np.float32) for k, v in grads.items()})


def _build_cell_steps(mesh, jcfg, params, batches, strategy):
    """Three steps of the reference's jitted training cell: (metrics per
    step, params, optimizer state, step, the step-1 gradients)."""
    cell = j_step.build_cell(jcfg, JSHAPE, mesh, strategy,
                             j_optim.OptConfig(**OPT))
    with mesh:
        p = jax.device_put({k: jnp.asarray(v) for k, v in params.items()},
                           cell.in_shardings[0])
        st = jax.jit(j_optim.init, out_shardings=cell.in_shardings[1])(p)
        fn = cell.jitted()
        metrics = []
        for b in batches:
            p, st, m = fn(p, st, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            if len(metrics) == 1:        # m = (1 - b1) g after step 1
                g1 = {k: np.asarray(v) / (1 - OPT_CFG.b1)
                      for k, v in st["m"].items()}
    return (metrics, {k: np.asarray(v) for k, v in p.items()},
            {q: {k: np.asarray(v) for k, v in st[q].items()}
             for q in ("master", "m", "v")}, int(st["step"]), g1)


@pytest.fixture(scope="module")
def runs(mesh_dm):
    """{"grads": (the reference's (loss, metrics, grads) per case, the
    ranks'), "steps": (the reference's steps per case, the ranks')}."""
    params, jobs, cases = {}, [], []
    for name, (arch, cf, kw) in CASES.items():
        jcfg, tcfg = _cfgs(arch, cf)
        if (arch, cf) not in params:
            params[(arch, cf)] = j_get_model(jcfg).init_params(
                jcfg, jax.random.key(0))
        p = params[(arch, cf)]
        batch = _batch(jcfg, 4)
        full = {k: np.asarray(v) for k, v in p.items()}
        jobs.append((name, jcfg, JRules(mesh=mesh_dm, **kw), p, batch))
        cases.append((name, tcfg, full, batch, ("rules", kw)))
        if name in DOTS_CASES:
            dots = dict(kw, remat="dots")
            jobs.append((name + " dots", jcfg, JRules(mesh=mesh_dm, **dots),
                         p, batch))
            cases.append((name + " dots", tcfg, full, batch,
                          ("rules", dots), ("dots",)))
    step_jobs, step_cases = [], []
    for name, (arch, cf, strategy) in STEPS.items():
        jcfg, tcfg = _cfgs(arch, cf)
        full = {k: np.asarray(v) for k, v in params[(arch, cf)].items()}
        batches = [{k: np.asarray(v) for k, v in j_synthetic_batch(
            jcfg, JSHAPE, i).items()} for i in range(3)]
        step_jobs.append((name, jcfg, full, batches, strategy))
        step_cases.append((name, tcfg, full, batches, (strategy,), OPT))
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.family_training, 8, "gloo",
                                args=(cases, step_cases))
        want, memo = {}, {}
        for name, jcfg, rules, p, batch in jobs:
            # FSDP banks the parameters only: the reference's loss and
            # gradients are those of the same rules without it
            key = (jcfg, dataclasses.replace(rules, fsdp=False))
            if key not in memo:
                memo[key] = _value_and_grad(mesh_dm, jcfg, rules, p, batch)
            want[name] = memo[key]
        steps = {name: _build_cell_steps(mesh_dm, jcfg, full, batches,
                                         strategy)
                 for name, jcfg, full, batches, strategy in step_jobs}
        results = ranks_run.result()
    return {"grads": (want, [r["grads"] for r in results]),
            "steps": (steps, [r["steps"] for r in results])}


def _check_grads(want, results, name, remat):
    loss, metrics, grads = want[name]
    for rank, res in enumerate(results):
        got_loss, got_metrics, _, drops, _ = res[(name, remat)]
        np.testing.assert_allclose(got_loss, loss, err_msg=f"rank {rank}",
                                   **LOSS_TOL)
        np.testing.assert_allclose(got_metrics["ce"], metrics["ce"],
                                   err_msg=f"rank {rank}", **LOSS_TOL)
        if "moe_aux" in metrics:
            np.testing.assert_allclose(got_metrics["moe_aux"],
                                       metrics["moe_aux"], rtol=1e-5,
                                       atol=1e-6)
        assert drops == 0
    got = results[0][(name, remat)][2]
    assert set(got) == set(grads)
    for k, g in grads.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[k], g, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-9, err_msg=k)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_value_and_grad(runs, name, remat):
    want, results = runs["grads"]
    _check_grads(want, results, name, remat)


@pytest.mark.parametrize("name", DOTS_CASES)
def test_dots_loss_and_gradients_match_value_and_grad(runs, name):
    want, results = runs["grads"]
    _check_grads(want, results, name + " dots", "dots")


def test_mixer_backward_reduce_scatters_its_gathers(runs):
    """The mixer island's weight gathers run backward as reduce-scatters
    (``all_gather.bwd``) and the gate norm's sum of squares as its own
    transpose (``all_reduce_sum.bwd``)."""
    _want, results = runs["grads"]
    bwd = results[0][("mamba2", "full")][4]
    assert {"all_gather.bwd", "all_reduce_sum.bwd",
            "reduce_scatter.bwd"} <= set(bwd), bwd


def _close(got, want, what, g1=None, steps=0):
    """``got`` within the leaves' bar of ``want`` (module docstring);
    ``steps`` updates' floor for a parameter or master leaf."""
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want)
    off = err > LEAF_TOL * np.abs(want) + LEAF_TOL * scale + 1e-12 \
        + steps * UPDATE_TOL * OPT_CFG.lr_peak
    if g1 is not None:
        off &= ~((np.abs(g1) <= EPS_EXCUSE * OPT_CFG.eps)
                 & (err <= 2 * OPT_CFG.lr_peak))
    assert not off.any(), \
        f"{what}: {off.sum()} of {want.size} off, worst {err[off].max():.3e}"


@pytest.mark.parametrize("name", list(STEPS))
def test_three_train_steps_match_build_cell(runs, name):
    want, got = runs["steps"]
    metrics, params, state, step, g1 = want[name]
    strategy = STEPS[name][2]
    for rank, res in enumerate(got):
        for i, (g, w) in enumerate(zip(res[name][strategy][0], metrics)):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(
                    g[k], w[k], rtol=1e-5,
                    err_msg=f"rank {rank} step {i + 1} {k}")
    g_params, g_state, g_step = got[0][name][strategy][1]
    assert g_step == step == 3
    assert set(g_params) == set(params)
    for k, v in params.items():
        _close(g_params[k], v, f"param {k}", g1[k], step)
        _close(g_state["master"][k], state["master"][k], f"master {k}",
               g1[k], step)
        for q in ("m", "v"):
            _close(g_state[q][k], state[q][k], f"{q} {k}")


def test_fsdp_banks_the_families_parameters():
    """Under FSDP a rank holds fewer parameter bytes than under
    baseline (a stand-in mesh object serves)."""
    dm = types.SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": 2, "model": 4})
    shape = ShapeConfig("t", SEQ, 8, "train")
    for arch in (MAMBA, JAMBA, WHISPER):
        cfg = reduced_config(get_config(arch))
        model = get_model(cfg)
        nbytes = {s: sum(int(np.prod(v)) for v in model.shard_table(
            cfg, cell_rules(dm, cfg, shape, s)).values())
            for s in ("baseline", "fsdp")}
        assert nbytes["fsdp"] < nbytes["baseline"], arch


def test_training_ranks_import_nothing_of_jax_or_repro(runs):
    _want, results = runs["grads"]
    assert all(r["modules"] == [] for r in results), results[0]["modules"]
