"""The port's ZeRO-1 / FSDP banking and its mesh training step against the
JAX package on the CPU.

* ``parallel.sharding.zero1_spec`` / ``optim.state_specs`` equal the
  reference's PartitionSpecs on ``tests/test_optim.py``'s three cases
  and on every parameter of each transformer config (published widths)
  on a (data 2, model 4) mesh, with the parameters' specs under ``baseline`` and the
  banked ones under ``fsdp`` equal to the reference ``build_cell``'s;
  the state bytes a rank as ``test_zero1_reduces_state_bytes``; FSDP
  shrinks a rank's parameters as ``test_fsdp_banks_params``.  These are
  layouts only: a stand-in mesh with the shape and axis names serves;
* three ``train_step``s on 8 gloo ranks equal three steps of the
  reference's ``build_cell(cfg, SHAPE, mesh_dm, strategy,
  OPT).jitted()`` on stablelm-3b (reduced, fp32) under ``baseline``,
  ``fsdp`` and ``no_zero1``: each step's loss, ``grad_norm`` and ``lr``
  within ``rtol=1e-5``, then every gathered parameter and ``master`` /
  ``m`` / ``v`` leaf, ``step`` exactly; the ``fsdp`` loss equals the
  ``baseline`` loss within ``rel=1e-5`` (``test_fsdp_compiles_and_matches``).

The leaves' bar: ``rtol=1e-5`` with an absolute floor of ``1e-5`` of the
leaf's largest magnitude (``m`` and ``v`` hold values near zero, where a
relative bar alone measures rounding, not the update), met by every
element of every leaf, with one excuse for ``params`` and ``master``
only: an element whose step-1 gradient in the reference (AdamW's, read
back from its ``m`` after one step) is within ``EPS_EXCUSE`` Adam eps of
zero may be off by up to ``2 * lr_peak`` (6e-4). Adam's first update is
``g / (|g| + eps)``, so such a gradient moves its parameter by an amount
its rounding decides, up to ``lr``, as ``tests/test_torch_train.py``
finds on one card (seen here: 1 element of 65,536 in ``layers/w_up``,
its gradient 4.2e-9, 5.0e-6 off).  Both sides start from the
reference's ``init_params`` and read ``synthetic_batch`` steps 0, 1, 2.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

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
from repro_torch.models import transformer
from repro_torch.parallel.sharding import Rules

SHAPE = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
JSHAPE = JShapeConfig("t", seq_len=32, global_batch=8, kind="train")
OPT = dict(warmup_steps=2, total_steps=10)
OPT_CFG = optim.OptConfig(**OPT)
STRATEGIES = ("baseline", "fsdp", "no_zero1")
TRANSFORMERS = ("qwen2-72b", "yi-34b", "qwen1.5-32b", "stablelm-3b",
                "mixtral-8x7b", "moonshot-v1-16b-a3b", "qwen2-vl-72b")
LEAF_TOL = 1e-5
EPS_EXCUSE = 4      # Adam eps a step-1 gradient may be from zero

# the layouts need a mesh's shape and axis names only
DM = types.SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 4})


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries, a 1-tuple entry as its
    name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,shape,want", [
    ((None, "model"), (6, 8), ("data", "model")),
    ((None, "model"), (5, 4), (None, "model")),
    ((None, "model"), (5, 8), (None, ("model", "data")))])
def test_zero1_specs_match_test_optim(mesh_dm, spec, shape, want):
    """``tests/test_optim.py::test_zero1_specs_divisible``'s three
    cases, on both packages."""
    j = j_optim.state_specs(
        {"w": NamedSharding(mesh_dm, P(*spec))},
        {"w": jax.ShapeDtypeStruct(shape, jnp.float32)},
        JRules(mesh=mesh_dm))["m"]["w"].spec
    got = optim.state_specs({"w": spec}, {"w": shape}, Rules(mesh=DM))
    assert _norm(got["m"]["w"], 2) == _norm(j, 2) == want
    assert got["step"] == ()


def test_zero1_reduces_state_bytes():
    """A (8, 16) leaf over (None, "model") banks to 1/8 of it a rank."""
    spec = optim.state_specs({"w": (None, "model")}, {"w": (8, 16)},
                             Rules(mesh=DM))["m"]["w"]
    local = [n // Rules(mesh=DM).axis_size(e) for n, e in zip((8, 16), spec)]
    assert int(np.prod(local)) == 8 * 16 // 8


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_state_specs_match_the_reference_on_every_parameter(mesh_dm, arch):
    """Every parameter of the published config: the parameters' specs
    (``baseline``; ``fsdp``'s banked ones as ``build_cell`` banks them)
    and the optimizer state's banks equal the reference's."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    model = j_get_model(jcfg)
    shapes = model.param_shapes(jcfg)
    for strategy in ("baseline", "fsdp"):
        cell = j_step.build_cell(jcfg, JSHAPE, mesh_dm, strategy)
        j_params = cell.in_shardings[0]
        j_state = cell.in_shardings[1]["m"]
        rules = cell_rules(DM, tcfg, SHAPE, strategy)
        specs = transformer.param_specs(tcfg, rules)
        table = transformer.param_table(tcfg)
        banked = optim.state_specs(specs, table, rules)
        assert set(specs) == set(j_params) == set(banked["m"])
        for k in specs:
            nd = len(shapes[k].shape)
            assert _norm(specs[k], nd) == _norm(j_params[k].spec, nd), \
                (strategy, k)
            assert _norm(banked["m"][k], nd) == _norm(j_state[k].spec, nd), \
                (strategy, k)


def _param_bytes(cfg, rules):
    return sum(int(np.prod(s)) * 4 for s in
               transformer.shard_table(cfg, rules).values())


def test_fsdp_banks_params():
    cfg = reduced_config(get_config("qwen2-72b"))
    base = cell_rules(DM, cfg, SHAPE, "baseline")
    fsdp = cell_rules(DM, cfg, SHAPE, "fsdp")
    assert fsdp.fsdp and _param_bytes(cfg, fsdp) < _param_bytes(cfg, base)
    # inference banks nothing
    assert not cell_rules(DM, cfg, ShapeConfig("d", 32, 8, "decode"),
                          "fsdp").fsdp


# ---------------------------------------------------------------------------
# three train steps against build_cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps(mesh_dm):
    """{strategy: (the reference's metrics, params, state), the ranks'}."""
    jcfg = j_reduced_config(j_get_config("stablelm-3b"))
    tcfg = reduced_config(get_config("stablelm-3b"))
    model = j_get_model(jcfg)
    batches = [{k: np.asarray(v) for k, v in
                j_synthetic_batch(jcfg, JSHAPE, i).items()} for i in range(3)]
    params = {k: np.asarray(v) for k, v in
              model.init_params(jcfg, jax.random.key(0)).items()}
    want = {}
    for strategy in STRATEGIES:
        cell = j_step.build_cell(jcfg, JSHAPE, mesh_dm, strategy,
                                 j_optim.OptConfig(**OPT))
        with mesh_dm:
            p = jax.device_put({k: jnp.asarray(v) for k, v in
                                params.items()}, cell.in_shardings[0])
            st = jax.jit(j_optim.init, out_shardings=cell.in_shardings[1])(p)
            fn = cell.jitted()
            metrics = []
            for b in batches:
                p, st, m = fn(p, st, {k: jnp.asarray(v)
                                      for k, v in b.items()})
                metrics.append({k: float(v) for k, v in m.items()})
                if len(metrics) == 1:        # m = (1 - b1) g after step 1
                    g1 = {k: np.asarray(v) / (1 - OPT_CFG.b1)
                          for k, v in st["m"].items()}
        want[strategy] = (metrics, {k: np.asarray(v) for k, v in p.items()},
                          {q: {k: np.asarray(v) for k, v in st[q].items()}
                           for q in ("master", "m", "v")}, int(st["step"]),
                          g1)
    got = spawn(ranks.spmd_train_steps, 8, "gloo",
                args=(tcfg, params, batches, STRATEGIES, OPT))
    return want, got


def _close(got, want, what, g1=None):
    """``got`` within the leaves' bar of ``want`` (module docstring); an
    element may miss it only where ``g1``, the reference's step-1
    gradient of a parameter or master leaf, is within ``EPS_EXCUSE``
    eps of zero, and then by at most ``2 * lr_peak``."""
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want)
    off = err > LEAF_TOL * np.abs(want) + LEAF_TOL * scale + 1e-12
    if g1 is not None:
        off &= ~((np.abs(g1) <= EPS_EXCUSE * OPT_CFG.eps)
                 & (err <= 2 * OPT_CFG.lr_peak))
    assert not off.any(), \
        f"{what}: {off.sum()} of {want.size} off, worst {err[off].max():.3e}"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_three_train_steps_match_build_cell(steps, strategy):
    want, got = steps
    metrics, params, state, step, g1 = want[strategy]
    for rank, res in enumerate(got):
        for i, (g, w) in enumerate(zip(res[strategy][0], metrics)):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(
                    g[k], w[k], rtol=1e-5,
                    err_msg=f"rank {rank} step {i + 1} {k}")
    g_params, g_state, g_step = got[0][strategy][1]
    assert g_step == step == 3
    assert set(g_params) == set(params)
    for k, v in params.items():
        _close(g_params[k], v, f"param {k}", g1[k])
        _close(g_state["master"][k], state["master"][k], f"master {k}",
               g1[k])
        for q in ("m", "v"):
            _close(g_state[q][k], state[q][k], f"{q} {k}")


def test_fsdp_loss_equals_baseline_and_banks(steps):
    _want, got = steps
    for res in got:
        for a, b in zip(res["fsdp"][0], res["baseline"][0]):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert res["fsdp"][2] < res["baseline"][2]         # parameter bytes
        assert res["baseline"][3] < res["no_zero1"][3]     # state bytes
