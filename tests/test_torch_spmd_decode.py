"""The port's sharded decode against the reference's: ``decode_step`` on
8 gloo ranks (data 2, model 4) under the reference's ``cell_rules`` of a
decode cell against ``repro.models.transformer.decode_step`` under the
same rules on the conftest's ``mesh_dm``: qwen2-72b (reduced) with a
batch of 4 (rows over ``data``, the KV cache over ``model``) and a batch
of 1 (``cell_rules`` drops the batch axis and spreads the cache over
``("data", "model")``), and Mixtral (its sliding window 16 wrapping the
cache, the MoE through ``ep`` under ``_decode_rules``; and with
``dispatch`` ``local`` and ``tp``); every step's logits within 2e-4 and
every cache leaf (the blocks gathered) within 2e-4, integers equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import step as j_step
from repro.models.api import get_model as j_get_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import spawn

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(arch, **overrides):
    return (j_reduced_config(j_get_config(arch), **overrides),
            reduced_config(get_config(arch), **overrides))


# name -> (arch, batch, decode steps, max_seq, rule overrides)
DECODES = {"qwen2 batch 4": ("qwen2-72b", 4, 5, 32, {}),
           "qwen2 batch 1": ("qwen2-72b", 1, 5, 32, {}),
           "mixtral window wraps": ("mixtral-8x7b", 2, 20, 32, {}),
           "mixtral local": ("mixtral-8x7b", 2, 4, 32,
                             dict(dispatch="local")),
           "mixtral tp": ("mixtral-8x7b", 2, 4, 32, dict(dispatch="tp"))}


def _j_decode(mesh, jcfg, params, steps, max_seq, overrides):
    """The reference's decode under ``cell_rules`` on ``mesh``: per step
    (logits, cache)."""
    model = j_get_model(jcfg)
    rules = j_step.cell_rules(mesh, jcfg, JShapeConfig(
        "d", max_seq, steps.shape[1], "decode"), **overrides)
    fn = jax.jit(lambda p, c, t: model.decode_step(p, c, t, jcfg, rules))
    out = []
    with mesh:
        cache = model.init_cache(jcfg, steps.shape[1], max_seq)
        for tok in steps:
            logits, cache = fn(params, cache, jnp.asarray(tok))
            out.append((np.asarray(logits),
                        {k: np.asarray(v) for k, v in cache.items()}))
    return out, rules


@pytest.fixture(scope="module")
def decode_runs(mesh_dm):
    want, cases = {}, []
    for name, (arch, B, n, max_seq, kw) in DECODES.items():
        jcfg, tcfg = _cfgs(arch)
        p = j_get_model(jcfg).init_params(jcfg, jax.random.key(1))
        steps = np.random.default_rng(2).integers(
            0, jcfg.vocab_size, (n, B)).astype(np.int32)
        want[name] = _j_decode(mesh_dm, jcfg, p, steps, max_seq, kw)
        cases.append((name, tcfg, {k: np.asarray(v) for k, v in p.items()},
                      steps, max_seq, kw))
    return want, spawn(ranks.model_decodes, 8, "gloo", args=(cases,))


@pytest.mark.parametrize("name", list(DECODES))
def test_sharded_decode_matches_reference(decode_runs, name):
    want, results = decode_runs
    steps, jrules = want[name]
    for rank, res in enumerate(results):
        got, batch, kv_seq = res[name]
        assert batch == jrules._clean(jrules.batch)
        assert kv_seq == jrules._clean(jrules.kv_seq)
        assert len(got) == len(steps)
        for i, ((logits, cache), (jl, jc)) in enumerate(zip(got, steps)):
            np.testing.assert_allclose(logits, jl, err_msg=f"step {i}",
                                       **TOL)
            for k in jc:
                if np.issubdtype(jc[k].dtype, np.floating):
                    np.testing.assert_allclose(cache[k], jc[k], **TOL,
                                               err_msg=f"{k} step {i}")
                else:
                    np.testing.assert_array_equal(cache[k], jc[k],
                                                  err_msg=f"{k} step {i}")
    if name == "qwen2 batch 1":
        assert results[0][name][1:] == (None, ("data", "model"))
