"""The port's transformer on a mesh against the reference's ``shard_map``
islands: forward logits on 8 gloo ranks (data 2, model 4) against
``repro.models.transformer.forward`` on the conftest's ``mesh_dm``, the
reduced configs in fp32.

* Megatron TP with ``manual_tp`` True and False on qwen2-72b and on
  qwen1.5-32b (``qkv_bias``): logits within 2e-4;
* the MoE dispatch modes ``tp``, ``ep``, ``local``, ``xy`` and ``x`` on
  moonshot with 4 experts, top-2 and capacity factor 8, as
  ``tests/test_parallel_equiv.py`` runs them (nothing drops): logits
  within 3e-4; and ``ep``, ``local``, ``xy`` at capacity factor 1, where
  each layout drops its own tokens: the port's drops are the
  reference's, mode for mode, so the logits still agree;
* M-RoPE on qwen2-vl with (3, B, S) positions whose temporal stream
  increases (the flash kernel masks by token index, the reference's
  chunked path by ``positions[0]``: the same mask here);
* ``last_only`` logits equal the full forward's last position, and the
  MoE aux loss the reference's;
* each rank's blocks gather back to the full parameters.

Both sides run on the reference's ``init_params`` (converted with
``params_from_jax``; each rank cuts its blocks with ``shard_params``) and
the same tokens from a numpy seed.  One spawn runs every case; a rank
imports nothing of JAX or ``repro``, which the last test checks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models.api import get_model as j_get_model
from repro.parallel.sharding import Rules as JRules
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import spawn

DENSE_TOL = dict(rtol=2e-4, atol=2e-4)
MOE_TOL = dict(rtol=3e-4, atol=3e-4)
MOE = "moonshot-v1-16b-a3b"


def _cfgs(arch, cf=None):
    j = j_reduced_config(j_get_config(arch))
    t = reduced_config(get_config(arch))
    if cf is not None:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_experts=4, top_k=2, capacity_factor=cf))
            for c in (j, t))
    return j, t


def _positions(B, S):
    """(3, B, S) M-RoPE positions: an increasing temporal stream, height
    and width streams that repeat over 2x2 patches."""
    t = np.arange(S)
    h = t // 4 + (t // 2) % 2
    w = t // 4 + t % 2
    return np.broadcast_to(np.stack([t, h, w])[:, None], (3, B, S)).astype(
        np.int32).copy()


# name -> (arch, capacity factor or None, rule overrides, M-RoPE positions)
CASES = {
    "qwen2 manual_tp": ("qwen2-72b", None, dict(manual_tp=True), False),
    "qwen2 gspmd": ("qwen2-72b", None, dict(manual_tp=False), False),
    "qwen1.5 manual_tp": ("qwen1.5-32b", None, dict(manual_tp=True), False),
    "qwen1.5 gspmd": ("qwen1.5-32b", None, dict(manual_tp=False), False),
    "moe tp": (MOE, 8.0, dict(dispatch="tp"), False),
    "moe ep": (MOE, 8.0, dict(dispatch="ep"), False),
    "moe local": (MOE, 8.0, dict(dispatch="local"), False),
    "moe xy": (MOE, 8.0, dict(dispatch="xy"), False),
    "moe x": (MOE, 8.0, dict(dispatch="x"), False),
    "moe ep cf 1": (MOE, 1.0, dict(dispatch="ep"), False),
    "moe local cf 1": (MOE, 1.0, dict(dispatch="local"), False),
    "moe xy cf 1": (MOE, 1.0, dict(dispatch="xy"), False),
    "qwen2-vl mrope": ("qwen2-vl-72b", None, dict(manual_tp=True), True),
}


@pytest.fixture(scope="module")
def runs(mesh_dm):
    """(the reference's (logits, aux) per case, the ranks' results)."""
    toks = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(
        np.int32)
    want, cases, params = {}, [], {}
    for name, (arch, cf, kw, mrope) in CASES.items():
        jcfg, tcfg = _cfgs(arch, cf)
        key = (arch, cf)
        if key not in params:
            params[key] = j_get_model(jcfg).init_params(jcfg,
                                                        jax.random.key(0))
        p = params[key]
        pos = _positions(*toks.shape) if mrope else None
        rules = JRules(mesh=mesh_dm, **kw)
        with mesh_dm:
            logits, aux = jax.jit(lambda p, t, q: j_get_model(jcfg).forward(
                p, t, jcfg, rules, positions=q))(
                p, jnp.asarray(toks), None if pos is None else
                jnp.asarray(pos))
        want[name] = (np.asarray(logits, np.float32), float(aux))
        cases.append((name, tcfg, {k: np.asarray(v) for k, v in p.items()},
                      toks, pos, kw))
    return want, spawn(ranks.model_forwards, 8, "gloo", args=(cases,))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_reference_islands(runs, name):
    want, results = runs
    logits, aux = want[name]
    tol = MOE_TOL if name.startswith("moe") else DENSE_TOL
    for rank, res in enumerate(results):
        got, got_aux, last, drops = res[name]
        np.testing.assert_allclose(got, logits, err_msg=f"rank {rank}",
                                   **tol)
        np.testing.assert_allclose(last[:, 0], logits[:, -1],
                                   err_msg=f"rank {rank}", **tol)
        assert abs(float(got_aux) - aux) <= 1e-4 * max(1.0, abs(aux))
        if "cf 1" in name:
            assert sum(r[name][3] for r in results) > 0, "nothing dropped"
        elif name.startswith("moe"):
            assert drops == 0


def test_shards_round_trip(runs):
    """Each rank's blocks (``shard_params``) have ``shard_table``'s
    shapes and gather back (``gather_params``) to the full parameters;
    ``init_params(..., rules=)`` draws exactly the blocks of the full
    draw."""
    _want, results = runs
    assert all(all(r["round trip"].values()) for r in results)
    assert set(results[0]["round trip"]) == set(CASES)


def test_ranks_import_nothing_of_jax_or_repro(runs):
    _want, results = runs
    assert all(r["modules"] == [] for r in results), results[0]["modules"]
