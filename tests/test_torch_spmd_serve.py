"""The port's mesh ``Server`` against the reference's, and a world of one
rank against the single-card port.

* the mesh ``Server`` (every rank the same admission loop) against the
  reference's ``Server(cfg, mesh_dm, ...)`` on ``tests/test_serve.py``'s
  three scenarios, on the reference server's own parameters: tokens
  identical, ticks equal; each request alone (1 slot: the batch axis
  dropped, the cache over every rank) equal to it packed;
* the same for Mamba-2, Jamba and Whisper (reduced, fp32; Whisper's
  cache built without an encoder output, as the reference's ``Server``
  builds it): the recurrent state reset on every slot re-admission, the
  mixers head-parallel, the KV over ``kv_seq``;
* a world of one rank (mesh 1 x 1) equals the single-card port: forward
  and prefill logits and greedy decode tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models.api import get_model as j_get_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import spawn
from repro_torch.launch.step import serve_step
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(arch, **overrides):
    return (j_reduced_config(j_get_config(arch), **overrides),
            reduced_config(get_config(arch), **overrides))


# ---------------------------------------------------------------------------
# the mesh Server: tests/test_serve.py's three scenarios
# ---------------------------------------------------------------------------

SERVE_CFG = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                 head_dim=32, d_ff=128, vocab_size=128)


def _prompts(seed, n, size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=size).astype(np.int32)
            for _ in range(n)]


# name -> (prompts, slots, max_new), as in tests/test_serve.py
SCENARIOS = {"all requests complete": (_prompts(0, 6, 5), 2, 6),
             "packed": (_prompts(1, 4, 4), 2, 6),
             "slot reuse": (_prompts(2, 5, 3), 2, 4)}
SCENARIOS.update({f"isolated {i}": ([p], 1, 6) for i, p in
                  enumerate(SCENARIOS["packed"][0])})


# name -> (arch, prompts, slots, max_new): the other families' servers
FAMILY_SERVERS = {
    "mamba2": ("mamba2-370m", _prompts(3, 5, 4), 2, 5),
    "jamba": ("jamba-v0.1-52b", _prompts(4, 5, 4), 2, 5),
    "whisper": ("whisper-large-v3", _prompts(5, 5, 4), 2, 5),
}


@pytest.fixture(scope="module")
def serve_runs(mesh_dm):
    jcfg, tcfg = _cfgs("stablelm-3b", **SERVE_CFG)
    runs = [(name, jcfg, tcfg) + v for name, v in SCENARIOS.items()]
    runs += [(name, *_cfgs(arch), prompts, slots, max_new)
             for name, (arch, prompts, slots, max_new)
             in FAMILY_SERVERS.items()]
    want, cases = {}, []
    for name, jcfg, tcfg, prompts, slots, max_new in runs:
        server = JServer(jcfg, mesh_dm, slots=slots, max_seq=64)
        for i, p in enumerate(prompts):
            server.submit(JRequest(rid=i, prompt=p, max_new=max_new))
        server.run(tick_limit=500)
        done = sorted(server.completed, key=lambda r: r.rid)
        want[name] = ([r.out for r in done], server.ticks)
        cases.append((name, tcfg, {k: np.asarray(v) for k, v in
                                   server.params.items()},
                      prompts, slots, max_new, 64))
    return want, spawn(ranks.servers, 8, "gloo", args=(cases,))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_server_tokens_equal_reference(serve_runs, name):
    want, results = serve_runs
    for rank, res in enumerate(results):
        assert res[name] == want[name], f"rank {rank}"
    outs, _ticks = want[name]
    assert all(len(o) == SCENARIOS[name][2] for o in outs)


@pytest.mark.parametrize("name", list(FAMILY_SERVERS))
def test_family_mesh_server_tokens_equal_reference(serve_runs, name):
    want, results = serve_runs
    for rank, res in enumerate(results):
        assert res[name] == want[name], f"rank {rank}"
    outs, _ticks = want[name]
    assert len(outs) == 5 and all(len(o) == 5 for o in outs)


def test_mesh_server_packed_equals_isolated(serve_runs):
    """Continuous batching on the mesh: each request's tokens alone (1
    slot: the batch axis dropped, the cache over every rank) equal its
    tokens packed 2 to a batch."""
    _want, results = serve_runs
    packed = results[0]["packed"][0]
    assert packed == [results[0][f"isolated {i}"][0][0]
                      for i in range(len(packed))]


# ---------------------------------------------------------------------------
# a world of one rank
# ---------------------------------------------------------------------------

def test_one_rank_world_equals_the_single_card_port():
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    p = {k: np.asarray(v) for k, v in
         j_get_model(jcfg).init_params(jcfg, jax.random.key(2)).items()}
    tokens = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(
        np.int32)
    steps = np.random.default_rng(4).integers(0, 512, (6, 2)).astype(
        np.int32)
    logits, last, toks = spawn(ranks.one_rank, 1, "gloo",
                               args=(tcfg, p, tokens, steps, 32))[0]
    model = get_model(tcfg)(tcfg, device="cpu",
                            params=params_from_jax(tcfg, p, device="cpu"))
    with torch.no_grad():
        want, _ = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits, want.numpy(), **TOL)
    np.testing.assert_allclose(last, want.numpy()[:, -1], **TOL)
    cache = model.init_cache(2, 32)
    for i, tok in enumerate(steps):
        nxt, cache = serve_step(model, cache, torch.from_numpy(tok))
        np.testing.assert_array_equal(toks[i], nxt.numpy())
