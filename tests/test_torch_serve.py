"""The port's continuous-batching ``Server`` against the JAX package's.

The JAX ``Server`` runs the reduced Jamba (and, for the other families,
the reduced Mixtral, Mamba-2 LM and Whisper) on a 1x1 mesh; its own parameters are
converted with ``params_from_jax`` and served by the port's ``Server`` on
the CPU.  Greedy tokens must be identical: both sides compute in fp32 and
differ by ~1e-6 in the logits (the tolerance of
``tests/test_torch_jamba.py`` is 2e-4), far below the gap between the
best and second-best logit of these random weights, which the tests
check.  The rest covers slot reuse and that a re-admitted slot starts
from a zero SSM state (dimension 2 of the hybrid's cache, 1 of the
Mamba-2 LM's).
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.serve import Request, Server
from repro_torch.models.convert import params_from_jax

ARCH = "jamba-v0.1-52b"


def _prompts(cfg, n, seed, lo=3, hi=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _serve(server, prompts, max_new, req=Request):
    for i, p in enumerate(prompts):
        server.submit(req(rid=i, prompt=p, max_new=max_new))
    server.run(tick_limit=500)
    return [r.out for r in sorted(server.completed, key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Server's outputs, ticks and parameters: 3 requests, 2
    slots."""
    cfg = j_reduced_config(j_get_config(ARCH))
    mesh = make_test_mesh((1, 1), ("data", "model"))
    server = JServer(cfg, mesh, slots=2, max_seq=32)
    prompts = _prompts(cfg, 3, seed=0)
    outs = _serve(server, prompts, max_new=5, req=JRequest)
    params = {k: np.asarray(v) for k, v in server.params.items()}
    return prompts, outs, server.ticks, params


def _port_server(params, slots, max_seq=32, cfg=None):
    cfg = cfg or reduced_config(get_config(ARCH))
    return Server(cfg, slots=slots, max_seq=max_seq, device="cpu",
                  params=params_from_jax(cfg, params, device="cpu"))


def test_server_tokens_equal_the_reference(jax_run):
    prompts, j_outs, j_ticks, params = jax_run
    server = _port_server(params, slots=2)
    outs = _serve(server, prompts, max_new=5)
    assert len(outs) == 3 and all(len(o) == 5 for o in outs)
    assert outs == j_outs
    assert server.ticks == j_ticks


def test_greedy_margin_is_wide_enough_to_compare_tokens(jax_run):
    """The comparison above is sound: the best logit of every served
    step leads the runner-up by far more than the two packages differ."""
    prompts, _o, _t, params = jax_run
    server = _port_server(params, slots=2)
    margins = []
    step = server.serve_step

    def spy(model, cache, tokens):
        logits, _ = model.decode_step({k: v.clone() for k, v in cache.items()},
                                      tokens)
        top = logits.topk(2, dim=-1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
        return step(model, cache, tokens)

    server.serve_step = spy
    _serve(server, prompts, max_new=5)
    assert min(margins) > 1e-4


def test_slot_reuse_matches_isolated_runs(jax_run):
    """More requests than slots: slots recycle, and every request's tokens
    equal a run of that request alone."""
    _p, _o, _t, params = jax_run
    cfg = reduced_config(get_config(ARCH))
    prompts = _prompts(cfg, 5, seed=2, lo=2, hi=5)
    server = _port_server(params, slots=2)
    packed = _serve(server, prompts, max_new=4)
    assert len(packed) == 5 and server.ticks < 500
    alone = [_serve(_port_server(params, slots=1), [p], max_new=4)[0]
             for p in prompts]
    assert packed == alone


def test_readmitted_slot_starts_from_zero_state(jax_run):
    """Admission zeroes the slot's length, SSM state and convolution tail
    (dimension 2 of ``state`` and ``conv``) and leaves the other slot's
    alone."""
    _p, _o, _t, params = jax_run
    server = _port_server(params, slots=2)
    server.submit(Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                          max_new=1))
    server.submit(Request(rid=1, prompt=np.array([9, 10, 11, 12], np.int32),
                          max_new=6))
    for _ in range(4):               # request 0 finishes, slot 0 frees
        server.tick()
    assert [r.rid for r in server.completed] == [0]
    assert server.active[0] is None
    state, conv = server.cache["state"], server.cache["conv"]
    assert float(state[:, :, 0].abs().sum()) > 0
    other = state[:, :, 1].clone(), conv[:, :, 1].clone()
    server.submit(Request(rid=2, prompt=np.array([1, 2], np.int32),
                          max_new=2))
    server._admit()
    assert int(server.cache["len"][0]) == 0
    assert float(state[:, :, 0].abs().sum()) == 0
    assert float(conv[:, :, 0].abs().sum()) == 0
    assert torch.equal(state[:, :, 1], other[0])
    assert torch.equal(conv[:, :, 1], other[1])
    server.run(tick_limit=100)
    assert sorted(r.rid for r in server.completed) == [0, 1, 2]
    # ... and serving it then gives the tokens it gets alone
    alone = _serve(_port_server(params, slots=1),
                   [np.array([1, 2], np.int32)], max_new=2)[0]
    assert next(r.out for r in server.completed if r.rid == 2) == alone


def _margin_spy(server):
    """Wrap ``server.serve_step`` to record the smallest gap between the
    best and second-best logit of every step."""
    margins = []
    step = server.serve_step

    def spy(model, cache, tokens):
        logits, _ = model.decode_step({k: v.clone() for k, v in cache.items()},
                                      tokens)
        top = logits.topk(2, dim=-1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
        return step(model, cache, tokens)

    server.serve_step = spy
    return margins


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-370m",
                                  "whisper-large-v3"])
def test_server_tokens_equal_the_reference_for_other_families(arch):
    """The MoE transformer (sliding-window cache), the Mamba-2 LM and
    Whisper (its cross KV zero in both, as both ``Server``s build the
    cache without an encoder output): 3 requests on 2 slots, the port's
    tokens and ticks equal the JAX ``Server``'s, with the greedy margin far
    above the packages' difference."""
    jcfg = j_reduced_config(j_get_config(arch))
    jserver = JServer(jcfg, make_test_mesh((1, 1), ("data", "model")),
                      slots=2, max_seq=32)
    prompts = _prompts(jcfg, 3, seed=5)
    j_outs = _serve(jserver, prompts, max_new=5, req=JRequest)
    params = {k: np.asarray(v) for k, v in jserver.params.items()}
    server = _port_server(params, slots=2,
                          cfg=reduced_config(get_config(arch)))
    margins = _margin_spy(server)
    outs = _serve(server, prompts, max_new=5)
    assert len(outs) == 3 and all(len(o) == 5 for o in outs)
    assert outs == j_outs
    assert server.ticks == jserver.ticks
    assert min(margins) > 1e-4


def test_readmitted_mamba2_slot_starts_from_zero_state():
    """The Mamba-2 LM's cache is (L, B, ...): admission zeroes slot 0's
    length, state and convolution tail along dimension 1 and leaves slot
    1's alone; the re-admitted request then gets the tokens it gets
    alone."""
    from repro_torch.models.convert import init_params
    cfg = reduced_config(get_config("mamba2-370m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def port(slots):
        return Server(cfg, slots=slots, max_seq=32, device="cpu",
                      params=params)

    server = port(2)
    server.submit(Request(rid=0, prompt=np.array([5, 6, 7], np.int32),
                          max_new=1))
    server.submit(Request(rid=1, prompt=np.array([9, 10, 11, 12], np.int32),
                          max_new=6))
    for _ in range(4):               # request 0 finishes, slot 0 frees
        server.tick()
    assert [r.rid for r in server.completed] == [0]
    state, conv = server.cache["state"], server.cache["conv"]
    assert state.dim() == 5 and state.shape[1] == 2
    assert float(state[:, 0].abs().sum()) > 0
    assert float(conv[:, 0].abs().sum()) > 0
    other = state[:, 1].clone(), conv[:, 1].clone()
    server.submit(Request(rid=2, prompt=np.array([1, 2], np.int32),
                          max_new=2))
    server._admit()
    assert int(server.cache["len"][0]) == 0
    assert float(state[:, 0].abs().sum()) == 0
    assert float(conv[:, 0].abs().sum()) == 0
    assert torch.equal(state[:, 1], other[0])
    assert torch.equal(conv[:, 1], other[1])
    server.run(tick_limit=100)
    assert sorted(r.rid for r in server.completed) == [0, 1, 2]
    alone = _serve(port(1), [np.array([1, 2], np.int32)], max_new=2)[0]
    assert next(r.out for r in server.completed if r.rid == 2) == alone


def test_transformer_reset_slot_zeroes_only_the_length():
    """A transformer's slot reset zeroes ``len`` alone, as the reference's
    does: stale KV and ``pos`` stay, masked by length and overwritten by
    the new request's appends."""
    from repro_torch.models import get_model
    cfg = reduced_config(get_config("mixtral-8x7b"))
    model = get_model(cfg)(cfg, device="cpu")
    cache = model.init_cache(2, 8)
    for leaf in cache.values():
        leaf.fill_(3)
    before = {k: v.clone() for k, v in cache.items()}
    model.reset_slot(cache, 0)
    assert cache["len"].tolist() == [0, 3]
    for k in ("k", "v", "pos"):
        assert torch.equal(cache[k], before[k])
