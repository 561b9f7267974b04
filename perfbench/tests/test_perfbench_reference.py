"""The plain references against the port's plain path on the CPU at a
reduced size, with the same weights, and the SSD reference against the
recurrence it stands for."""
import dataclasses

import pytest
import torch

from perfbench.reference import common, jamba, mixtral
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.step import prefill_step
from repro_torch.models import get_model
from repro_torch.models.convert import init_params

CASES = {
    "jamba": ("jamba-v0.1-52b", jamba, {}),
    "mixtral": ("mixtral-8x7b", mixtral, {"sliding_window": None}),
    "mixtral_window": ("mixtral-8x7b", mixtral, {"sliding_window": 24}),
}


def _cfg(case, capacity_factor):
    arch, mod, kw = CASES[case]
    cfg = reduced_config(get_config(arch), **kw)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    return cfg, mod


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_port(case, capacity_factor):
    """fp32 last-position logits equal the port's prefill to rounding, at
    the configuration's capacity and at one that drops assignments."""
    cfg, mod = _cfg(case, capacity_factor)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    model = get_model(cfg)(cfg, "cpu", params=params)
    tokens = torch.randint(0, cfg.vocab_size, (1, 77),
                           generator=torch.Generator().manual_seed(4))
    port = prefill_step(model, {"tokens": tokens})[0]
    ref = mod.last_logits(dataclasses.asdict(cfg), params, tokens[0])[0]
    assert ref.dtype == torch.float32 and ref.shape == port.shape
    err = float((port - ref).abs().max() / ref.abs().max())
    assert err < 1e-5, err


@pytest.mark.parametrize("suffix", [1, 4])
@pytest.mark.parametrize("case", ["jamba", "mixtral_window"])
def test_paths_retrace_the_last_position(case, suffix, monkeypatch):
    """A path that takes every decision as the reference does (each fork
    made the route itself) reproduces the reference's own last logits:
    the paths' attention over the context, convolution window, state and
    expert loads are the sequence's.  A path that takes one the other way
    does not."""
    cfg, mod = _cfg(case, 0.5)
    conf = dataclasses.asdict(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (61,),
                           generator=torch.Generator().manual_seed(6))
    rule = {"margin": 1e9, "slack": 1e9, "most": 64, "suffix": suffix}
    swapped = mod.last_logits(conf, params, tokens, rule=rule)
    assert swapped.shape[0] >= 3
    assert float((swapped[1:] - swapped[0]).abs().max()) > 1e-3
    monkeypatch.setattr(common, "_forks",
                        lambda lg, route, *a: [(0.0, route)])
    same = mod.last_logits(conf, params, tokens, rule=rule)
    assert same.shape[0] >= 3
    assert torch.allclose(same[1:], same[:1].expand_as(same[1:]),
                          rtol=1e-4, atol=1e-4)


def test_ssd_matches_recurrence():
    g = torch.Generator().manual_seed(0)
    S, H, P, G, N = 150, 4, 8, 2, 16
    x = torch.randn(S, H, P, generator=g)
    dt = torch.rand(S, H, generator=g) * 0.5
    A = -torch.linspace(1, 4, H)
    B = torch.randn(S, G, N, generator=g)
    C = torch.randn(S, G, N, generator=g)
    h = torch.zeros(H, N, P)
    want = []
    for t in range(S):
        Bt = B[t].repeat_interleave(H // G, 0)
        Ct = C[t].repeat_interleave(H // G, 0)
        h = torch.exp(dt[t] * A)[:, None, None] * h + \
            dt[t][:, None, None] * Bt[:, :, None] * x[t][:, None, :]
        want.append(torch.einsum("hn,hnp->hp", Ct, h))
    got = common.ssd(x, dt, A, B, C, chunk=32)
    assert torch.allclose(got, torch.stack(want), rtol=1e-4, atol=1e-4)


def test_capacity_fifo_drops_latest_arrivals():
    """An expert over its capacity keeps the first assignments in arrival
    order: with every token routed to the same two experts, the last
    tokens lose their MoE output."""
    cfg = {"moe": {"num_experts": 4, "top_k": 2, "capacity_factor": 1.0,
                   "d_ff_expert": 8}}
    T, D = 40, 16
    h = torch.ones(T, D)
    router = torch.zeros(D, 4)
    router[:, 0], router[:, 1] = 1.0, 0.5
    w = torch.ones(4, D, 8), torch.ones(4, D, 8), torch.ones(4, 8, D)
    out, _, _ = common.moe(h, h[:0], router, *w, cfg, common.fp32_linear)
    cap = common.capacity(T, cfg["moe"])
    assert cap == 24
    assert bool((out[:cap] != 0).all()) and bool((out[cap:] == 0).all())


def test_fp8_control_is_coarser_than_fp32():
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(64, 128, generator=g), torch.randn(128, 96, generator=g)
    exact = common.fp32_linear(x, w)
    rel = float((common.fp8_linear(x, w) - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1, rel
