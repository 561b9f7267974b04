"""The port's spans and counters (``repro_torch.obs``) on the CPU.

* spans nest with the right parent and step id, and the self times of
  ``device_seconds()`` add up to the roots' totals;
* off, no span enters a profiler range and no counter keeps a value;
* under a CPU ``torch.profiler`` the ``repro_torch.*`` ranges of a tiny
  Mixtral and a tiny Jamba prefill nest under ``repro_torch.prefill_step``,
  each under the span that holds it;
* ``train_step``'s phases are root spans, ``cross_entropy`` inside the
  loss's;
* the MoE counters equal a plain count from the router's own top-k where
  capacity binds: kept = sum over experts of min(n_e,
  capacity), rows = E x capacity; ``counting_drops`` yields each call's
  drops, turns on no span and no other counter, and keeps nothing after
  its block;
* logits are bitwise equal with recording on and off;
* the expert FFN fuses its gate/up products (``moe_gmm.grouped_swiglu``)
  only
  where autograd does not record and the operands are bf16 at a ``tma``
  shape, computes the same function either way, and counts
  ``moe.ffn_fused`` (1 or 0) once a call.
"""
import time

import pytest
import torch

from repro_torch import obs, optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ref
from repro_torch.launch.step import prefill_step, train_step
from repro_torch.models import get_model, moe
from repro_torch.models.convert import init_params

ARCHS = ("mixtral-8x7b", "jamba-v0.1-52b")
PREFILL_SPANS = {"prefill_step", "embed", "attention", "attention.flash",
                 "moe", "moe.route", "moe.dispatch", "moe.gmm",
                 "moe.combine", "head"}
JAMBA_SPANS = {"mamba", "mamba.ssd", "mlp"}
# each span's parent in a one-card prefill
PARENT = {"embed": "prefill_step", "attention": "prefill_step",
          "attention.flash": "attention", "moe": "prefill_step",
          "moe.route": "moe", "moe.dispatch": "moe", "moe.gmm": "moe",
          "moe.combine": "moe", "head": "prefill_step",
          "mamba": "prefill_step", "mamba.ssd": "mamba",
          "mlp": "prefill_step"}


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def _model(arch):
    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, get_model(cfg)(cfg, "cpu", params=params)


@pytest.fixture(scope="module", params=ARCHS)
def tiny(request):
    """(config, model, batch) of a reduced model, 40 tokens."""
    cfg, model = _model(request.param)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, {"tokens": tokens}


def test_spans_nest_with_parent_and_step_id():
    with obs.recording():
        for _ in range(2):
            with obs.span("root"):
                with obs.span("a"):
                    time.sleep(0.002)
                    with obs.span("a.b"):
                        time.sleep(0.002)
                with obs.span("c"):
                    time.sleep(0.001)
    got = [(s.name, s.parent.name if s.parent else None, s.step)
           for s in obs.records()]
    assert got == [("root", None, 1), ("a", "root", 1), ("a.b", "a", 1),
                   ("c", "root", 1), ("root", None, 2), ("a", "root", 2),
                   ("a.b", "a", 2), ("c", "root", 2)]
    ds = obs.device_seconds()
    assert {k: v["calls"] for k, v in ds.items()} == {
        "root": 2, "a": 2, "a.b": 2, "c": 2}
    assert sum(v["self"] for v in ds.values()) == \
        pytest.approx(ds["root"]["total"], rel=1e-9)
    assert ds["a"]["self"] == pytest.approx(
        ds["a"]["total"] - ds["a.b"]["total"], rel=1e-9)
    assert ds["a.b"]["self"] == ds["a.b"]["total"] >= 0.004
    assert min(v["self"] for v in ds.values()) >= 0


def test_counters_sum_host_and_device_values():
    with obs.recording():
        obs.count("n", 3)
        obs.count("n", torch.tensor(4))
        obs.count("n", torch.tensor([True, False, True]).sum())
    obs.count("n", 100)                       # off: not kept
    assert obs.counters() == {"n": 9}


def test_off_enters_no_range(tiny, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered with obs off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _cfg, model, batch = tiny
    assert not obs.active()
    assert obs.span("prefill_step") is obs.span("moe")
    prefill_step(model, batch)
    assert obs.records() == [] and obs.counters() == {}


def _range_chains(prof):
    """Each ``repro_torch.*`` host range: (its span name, the names of the
    ``repro_torch.*`` ranges above it, innermost first)."""
    out = []
    for ev in prof.events():
        if not ev.name.startswith("repro_torch."):
            continue
        chain, p = [], ev.cpu_parent
        while p is not None:
            if p.name.startswith("repro_torch."):
                chain.append(p.name[len("repro_torch."):])
            p = p.cpu_parent
        out.append((ev.name[len("repro_torch."):], chain))
    return out


def test_profiler_ranges_nest_under_prefill_step(tiny):
    from torch.profiler import ProfilerActivity, profile
    cfg, model, batch = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill_step(model, batch)
    chains = _range_chains(prof)
    want = PREFILL_SPANS | (JAMBA_SPANS if cfg.family == "hybrid" else set())
    assert {name for name, _ in chains} == want
    for name, chain in chains:
        if name == "prefill_step":
            assert chain == []
        else:
            assert chain[0] == PARENT[name] and chain[-1] == "prefill_step"
    # the profiler turned the spans on: their records match its ranges
    assert sorted(s.name for s in obs.records()) == \
        sorted(name for name, _ in chains)
    assert {s.step for s in obs.records()} == {1}
    n_moe = sum(1 for name, _ in chains if name == "moe")
    assert sum(1 for name, _ in chains if name == "moe.gmm") == 3 * n_moe


def test_logits_bitwise_equal_with_recording_on_and_off(tiny):
    _cfg, model, batch = tiny
    off = prefill_step(model, batch)
    with obs.recording():
        on = prefill_step(model, batch)
    assert obs.records()
    assert torch.equal(on, off)


def test_moe_counters_equal_a_plain_count(tiny, monkeypatch):
    cfg, model, _batch = tiny
    m = cfg.moe
    # one token repeated: every position routes alike, so capacity binds
    batch = {"tokens": torch.full((1, 40), 7)}
    routed = []
    real = moe.router_topk

    def topk(x2d, w, k):
        idx, weights, aux = real(x2d, w, k)
        routed.append(idx)
        return idx, weights, aux
    monkeypatch.setattr(moe, "router_topk", topk)
    with obs.recording(), moe.counting_drops() as outer_before:
        prefill_step(model, batch)
        with moe.counting_drops() as drops:
            prefill_step(model, batch)
    calls = routed[len(routed) // 2:]
    assert len(calls) == len(drops) and len(outer_before) == 2 * len(drops)
    kept = rows = assigned = 0
    for idx, lost in zip(calls, drops):
        cap = moe.capacity(idx.shape[0], m)
        n_e = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
        k = int(n_e.clamp_max(cap).sum())
        assert int(lost) == idx.numel() - k
        kept, rows, assigned = kept + k, rows + m.num_experts * cap, \
            assigned + idx.numel()
    got = obs.counters()
    assert got["moe.kept"] == 2 * kept and got["moe.gmm_rows"] == 2 * rows
    assert got["moe.ffn_fused"] == 0         # fp32: three grouped matmuls
    assert got["moe.dropped"] == 2 * (assigned - kept)
    assert kept < assigned


@pytest.mark.parametrize("case,fused", [
    ("bf16 inference", True), ("autograd records", False),
    ("fp32", False), ("decode rows", False), ("ragged rows", False)])
def test_expert_ffn_fuses_gate_up_only_in_bf16_inference(case, fused,
                                                          monkeypatch):
    e, m, k, n = 4, 64 if case == "decode rows" else 130, \
        40 if case == "ragged rows" else 128, 64
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    g = torch.Generator().manual_seed(3)
    buf = torch.randn(e, m, k, generator=g).to(dtype)
    w_gate, w_up = (torch.randn(e, k, n, generator=g).mul(k ** -0.5)
                    .to(dtype) for _ in range(2))
    w_down = torch.randn(e, n, k, generator=g).mul(n ** -0.5).to(dtype)
    if case == "ragged rows":        # a row of 40 + 1 bf16: 82 bytes
        buf = torch.randn(e, m, k + 1, generator=g).to(dtype)
        w_gate, w_up = (torch.randn(e, k + 1, n, generator=g).to(dtype)
                        for _ in range(2))
        w_down = torch.randn(e, n, k + 1, generator=g).to(dtype)
    if case == "autograd records":
        w_gate.requires_grad_()
    calls = []
    for name in ("grouped_matmul", "grouped_swiglu"):
        def spy(*a, _name=name, _real=getattr(moe, name)):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(moe, name, spy)
    grad = case == "autograd records"
    with torch.set_grad_enabled(grad), obs.recording():
        out = moe._expert_ffn(buf, w_gate, w_up, w_down)
    assert calls == (["grouped_swiglu", "grouped_matmul"] if fused
                     else ["grouped_matmul"] * 3)
    assert obs.counters()["moe.ffn_fused"] == int(fused)
    assert out.requires_grad == grad
    with torch.no_grad():
        gg = ref.grouped_matmul_ref(buf, w_gate)
        uu = ref.grouped_matmul_ref(buf, w_up)
        h = (torch.nn.functional.silu(gg.float()) * uu.float()).to(dtype)
        assert torch.equal(out.detach(), ref.grouped_matmul_ref(h, w_down))


def test_ffn_fused_counts_once_a_call():
    """A bf16 prefill whose capacity takes the ``tma`` variant (200 tokens,
    128 rows an expert): every MoE call runs the fused gate/up kernel, and
    ``moe.ffn_fused`` counts 1 a call, as many as the ``moe`` spans."""
    cfg = reduced_config(get_config("mixtral-8x7b"), dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = get_model(cfg)(cfg, "cpu", params=params)
    assert moe.capacity(200, cfg.moe) == 128
    tokens = torch.randint(0, cfg.vocab_size, (1, 200),
                           generator=torch.Generator().manual_seed(1))
    with obs.recording():
        prefill_step(model, {"tokens": tokens})
    n_moe = sum(1 for s in obs.records() if s.name == "moe")
    assert n_moe == cfg.num_layers
    assert obs.counters()["moe.ffn_fused"] == n_moe
    assert sum(1 for s in obs.records() if s.name == "moe.gmm") == 2 * n_moe


def test_counting_drops_alone_keeps_nothing(tiny):
    _cfg, model, _batch = tiny
    batch = {"tokens": torch.full((1, 40), 7)}
    with moe.counting_drops() as drops:
        assert obs.active("moe.dropped") and not obs.active()
        assert obs.span("moe") is obs.span("prefill_step")
        prefill_step(model, batch)
    assert not obs.active("moe.dropped")
    assert obs.records() == [] and obs.counters() == {}
    with obs.recording(), moe.counting_drops() as again:
        prefill_step(model, batch)
    assert [int(d) for d in drops] == [int(d) for d in again]
    assert obs.counters()["moe.dropped"] == sum(int(d) for d in drops) > 0


def test_train_step_phases_are_spans():
    cfg, model = _model("mixtral-8x7b")
    model.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(2))
    state = optim.init(dict(model.named_parameters()))
    with obs.recording():
        train_step(model, optim.OptConfig(), state,
                   {"tokens": tokens, "labels": tokens.roll(-1, 1),
                    "mask": torch.ones(tokens.shape)})
    top = [(s.name, s.parent.name if s.parent else None, s.step)
           for s in obs.records() if s.name.startswith("train_step")
           or s.name == "cross_entropy"]
    assert top == [("train_step: loss", None, 1),
                   ("cross_entropy", "train_step: loss", 1),
                   ("train_step: backward", None, 2),
                   ("train_step: optimizer", None, 3)]
