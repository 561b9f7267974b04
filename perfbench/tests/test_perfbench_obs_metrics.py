"""The readers of the program's spans and counters (``moe_plain_share``,
``gmm_row_fill``, ``step_idle_share``) on hand-built contexts, on a
program without ``repro_torch.obs`` (as before it existed: each reads
None), and in a tiny traced run on the CPU, where the row fill equals a
plain count from the router's own top-k and the two device timings are
left out of the line."""
import sys
import time

import pytest
import torch

from perfbench.harness import cell, spec
from perfbench.harness.trace import Trace
from perfbench.harness.traffic import lengths
from repro_torch import obs
from repro_torch.configs.base import MoEConfig

from .tiny import conf as tiny_conf, traffic as tiny_traffic

NEW = ("moe_plain_share", "gmm_row_fill", "step_idle_share")


def _read(name, ctx):
    return spec.reader(name).read(ctx)


def _ctx(trace):
    return cell.Context({}, [], [], 1.0, 0.0, None, trace)


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def test_step_idle_share_counts_gaps_inside_step_spans():
    # steps on the host 5-32 and 38-58; the cycle's last event ends at 60,
    # so the window is 5-60 (55 us).  Device busy in it 5-10, 15-30,
    # 40-50, 52-60 (38 us; the operation at 0-10 clipped to the window):
    # idle 17 us, of which 10-15, 30-32, 38-40 and 50-52 (11 us) lie
    # inside the steps and 32-38 between them
    dev = [("k", 0, 10), ("k", 15, 25), ("k", 20, 30), ("k", 40, 50),
           ("k", 52, 60)]
    host = [("repro_torch.prefill_step", 5, 32),
            ("repro_torch.prefill_step", 38, 58),
            ("repro_torch.moe", 16, 20), ("perfbench: prefill_step", 4, 33)]
    tr = Trace(dev, host, 60e-6)
    step_idle = _read("step_idle_share", _ctx(tr))
    assert step_idle == pytest.approx(100 * 11 / 55)
    assert step_idle <= _read("device_idle_share", _ctx(tr))
    # device work from before the window (an earlier trace's) is clipped
    # away
    tr = Trace(dev + [("k", -100, -50)], host, 60e-6)
    assert _read("step_idle_share", _ctx(tr)) == pytest.approx(step_idle)


def test_gmm_row_fill_reads_the_counters():
    with obs.recording():
        obs.count("moe.kept", torch.tensor(30))
        obs.count("moe.kept", 45)
        obs.count("moe.gmm_rows", 100)
    assert _read("gmm_row_fill", _ctx(Trace([], [], 1.0))) == \
        pytest.approx(75.0)


def test_moe_plain_share_puts_each_operation_down_to_its_launch():
    host = [("repro_torch.prefill_step", 0, 100),
            ("repro_torch.moe", 10, 50), ("repro_torch.moe.route", 12, 15),
            ("repro_torch.moe.gmm", 20, 30), ("aten::mm", 20.5, 22),
            # the calls that enqueue device work, and one that does not
            ("cudaLaunchKernel", 11, 11.5), ("cudaLaunchKernel", 13, 13.5),
            ("cudaEventRecord", 14, 14.2), ("cudaLaunchKernel", 21, 21.5),
            ("cudaLaunchKernel", 40, 42), ("cuLaunchKernel", 40.5, 41.5),
            ("cudaLaunchKernel", 60, 60.5), ("cudaMemcpyAsync", 70, 71),
            ("cudaLaunchKernel", 150, 151)]
    # the device runs them in order, later: moe 2 + route 3 + moe 4 us
    # (the nested cuLaunchKernel is the same launch), gmm 10, the step's own
    # kernel 5 and copy 6, then a kernel after the step
    dev = [("a", 100, 102), ("b", 102, 105), ("gmm", 105, 115),
           ("c", 116, 120), ("d", 120, 125),
           ("Memcpy HtoD (Pageable -> Device)", 126, 132), ("e", 160, 167)]
    share = _read("moe_plain_share", _ctx(Trace(dev, host, 1.0)))
    assert share == pytest.approx(100 * 9 / 30)
    # a trace that lost its first kernel (a later profiler session in a
    # process): the rest still pair with their own calls
    share = _read("moe_plain_share", _ctx(Trace(dev[1:], host, 1.0)))
    assert share == pytest.approx(100 * 7 / 28)
    # one that lost its last: pairing from the end would put a kernel
    # before its call, so the pairs run from the start
    assert _read("moe_plain_share", _ctx(Trace(dev[:-1], host, 1.0))) == \
        pytest.approx(100 * 9 / 30)
    # a trace with no device operations (a CPU run): no device timing
    assert _read("moe_plain_share", _ctx(Trace([], host, 1.0))) is None


def test_none_when_nothing_was_recorded():
    tr = Trace([("k", 0, 10)], [("aten::mm", 0, 5)], 1.0)
    for name in NEW:
        assert _read(name, _ctx(tr)) is None
        assert _read(name, _ctx(None)) is None


def test_none_on_a_program_without_obs(monkeypatch):
    """The parent's program: no ``repro_torch.obs`` to import, no
    ``repro_torch.*`` ranges in its trace."""
    with obs.recording():
        with obs.span("prefill_step"), obs.span("moe"):
            obs.count("moe.kept", 1)
            obs.count("moe.gmm_rows", 2)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "obs")
    with pytest.raises(ImportError):
        from repro_torch import obs as _  # noqa: F401
    tr = Trace([("k", 0, 10), ("k", 20, 30)],
               [("perfbench: prefill_step", 0, 30)], 1.0)
    for name in NEW:
        assert _read(name, _ctx(tr)) is None


@pytest.mark.parametrize("name", ["mixtral_8x7b_16L.prefill_long"])
def test_tiny_traced_run_counts_the_rows_it_computes(name, monkeypatch):
    from repro_torch.models import moe
    c = spec.workload(spec.benchmark(), name)
    conf = tiny_conf(c["config"])
    routed = []
    real = moe.router_topk

    def topk(x2d, w, k):
        idx, weights, aux = real(x2d, w, k)
        if obs.active():
            routed.append(idx)
        return idx, weights, aux
    monkeypatch.setattr(moe, "router_topk", topk)
    r = cell.run(name, 2**33 + 7, 0.1, True, "cpu", time.perf_counter(),
                 conf=conf, traffic=tiny_traffic(c["traffic"]),
                 limits={"sample": 1,
                         "numbers": {"max_gap": {"limit": 1e-3}}})
    m = MoEConfig(**conf["moe"])
    kept = rows = 0
    for idx in routed:
        cap = moe.capacity(idx.shape[0], m)
        n_e = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
        kept += int(n_e.clamp_max(cap).sum())
        rows += m.num_experts * cap
    # the traced cycle: one step a length, every layer an MoE
    steps = len(lengths(tiny_traffic(c["traffic"])))
    assert len(routed) == conf["num_layers"] * steps and kept < rows
    assert r["metrics"]["gmm_row_fill"]["value"] == \
        pytest.approx(100 * kept / rows, rel=1e-12)
    assert "moe_plain_share" not in r["metrics"]
    assert "step_idle_share" not in r["metrics"]
