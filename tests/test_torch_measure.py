"""The port's phased load–latency measurement
(``repro_torch.netsim.measure``) against ``repro.netsim_jax.measure`` on
a 4x4 mesh, on the CPU: the batched sweep, and the one-lane streaming
measurement fence block by fence block.

Integer results (the histogram and every count behind the rates) must
match exactly.  The float32 fields are held to 1 ulp: the reference
divides under ``jit``, where XLA may turn a division into a product with
the reciprocal, while the port divides eagerly (ROADMAP C-2).  The
located saturation point must be the same.
"""
import jax
import numpy as np
import pytest
import torch

from repro.mesh import MeshConfig as JMeshConfig
from repro.mesh import Topology as JTopology
from repro.netsim_jax import batched_phased_stats as j_batched
from repro.netsim_jax import curve_record as j_curve_record
from repro.netsim_jax import hist_quantile as j_hist_quantile
from repro.netsim_jax import load_latency_sweep as j_sweep
from repro.netsim_jax import stack_rate_programs as j_stack
from repro.netsim_jax.measure import SweepKey as JSweepKey
from repro.netsim_jax.measure import measure_program as j_measure_program
from repro.netsim_jax.measure import phase_schedule as j_phase_schedule
from repro.netsim_jax.measure import reduce_window_stats as j_reduce
from repro.netsim_jax.measure import stream_phased_stats as j_stream
from repro.netsim_jax.sim import load_program as j_load_program
from repro_torch.mesh import MeshConfig, Topology, make_traffic
from repro_torch.netsim import measure
from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES, SweepKey,
                                        batched_phased_stats, compile_sweep,
                                        hist_quantile, load_latency_sweep,
                                        measure_program, phase_schedule,
                                        stack_rate_programs,
                                        stream_phased_stats)
from repro_torch.netsim.sim import load_program

PHASES = dict(warmup=60, measure=150, drain=150)
FLOAT_FIELDS = ("offered", "accepted", "delivered", "lat_mean", "lat_p50",
                "lat_p95", "lat_p99", "lat_max", "peak_link_util", "hops")


def _assert_stats_equal(t, j):
    np.testing.assert_array_equal(np.asarray(t["hist"]), np.asarray(j["hist"]))
    for f in FLOAT_FIELDS:
        a = np.asarray(t[f], np.float32)
        b = np.asarray(j[f], np.float32)
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
        # the integer counts behind each rate are exact
        if f in ("offered", "accepted", "delivered"):
            np.testing.assert_array_equal(np.rint(a * 150 * 16),
                                          np.rint(b * 150 * 16))


@pytest.mark.parametrize("topo", ["mesh", "torus"])
def test_load_latency_sweep_matches_reference(topo):
    """Twelve offered loads as twelve lanes of one state against the
    reference's vmapped sweep; same knee."""
    jt, tt = JTopology.parse(topo), Topology.parse(topo)
    j = j_sweep("uniform", 4, 4, DEFAULT_SWEEP_RATES, seed=0,
                cfg=JMeshConfig(nx=4, ny=4, topology=jt), **PHASES)
    t = load_latency_sweep("uniform", 4, 4, DEFAULT_SWEEP_RATES, seed=0,
                           cfg=MeshConfig(nx=4, ny=4, topology=tt),
                           cycles_per_call=7, device="cpu", **PHASES)
    _assert_stats_equal(t, j)
    assert t["saturation_index"] == j["saturation_index"]
    assert t["saturation_rate"] == j["saturation_rate"]
    assert t["monotone"] == j["monotone"]
    assert t["topology"] == j["topology"] and t["mesh"] == j["mesh"]
    np.testing.assert_array_equal(t["rates"], j["rates"])
    assert measure.curve_record(t)["saturation_index"] == \
        j_curve_record(j)["saturation_index"]
    assert measure.ascii_curve(t["rates"], t["lat_mean"],
                               t["saturation_index"]).count("\n") == 11


def test_batched_phased_stats_with_per_lane_depths_and_credits():
    """Per-lane FIFO depths and credit allowances, lane for lane equal to
    the reference's vmapped batch."""
    rates = (0.1, 0.3, 0.5, 0.8)
    depths, credits = [8, 2, 4, 1], [32, 4, 9, 2]
    jkey = JSweepKey(JMeshConfig(nx=4, ny=4, router_fifo=8,
                                 max_out_credits=32), **PHASES)
    key = SweepKey(MeshConfig(nx=4, ny=4, router_fifo=8,
                              max_out_credits=32), cycles_per_call=4,
                   **PHASES)
    jprogs = j_stack("hotspot", 4, 4, rates, jkey.horizon, seed=2)
    progs = stack_rate_programs("hotspot", 4, 4, rates, key.horizon, seed=2,
                                device="cpu")
    np.testing.assert_array_equal(progs.buf.numpy(), np.asarray(jprogs.buf))
    j = j_batched(jkey, jprogs, np.asarray(depths, np.int32),
                  np.asarray(credits, np.int32))
    t = batched_phased_stats(key, progs, depths, credits)
    _assert_stats_equal({k: v.numpy() for k, v in t._asdict().items()},
                        {k: np.asarray(v) for k, v in j._asdict().items()})


def test_hist_quantile_matches_reference():
    rng = np.random.default_rng(0)
    hists = rng.integers(0, 5, (6, 512)).astype(np.int32)
    hists[0] = 0                           # empty: quantile 0
    hists[1, :] = 0
    hists[1, 37] = 3                       # one bin
    t = torch.as_tensor(hists)
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        want = np.stack([np.asarray(j_hist_quantile(h, q)) for h in hists])
        np.testing.assert_array_equal(hist_quantile(t, q).numpy(), want)
        np.testing.assert_array_equal(hist_quantile(t[2], q).numpy(), want[2])


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_lat_mean_above_float32_exact_sums(seed):
    """Synthetic window histograms whose latency sum is far above 2**24,
    where the reference's float32 ``(bins * hist).sum()`` is no longer
    exact: the port's exact int64 sum gives the float32 mean within 1 ulp
    of the true mean, and stays within 1 ulp of the reference
    (ROADMAP C-2)."""
    rng = np.random.default_rng(seed)
    hist = np.zeros(512, np.int32)
    hist[30:500] = rng.integers(0, 2000, 470)
    hist[501] = 12345
    weight = int((np.arange(512) * hist.astype(np.int64)).sum())
    assert weight > 2 ** 26
    util = np.zeros((2, 4, 4, 5), np.int32)
    j = jax.jit(j_reduce, static_argnums=(0, 1))(
        16, 150, hist, np.int32(5), np.int32(5), util)
    t = measure.reduce_window_stats(16, 150, torch.as_tensor(hist)[None],
                                    torch.tensor([5]), torch.tensor([5]),
                                    torch.as_tensor(util)[None])
    mean = t.lat_mean.numpy()
    np.testing.assert_array_max_ulp(
        mean, np.float32([weight / hist.sum()]), maxulp=1)
    np.testing.assert_array_max_ulp(
        mean, np.asarray(j.lat_mean, np.float32)[None], maxulp=1)


def test_sweep_key_and_config_helpers():
    key = SweepKey(measure.sweep_config(4, 4), 1, 2, 3)
    assert key.horizon == 6 and key.cfg.router_fifo == 16
    assert key.cycles_per_call is None         # one call per phase
    with pytest.raises(ValueError, match="cycles_per_call"):
        SweepKey(MeshConfig(nx=2, ny=2), 1, 2, 3, cycles_per_call=0)
    with pytest.raises(ValueError, match="measure"):
        SweepKey(MeshConfig(nx=2, ny=2), 1, 0, 1)
    assert measure.saturation_point([10, 20, 31]) == 2
    assert measure.saturation_point([10, 11]) is None
    assert measure.curve_is_monotone([10, 12, 40, 45])
    assert not measure.curve_is_monotone([10, 8, 40])


# -- streaming ----------------------------------------------------------

@pytest.mark.parametrize("phases,check_every", [
    ((60, 150, 150), 1), ((60, 150, 150), 7), ((0, 5, 3), 2),
    ((10, 20, 0), 100), ((3, 4, 5), 4)])
def test_phase_schedule_matches_reference(phases, check_every):
    assert phase_schedule(*phases, check_every) == \
        j_phase_schedule(*phases, check_every)


# the streaming tests' recipe: the window of PHASES, shorter warm-up and
# drain (a streamed block is one call of the plain cycle each)
STREAM = dict(warmup=20, measure=150, drain=30)


def _drive(gen):
    """(chunks, final stats) of a streaming generator."""
    chunks = []
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            return chunks, stop.value


@pytest.mark.parametrize("check_every,topo,depth,credits", [
    (1, "mesh", None, None), (7, "torus", 3, 9), (100, "mesh", 2, 4)])
def test_stream_phased_stats_matches_reference(check_every, topo, depth,
                                               credits):
    """Chunk by chunk equal to the reference's stream; the final stats
    equal the port's one-shot ``batched_phased_stats`` on the same lane
    exactly, and the reference's within 1 ulp (ROADMAP C-2)."""
    jt, tt = JTopology.parse(topo), Topology.parse(topo)
    jcfg = JMeshConfig(nx=4, ny=4, router_fifo=8, max_out_credits=32,
                       topology=jt)
    cfg = MeshConfig(nx=4, ny=4, router_fifo=8, max_out_credits=32,
                     topology=tt)
    e = make_traffic("uniform", 4, 4, 120, rate=0.4, seed=3, topology=tt)
    chunks, final = _drive(stream_phased_stats(
        cfg, e, check_every=check_every, fifo_depth=depth,
        max_credits=credits, cycles_per_call=5, device="cpu", **STREAM))
    jchunks, jfinal = _drive(j_stream(
        jcfg, j_load_program(e), check_every=check_every, fifo_depth=depth,
        max_credits=credits, **STREAM))
    assert len(chunks) == len(jchunks) == len(phase_schedule(
        *STREAM.values(), check_every))
    for a, b in zip(chunks, jchunks):
        assert (a.phase, a.start, a.stop, a.injected, a.completed,
                a.delivered) == (b.phase, b.start, b.stop, b.injected,
                                 b.completed, b.delivered)
        np.testing.assert_array_equal(a.hist, b.hist)
        assert a.hist.dtype == np.asarray(b.hist).dtype
    assert sum(c.delivered for c in chunks) == int(final.hist.sum())
    key = SweepKey(cfg, **STREAM)
    one = batched_phased_stats(key, load_program(e, "cpu"),
                               depth if depth else None,
                               credits if credits else None)
    for f in final._fields:
        assert torch.equal(getattr(final, f), getattr(one, f)), f
    _assert_stats_equal({k: v.numpy() for k, v in final._asdict().items()},
                        {k: np.asarray(v)[None]
                         for k, v in jfinal._asdict().items()})


def test_stream_takes_a_one_lane_program_and_checks_at_the_call():
    cfg = MeshConfig(nx=4, ny=4)
    e = make_traffic("tornado", 4, 4, 40, rate=0.5, seed=1)
    a = _drive(stream_phased_stats(cfg, load_program(e, "cpu"),
                                   check_every=50, device="cpu", **STREAM))
    b = _drive(stream_phased_stats(cfg, e, check_every=50, device="cpu",
                                   **STREAM))
    assert [c[:6] for c in a[0]] == [c[:6] for c in b[0]]
    two = stack_rate_programs("uniform", 4, 4, (0.1, 0.2), 10, device="cpu")
    with pytest.raises(ValueError, match="one lane"):
        stream_phased_stats(cfg, two, device="cpu")
    with pytest.raises(ValueError, match="check_every"):
        stream_phased_stats(cfg, e, check_every=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_phased_stats(cfg, e)          # no card here: never the CPU


def test_measure_program_matches_reference():
    e = make_traffic("transpose", 4, 4, 90, rate=0.5, seed=2)
    t = measure_program(MeshConfig(nx=4, ny=4), e, cycles_per_call=9,
                        device="cpu", **STREAM)
    j = j_measure_program(JMeshConfig(nx=4, ny=4), e, **STREAM)
    assert set(t) == set(j)
    _assert_stats_equal({k: np.asarray(v) for k, v in t.items()},
                        {k: np.asarray(v) for k, v in j.items()})


def test_compile_sweep_checks_its_key():
    """A prepared sweep runs only under its own key: the same total
    horizon with the phases permuted raises; the same key gives the
    uncompiled sweep's curve."""
    cfg = MeshConfig(nx=4, ny=4)
    progs = stack_rate_programs("uniform", 4, 4, (0.1, 0.3), 360,
                                device="cpu")
    compiled, secs = compile_sweep(cfg, progs, **PHASES)
    assert secs >= 0 and compiled.key == SweepKey(cfg, **PHASES)
    kw = dict(cfg=cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="compiled sweep"):
        load_latency_sweep("uniform", 4, 4, (0.1, 0.3), warmup=150,
                           measure=150, drain=60, compiled=compiled, **kw)
    got = load_latency_sweep("uniform", 4, 4, (0.1, 0.3), compiled=compiled,
                             **kw, **PHASES)
    want = load_latency_sweep("uniform", 4, 4, (0.1, 0.3), **kw, **PHASES)
    for k in FLOAT_FIELDS + ("hist",):
        np.testing.assert_array_equal(got[k], want[k])
