"""The port's phased load–latency measurement
(``repro_torch.netsim.measure``) against ``repro.netsim_jax.measure`` on
a 4x4 mesh, on the CPU.

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
from repro.netsim_jax.measure import reduce_window_stats as j_reduce
from repro_torch.mesh import MeshConfig, Topology
from repro_torch.netsim import measure
from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES, SweepKey,
                                        batched_phased_stats, hist_quantile,
                                        load_latency_sweep,
                                        stack_rate_programs)

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
