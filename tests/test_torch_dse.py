"""The port's design-space exploration (``repro_torch.dse``) against the
JAX package's (``repro.dse``) on the CPU: spec expansion and keys, cost,
Pareto, the result cache and its code hash, and ``run_sweep`` record by
record against the reference's single-device run — chunked, with
program reuse, fanned out over two CPU devices, resubmitted.

Records round each stat to 6 decimals.  Where a float32 stat of the port
and of the reference differs by 1 ulp before rounding (the reference
divides under ``jit``; ROADMAP C-2), rounding can make the records
differ; such a field is then held to 1 ulp unrounded."""
import shutil
import warnings

import numpy as np
import pytest
import torch

import repro.dse as J
import repro_torch.dse as T
from repro.mesh.config import MeshConfig as JMeshConfig
from repro.mesh.traffic import make_traffic as j_make_traffic
from repro.netsim_jax.measure import batched_phased_stats as j_batched
from repro.netsim_jax.sim import load_program as j_load_program
from repro_torch.dse import cache as cache_mod
from repro_torch.dse import runner
from repro_torch.kernels import build
from repro_torch.mesh.config import MeshConfig
from repro_torch.mesh.traffic import make_traffic
from repro_torch.netsim.measure import batched_phased_stats, clear_sweep_cache
from repro_torch.netsim.sim import load_program

PHASES = dict(warmup=50, measure=100, drain=100)
CPU = torch.device("cpu")


def small_spec(m, **kw):
    """The reference test's ``small_spec``, built by module ``m``."""
    base = dict(nx=4, ny=4, fifo_depths=(2, 4), credits=(4, 16),
                patterns=("uniform",), loads=(0.1, 0.3),
                topologies=("mesh",), name="t", **PHASES)
    base.update(kw)
    return m.SweepSpec(**base)


def _recipe_free(key):
    """A point key without its recipe suffix (the port names its own)."""
    return key.rsplit("|w", 1)[0]


# -- spec, cost, Pareto ---------------------------------------------------

SPECS = {
    "small": {},
    "workloads_two_topologies": dict(topologies=("mesh", "torus"),
                                     workloads=("allreduce", "moe")),
    "pruned": dict(fifo_depths=(1, 2, 4), topologies=("torus", "mesh",
                                                      "multi_chip:2:2"),
                   patterns=("tornado", "uniform"), loads=(0.3, 0.1, 0.3)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_matches_reference(name):
    """Expansion order, pruning, description, bucket identities and point
    keys equal the reference's."""
    s, j = small_spec(T, **SPECS[name]), small_spec(J, **SPECS[name])
    assert [p.label() for p in s.points()] == [p.label() for p in j.points()]
    assert [(t.spec, d, why) for t, d, why in s.infeasible()] == \
        [(t.spec, d, why) for t, d, why in j.infeasible()]
    assert s.describe() == j.describe()
    assert s.traffic_length() == j.traffic_length()
    assert [_recipe_free(s.point_key(p)) for p in s.points()] == \
        [_recipe_free(j.point_key(p)) for p in j.points()]
    assert s.point_key(s.points()[0]).endswith("|w50m100d100|torch|"
                                               "callsphase")
    for ts, tj in zip(s.topologies, j.topologies):
        assert s.bucket_config(ts).cache_token() == \
            j.bucket_config(tj).cache_token()
        key = s.sweep_key(ts)
        assert key.horizon == s.horizon and key.cycles_per_call is None
        assert key.cfg.router_fifo == j.sweep_key(tj).cfg.router_fifo


@pytest.mark.parametrize("kw,match", [
    (dict(fifo_depths=()), "fifo_depths"),
    (dict(fifo_depths=(0,)), "fifo_depths"),
    (dict(credits=(-1,)), "credits"),
    (dict(patterns=("nope",)), "unknown traffic pattern"),
    (dict(loads=(0.0,)), "offered loads"),
    (dict(loads=(1.5,)), "offered loads"),
    (dict(workloads=("nope",)), "unknown workload family"),
    (dict(patterns=(), workloads=()), "at least one"),
    (dict(topologies=()), "at least one topology"),
    (dict(topologies=("klein_bottle",)), "unknown topology"),
])
def test_spec_validation_names_the_axis(kw, match):
    with pytest.raises(ValueError, match=match):
        small_spec(T, **kw)
    with pytest.raises(ValueError, match=match):
        small_spec(J, **kw)


@pytest.mark.parametrize("family", T.WORKLOAD_FAMILIES)
def test_workload_entries_match_reference(family):
    t, j = T.workload_entries(family, 4, 4, 3), J.workload_entries(family,
                                                                   4, 4, 3)
    for k, v in j.items():
        np.testing.assert_array_equal(t[k], v, err_msg=k)
    assert T.workload_instance(family, 4, 4, 3).family == family


def test_cost_and_pareto_match_reference():
    tc = T.CostModel(sram_um2_per_bit=0.5)
    jc = J.CostModel(sram_um2_per_bit=0.5)
    assert tc.to_json() == jc.to_json() and T.FLIT_BITS == J.FLIT_BITS
    for nx, ny, depth, ep in ((4, 4, 2, 4), (16, 32, 16, 8)):
        assert tc.buffer_area_mm2(MeshConfig(nx=nx, ny=ny, router_fifo=depth,
                                             ep_fifo=ep)) == \
            jc.buffer_area_mm2(JMeshConfig(nx=nx, ny=ny, router_fifo=depth,
                                           ep_fifo=ep))
        assert tc.energy_per_packet_pj(1234.0, 17.0) == \
            jc.energy_per_packet_pj(1234.0, 17.0)
    rng = np.random.default_rng(0)
    recs = [{"area_mm2": float(a), "throughput": float(t)}
            for a, t in zip(rng.integers(1, 6, 30), rng.random(30))]
    recs.append({"area_mm2": 2.0, "throughput": None})
    front = T.pareto_front(recs)
    assert front == J.pareto_front(recs)
    assert T.frontier_is_monotone(front) == J.frontier_is_monotone(front)
    assert not T.frontier_is_monotone([])
    assert T.ascii_frontier(recs, front) == J.ascii_frontier(recs, front)


# -- the result cache -----------------------------------------------------

def test_result_cache_round_trip_and_collisions(tmp_path):
    cache = T.ResultCache(tmp_path)
    assert len(cache) == 0 and cache.get("k") is None
    cache.put("k", {"stats": {"x": 1.5}})
    assert cache.get("k") == {"stats": {"x": 1.5}} and len(cache) == 1
    cache.path_for("k").rename(cache.path_for("k2"))
    assert cache.get("k2") is None       # a collision degrades to a miss
    off = T.ResultCache(None)
    off.put("k", {"a": 1})
    assert off.get("k") is None and len(off) == 0


def test_config_hash_is_the_ports_sources():
    h = T.config_hash()
    assert h == T.config_hash() and len(h) == 16 and int(h, 16) >= 0
    assert h == cache_mod.source_digest(cache_mod._PACKAGE,
                                        cache_mod.HASHED_SOURCES)
    assert "kernels/csrc/router_step.cu" in cache_mod.HASHED_SOURCES
    assert h != J.config_hash()          # never the reference's directory


@pytest.mark.parametrize("name", cache_mod.HASHED_SOURCES)
def test_config_hash_moves_with_each_hashed_source(name, tmp_path):
    for n in cache_mod.HASHED_SOURCES:
        (tmp_path / n).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(cache_mod._PACKAGE / n, tmp_path / n)
    before = cache_mod.source_digest(tmp_path, cache_mod.HASHED_SOURCES)
    assert before == T.config_hash()
    with open(tmp_path / name, "a") as f:
        f.write("\n")
    assert cache_mod.source_digest(tmp_path,
                                   cache_mod.HASHED_SOURCES) != before


# -- run_sweep against the reference --------------------------------------

def _unrounded(m, spec, point):
    """One point's stats before rounding, through the batched measurement
    of the port (``m`` is ``T``) or of the reference (``J``)."""
    if point.is_workload:
        entries = m.workload_entries(point.family, point.nx, point.ny,
                                     point.seed)
    else:
        entries = (make_traffic if m is T else j_make_traffic)(
            point.traffic, point.nx, point.ny, spec.traffic_length(),
            rate=point.load, seed=point.seed, topology=point.topology)
    key = spec.sweep_key(point.topology)
    depth, credits = [point.fifo_depth], [point.credits]
    if m is T:
        s = batched_phased_stats(key, load_program(entries, "cpu"), depth,
                                 credits)
        return {f: getattr(s, f).numpy()[0] for f in runner.STAT_FIELDS}
    prog = j_load_program(entries)
    prog = type(prog)(*(np.asarray(x)[None] for x in prog))
    s = j_batched(key, prog, np.int32(depth), np.int32(credits))
    return {f: np.asarray(getattr(s, f))[0] for f in runner.STAT_FIELDS}


def _assert_records_match(tspec, jspec, trecs, jrecs):
    assert len(trecs) == len(jrecs)
    for tp, jp, tr, jr in zip(tspec.points(), jspec.points(), trecs, jrecs):
        assert tr["point"] == jr["point"]
        bad = [f for f in runner.STAT_FIELDS
               if tr["stats"][f] != jr["stats"][f]]
        if bad:
            a, b = _unrounded(T, tspec, tp), _unrounded(J, jspec, jp)
            for f in bad:
                np.testing.assert_array_max_ulp(
                    np.float32(a[f]), np.float32(b[f]), maxulp=1)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's single-device records of the small specs."""
    return {name: J.run_sweep(small_spec(J, **kw), chunk=4).records
            for name, kw in (("small", {}),
                             ("workloads", SPECS["workloads_two_topologies"]))}


@pytest.mark.parametrize("name", ["small", "workloads"])
def test_run_sweep_matches_reference(name, reference_runs):
    kw = {} if name == "small" else SPECS["workloads_two_topologies"]
    res = T.run_sweep(small_spec(T, **kw), device="cpu")
    assert res.devices == 1 and res.simulated == res.n_points
    assert res.buckets == (1 if name == "small" else 6) \
        == len(runner.buckets(small_spec(T, **kw)))
    _assert_records_match(small_spec(T, **kw), small_spec(J, **kw),
                          res.records, reference_runs[name])


def test_frontier_artifact_matches_reference(tmp_path):
    kw = dict(loads=(0.05, 0.2, 0.4), topologies=("mesh", "torus"))
    j = J.frontier_artifact(J.run_sweep(small_spec(J, **kw), chunk=8))
    res = T.run_sweep(small_spec(T, **kw), cache_dir=tmp_path, device="cpu")
    t = T.frontier_artifact(res)
    assert t.pop("config_hash") == T.config_hash()
    j.pop("config_hash")
    assert t == j
    assert T.frontier_ascii(t) == J.frontier_ascii(j)
    assert T.write_frontier(tmp_path / "f.json", t).exists()
    cheap = T.frontier_artifact(res, cost=T.CostModel(sram_um2_per_bit=0.1))
    assert cheap["frontiers"]["mesh"]["points"][0]["area_mm2"] < \
        t["frontiers"]["mesh"]["points"][0]["area_mm2"]
    only_wl = T.run_sweep(small_spec(T, patterns=(), workloads=("broadcast",),
                                     fifo_depths=(2,), credits=(4,)),
                          device="cpu")
    with pytest.raises(ValueError, match="workload"):
        T.frontier_artifact(only_wl)


# Port-against-port checks run a shorter recipe (100 cycles a point): the
# plain PyTorch cycle on the CPU costs the same per call at any size.
SHORT = dict(warmup=20, measure=40, drain=40)


@pytest.fixture(scope="module")
def one_device():
    """The port's single-device records of a short spec with a uniform
    and a workload bucket (12 points)."""
    spec = small_spec(T, workloads=("moe",), **SHORT)
    return spec, T.run_sweep(spec, device="cpu").records


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunk_size_does_not_change_records(chunk, one_device):
    spec, want = one_device
    assert T.run_sweep(spec, chunk=chunk, device="cpu").records == want


def test_program_reuse_is_invisible(one_device):
    """Points sharing a program get it gathered from one copy; each
    record equals the point run alone from a program of its own."""
    spec, want = one_device
    by_point = dict(zip(spec.points(), want))
    pts = [p for p in spec.points() if not p.is_workload]
    progs, rows = runner.bucket_programs(pts, spec.traffic_length(), CPU)
    assert progs.buf.shape[0] == 2 and len(pts) == 8      # one per load
    assert rows.tolist() == [0, 1] * 4
    for p in pts:
        alone = batched_phased_stats(
            spec.sweep_key(p.topology),
            load_program(make_traffic(p.traffic, 4, 4, spec.traffic_length(),
                                      rate=p.load, seed=p.seed,
                                      topology=p.topology), "cpu"),
            [p.fifo_depth], [p.credits])
        stats = {f: float(getattr(alone, f)[0]) for f in runner.STAT_FIELDS}
        assert runner.point_record(p, stats) == by_point[p]


def test_fan_out_over_two_devices_matches_one(one_device):
    """The bucket split over [cpu, cpu] — each slice launched before any
    is read back, merged in point order — equals one device."""
    spec, want = one_device
    by_point = dict(zip(spec.points(), want))
    for (key, length), pts in runner.buckets(spec).items():
        for chunk in (None, 2):
            stats, _, _, _ = runner._run_bucket(key, length, pts, [CPU, CPU],
                                                chunk, {})
            assert [runner.point_record(p, s) for p, s in zip(pts, stats)] \
                == [by_point[p] for p in pts]


def test_more_devices_than_visible_falls_back_with_a_warning(one_device):
    spec, want = one_device
    with pytest.warns(UserWarning, match="falling back"):
        res = T.run_sweep(spec, devices=2, device="cpu")
    assert res.devices == 1 and res.records == want
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert T.run_sweep(spec, devices=1, device="cpu").devices == 1


def test_resubmission_simulates_and_compiles_nothing(tmp_path):
    clear_sweep_cache()
    spec = small_spec(T, **SHORT)
    first = T.run_sweep(spec, cache_dir=tmp_path, device="cpu")
    assert first.compiles == first.buckets == 1
    again = T.run_sweep(spec, cache_dir=tmp_path, device="cpu")
    assert again.simulated == 0 and again.cache_hits == first.n_points
    assert again.compiles == 0 and again.buckets == 0
    assert again.records == first.records
    wide = small_spec(T, loads=(0.1, 0.3, 0.5), **SHORT)
    part = T.run_sweep(wide, cache_dir=tmp_path, device="cpu")
    assert part.cache_hits == first.n_points
    assert part.simulated == len(wide.points()) - first.n_points
    # the same shape again, uncached: no new compile until the registry
    # of executed shapes is cleared
    assert T.run_sweep(spec, device="cpu").compiles == 0
    clear_sweep_cache()
    assert T.run_sweep(spec, device="cpu").compiles == 1


def test_infeasible_compile_cache_dir_and_the_card(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "before"))
    spec = small_spec(T, fifo_depths=(1, 2), topologies=("torus",),
                      loads=(0.1,), **SHORT)
    res = T.run_sweep(spec, device="cpu", compile_cache_dir=tmp_path / "lib")
    assert build.build_dir() == tmp_path / "lib"
    assert len(res.infeasible) == 1 and "fifo_depth=1" in res.infeasible[0]
    assert all(r["point"]["fifo_depth"] >= 2 for r in res.records)
    assert res.program_s >= 0 and res.simulate_s > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_sweep(spec)                 # no card here: never the CPU
