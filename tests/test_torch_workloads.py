"""The port's workload library (``repro_torch.workloads``) against the
JAX package's (``repro.workloads``) on the CPU: every workload
compiler's program array by array, the run reports of the port's two backends (the numpy
oracle, and the torch backend with ``device="cpu"``: the plain PyTorch
step), the drain-fence block of the torch backend, and the congestion
fit and calibration."""
import numpy as np
import pytest

import repro.workloads as J
import repro_torch.workloads as T
from repro.mesh import MeshConfig as JMeshConfig
from repro.mesh import Topology as JTopology
from repro_torch.mesh import MeshConfig, Topology
from repro_torch.workloads import runner

COMPILERS = {
    "allreduce_w16": lambda m: m.ring_all_reduce(4, 4, 16),
    "allreduce_w33_k5": lambda m: m.ring_all_reduce(4, 4, 33, k=5),
    "allreduce_load_8x4": lambda m: m.ring_all_reduce(8, 4, 7, op=0),
    "broadcast": lambda m: m.parameter_broadcast(4, 3, 9, start=4),
    "broadcast_k3": lambda m: m.parameter_broadcast(4, 4, 5, k=3),
    "moe_balanced": lambda m: m.moe_all_to_all(4, 4, 5, seed=0),
    "moe_hot_top2": lambda m: m.moe_all_to_all(4, 4, 5, imbalance=0.5,
                                               top_k=2, seed=3),
    "moe_paced_8x4": lambda m: m.moe_all_to_all(8, 4, 3, imbalance=0.25,
                                                n_experts=6, rate=0.5,
                                                seed=7),
    "pipeline": lambda m: m.pipeline_p2p(4, 4, n_micro=3),
    "pipeline_fwdbwd_s5": lambda m: m.pipeline_p2p(4, 4, n_stages=5,
                                                   n_micro=2, act_words=3,
                                                   backward=True),
    "pgas_scatter": lambda m: m.pgas_scatter(4, 4, 5),
    "pgas_scatter_8x4": lambda m: m.pgas_scatter(8, 4, 3, start=2),
    "merged": lambda m: m.merge_workloads(
        "mix", [m.ring_all_reduce(4, 4, 8), m.pgas_scatter(4, 4, 3)], gap=2),
}


def _assert_same_workload(t, j):
    assert (t.name, t.family, t.nx, t.ny, t.n_steps, t.n_packets) == \
        (j.name, j.family, j.nx, j.ny, j.n_steps, j.n_packets)
    assert t.meta == j.meta
    assert set(t.program) == set(j.program)
    for k, v in j.program.items():
        np.testing.assert_array_equal(t.program[k], v, err_msg=k)
        assert t.program[k].dtype == v.dtype, k
    if j.placement is not None:
        np.testing.assert_array_equal(t.placement.coords, j.placement.coords)


@pytest.mark.parametrize("name", sorted(COMPILERS))
def test_compiled_programs_match_reference(name):
    _assert_same_workload(COMPILERS[name](T), COMPILERS[name](J))


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("imbalance", [0.0, 0.3, 0.9])
def test_moe_seeds_and_imbalances_match_reference(seed, imbalance):
    kw = dict(imbalance=imbalance, seed=seed, top_k=1 + seed % 2)
    _assert_same_workload(T.moe_all_to_all(4, 4, 4, **kw),
                          J.moe_all_to_all(4, 4, 4, **kw))


@pytest.mark.parametrize("seed", [0, 2])
def test_pgas_batches_and_memory_image_match_reference(seed):
    """Random collision-free store batches: the program and the
    post-scatter memory image equal the reference's."""
    rng = np.random.default_rng(seed)
    T_, S = 8, 3
    mask = rng.random((T_, T_, S)) < 0.4
    addr = np.broadcast_to(np.arange(S), (T_, T_, S)) + 4 * \
        np.arange(T_)[:, None, None]
    data = rng.integers(0, 1000, (T_, T_, S))
    for op, rate in ((1, 1.0), (0, 0.5)):
        kw = dict(op=op, rate=rate)
        _assert_same_workload(T.pgas_from_batches(addr, data, mask, 4, 2,
                                                  **kw),
                              J.pgas_from_batches(addr, data, mask, 4, 2,
                                                  **kw))
    np.testing.assert_array_equal(
        T.expected_memory(addr, data, mask, 4, 2),
        J.expected_memory(addr, data, mask, 4, 2))


def test_placements_and_helpers_match_reference():
    for nx, ny in ((4, 3), (5, 2)):
        np.testing.assert_array_equal(T.snake_order(nx, ny),
                                      J.snake_order(nx, ny))
        np.testing.assert_array_equal(T.row_major_order(nx, ny),
                                      J.row_major_order(nx, ny))
    p, q = T.Placement.ring(4, 4), J.Placement.ring(4, 4)
    for topo in ("mesh", "torus", "ring_mesh"):
        assert [p.ring_hop_length(r, Topology.parse(topo))
                for r in range(p.k)] == \
            [q.ring_hop_length(r, JTopology.parse(topo)) for r in range(q.k)]
    assert T.expert_capacity(100, 7, 1.5) == J.expert_capacity(100, 7, 1.5)
    with pytest.raises(ValueError, match="same tile"):
        T.Placement(2, 2, [(0, 0), (0, 0)])
    with pytest.raises(ValueError, match="claims"):
        T.Workload("w", "pgas", 2, 2, T.program_from_packets(
            2, 2, [T.Packet(0, 0, 1, 1, 0)]), n_steps=1, n_packets=2)
    assert T.program_from_packets(2, 2, [])["op"].shape == (2, 2, 1)


# ------------------------------------------------------------ run reports

RUNS = {
    "allreduce": (lambda m: m.ring_all_reduce(4, 4, 16), "mesh"),
    "allreduce_torus": (lambda m: m.ring_all_reduce(4, 4, 16), "torus"),
    "moe_hot": (lambda m: m.moe_all_to_all(4, 4, 4, imbalance=0.5,
                                           seed=1), "mesh"),
    "pipeline_fwdbwd": (lambda m: m.pipeline_p2p(4, 4, n_micro=3,
                                                 backward=True), "ring_mesh"),
    "pgas": (lambda m: m.pgas_scatter(8, 4, 3), "mesh"),
}


def _cfgs(make, topo):
    w = make(J)
    kw = dict(nx=w.nx, ny=w.ny, max_out_credits=128, router_fifo=16)
    return (JMeshConfig(topology=JTopology.parse(topo), **kw),
            MeshConfig(topology=Topology.parse(topo), **kw))


def _json_without_backend(report):
    out = report.to_json()
    out.pop("backend")
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_workload_reports_match_reference(name):
    """The port's numpy and torch (CPU) reports equal the reference's
    ``to_json()`` but for the backend field; ``"both"`` asserts their
    parity itself."""
    make, topo = RUNS[name]
    jcfg, cfg = _cfgs(make, topo)
    want = _json_without_backend(J.run_workload(make(J), jcfg,
                                                backend="numpy"))
    w = make(T)
    for backend in ("numpy", "torch", "both"):
        r = T.run_workload(w, cfg, backend=backend, device=None
                           if backend == "numpy" else "cpu")
        assert r.backend == backend
        assert _json_without_backend(r) == want, backend


@pytest.mark.parametrize("name", ["allreduce_torus", "pgas"])
def test_report_is_the_same_at_every_fence_block(name, monkeypatch):
    """The torch backend checks its drain fence every ``CHECK_EVERY``
    cycles; a check every cycle gives the same report."""
    make, topo = RUNS[name]
    _, cfg = _cfgs(make, topo)
    w = make(T)
    assert runner.CHECK_EVERY == 256
    block = T.run_workload(w, cfg, device="cpu")
    monkeypatch.setattr(runner, "CHECK_EVERY", 1)
    assert T.run_workload(w, cfg, device="cpu") == block


def test_run_workload_checks_backend_config_and_device():
    w = T.ring_all_reduce(4, 4, 4)
    with pytest.raises(ValueError, match="unknown backend"):
        T.run_workload(w, backend="jax")
    with pytest.raises(ValueError, match="compiled for a 4x4"):
        T.run_workload(w, MeshConfig(nx=4, ny=3), backend="numpy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_workload(w)                 # no card here: never the CPU


# -------------------------------------------------------------- congestion

def test_congestion_fit_matches_reference():
    """The same reports fit to the same coefficients, and price the same
    collectives; the model round-trips through JSON."""
    reports = [J.run_workload(J.ring_all_reduce(4, 4, w), backend="numpy")
               for w in (16, 48)]
    reports.append(J.run_workload(J.moe_all_to_all(4, 4, 3, seed=1),
                                  backend="numpy"))
    j = J.CongestionModel.fit(reports, clock_hz=2e9)
    t = T.CongestionModel.fit(reports, clock_hz=2e9)
    assert t.to_json() == j.to_json()
    colls = {"all-reduce": {"bytes": 1e6, "count": 2, "wire_bytes": 1.5e6},
             "collective-broadcast": {"wire_bytes": 4e5},
             "all-to-all": {"bytes": 2e5, "count": 4}}
    assert t.collective_times(colls) == j.collective_times(colls)
    assert T.CongestionModel.from_json(t.to_json()) == t
    assert T.OP_FAMILY == J.OP_FAMILY and T.WORD_BYTES == J.WORD_BYTES


def test_calibrate_matches_reference():
    """``calibrate(4, 4)`` on both port backends gives the reference's
    coefficients."""
    want = J.calibrate(4, 4, backend="numpy").to_json()
    assert T.calibrate(4, 4, backend="numpy").to_json() == want
    assert T.calibrate(4, 4, device="cpu").to_json() == want
