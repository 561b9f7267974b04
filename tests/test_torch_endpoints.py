"""Reactive endpoints, the numpy oracle and the trace-to-program bridge of
the port, against the JAX package's on the CPU.

Every scenario runs three times: on the port's ``numpy`` backend (its own
copy of the oracle, endpoints called natively), on its ``torch`` backend
with ``device="cpu"`` (the endpoints traced on the internal oracle, the
trace replayed on the plain PyTorch step) and on the reference's numpy
oracle (``repro.mesh.Simulator(backend="numpy")``).  The drain cycle,
every ``Telemetry`` field and the memories must be bit-identical across
the three; chasers must see the same replies.  The scenarios mirror
``tests/test_mesh_endpoints.py`` (the DMA engine, the pointer chase, the
valid/ready contract) and the endpoint tests of ``tests/test_mesh_api.py``
(the program-endpoint grid, the trace replay, the 6-seed fuzz, a mixed
program and endpoints, ``step()``, attach-after-run).  A further test
holds the port's ``MeshSim`` state, field by field and cycle by cycle,
equal to the reference's over random programs on every topology.
"""
import numpy as np
import pytest

import repro.core.netsim as j_netsim
import repro.mesh as J
import repro_torch.core.netsim as t_netsim
import repro_torch.mesh as T
from repro_torch.core.netsim import OP_CAS, OP_LOAD, OP_STORE, unloaded_rtt
from repro_torch.mesh import (BACKENDS, DmaEndpoint, MemoryControllerEndpoint,
                              MeshConfig, ProgramEndpoint, Request, Simulator,
                              Telemetry, make_traffic, trace_to_program)

PORT = ("numpy", "torch")
MAX_CYCLES = 3000


def _sim(kind, cfg_kw, **kw):
    """A facade of ``kind``: ``ref`` (the reference's numpy oracle),
    ``numpy`` or ``torch`` (the port's, on the CPU)."""
    if kind == "ref":
        return J.Simulator(J.MeshConfig(**cfg_kw), backend="numpy", **kw)
    if kind == "torch":
        kw["device"] = "cpu"
    return Simulator(MeshConfig(**cfg_kw), backend=kind, **kw)


def _mod(kind):
    return J if kind == "ref" else T


def _run_three(cfg_kw, build, max_cycles=MAX_CYCLES, **kw):
    """``build(sim, mod)`` attaches the scenario (``mod`` is the package
    whose endpoints to use) on the three facades, which run until
    drained.  Asserts the drain cycle, Telemetry and memory bit-identical
    and returns {kind: (sim, build's result)}."""
    out = {}
    for kind in ("ref",) + PORT:
        sim = _sim(kind, cfg_kw, **kw)
        made = build(sim, _mod(kind))
        out[kind] = (sim, made, sim.run_until_drained(max_cycles))
    ref, cyc = out["ref"][0], out["ref"][2]
    for kind in PORT:
        sim = out[kind][0]
        assert out[kind][2] == cyc, f"{kind}: drain cycle {out[kind][2]} " \
            f"!= reference {cyc}"
        Telemetry.of(ref).assert_bit_identical(sim.telemetry())
        np.testing.assert_array_equal(np.asarray(sim.mem), np.asarray(ref.mem))
        np.testing.assert_array_equal(np.asarray(sim.credits),
                                      np.asarray(ref.credits))
    # the torch backend's results are the replay's, not the oracle's
    assert type(out["torch"][0]._sim).__name__ == "TorchMeshSim"
    return {k: (v[0], v[1]) for k, v in out.items()}


# ----------------------------------------------------------------------
# DMA engine
# ----------------------------------------------------------------------
def test_dma_streams_buffer_into_remote_memory():
    data = [7 * i + 1 for i in range(20)]

    def build(sim, mod):
        dma = mod.DmaEndpoint(dst_x=4, dst_y=1, data=data, addr=3)
        sim.attach(dma, at=(0, 0))
        return dma
    for kind, (sim, dma) in _run_three(dict(nx=5, ny=2, mem_words=32),
                                       build).items():
        assert dma.done() and dma.acked == len(data), kind
        np.testing.assert_array_equal(np.asarray(sim.mem)[1, 4, 3:23], data)


def test_dma_window_bounds_outstanding_stores():
    def build(sim, mod):
        dma = mod.DmaEndpoint(dst_x=5, dst_y=0, data=range(30),
                              max_inflight=2)
        sim.attach(dma, at=(0, 0))
        return dma
    for kind, (_sim_, dma) in _run_three(dict(nx=6, ny=1, max_out_credits=16),
                                         build).items():
        assert dma.peak_inflight <= 2 and dma.acked == 30, kind


def test_dma_rejects_empty_window():
    with pytest.raises(ValueError, match="at least one outstanding"):
        DmaEndpoint(dst_x=1, dst_y=0, data=[1], max_inflight=0)


def test_dma_throughput_scales_with_window():
    """A 1-deep window serialises on the RTT; a BDP-deep window streams."""
    n = 40
    cycles = {}
    for win in (1, 32):
        def build(sim, mod, win=win):
            sim.attach(mod.DmaEndpoint(dst_x=8, dst_y=0, data=range(n),
                                       max_inflight=win), at=(0, 0))
        sims = _run_three(dict(nx=9, ny=1, max_out_credits=64,
                               router_fifo=32), build)
        cycles[win] = sims["torch"][0].cycle
    rtt = unloaded_rtt(8)
    assert cycles[1] >= n * (rtt - 2)
    assert cycles[32] < cycles[1] / 4


# ----------------------------------------------------------------------
# request/reply memory-controller client
# ----------------------------------------------------------------------
def _ring_mem(nx, ny, words, tile_xy, stride):
    x, y = tile_xy
    mem = np.zeros((ny, nx, words), np.int64)
    mem[y, x, :] = (np.arange(words) + stride) % words
    return mem


def test_memory_controller_pointer_chase():
    """Each reply's data selects the next address: the visited sequence
    follows the seeded chain on every backend, memory seeded before the
    attach reaching the replay."""
    def build(sim, mod):
        sim.set_mem(_ring_mem(4, 4, 16, (3, 2), stride=5))
        mc = mod.MemoryControllerEndpoint(dst_x=3, dst_y=2, start_addr=1,
                                          n_requests=7, mem_words=16)
        sim.attach(mc, at=(0, 0))
        return mc
    sims = _run_three(dict(nx=4, ny=4, mem_words=16), build)
    want = [(1 + 5 * i) % 16 for i in range(7)]
    for kind, (_s, mc) in sims.items():
        assert mc.visited == want and len(mc.latencies) == 7, kind
        assert mc.latencies == sims["ref"][1].latencies


def test_memory_controller_latency_is_analytic_on_idle_mesh():
    def build(sim, mod):
        sim.set_mem(_ring_mem(6, 1, 8, (5, 0), stride=1))
        mc = mod.MemoryControllerEndpoint(dst_x=5, dst_y=0, start_addr=0,
                                          n_requests=4, mem_words=8)
        sim.attach(mc, at=(0, 0))
        return mc
    for kind, (_s, mc) in _run_three(dict(nx=6, ny=1, mem_words=8),
                                     build).items():
        assert mc.latencies == [unloaded_rtt(5)] * 4, kind


def test_memory_controller_serializes_requests():
    n = 5

    def build(sim, mod):
        sim.set_mem(_ring_mem(4, 1, 8, (3, 0), stride=3))
        sim.attach(mod.MemoryControllerEndpoint(
            dst_x=3, dst_y=0, start_addr=0, n_requests=n, mem_words=8),
            at=(0, 0))
    sims = _run_three(dict(nx=4, ny=1, mem_words=8), build)
    assert sims["torch"][0].cycle >= n * unloaded_rtt(3)


# ----------------------------------------------------------------------
# protocol plumbing
# ----------------------------------------------------------------------
def test_offer_only_called_when_ready_and_injection_guaranteed():
    """offer() fires only with a credit and FIFO space in hand, and every
    offered packet injects that same cycle."""
    class Probe:
        def __init__(self, req):
            self.sent, self.calls, self.req = 0, [], req

        def offer(self, cycle, credits):
            assert credits > 0, "offered with no credit"
            self.calls.append((cycle, credits))
            if self.sent >= 3:
                return None
            self.sent += 1
            return self.req(dst_x=1, dst_y=0, addr=self.sent, data=self.sent)

        def deliver(self, response):
            pass

        def done(self):
            return self.sent >= 3

    def build(sim, mod):
        probe = Probe(mod.Request)
        sim.attach(probe, at=(0, 0))
        return probe
    sims = _run_three(dict(nx=2, ny=1, max_out_credits=2), build)
    for kind, (sim, probe) in sims.items():
        assert probe.sent == 3 and int(np.asarray(sim.completed).sum()) == 3
        assert max(c for (_cyc, c) in probe.calls) <= 2, kind
        assert probe.calls == sims["ref"][1].calls


def test_deliver_receives_load_data_and_latency_fields():
    class Collector:
        def __init__(self, req):
            self.issued, self.seen, self.req = 0, [], req

        def offer(self, cycle, credits):
            if self.issued:
                return None
            self.issued = 1
            return self.req(dst_x=2, dst_y=0, addr=4, op=OP_LOAD)

        def deliver(self, response):
            self.seen.append(response)

        def done(self):
            return bool(self.issued)

    def build(sim, mod):
        mem = np.zeros((1, 3, 8), np.int64)
        mem[0, 2, 4] = 1234
        sim.set_mem(mem)
        col = Collector(mod.Request)
        sim.attach(col, at=(0, 0))
        return col
    for kind, (_s, col) in _run_three(dict(nx=3, ny=1, mem_words=8),
                                      build).items():
        (resp,) = col.seen
        assert (resp.data, resp.op, resp.addr) == (1234, OP_LOAD, 4), kind
        assert (resp.src_x, resp.src_y) == (2, 0)
        assert resp.latency == unloaded_rtt(2)


def test_program_endpoint_grid_matches_native_program_path():
    """A whole program through per-tile ProgramEndpoints is cycle-identical
    to the native program path, on every backend."""
    cfg_kw = dict(nx=4, ny=3, max_out_credits=3, router_fifo=2)
    entries = make_traffic("uniform", 4, 3, 7, rate=0.6, seed=13)
    native = _sim("ref", cfg_kw)
    native.attach({k: v.copy() for k, v in entries.items()})
    cn = native.run_until_drained()

    def build(sim, mod):
        for (x, y), ep in mod.ProgramEndpoint.grid(entries).items():
            sim.attach(ep, at=(x, y))
    sims = _run_three(cfg_kw, build)
    for kind in PORT:
        own = _sim(kind, cfg_kw)
        own.attach({k: v.copy() for k, v in entries.items()})
        assert own.run_until_drained() == cn == sims[kind][0].cycle
        own.telemetry().assert_bit_identical(sims[kind][0].telemetry())
        Telemetry.of(native).assert_bit_identical(own.telemetry())


def test_trace_program_replays_bit_identically():
    """The exported trace program reproduces a reactive run on a fresh
    simulator of either backend, and equals the reference's export."""
    cfg_kw = dict(nx=4, ny=4, mem_words=16)

    def build(sim, mod):
        sim.attach(mod.DmaEndpoint(dst_x=3, dst_y=3, data=range(8),
                                   max_inflight=2), at=(0, 0))
    sims = _run_three(cfg_kw, build)
    want = sims["ref"][0].injection_trace_program()
    for kind in PORT:
        live = sims[kind][0]
        prog = live.injection_trace_program()
        assert prog.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(prog[k], want[k], err_msg=k)
        for replay_kind in PORT:
            replay = _sim(replay_kind, cfg_kw)
            replay.attach(prog)
            assert replay.run_until_drained() == live.cycle
            live.telemetry().assert_bit_identical(replay.telemetry())
            np.testing.assert_array_equal(live.mem, replay.mem)


def test_trace_to_program_rejects_double_master():
    prog = make_traffic("neighbor", 2, 2, 2)
    trace = [(0, 0, 5, Request(dst_x=1, dst_y=0, addr=0))]
    with pytest.raises(ValueError, match="one master"):
        trace_to_program(trace, 2, 2, base=prog)


def test_facade_rejects_bad_attachments():
    for kind in PORT:
        sim = _sim(kind, dict(nx=3, ny=3))
        with pytest.raises(TypeError, match="cannot attach"):
            sim.attach(42)
        ep = DmaEndpoint(dst_x=1, dst_y=1, data=[1])
        with pytest.raises(ValueError, match="needs its tile"):
            sim.attach(ep)
        with pytest.raises(ValueError, match="outside the"):
            sim.attach(ep, at=(3, 0))
        sim.attach(ep, at=(0, 0))
        with pytest.raises(ValueError, match="one master"):
            sim.attach(DmaEndpoint(dst_x=1, dst_y=1, data=[1]), at=(0, 0))
        with pytest.raises(ValueError, match="one master"):
            sim.attach(make_traffic("uniform", 3, 3, 2, seed=0))
    with pytest.raises(ValueError, match="unknown backend"):
        Simulator(MeshConfig(nx=2, ny=2), backend="jax")
    with pytest.raises(ValueError, match="torch backend"):
        Simulator(MeshConfig(nx=2, ny=2), backend="numpy", device="cpu")
    assert BACKENDS == ("numpy", "torch")


def test_replay_rejects_a_payload_beyond_int32():
    """The oracle holds int64; the device's lanes are int32, so a DMA
    buffer (user data) that does not fit cannot be replayed and raises
    instead of wrapping.  The numpy backend, like the reference, runs
    it."""
    cfg_kw = dict(nx=3, ny=1)
    big = [1, 2 ** 40, 3]
    sim = _sim("torch", cfg_kw)
    sim.attach(DmaEndpoint(dst_x=2, dst_y=0, data=big), at=(0, 0))
    with pytest.raises(ValueError, match="data"):
        sim.run_until_drained()
    host = _sim("numpy", cfg_kw)
    host.attach(DmaEndpoint(dst_x=2, dst_y=0, data=big), at=(0, 0))
    host.run_until_drained()
    assert list(host.mem[0, 2, :3]) == big
    with pytest.raises(ValueError, match="int32"):
        _sim("torch", cfg_kw).set_mem(np.full((1, 3, 64), 2 ** 33))


# ----------------------------------------------------------------------
# fuzzed endpoint corpus: telemetry parity across the three
# ----------------------------------------------------------------------
FUZZ_MESHES = ((3, 2), (4, 3))


def _fuzz_build(seed):
    def build(sim, mod):
        rng = np.random.default_rng(seed)
        ny, nx = sim.cfg.ny, sim.cfg.nx
        words = sim.cfg.mem_words
        sim.set_mem(rng.integers(0, words, (ny, nx, words)))
        tiles = [(x, y) for y in range(ny) for x in range(nx)]
        rng.shuffle(tiles)
        eps = {}
        for _ in range(int(rng.integers(1, 3))):
            x, y = tiles.pop()
            dx, dy = tiles[int(rng.integers(0, len(tiles)))]
            eps[(x, y)] = mod.DmaEndpoint(
                dst_x=dx, dst_y=dy,
                data=rng.integers(0, 1000, int(rng.integers(1, 12))),
                max_inflight=int(rng.integers(1, 5)))
        for _ in range(int(rng.integers(1, 3))):
            x, y = tiles.pop()
            dx, dy = tiles[int(rng.integers(0, len(tiles)))]
            eps[(x, y)] = mod.MemoryControllerEndpoint(
                dst_x=dx, dst_y=dy, start_addr=int(rng.integers(0, words)),
                n_requests=int(rng.integers(1, 8)), mem_words=words)
        for at, ep in eps.items():
            sim.attach(ep, at=at)
        return eps
    return build


@pytest.mark.parametrize("seed", range(6))
def test_endpoint_telemetry_parity_fuzz(seed):
    """DMA engines and pointer-chasing controllers at random tiles drain
    at the reference oracle's cycle on both port backends, with
    bit-identical Telemetry and memory; every chaser sees the same
    replies."""
    case = int(np.random.default_rng(4000 + seed).integers(0, 2 ** 31))
    rng = np.random.default_rng(case)
    nx, ny = FUZZ_MESHES[int(rng.integers(0, len(FUZZ_MESHES)))]
    cfg_kw = dict(nx=nx, ny=ny, mem_words=16,
                  max_out_credits=int(rng.integers(2, 9)),
                  router_fifo=int(rng.integers(2, 5)))
    sims = _run_three(cfg_kw, _fuzz_build(case))
    ref_eps = sims["ref"][1]
    for kind in PORT:
        for at, ep in sims[kind][1].items():
            if isinstance(ep, MemoryControllerEndpoint):
                assert ep.visited == ref_eps[at].visited, (kind, at)
                assert ep.latencies == ref_eps[at].latencies
            else:
                assert ep.acked == ref_eps[at].acked


def test_mixed_program_and_endpoint_parity():
    """A base program on most tiles plus a DMA on one: the bridge merges
    the trace with the base program."""
    nx, ny = 3, 3
    entries = make_traffic("uniform", nx, ny, 4, rate=0.5, seed=2)
    for k in entries:
        entries[k][0, 0] = -1 if k == "op" else 0

    def build(sim, mod):
        sim.attach({k: v.copy() for k, v in entries.items()})
        sim.attach(mod.DmaEndpoint(dst_x=2, dst_y=2, data=range(6),
                                   max_inflight=2), at=(0, 0))
    _run_three(dict(nx=nx, ny=ny, mem_words=16), build)


def test_measure_window_reaches_the_replay():
    """A measurement window set before the run gates the histogram the
    same way on the oracle and the replay."""
    entries = make_traffic("uniform", 4, 4, 6, rate=0.5, seed=5)
    for k in entries:
        entries[k][1, 2] = -1 if k == "op" else 0

    def build(sim, mod):
        sim.set_measure_window(10, 40)
        sim.attach({k: v.copy() for k, v in entries.items()})
        sim.attach(mod.DmaEndpoint(dst_x=0, dst_y=3, data=range(9),
                                   max_inflight=3), at=(2, 1))
    sims = _run_three(dict(nx=4, ny=4), build)
    t = sims["torch"][0].telemetry()
    assert 0 < int(t.lat_hist.sum()) < int(t.completed.sum())


def test_run_then_drain_replays_from_cycle_zero():
    """``run(n)`` with endpoints on the torch backend stops at the
    oracle's cycle n with the oracle's telemetry; a later drain replays
    the whole scenario."""
    def build(sim, mod):
        sim.attach(mod.DmaEndpoint(dst_x=3, dst_y=2, data=range(12),
                                   max_inflight=3), at=(0, 0))
    cfg_kw = dict(nx=4, ny=3)
    a, b = _sim("numpy", cfg_kw), _sim("torch", cfg_kw)
    for s in (a, b):
        build(s, T)
        s.run(17)
    assert a.cycle == b.cycle == 17
    a.telemetry().assert_bit_identical(b.telemetry())
    assert a.run_until_drained() == b.run_until_drained()
    a.telemetry().assert_bit_identical(b.telemetry())


def test_torch_backend_rejects_endpoint_attach_after_run():
    """The bridge replays from cycle 0, so attaching to a torch-backend
    Simulator that already ran raises; the numpy backend attaches mid-run
    natively."""
    prog = make_traffic("neighbor", 3, 3, 2)
    for k in prog:
        prog[k][0, 0] = -1 if k == "op" else 0
    t = _sim("torch", dict(nx=3, ny=3))
    t.attach({k: v.copy() for k, v in prog.items()})
    t.run(10)
    with pytest.raises(ValueError, match="already run"):
        t.attach(DmaEndpoint(dst_x=2, dst_y=2, data=[1]), at=(0, 0))
    # ... and a program after a run once endpoints drive it
    e = _sim("torch", dict(nx=3, ny=3))
    e.attach(DmaEndpoint(dst_x=2, dst_y=2, data=[1]), at=(0, 0))
    e.run(5)
    with pytest.raises(ValueError, match="already run"):
        e.attach({k: v.copy() for k, v in prog.items()})
    n = _sim("numpy", dict(nx=3, ny=3))
    n.attach({k: v.copy() for k, v in prog.items()})
    n.run(10)
    n.attach(DmaEndpoint(dst_x=2, dst_y=2, data=[1]), at=(0, 0))
    n.run_until_drained()


def test_facade_step_services_endpoints():
    """Manual stepping on the numpy backend delivers responses (the same
    path as run()); the torch backend refuses per-cycle driving."""
    sim = _sim("numpy", dict(nx=4, ny=1, mem_words=8))
    mc = MemoryControllerEndpoint(dst_x=3, dst_y=0, start_addr=0,
                                  n_requests=3, mem_words=8)
    sim.attach(mc, at=(0, 0))
    for _ in range(200):
        sim.step()
    assert len(mc.latencies) == 3, "manual stepping starved deliver()"
    with pytest.raises(NotImplementedError, match="numpy-backend feature"):
        _sim("torch", dict(nx=4, ny=1)).step()


# ----------------------------------------------------------------------
# the oracle copy and the config conversions
# ----------------------------------------------------------------------
def _oracle_state(sim):
    out = {f: np.asarray(getattr(sim, f)) for f in (
        "cycle", "mem", "credits", "rr", "rr_rev", "prog_len", "prog_ptr",
        "reg_valid", "completed", "lat_sum", "out_of_credit_cycles",
        "completed_per_cycle", "link_util_fwd", "link_util_rev",
        "fifo_hwm_fwd", "fifo_hwm_rev", "ep_hwm", "lat_hist", "resp_valid",
        "measure_start", "measure_stop")}
    for net in ("fwd", "rev", "ep_in"):
        fifo = getattr(sim, net)
        out[f"{net}.head"], out[f"{net}.count"] = fifo.head, fifo.count
        out.update({f"{net}.{k}": v for k, v in fifo.f.items()})
    out.update({f"reg_pkt.{k}": v for k, v in sim.reg_pkt.items()})
    out.update({f"resp_pkt.{k}": v for k, v in sim.resp_pkt.items()})
    return out


@pytest.mark.parametrize("spec", ["mesh", "torus", "ring_mesh",
                                  "multi_chip:2:3"])
def test_oracle_state_equals_the_reference_field_by_field(spec):
    """Random loads, stores and CAS (some addresses off the memory) on
    every topology, resp_latency 1 and 3, a measurement window and the
    response log: every field of the port's MeshSim equals the
    reference's after every cycle."""
    for lat in (1, 3):
        rng = np.random.default_rng(len(spec) * 10 + lat)
        nx, ny = 6, 4
        kw = dict(nx=nx, ny=ny, router_fifo=3, ep_fifo=2, max_out_credits=4,
                  mem_words=16, resp_latency=lat, record_log=True)
        ref = j_netsim.MeshSim(j_netsim.NetConfig(
            topology=J.Topology.parse(spec), **kw))
        port = t_netsim.MeshSim(t_netsim.NetConfig(
            topology=T.Topology.parse(spec), **kw))
        prog = make_traffic("uniform", nx, ny, 12, rate=0.7, seed=lat)
        live = prog["op"] >= 0
        prog["op"] = np.where(live, rng.choice([OP_LOAD, OP_STORE, OP_CAS],
                                               live.shape), -1)
        prog["addr"] = rng.integers(-2, 20, live.shape)
        prog["cmp"] = rng.integers(0, 3, live.shape)
        prog["not_before"] = np.sort(rng.integers(0, 30, live.shape), -1)
        mem = rng.integers(0, 3, (ny, nx, 16))
        for sim in (ref, port):
            sim.load_program({k: v.copy() for k, v in prog.items()})
            sim.mem[:] = mem
            sim.set_measure_window(5, 60)
        for c in range(150):
            ref.step()
            port.step()
            a, b = _oracle_state(ref), _oracle_state(port)
            for k in a:
                np.testing.assert_array_equal(
                    a[k], b[k], err_msg=f"{spec} lat {lat} cycle {c}: {k}")
        assert port.log == ref.log and len(port.log) > 0
        assert int(port.completed.sum()) == int(live.sum())


def test_mesh_config_converts_like_the_reference():
    from repro_torch.netsim.sim import SimConfig
    kw = dict(nx=6, ny=4, router_fifo=3, ep_fifo=2, max_out_credits=5,
              mem_words=32, resp_latency=2, record_log=True)
    for spec in ("mesh", "torus", "multi_chip:2:3"):
        t = MeshConfig(topology=T.Topology.parse(spec), **kw)
        j = J.MeshConfig(topology=J.Topology.parse(spec), **kw)
        assert t.cache_token() == j.cache_token()
        net = t.to_net()
        assert isinstance(net, t_netsim.NetConfig) and net.record_log
        assert MeshConfig.from_net(net) == t
        assert MeshConfig.coerce(net) == t
        assert MeshConfig.coerce(t.to_sim()) == t.replace(record_log=False)
        assert isinstance(t.to_sim(), SimConfig)
        jn = j.to_net()
        assert {f: getattr(net, f) for f in kw} == \
            {f: getattr(jn, f) for f in kw}
    with pytest.raises(ValueError, match="router_fifo >= 2"):
        t_netsim.NetConfig(nx=4, ny=4, router_fifo=1,
                           topology=T.Topology.torus())
