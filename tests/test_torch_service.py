"""The port's simulation service (``repro_torch.sim_service``) against the
reference's (``repro.sim_service``) on the CPU, at the reference tests'
sizes: a 4x4 mesh, phases 50/100/100, ``check_every`` 50.

Both services get the same requests.  The integer fields, every
histogram and every streamed chunk must match exactly; the float32
fields within 1 ulp (the reference divides under ``jit``, the port
eagerly: ROADMAP C-2), and ``lat_mean`` from the port's exact int64
latency sum (C-3) within 1 ulp too.  Against the port's own direct
``phased_stats`` (the same arithmetic on the same device) every field
must be identical.  The batch, block, chunk and shape counts must be the
reference's.  The reference is imported inside the tests, so that the
one card test here runs where JAX is not installed.
"""
import asyncio
import os

import numpy as np
import pytest
import torch

from repro_torch import sim_service as T
from repro_torch.mesh import MeshConfig, make_traffic
from repro_torch.netsim.measure import (load_latency_sweep, phased_stats,
                                        sweep_config)
from repro_torch.netsim.sim import init_state, load_program

PHASES = dict(warmup=50, measure=100, drain=100, check_every=50)
HORIZON = 250
CPU = dict(device="cpu")
FLOAT_FIELDS = ("offered", "accepted", "delivered", "lat_mean", "lat_p50",
                "lat_p95", "lat_p99", "lat_max", "peak_link_util", "hops")
# the knob pairs of the reference's mixed batch: (seed, fifo, credits)
MIXED = [(0, None, None), (1, 2, 8), (2, 8, 32), (3, 4, 16)]


def _ref():
    """The reference's service and config (imported here: see the module
    docstring)."""
    from repro import sim_service as J
    from repro.mesh.config import MeshConfig as JMeshConfig
    return J, JMeshConfig


def _pair(cls, cfg_kw, **kw):
    """The same request for the port and for the reference."""
    J, JMeshConfig = _ref()
    return (getattr(T, cls)(cfg=MeshConfig(**cfg_kw), **kw),
            getattr(J, cls)(cfg=JMeshConfig(**cfg_kw), **kw))


def _port_direct(req):
    """The port's one-shot phased_stats on the request's program and
    knobs alone, no service in the loop."""
    cfg = req.cfg.to_sim()
    if req.entries is not None:
        prog = load_program(dict(req.entries), "cpu")
    else:
        length = int(np.ceil(req.load * req.horizon)) + 1
        prog = load_program(make_traffic(
            req.pattern, req.cfg.nx, req.cfg.ny, length, rate=req.load,
            seed=req.seed, topology=req.cfg.topology), "cpu")
    st = init_state(cfg, req.fifo_depth, req.max_credits, lanes=1, **CPU)
    return phased_stats(cfg, prog, st, req.warmup, req.measure, req.drain,
                        req.cycles_per_call)


def _assert_identical(direct, served, ctx=""):
    """Every field equal: ``direct`` has one-lane tensors, ``served``
    numpy leaves."""
    for f in direct._fields:
        a = getattr(direct, f)[0].numpy()
        b = np.asarray(getattr(served, f))
        assert a.dtype == b.dtype and a.shape == b.shape \
            and (a == b).all(), f"{ctx}: {f} direct={a} served={b}"


def _assert_like_reference(t, j, ntiles=16, measure=100, ctx=""):
    """Port ``PhaseStats`` vs the reference's: histogram and the counts
    behind the rates exact, float32 fields within 1 ulp."""
    np.testing.assert_array_equal(np.asarray(t.hist), np.asarray(j.hist),
                                  err_msg=ctx)
    for f in FLOAT_FIELDS:
        a = np.asarray(getattr(t, f), np.float32)
        b = np.asarray(getattr(j, f), np.float32)
        np.testing.assert_array_max_ulp(a, b, maxulp=1)
        if f in ("offered", "accepted", "delivered"):
            assert np.rint(a * measure * ntiles) == \
                np.rint(b * measure * ntiles), f"{ctx}: {f}"


def _assert_chunks_equal(tc, jc):
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        assert (a.rid, a.lane, a.label) == (b.rid, b.lane, b.label)
        for f in ("phase", "start", "stop", "injected", "completed",
                  "delivered"):
            assert getattr(a.chunk, f) == getattr(b.chunk, f), f
        assert a.chunk.hist.dtype == np.int32
        np.testing.assert_array_equal(a.chunk.hist, np.asarray(b.chunk.hist))


def _counts(metrics):
    return {k: getattr(metrics, k) for k in (
        "submitted", "rejected", "completed", "lanes", "ticks", "batches",
        "blocks", "chunks", "sim_compiles", "aux_compiles", "peak_pending")}


def _run_both(pairs, max_batch=8, clear=False):
    """Submit every pair's request to a fresh port and reference service,
    run both until idle; returns (port service, reference service, port
    tickets, reference tickets)."""
    J, _ = _ref()
    if clear:
        T.clear_service_cache()
        J.clear_service_cache()
    ts, js = T.SimService(max_batch=max_batch, **CPU), \
        J.SimService(max_batch=max_batch)
    tt = [ts.submit(t) for t, _ in pairs]
    jt = [js.submit(j) for _, j in pairs]
    ts.server.run_until_idle()
    js.server.run_until_idle()
    return ts, js, tt, jt


# -- the reference's seven scenarios --------------------------------------

def test_mixed_knob_batch_matches_reference():
    """Different seeds and per-lane fifo/credit knobs in one batch: every
    response equals its request run alone, and the reference's response;
    every chunk equals the reference's."""
    cfg = dict(nx=4, ny=4, router_fifo=8, max_out_credits=32)
    pairs = [_pair("SimRequest", cfg, pattern="uniform", load=0.3, seed=s,
                   fifo_depth=d, max_credits=c, **PHASES)
             for s, d, c in MIXED]
    ts, js, tt, jt = _run_both(pairs)
    assert ts.metrics.batches == js.metrics.batches == 1
    for (t_req, _), a, b in zip(pairs, tt, jt):
        ctx = f"seed={t_req.seed} fifo={t_req.fifo_depth}"
        _assert_identical(_port_direct(t_req), a.response.stats, ctx)
        _assert_like_reference(a.response.stats, b.response.stats, ctx=ctx)
        _assert_chunks_equal(a.chunks, b.chunks)
        assert a.response.metrics["batch_lanes"] == len(pairs)
        for k in ("bucket", "batch_width", "batch_lanes", "blocks",
                  "chunks"):
            assert a.response.metrics[k] == b.response.metrics[k], k
        assert set(a.response.metrics) == set(b.response.metrics)


def test_mixed_shapes_bucket_and_shape_counts():
    """Distinct shapes (mesh size / padded program length / cadence) land
    in distinct buckets, same-shape requests share one; the batch, block,
    chunk and shape counts are the reference's on cleared registries."""
    pairs = (
        [_pair("SimRequest", dict(nx=4, ny=4), load=0.3, seed=s, **PHASES)
         for s in (0, 1)]
        + [_pair("SimRequest", dict(nx=4, ny=2), load=0.3, **PHASES)]
        + [_pair("SimRequest", dict(nx=4, ny=4), load=0.3, warmup=50,
                 measure=100, drain=100, check_every=125)])
    ts, js, tt, jt = _run_both(pairs, clear=True)
    assert _counts(ts.metrics) == _counts(js.metrics)
    assert ts.metrics.batches == 3 and ts.metrics.sim_compiles == 4
    assert T.executed_shapes() == 10       # 4 block, 3 init, 3 reduce
    for (t_req, _), a, b in zip(pairs, tt, jt):
        n = t_req.cfg.nx * t_req.cfg.ny
        _assert_identical(_port_direct(t_req), a.response.stats)
        _assert_like_reference(a.response.stats, b.response.stats, ntiles=n)
        _assert_chunks_equal(a.chunks, b.chunks)
        assert a.response.metrics["bucket"] == b.response.metrics["bucket"]


def test_streamed_chunks_concatenate_to_final_stats():
    """Chunk deltas are exact: summed counters/histograms reproduce the
    response totals, cover the full horizon, follow the phase schedule,
    and equal the reference's stream chunk for chunk."""
    J, _ = _ref()
    t_req, j_req = _pair("SimRequest", dict(nx=4, ny=4), load=0.3, **PHASES)

    def drain(gen):
        chunks = []
        while True:
            try:
                chunks.append(next(gen))
            except StopIteration as stop:
                return chunks, stop.value
    chunks, resp = drain(T.SimService(**CPU).stream(t_req))
    j_chunks, j_resp = drain(J.SimService().stream(j_req))
    _assert_chunks_equal(chunks, j_chunks)
    _assert_like_reference(resp.stats, j_resp.stats)
    assert [c.chunk.phase for c in chunks] == \
        ["warmup", "measure", "measure", "drain", "drain"]
    assert chunks[0].chunk.start == 0 and chunks[-1].chunk.stop == HORIZON
    assert all(a.chunk.stop == b.chunk.start
               for a, b in zip(chunks, chunks[1:]))
    hist = np.asarray(resp.stats.hist)
    assert sum(c.chunk.delivered for c in chunks) == int(hist.sum())
    assert (sum(c.chunk.hist for c in chunks) == hist).all()
    inj_meas = sum(c.chunk.injected for c in chunks
                   if c.chunk.phase == "measure")
    assert inj_meas == round(float(resp.stats.offered) * 16 * 100)


def test_cold_vs_warm_service_shape_counts():
    """A second service instance in the same process re-serves a seen
    shape with 0 new shapes (block and aux), as the reference's reports
    0 fresh executables, and identical results."""
    J, _ = _ref()
    t_req, j_req = _pair("SimRequest", dict(nx=4, ny=4), load=0.25,
                         **PHASES)
    got = {}
    for name, mod, req, kw in (("port", T, t_req, CPU),
                               ("ref", J, j_req, {})):
        mod.clear_service_cache()
        cold = mod.SimService(max_batch=4, **kw)
        r_cold = cold.run_one(req)
        warm = mod.SimService(max_batch=4, **kw)
        r_warm = warm.run_one(req)
        got[name] = (cold.metrics.sim_compiles, cold.metrics.aux_compiles,
                     warm.metrics.sim_compiles, warm.metrics.aux_compiles,
                     r_warm.metrics["new_sim_compiles"])
        if name == "port":
            for f in r_cold.stats._fields:
                assert (np.asarray(getattr(r_cold.stats, f))
                        == np.asarray(getattr(r_warm.stats, f))).all(), f
    assert got["port"] == got["ref"] == (1, 2, 0, 0, 0)


def test_bounded_queue_backpressure():
    """submit() past queue_limit raises ServiceOverloaded with the
    reference's message (and counts the rejection); draining the queue
    re-opens admission."""
    J, _ = _ref()
    t_req, j_req = _pair("SimRequest", dict(nx=4, ny=4), load=0.3, **PHASES)
    msgs, counts = [], []
    for mod, req, kw in ((T, t_req, CPU), (J, j_req, {})):
        svc = mod.SimService(queue_limit=3, **kw)
        for _ in range(3):
            svc.submit(req)
        with pytest.raises(mod.ServiceOverloaded) as err:
            svc.submit(req)
        msgs.append(str(err.value))
        assert svc.metrics.rejected == 1 and svc.metrics.peak_pending == 3
        svc.server.run_until_idle()
        ticket = svc.submit(req)           # space again once drained
        svc.server.run_until_idle()
        assert ticket.done
        counts.append(_counts(svc.metrics))
    assert msgs[0] == msgs[1]
    assert counts[0] == counts[1]


@pytest.mark.parametrize("topo", ["mesh", "torus"])
def test_sweep_request_matches_load_latency_sweep(topo):
    """A service-side sweep equals the port's load_latency_sweep field by
    field per rate, and the reference's service sweep within the stated
    tolerance; all three agree on the knee."""
    from repro.netsim_jax.measure import load_latency_sweep as j_sweep
    from repro_torch.mesh import Topology
    from repro.mesh import Topology as JTopology
    J, JMeshConfig = _ref()
    rates = (0.05, 0.2, 0.4, 0.6)
    cfg = sweep_config(4, 4, Topology.parse(topo))
    j_cfg = JMeshConfig(nx=4, ny=4, router_fifo=16, max_out_credits=128,
                        topology=JTopology.parse(topo))
    svc = T.SimService(max_batch=4, **CPU)
    resp = svc.run_one(T.SweepRequest(cfg=cfg, rates=rates, **PHASES))
    assert svc.metrics.batches == 1        # the curve is one bucket
    j_resp = J.SimService(max_batch=4).run_one(
        J.SweepRequest(cfg=j_cfg, rates=rates, **PHASES))
    direct = load_latency_sweep("uniform", 4, 4, rates, cfg=cfg, warmup=50,
                                measure=100, drain=100, **CPU)
    for i, r in enumerate(rates):
        for f in resp.stats[i]._fields:
            a = np.asarray(direct[f])[i]
            b = np.asarray(getattr(resp.stats[i], f))
            assert a.dtype == b.dtype and (a == b).all(), f"{r} {f}"
        _assert_like_reference(resp.stats[i], j_resp.stats[i], ctx=str(r))
    j_direct = j_sweep("uniform", 4, 4, rates, cfg=j_cfg, warmup=50,
                       measure=100, drain=100)
    assert resp.curve["saturation_index"] == direct["saturation_index"] \
        == j_resp.curve["saturation_index"] == j_direct["saturation_index"]
    assert resp.curve["zero_load_latency"] == direct["zero_load_latency"]
    assert resp.curve["monotone"] == direct["monotone"] \
        == j_resp.curve["monotone"]
    assert resp.curve["saturation_rate"] == j_resp.curve["saturation_rate"]
    assert set(resp.curve) == set(j_resp.curve)


def test_async_server_streams_and_resolves():
    """The asyncio surface: serve() + Ticket.stream()/result() deliver
    the same chunks and stats as the sync facade and as the reference's
    async server."""
    J, _ = _ref()
    t_req, j_req = _pair("SimRequest", dict(nx=4, ny=4), load=0.3, **PHASES)

    async def scenario(server, req):
        t1, t2 = server.submit(req), server.submit(req)
        serve = asyncio.ensure_future(server.serve(until_idle=True))

        async def consume(t):
            return [c async for c in t.stream()], await t.result()
        out = await asyncio.gather(consume(t1), consume(t2))
        await serve
        return out

    server = T.SimServer(max_batch=4, **CPU)
    (c1, r1), (c2, r2) = asyncio.run(scenario(server, t_req))
    (jc1, jr1), _ = asyncio.run(scenario(J.SimServer(max_batch=4), j_req))
    assert server.metrics.batches == 1
    assert len(c1) == len(c2) == 5
    _assert_chunks_equal(c1, jc1)
    _assert_like_reference(r1.stats, jr1.stats)
    sync = T.SimService(**CPU)
    s_ticket = sync.submit(t_req)
    sync.server.run_until_idle()
    for got in ((c1, r1), (c2, r2)):
        assert [c.chunk.injected for c in got[0]] == \
            [c.chunk.injected for c in s_ticket.chunks]
        for a, b in zip(got[0], s_ticket.chunks):
            np.testing.assert_array_equal(a.chunk.hist, b.chunk.hist)
        _assert_identical(_port_direct(t_req), got[1].stats)
    _assert_identical(_port_direct(t_req), s_ticket.response.stats)


# -- the port's own pieces ----------------------------------------------

def test_bucketing_helpers_match_reference():
    """next_pow2, pad_program_length and stack_lanes (width padding by
    lane 0) give the reference's arrays."""
    from repro.sim_service import bucketing as JB
    from repro.sim_service.request import LaneSpec as JLaneSpec
    from repro.netsim_jax.sim import load_program as j_load_program
    for n in range(1, 70):
        assert T.next_pow2(n) == JB.next_pow2(n)
    lanes, j_lanes = [], []
    for seed, (d, c) in enumerate(((2, 8), (8, 32), (4, 16))):
        entries = make_traffic("uniform", 4, 2, 13 + seed, rate=0.3,
                               seed=seed)
        lanes.append(T.LaneSpec(load_program(entries, "cpu"), d, c))
        j_lanes.append(JLaneSpec(j_load_program(entries), d, c))
    padded = T.bucketing.pad_program_length(lanes[0].program, 32)
    j_padded = JB.pad_program_length(j_lanes[0].program, 32)
    # the port's one-lane program keeps its lane axis
    np.testing.assert_array_equal(padded.buf.numpy()[0],
                                  np.asarray(j_padded.buf))
    np.testing.assert_array_equal(padded.length.numpy()[0],
                                  np.asarray(j_padded.length))
    with pytest.raises(ValueError, match="exceeds bucket length"):
        T.bucketing.pad_program_length(lanes[2].program, 8)
    progs, depths, credits = T.bucketing.stack_lanes(lanes, 16, 4)
    j_progs, j_depths, j_credits = JB.stack_lanes(j_lanes, 16, 4)
    np.testing.assert_array_equal(progs.buf.numpy(), np.asarray(j_progs.buf))
    np.testing.assert_array_equal(progs.length.numpy(),
                                  np.asarray(j_progs.length))
    np.testing.assert_array_equal(depths, np.asarray(j_depths))
    np.testing.assert_array_equal(credits, np.asarray(j_credits))
    assert depths.dtype == np.int32 and progs.buf.shape[0] == 4
    with pytest.raises(ValueError, match="cannot pad to width 2"):
        T.bucketing.stack_lanes(lanes, 16, 2)
    key = T.SimRequest(cfg=MeshConfig(nx=4, ny=2)).sweep_key()
    assert T.bucket_key(key, lanes[1].program, 50) == \
        T.BucketKey(key, 16, 50)             # 14 entries pad to 16


@pytest.mark.parametrize("cls,kw,match", [
    ("SimRequest", dict(check_every=0), "check_every must be >= 1"),
    ("SimRequest", dict(fifo_depth=9), r"fifo_depth=9 outside \[1, 8\]"),
    ("SimRequest", dict(max_credits=0), r"max_credits=0 outside \[1, 32\]"),
    ("SweepRequest", dict(rates=(0.0, 0.5)), "sweep rates must be in"),
    ("SweepRequest", dict(rates=(0.5, 1.5)), "sweep rates must be in"),
])
def test_request_validation_matches_reference(cls, kw, match):
    """The reference's validation errors, with its messages."""
    J, JMeshConfig = _ref()
    cfg = dict(nx=4, ny=4, router_fifo=8, max_out_credits=32)
    with pytest.raises(ValueError, match=match) as t_err:
        getattr(T, cls)(cfg=MeshConfig(**cfg), **kw)
    with pytest.raises(ValueError, match=match) as j_err:
        getattr(J, cls)(cfg=JMeshConfig(**cfg), **kw)
    assert str(t_err.value) == str(j_err.value)


def test_port_request_and_server_arguments():
    """The port's own argument checks: ``cycles_per_call`` (default
    ``None``, one kernel call per fence block) is validated by the
    port's SweepKey at submit; ``max_batch`` must be >= 1 and rounds
    down to a power of two; the requests have no ``unroll``/``impl``."""
    req = T.SimRequest(cfg=MeshConfig(nx=4, ny=4), cycles_per_call=0)
    svc = T.SimService(**CPU)
    with pytest.raises(ValueError, match="cycles_per_call"):
        svc.submit(req)
    assert svc.server.pending_lanes == 0 and svc.server.idle
    assert T.SimRequest(cfg=MeshConfig(nx=4, ny=4)).cycles_per_call is None
    with pytest.raises(TypeError):
        T.SimRequest(cfg=MeshConfig(nx=4, ny=4), unroll=2)
    with pytest.raises(ValueError, match="max_batch must be >= 1"):
        T.SimServer(max_batch=0, **CPU)
    assert T.SimServer(max_batch=6, **CPU).max_batch == 4


def test_cycles_per_call_none_and_7_agree():
    """One kernel call per fence block (the default) and calls of 7
    cycles give equal responses and chunks, in separate buckets."""
    reqs = [T.SimRequest(cfg=MeshConfig(nx=4, ny=4, router_fifo=8,
                                        max_out_credits=32),
                         load=0.3, seed=s, fifo_depth=d, max_credits=c,
                         cycles_per_call=cpc, **PHASES)
            for cpc in (None, 7) for s, d, c in MIXED[:2]]
    svc = T.SimService(**CPU)
    tickets = [svc.submit(r) for r in reqs]
    svc.server.run_until_idle()
    assert svc.metrics.batches == 2
    for a, b in zip(tickets[:2], tickets[2:]):
        for f in a.response.stats._fields:
            assert (np.asarray(getattr(a.response.stats, f))
                    == np.asarray(getattr(b.response.stats, f))).all(), f
        assert [c.chunk.completed for c in a.chunks] == \
            [c.chunk.completed for c in b.chunks]


def test_explicit_entries_request():
    """A request with an explicit injection program (``entries``) equals
    its direct run and the reference's response."""
    entries = make_traffic("transpose", 4, 4, 40, rate=0.4, seed=3)
    t_req, j_req = _pair("SimRequest", dict(nx=4, ny=4), entries=entries,
                         **PHASES)
    ts, js, tt, jt = _run_both([(t_req, j_req)])
    _assert_identical(_port_direct(t_req), tt[0].response.stats)
    _assert_like_reference(tt[0].response.stats, jt[0].response.stats)
    _assert_chunks_equal(tt[0].chunks, jt[0].chunks)
    assert tt[0].response.metrics["bucket"] == "mesh-4x4/L64/ce50"


def test_compile_cache_dir_on_cpu_builds_nothing(tmp_path, monkeypatch):
    """On the CPU ``compile_cache_dir`` has nothing to build: the build
    directory is left alone and the stats say nothing was built."""
    from repro_torch.kernels import build
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    before = build.build_dir()
    svc = T.SimService(compile_cache_dir=tmp_path / "kc", **CPU)
    svc.run_one(T.SimRequest(cfg=MeshConfig(nx=4, ny=4), load=0.2,
                             **PHASES))
    cache = svc.metrics.snapshot()["compilation_cache"]
    assert cache["built"] == 0 and cache["loaded"] == 0
    assert cache["dir"] is None and "nothing is built" in cache["note"]
    assert "REPRO_TORCH_BUILD_DIR" not in os.environ
    assert build.build_dir() == before
    assert not (tmp_path / "kc").exists()
    snap = svc.metrics.snapshot()
    assert snap["completed"] == 1 and snap["blocks"] == 5


def test_using_build_dir_is_scoped(tmp_path, monkeypatch):
    """A server's ``compile_cache_dir`` is set around its own work only:
    ``build.using_build_dir`` nests, ends with its block (also on an
    error) and leaves the environment alone."""
    from repro_torch.kernels import build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "env"))
    with build.using_build_dir(tmp_path / "a"):
        assert build.build_dir() == tmp_path / "a"
        with build.using_build_dir(None):
            assert build.build_dir() == tmp_path / "a"
        with pytest.raises(KeyError):
            with build.using_build_dir(str(tmp_path / "b")):
                assert build.build_dir() == tmp_path / "b"
                raise KeyError
        assert build.build_dir() == tmp_path / "a"
    assert build.build_dir() == tmp_path / "env"
    assert os.environ["REPRO_TORCH_BUILD_DIR"] == str(tmp_path / "env")


def test_build_cache_stats_count_per_directory(tmp_path):
    """``build.load`` keeps one library per name and directory and counts
    a library it finds already built as loaded, not built;
    ``build.cache_stats`` reports that and the directory's entries.  A
    copy of an extension module stands in for the built library (no
    ``nvcc`` here, and nothing of it is called)."""
    import _ctypes
    import shutil
    from repro_torch.kernels import build
    assert build.cache_stats(tmp_path) == {"dir": str(tmp_path), "built": 0,
                                           "loaded": 0, "entries": 0}
    lib = build.library_path("router_step", tmp_path)
    shutil.copy(_ctypes.__file__, lib)
    first = build.load("router_step", tmp_path)
    assert build.load("router_step", str(tmp_path)) is first
    assert build.cache_stats(tmp_path) == {"dir": str(tmp_path), "built": 0,
                                           "loaded": 1, "entries": 1}
    other = tmp_path / "other"
    other.mkdir()
    shutil.copy(_ctypes.__file__, build.library_path("router_step", other))
    assert build.load("router_step", other) is not first
    assert build.cache_stats(other)["loaded"] == 1
    assert build.cache_stats(tmp_path / "none")["entries"] == 0


def test_the_card_by_default():
    """No card and no ``device="cpu"``: the server raises rather than
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SimService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SimServer(max_batch=4)


@pytest.mark.gpu
def test_service_on_card_matches_cpu():
    """The mixed-knob batch on the card (one router kernel call per fence
    block) equals the same batch on the CPU, field for field and chunk
    for chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 (no CUDA device visible)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")
    from repro_torch.kernels.router_step import router_step_call
    cfg = MeshConfig(nx=4, ny=4, router_fifo=8, max_out_credits=32)
    reqs = [T.SimRequest(cfg=cfg, load=0.3, seed=s, fifo_depth=d,
                         max_credits=c, **PHASES) for s, d, c in MIXED]
    out = {}
    for dev in ("cuda", "cpu"):
        svc = T.SimService(device=dev)
        before = router_step_call.launches
        tickets = [svc.submit(r) for r in reqs]
        svc.server.run_until_idle()
        out[dev] = (tickets, router_step_call.launches - before)
    (card, launches), (cpu, none) = out["cuda"], out["cpu"]
    assert launches == 5 and none == 0
    for a, b in zip(card, cpu):
        for f in a.response.stats._fields:
            assert (np.asarray(getattr(a.response.stats, f))
                    == np.asarray(getattr(b.response.stats, f))).all(), f
        assert [c.chunk for c in a.chunks] != [] and len(a.chunks) == 5
        for x, y in zip(a.chunks, b.chunks):
            assert x.chunk.injected == y.chunk.injected
            np.testing.assert_array_equal(x.chunk.hist, y.chunk.hist)
        assert set(a.response.metrics) == set(b.response.metrics)
