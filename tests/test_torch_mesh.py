"""The port's own copies of the JAX package's numpy-level modules, held
equal to their originals: the network constants, the packed-header
encoding, the topologies and their routing (``xp=torch`` against the
original's ``xp=np``), the traffic library (byte-identical programs for
the same seed), ``MeshConfig`` validation and the telemetry record."""
import numpy as np
import pytest
import torch

import repro.core.netsim as j_netsim
import repro.mesh.encoding as j_enc
from repro.mesh import MeshConfig as JMeshConfig
from repro.mesh import TELEMETRY_ARRAY_FIELDS as J_TELEMETRY_ARRAY_FIELDS
from repro.mesh import Telemetry as JTelemetry
from repro.mesh import Topology as JTopology
from repro.mesh import make_traffic as j_make_traffic
from repro.mesh.traffic import PATTERNS as J_PATTERNS
import repro_torch.core.netsim as t_netsim
import repro_torch.mesh.encoding as t_enc
from repro_torch.mesh import (MeshConfig, PATTERNS, TELEMETRY_ARRAY_FIELDS,
                              Telemetry, Topology, make_traffic)

TOPOLOGIES = ["mesh", "torus", "ring_mesh", "multi_chip:2:3"]


def test_constants_equal():
    for name in ("P", "W", "E", "N", "S", "NUM_DIRS", "LAT_BINS",
                 "NO_MEASURE", "OP_LOAD", "OP_STORE", "OP_CAS"):
        assert getattr(t_netsim, name) == getattr(j_netsim, name), name
    assert [t_netsim.unloaded_rtt(h) for h in range(8)] == \
        [j_netsim.unloaded_rtt(h) for h in range(8)]
    for name in j_enc.__all__:
        if name.isupper():
            assert getattr(t_enc, name) == getattr(j_enc, name), name


@pytest.mark.parametrize("pattern", sorted(J_PATTERNS))
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_make_traffic_byte_identical(pattern, seed):
    assert sorted(PATTERNS) == sorted(J_PATTERNS)
    for topo in ("mesh", "torus"):
        kw = dict(rate=0.37, seed=seed)
        j = j_make_traffic(pattern, 6, 6, 9, topology=JTopology.parse(topo),
                           **kw)
        t = make_traffic(pattern, 6, 6, 9, topology=Topology.parse(topo),
                         **kw)
        assert j.keys() == t.keys()
        for k in j:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k], err_msg=k)


def test_make_traffic_errors_match():
    for args, kw in [(("nope", 4, 4, 2), {}), (("uniform", 4, 4, 2),
                                               {"rate": 0.0}),
                     (("transpose", 4, 3, 2), {}),
                     (("hotspot", 4, 4, 2), {"spot": (9, 0)}),
                     (("hotspot", 4, 4, 2), {"fraction": 2.0})]:
        with pytest.raises(ValueError) as je:
            j_make_traffic(*args, **kw)
        with pytest.raises(ValueError) as te:
            make_traffic(*args, **kw)
        assert str(je.value) == str(te.value)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_route_torch_equals_reference_numpy(topo):
    """Every (position, destination) pair on two array shapes, including
    the even-ring half-way ties."""
    jt, tt = JTopology.parse(topo), Topology.parse(topo)
    for nx, ny in ((6, 4), (6, 5)):
        g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nx),
                                 np.arange(ny), indexing="ij")).reshape(4, -1)
        x, y, dx, dy = g
        want = jt.route(dx, dy, x, y, nx, ny, xp=np)
        got = tt.route(*(torch.as_tensor(v.astype(np.int32))
                         for v in (dx, dy, x, y)), nx, ny, xp=torch)
        np.testing.assert_array_equal(got.numpy(), want)
        assert tt.diameter(nx, ny) == jt.diameter(nx, ny)
        assert tt.uniform_saturation_bound(nx, ny) == \
            jt.uniform_saturation_bound(nx, ny)
        np.testing.assert_array_equal(tt.hops(x, y, dx, dy, nx, ny),
                                      jt.hops(x, y, dx, dy, nx, ny))
    assert tt.spec == jt.spec and tt.boundary_cols(6) == jt.boundary_cols(6)


def test_topology_parse_errors_match():
    for spec in ("hex", "torus:2", "multi_chip:a", "multi_chip:1:2:3",
                 "multi_chip:1"):
        with pytest.raises(ValueError) as je:
            JTopology.parse(spec)
        with pytest.raises(ValueError) as te:
            Topology.parse(spec)
        assert str(je.value) == str(te.value)


def test_header_packing_equal():
    rng = np.random.default_rng(3)
    dx, dy, sx, sy = rng.integers(0, 128, (4, 200))
    op = rng.integers(0, 4, 200)
    hdr = j_enc.pack_dst_op(dx, dy, op)
    np.testing.assert_array_equal(t_enc.pack_dst_op(dx, dy, op), hdr)
    np.testing.assert_array_equal(
        t_enc.with_src(torch.as_tensor(hdr.astype(np.int32)),
                       torch.as_tensor(sx.astype(np.int32)),
                       torch.as_tensor(sy.astype(np.int32))).numpy(),
        j_enc.with_src(hdr, sx, sy))
    full = j_enc.pack_header(dx, dy, sx, sy, op)
    np.testing.assert_array_equal(
        t_enc.swap_for_response(torch.as_tensor(full.astype(np.int32)),
                                torch.as_tensor(dy.astype(np.int32)),
                                torch.as_tensor(sx.astype(np.int32))).numpy(),
        j_enc.swap_for_response(full, dy, sx))
    for k, v in j_enc.decode_header(full).items():
        np.testing.assert_array_equal(t_enc.decode_header(full)[k], v)


def test_validate_program_errors_match():
    base = make_traffic("uniform", 4, 4, 3)
    cases = [("dst_x", 200, {}), ("dst_y", 5, {"nx": 4, "ny": 4}),
             ("op", 4, {}), ("addr", 2**31, {}), ("not_before", -2**31 - 1, {})]
    for field, value, kw in cases:
        bad = {k: v.copy() for k, v in base.items()}
        bad[field][0, 0, 0] = value
        with pytest.raises(ValueError) as je:
            j_enc.validate_program(bad, **kw)
        with pytest.raises(ValueError) as te:
            t_enc.validate_program(bad, **kw)
        assert str(je.value) == str(te.value)
    t_enc.validate_program(base, 4, 4, Topology.mesh())


def test_mesh_config_validation_matches():
    for kw in (dict(nx=0, ny=3), dict(nx=3, ny=-1)):
        with pytest.raises(ValueError) as je:
            JMeshConfig(**kw)
        with pytest.raises(ValueError) as te:
            MeshConfig(**kw)
        assert str(je.value) == str(te.value)
    with pytest.raises(ValueError) as je:
        JMeshConfig(nx=5, ny=2, topology=JTopology.multi_chip(2))
    with pytest.raises(ValueError) as te:
        MeshConfig(nx=5, ny=2, topology=Topology.multi_chip(2))
    assert str(je.value) == str(te.value)
    kw = dict(nx=6, ny=3, router_fifo=5, ep_fifo=2, max_out_credits=7,
              mem_words=9, resp_latency=2)
    j = JMeshConfig(topology=JTopology.torus(), **kw)
    t = MeshConfig(topology=Topology.torus(), **kw)
    assert (t.nx, t.ny, t.router_fifo, t.ep_fifo, t.max_out_credits,
            t.mem_words, t.resp_latency, t.topology.spec) == \
        (j.nx, j.ny, j.router_fifo, j.ep_fifo, j.max_out_credits,
         j.mem_words, j.resp_latency, j.topology.spec)
    assert MeshConfig.coerce(t.to_sim()) == t
    assert MeshConfig.coerce(t.to_sim()).to_sim() == t.to_sim()
    with pytest.raises(TypeError):
        MeshConfig.coerce(3)


class _Counters:
    """Anything oracle-shaped: the telemetry fields plus ``cycle``."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.cycle = 40
        for f, shape in (("completed", (3, 4)), ("lat_sum", (3, 4)),
                         ("completed_per_cycle", (40,)),
                         ("link_util_fwd", (3, 4, 5)),
                         ("link_util_rev", (3, 4, 5)),
                         ("fifo_hwm_fwd", (3, 4, 5)),
                         ("fifo_hwm_rev", (3, 4, 5)), ("ep_hwm", (3, 4)),
                         ("lat_hist", (512,))):
            setattr(self, f, rng.integers(0, 9, shape))


def test_telemetry_record_equal():
    assert TELEMETRY_ARRAY_FIELDS == J_TELEMETRY_ARRAY_FIELDS
    t, j = Telemetry.of(_Counters(1)), JTelemetry.of(_Counters(1))
    t.assert_bit_identical(j)
    assert t == Telemetry.of(_Counters(1)) and t != Telemetry.of(_Counters(2))
    with pytest.raises(AssertionError, match="mismatch: completed"):
        t.assert_bit_identical(JTelemetry.of(_Counters(2)))
    np.testing.assert_array_equal(t.link_heatmap("rev"), j.link_heatmap("rev"))
    assert t.hotspots() == j.hotspots()
    assert t.heatmap_str(per_port=True) == j.heatmap_str(per_port=True)
    assert t.mean_latency() == j.mean_latency()
    assert t.throughput(5) == j.throughput(5)
