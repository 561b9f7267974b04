"""The port's simulator (``repro_torch.netsim.sim``) against the JAX
reference (``repro.netsim_jax``), leaf for leaf.

Every test makes its program with numpy from a seed, hands the same
program to both packages, runs the JAX fused step and the port's plain
PyTorch step on the CPU, and compares every ``SimState`` leaf and every
per-cycle completion count exactly (the simulator is integer-only, so the
bar is bit-identity):

* the 3-shape x 6-pattern grid on the mesh, mid-flight and at the drain
  cycle, and a subset on torus, ring-mesh and multi-chip;
* ``resp_latency > 1``, and effective FIFO depth / credits below capacity;
* a batch of lanes with different depths and credits, lane by lane
  against separate JAX runs;
* the exact drain cycle for every ``check_every`` and ``cycles_per_call``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.mesh import MeshConfig as JMeshConfig
from repro.mesh import Topology as JTopology
from repro.mesh import make_traffic as j_make_traffic
from repro.netsim_jax import init_state as j_init_state
from repro.netsim_jax import load_program as j_load_program
from repro.netsim_jax import run_until_drained as j_run_until_drained
from repro.netsim_jax import run_until_drained_traced as j_drain
from repro.netsim_jax import simulate as j_simulate
from repro_torch.mesh import MeshConfig, PATTERNS, Topology, make_traffic
from repro_torch.netsim import (init_state, load_program, program_from_jax,
                                run_until_drained, run_until_drained_traced,
                                simulate, stack_programs, state_from_jax,
                                state_to_numpy)
from repro_torch.netsim.sim import STATE_LEAVES, SimConfig, drained

MESHES = [(2, 2), (4, 4), (3, 5)]
LENGTH = 16              # program entries per tile
# a mid-flight stop: at any rate <= 1 the last entry (not_before >= 15)
# is still pending at cycle 14, and earlier packets are in flight
MID = 14
MAX = 2000


def _cfgs(nx, ny, topo="mesh", **kw):
    return (JMeshConfig(nx=nx, ny=ny, topology=JTopology.parse(topo),
                        **kw).to_sim(),
            MeshConfig(nx=nx, ny=ny, topology=Topology.parse(topo),
                       **kw).to_sim())


def _programs(pattern, nx, ny, topo="mesh", length=LENGTH, **kw):
    """The same program from both traffic libraries (asserted equal)."""
    j = j_make_traffic(pattern, nx, ny, length, topology=JTopology.parse(topo),
                       **kw)
    t = make_traffic(pattern, nx, ny, length, topology=Topology.parse(topo),
                     **kw)
    for k in j:
        np.testing.assert_array_equal(j[k], t[k])
    return j, t


def _jleaves(st):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]


def assert_lane_equal(tst, jst, lane=0, what=""):
    """Lane ``lane`` of the port's state equals the JAX state, leaf for
    leaf (dtype included: bools stay bools)."""
    for name, a, b in zip(STATE_LEAVES, state_to_numpy(tst), _jleaves(jst)):
        assert a[lane].dtype == b.dtype, name
        np.testing.assert_array_equal(a[lane], b,
                                      err_msg=f"{what} leaf {name}")


def _run_both(jcfg, tcfg, jprog, tprog, *, fifo_depth=None, max_credits=None,
              mid=MID, check_every=1, cycles_per_call=1):
    """Mid-flight then drain on both packages; compares after each."""
    jst = j_init_state(jcfg, fifo_depth, max_credits)
    tst = init_state(tcfg, fifo_depth, max_credits, device="cpu")
    jst, jdone = j_simulate(jcfg, jprog, jst, mid)
    tst, tdone = simulate(tcfg, tprog, tst, mid, cycles_per_call)
    np.testing.assert_array_equal(tdone[0].numpy(), np.asarray(jdone))
    assert_lane_equal(tst, jst, what="mid-flight")
    assert not bool(drained(tst, tprog)[0]), "not mid-flight: already drained"

    jst, jsteps, jtrace = j_drain(jcfg, jprog, jst, MAX, 1)
    tst, tsteps, ttrace = run_until_drained_traced(
        tcfg, tprog, tst, MAX, check_every, cycles_per_call)
    steps = int(jsteps)
    assert int(tsteps[0]) == steps
    np.testing.assert_array_equal(ttrace[0, :steps].numpy(),
                                  np.asarray(jtrace)[:steps])
    assert bool(drained(tst, tprog)[0])
    if check_every == 1:
        assert_lane_equal(tst, jst, what="drained")
    return tst, jst


GRID = [(p, nx, ny) for p in sorted(PATTERNS) for nx, ny in MESHES
        if not (p == "transpose" and nx != ny)]


@pytest.mark.parametrize("pattern,nx,ny", GRID)
def test_mesh_grid_midflight_and_drain(pattern, nx, ny):
    jcfg, tcfg = _cfgs(nx, ny)
    j, t = _programs(pattern, nx, ny, rate=0.7, seed=3)
    _run_both(jcfg, tcfg, j_load_program(j), load_program(t, "cpu"))


@pytest.mark.parametrize("topo,pattern,nx,ny", [
    ("torus", "uniform", 4, 4), ("torus", "tornado", 3, 5),
    ("torus", "bit_complement", 4, 4), ("ring_mesh", "uniform", 3, 5),
    ("ring_mesh", "tornado", 4, 4), ("multi_chip:2:3", "uniform", 4, 4),
    ("multi_chip:2:3", "neighbor", 4, 3), ("multi_chip:3:2", "hotspot", 6, 2),
])
def test_topologies_midflight_and_drain(topo, pattern, nx, ny):
    jcfg, tcfg = _cfgs(nx, ny, topo)
    j, t = _programs(pattern, nx, ny, topo, rate=0.8, seed=5)
    _run_both(jcfg, tcfg, j_load_program(j), load_program(t, "cpu"))


@pytest.mark.parametrize("topo", ["mesh", "torus"])
def test_resp_latency_two(topo):
    jcfg, tcfg = _cfgs(4, 4, topo, resp_latency=2)
    j, t = _programs("uniform", 4, 4, topo, rate=0.9, seed=7)
    _run_both(jcfg, tcfg, j_load_program(j), load_program(t, "cpu"))


@pytest.mark.parametrize("topo,depth,credits", [("mesh", 2, 3),
                                                ("ring_mesh", 2, 5),
                                                ("mesh", 1, 1)])
def test_effective_depth_and_credits_below_capacity(topo, depth, credits):
    jcfg, tcfg = _cfgs(4, 4, topo, router_fifo=4, max_out_credits=16)
    j, t = _programs("uniform", 4, 4, topo, rate=1.0, seed=2)
    _run_both(jcfg, tcfg, j_load_program(j), load_program(t, "cpu"),
              fifo_depth=depth, max_credits=credits)


def test_lanes_with_different_depths_and_credits():
    """Four lanes of one state (different programs, depths, credits),
    each equal to its own JAX run, mid-flight and at drain; a lane that
    drains early stops at its own fence block."""
    jcfg, tcfg = _cfgs(3, 5, "torus", router_fifo=6, max_out_credits=12)
    depths, credits = [6, 2, 4, 3], [12, 3, 7, 1]
    pairs = [_programs("uniform", 3, 5, "torus", rate=r, seed=s,
                       length=8 + 2 * s)
             for s, r in enumerate((0.9, 0.3, 0.6, 1.0))]
    L = max(t["op"].shape[-1] for _, t in pairs)

    def pad(e):
        out = {k: np.zeros(v.shape[:2] + (L,), v.dtype) for k, v in e.items()}
        out["op"][:] = -1
        for k, v in e.items():
            out[k][..., :v.shape[-1]] = v
        return out

    tprog = stack_programs([load_program(pad(t), "cpu") for _, t in pairs])
    tst = init_state(tcfg, depths, credits, device="cpu")
    assert tst.cycle.shape == (4,)
    K = 4
    tst, tdone = simulate(tcfg, tprog, tst, MID, 3)
    tmid = state_to_numpy(tst)
    tst, tdcyc = run_until_drained(tcfg, tprog, tst, MAX, K, 3)
    tend = state_to_numpy(tst)
    for b, (j, _) in enumerate(pairs):
        jprog = j_load_program(pad(j))
        jst = j_init_state(jcfg, depths[b], credits[b])
        jst, jdone = j_simulate(jcfg, jprog, jst, MID)
        np.testing.assert_array_equal(tdone[b].numpy(), np.asarray(jdone))
        for name, a, c in zip(STATE_LEAVES, tmid, _jleaves(jst)):
            np.testing.assert_array_equal(a[b], c, err_msg=f"lane {b} {name}")
        jst, jdcyc = j_run_until_drained(jcfg, jprog, jst, MAX, K)
        assert int(tdcyc[b]) == int(jdcyc), f"lane {b} drain cycle"
        for name, a, c in zip(STATE_LEAVES, tend, _jleaves(jst)):
            np.testing.assert_array_equal(a[b], c,
                                          err_msg=f"lane {b} drained {name}")


@pytest.mark.parametrize("check_every", [1, 4, 7])
@pytest.mark.parametrize("cycles_per_call", [1, 3, None])
def test_exact_drain_cycle(check_every, cycles_per_call):
    """The drain cycle is exact for every fence cadence and launch size
    (the state may overshoot by < check_every cycles, nothing else)."""
    jcfg, tcfg = _cfgs(4, 4)
    j, t = _programs("hotspot", 4, 4, rate=0.5, seed=11)
    tst, jst = _run_both(jcfg, tcfg, j_load_program(j),
                         load_program(t, "cpu"), check_every=check_every,
                         cycles_per_call=cycles_per_call)
    over = int(tst.cycle[0]) - int(jst.cycle)
    assert 0 <= over < check_every
    a, b = state_to_numpy(tst), _jleaves(jst)
    for k, name in enumerate(STATE_LEAVES):
        if name != "cycle":
            np.testing.assert_array_equal(a[k][0], b[k], err_msg=name)


def test_state_and_program_carry_across():
    """A JAX state (one lane, or a vmapped batch) converts to the port and
    back unchanged; booleans stay booleans."""
    jcfg, tcfg = _cfgs(3, 5, resp_latency=3)
    j, _ = _programs("uniform", 3, 5, rate=0.8, seed=4)
    jprog = j_load_program(j)
    jst, _ = j_simulate(jcfg, jprog, j_init_state(jcfg), MID)
    tst = state_from_jax(_jleaves(jst), device="cpu")
    assert_lane_equal(tst, jst)
    assert tst.resp_valid.dtype == torch.bool
    batch = [np.stack([x, x]) for x in _jleaves(jst)]
    tb = state_from_jax(batch, device="cpu")
    assert tb.cycle.shape == (2,)
    assert_lane_equal(tb, jst, lane=1)
    tp = program_from_jax([np.asarray(x) for x in jprog], device="cpu")
    np.testing.assert_array_equal(tp.buf[0].numpy(), np.asarray(jprog.buf))
    np.testing.assert_array_equal(tp.length[0].numpy(),
                                  np.asarray(jprog.length))
    with pytest.raises(ValueError, match="leaves"):
        state_from_jax(_jleaves(jst)[:-1], device="cpu")


def test_config_and_state_validation():
    with pytest.raises(ValueError, match="router_fifo >= 2"):
        SimConfig(nx=4, ny=4, router_fifo=1, topology=Topology.torus())
    with pytest.raises(ValueError, match="mesh dimensions"):
        SimConfig(nx=200, ny=4)
    cfg = SimConfig(nx=2, ny=2)
    with pytest.raises(ValueError, match="fifo_depth"):
        init_state(cfg, fifo_depth=5, device="cpu")
    with pytest.raises(ValueError, match="one value per lane"):
        init_state(cfg, fifo_depth=[1, 2], lanes=3, device="cpu")


@pytest.mark.parametrize("per_lane", [list, np.asarray, torch.tensor])
def test_init_state_infers_lanes_from_per_lane_values(per_lane):
    """One value a lane as a list, an array or a tensor: the lane count
    is its length, each lane holds its own value."""
    cfg = SimConfig(nx=2, ny=2, max_out_credits=64)
    st = init_state(cfg, max_credits=per_lane([1, 2, 4]),
                    fifo_depth=per_lane([2, 1, 2]), device="cpu")
    assert st.cycle.shape == (3,)
    assert st.max_credits.tolist() == [1, 2, 4]
    assert st.fifo_depth.tolist() == [2, 1, 2]
    assert st.credits[:, 0, 0].tolist() == [1, 2, 4]
    with pytest.raises(ValueError, match="cycles_per_call"):
        simulate(cfg, load_program(make_traffic("uniform", 2, 2, 2), "cpu"),
                 init_state(cfg, device="cpu"), 3, 0)
