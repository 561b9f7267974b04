"""The port's facade (``repro_torch.mesh.Simulator``) against the JAX
package's (``repro.mesh.Simulator(backend="jax")``) on the CPU, the
carry-across of a JAX run stopped mid-flight, and the port's import
hygiene (it must import nothing of JAX and nothing of ``repro``)."""
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.mesh import MeshConfig as JMeshConfig
from repro.mesh import Simulator as JSimulator
from repro.mesh import Topology as JTopology
from repro.mesh import make_traffic as j_make_traffic
from repro.netsim_jax import init_state as j_init_state
from repro.netsim_jax import load_program as j_load_program
from repro.netsim_jax import simulate as j_simulate
from repro_torch.core.netsim import OP_CAS, OP_LOAD
from repro_torch.mesh import (DmaEndpoint, MeshConfig, Simulator, Topology,
                               make_traffic)
from repro_torch.netsim import (program_from_jax, simulate, state_from_jax,
                                state_to_numpy)
from repro_torch.netsim.sim import STATE_LEAVES


def _mixed_program(nx, ny, seed):
    """Loads, stores and CAS with some addresses beyond mem_words (the
    memory index clamps; the response carries the unclamped address)."""
    e = make_traffic("uniform", nx, ny, 10, rate=0.6, seed=seed)
    rng = np.random.default_rng(seed)
    e["op"] = rng.choice([OP_LOAD, 1, OP_CAS], e["op"].shape)
    e["addr"] = rng.integers(-3, 70, e["addr"].shape)
    e["cmp"] = rng.integers(0, 3, e["cmp"].shape)
    return e


@pytest.mark.parametrize("topo,check_every,cycles_per_call", [
    ("mesh", 1, 1), ("torus", 5, 3)])
def test_facade_telemetry_bit_identical(topo, check_every, cycles_per_call):
    """Same program, memory image and measurement window on both facades:
    telemetry, memory and credits identical after ``run`` and after
    ``run_until_drained`` (same drain cycle)."""
    e = _mixed_program(4, 3, seed=1)
    mem = np.random.default_rng(2).integers(0, 3, (3, 4, 64))
    j = JSimulator(JMeshConfig(nx=4, ny=3, topology=JTopology.parse(topo)),
                   backend="jax", check_every=check_every)
    t = Simulator(MeshConfig(nx=4, ny=3, topology=Topology.parse(topo)),
                  check_every=check_every, cycles_per_call=cycles_per_call,
                  device="cpu")
    for sim in (j, t):
        sim.attach({k: v.copy() for k, v in e.items()})
        sim.set_mem(mem)
        sim.set_measure_window(3, 12)
    j.run(11)
    t.run(11)
    t.telemetry().assert_bit_identical(j.telemetry())
    np.testing.assert_array_equal(t.mem, j.mem)
    assert j.run_until_drained() == t.run_until_drained()
    t.telemetry().assert_bit_identical(j.telemetry())
    np.testing.assert_array_equal(t.mem, j.mem)
    np.testing.assert_array_equal(t.credits, j.credits)
    np.testing.assert_array_equal(t.out_of_credit_cycles,
                                  j.out_of_credit_cycles)
    assert t.mean_latency() == j.mean_latency()
    assert t.throughput(3) == j.throughput(3)


def test_carry_across_a_jax_run_stopped_mid_flight():
    """A JAX run stopped mid-flight continues on the port: converted with
    ``state_from_jax`` and run on both for more cycles, every leaf agrees
    at the end."""
    jcfg = JMeshConfig(nx=4, ny=4, resp_latency=2,
                       topology=JTopology.ring_mesh()).to_sim()
    tcfg = MeshConfig(nx=4, ny=4, resp_latency=2,
                      topology=Topology.ring_mesh()).to_sim()
    jprog = j_load_program(j_make_traffic("tornado", 4, 4, 16, rate=0.8,
                                          topology=JTopology.ring_mesh()))
    jst, _ = j_simulate(jcfg, jprog, j_init_state(jcfg, 3, 6), 12)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    tst = state_from_jax(leaves, device="cpu")
    tprog = program_from_jax([np.asarray(x) for x in jprog], device="cpu")
    jst, jdone = j_simulate(jcfg, jprog, jst, 25)
    tst, tdone = simulate(tcfg, tprog, tst, 25, 4)
    np.testing.assert_array_equal(tdone[0].numpy(), np.asarray(jdone))
    for name, a, b in zip(STATE_LEAVES, state_to_numpy(tst),
                          jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(a[0], np.asarray(b), err_msg=name)


def test_facade_rejects_endpoints_and_bad_input():
    """Endpoints attach by the reference's rules (a tile, inside the mesh,
    one master, not after a run on the torch backend), and bad input
    raises."""
    sim = Simulator(MeshConfig(nx=4, ny=4), device="cpu")
    ep = DmaEndpoint(dst_x=1, dst_y=0, data=range(4))
    with pytest.raises(ValueError, match="needs its tile"):
        sim.attach(ep)
    with pytest.raises(ValueError, match="outside the"):
        sim.attach(ep, at=(4, 0))
    sim.attach(ep, at=(0, 0))
    with pytest.raises(ValueError, match="one master"):
        sim.attach(DmaEndpoint(dst_x=1, dst_y=0, data=[1]), at=(0, 0))
    ran = Simulator(MeshConfig(nx=4, ny=4), device="cpu")
    ran.run(3)
    with pytest.raises(ValueError, match="already run"):
        ran.attach(DmaEndpoint(dst_x=1, dst_y=0, data=[1]), at=(0, 0))
    with pytest.raises(TypeError):
        sim.attach([1, 2])
    with pytest.raises(ValueError, match="dst_x"):
        bad = make_traffic("uniform", 4, 4, 2)
        bad["dst_x"][0, 0, 0] = 9
        sim.attach(bad)
    with pytest.raises(ValueError, match="memory image"):
        sim.set_mem(np.zeros((4, 4, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(MeshConfig(nx=2, ny=2))      # no card here: never the CPU


def test_port_imports_nothing_of_jax_or_repro():
    """A fresh interpreter imports the port and all its submodules (the
    workload library, the DSE, the simulation service, the training path,
    the SPMD mechanisms, sharding rules and mesh launcher, and the mesh
    training path (the collectives' backward, ZeRO-1 banking, sharded
    checkpoints, the mesh ``Trainer``) among them); no ``jax*``, no
    ``ml_dtypes`` and no ``repro`` / ``repro.*`` module may be loaded.
    (A spawned rank's modules are checked in
    ``tests/test_torch_spmd_models.py`` and, for the training ranks,
    ``tests/test_torch_spmd_{grad,trainer}.py``.)"""
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'repro' or n.startswith('repro.')\n"
        "             or n == 'ml_dtypes' or n.startswith('ml_dtypes.'))\n"
        "for m in ('kernels.router_step', 'kernels.flash_attention',\n"
        "          'kernels.ssd_scan', 'kernels.moe_gmm', 'models.jamba',\n"
        "          'workloads.placement', 'workloads.base',\n"
        "          'workloads.collectives', 'workloads.pipeline',\n"
        "          'workloads.moe', 'workloads.pgas', 'workloads.runner',\n"
        "          'workloads.congestion', 'dse.pareto', 'dse.cost',\n"
        "          'dse.cache', 'dse.spec', 'dse.runner', 'sim_service',\n"
        "          'sim_service.request', 'sim_service.bucketing',\n"
        "          'sim_service.metrics', 'sim_service.streaming',\n"
        "          'sim_service.server', 'optim.adamw', 'data.pipeline',\n"
        "          'checkpoint.store', 'runtime.trainer', 'launch.step',\n"
        "          'launch.train', 'kernels.ops', 'core.coords',\n"
        "          'core.routing', 'core.credits', 'core.pgas',\n"
        "          'core.token_queue', 'core.endpoint', 'core.sync',\n"
        "          'parallel.comm', 'parallel.sharding', 'launch.mesh',\n"
        "          'launch.serve', 'models.transformer', 'models.moe',\n"
        "          'models.base', 'models.convert', 'optim', 'checkpoint',\n"
        "          'runtime', 'parallel'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 84
