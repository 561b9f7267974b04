"""The nine ``examples/torch_*.py`` on the CPU (``--device cpu``), each at
a small size and held to its reference example where that costs no more
than one small JAX compile:

* ``torch_mesh_endpoints``: drain cycle, ``Telemetry``, the DMA's and the
  chaser's statistics and the memory bit-identical to the reference
  example's ``build(cfg, "numpy")`` at 4x4;
* ``torch_netsim_traffic``: at 4x4 and 200 cycles each pattern's
  throughput, and the credit sweep's 7 lanes (8 hops, 400 cycles), equal
  to the reference example's own runs (its JAX backend, one compile;
  the numpy oracle, run once per credit, is many times slower);
* ``torch_load_latency``: the written record field for field against the
  reference's ``curve_record(load_latency_sweep(...))`` at 4x4, one
  pattern, two rates, 50/100/100 (integers exact, float32 fields within
  1 ulp: ROADMAP C-2);
* ``torch_dse_sweep``: 2 depths x 2 credits x 2 loads on the mesh; the
  artifact's frontier points equal the reference's;
* the five rank examples in one spawn of 8 gloo ranks: ``pgas`` (the
  memory image equal to ``repro.workloads.expected_memory``, one CAS
  winner), ``pipeline_parallel`` (the pipelined loss within 1e-5 of the
  reference's sequential ``loss_ref`` in JAX, the 10 SGD losses within
  1e-4 relative of ``jax.grad`` SGD on it), ``serve_decode`` (10
  requests, tokens identical to the port's one-process ``Server`` on the
  same weights), ``quickstart`` and ``train_lm`` at a few steps (their own
  assertions; ``train_lm``'s two faults and its re-shard in
  ``trainer.events``), no rank loading JAX or ``repro``;
* without a card and without ``--device cpu`` every example raises.

The spawn runs in a thread while this process runs the simulator
examples and the references.
"""
import importlib.util
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
if str(EXAMPLES) not in sys.path:
    # appended, so nothing else is shadowed; spawned ranks inherit it
    sys.path.append(str(EXAMPLES))

import torch_dse_sweep  # noqa: E402
import torch_load_latency  # noqa: E402
import torch_mesh_endpoints  # noqa: E402
import torch_netsim_traffic  # noqa: E402
import torch_pgas_scatter_gather  # noqa: E402
import torch_pipeline_parallel  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_decode  # noqa: E402
import torch_spmd_ranks as ranks  # noqa: E402
import torch_train_lm  # noqa: E402
import repro.mesh as J  # noqa: E402
from repro.dse import SweepSpec as JSweepSpec  # noqa: E402
from repro.dse import frontier_artifact as j_frontier_artifact  # noqa: E402
from repro.dse import run_sweep as j_run_sweep  # noqa: E402
from repro.netsim_jax import curve_record as j_curve_record  # noqa: E402
from repro.netsim_jax import init_state as j_init_state  # noqa: E402
from repro.netsim_jax import load_program as j_load_program  # noqa: E402
from repro.netsim_jax import simulate as j_simulate  # noqa: E402
from repro.netsim_jax import load_latency_sweep as j_sweep  # noqa: E402
from repro.netsim_jax import sweep_config as j_sweep_config  # noqa: E402
from repro.workloads import expected_memory as j_expected_memory  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.mesh import Telemetry  # noqa: E402

NX = NY = 4
TRAFFIC_CYCLES = 200
LL = dict(pattern="uniform", rates=(0.1, 0.5), warmup=50, measure=100,
          drain=100)
DSE = dict(fifo_depths=(2, 4), credits=(4, 16), loads=(0.1, 0.4))
QUICK_STEPS, QUICK_DECODE = 2, 2
TRAIN_LM = dict(steps=16, seq_len=32, batch=8, layers=2, vocab=128)


def _load_reference(name):
    """The reference example ``examples/<name>.py`` as a module of its
    own name (``ref_<name>``), so it never shadows the port's."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_pipeline():
    """The reference example's sequential ``loss_ref`` on the example's
    draws, and 10 SGD steps of ``jax.grad`` on it: (loss, losses)."""
    w1, w2, x, y = (jnp.asarray(a) for a in torch_pipeline_parallel.draw())

    def body(lp, h):
        def blk(h, w):
            return h + jnp.tanh(h @ w[0]) @ w[1], None
        return jax.lax.scan(blk, h, lp)[0]

    def loss_ref(ws, xb):
        out = jax.vmap(lambda m: body(ws, m))(xb)
        return jnp.mean((out - y) ** 2)

    p = (w1, w2)
    loss0 = float(jax.jit(loss_ref)(p, x))
    grad = jax.jit(jax.grad(loss_ref))
    losses = []
    for _ in range(torch_pipeline_parallel.STEPS):
        g = grad(p, x)
        p = jax.tree.map(lambda a, b: a - torch_pipeline_parallel.LR * b,
                         p, g)
        losses.append(float(jax.jit(loss_ref)(p, x)))
    return loss0, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    plan = {"quickstart": dict(ckpt_dir=str(tmp / "quickstart"),
                               steps=QUICK_STEPS, ckpt_every=1,
                               decode_steps=QUICK_DECODE),
            "train_lm": dict(TRAIN_LM, ckpt_dir=str(tmp / "train_lm"))}
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)         # leave the cores to the 8 ranks
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.examples, 8, "gloo",
                                args=(plan,))
        out["endpoints"] = torch_mesh_endpoints.main(
            ["--nx", str(NX), "--ny", str(NY), "--device", "cpu"])
        out["patterns"] = torch_netsim_traffic.pattern_sweep(
            NX, NY, TRAFFIC_CYCLES, device="cpu")
        out["credits"] = torch_netsim_traffic.credit_sweep(device="cpu")
        ll_out = tmp / "torch_load_latency.json"
        torch_load_latency.main(
            ["--nx", str(NX), "--ny", str(NY), "--patterns", LL["pattern"],
             "--rates", *map(str, LL["rates"]), "--warmup",
             str(LL["warmup"]), "--measure", str(LL["measure"]), "--drain",
             str(LL["drain"]), "--out", str(ll_out), "--device", "cpu"])
        out["load_latency"] = json.loads(ll_out.read_text())
        out["dse"] = torch_dse_sweep.main(
            ["--fifo-depths", *map(str, DSE["fifo_depths"]), "--credits",
             *map(str, DSE["credits"]), "--loads", *map(str, DSE["loads"]),
             "--topologies", "mesh", "--cache", str(tmp / "dse_cache"),
             "--out", str(tmp / "dse.json"), "--device", "cpu"])
        out["ref pipeline"] = _reference_pipeline()
        out["ref patterns"] = _ref_patterns()
        out["ref credits"] = _ref_credits(out["credits"][0])
        out["ref load_latency"] = _ref_load_latency()
        out["ref dse"] = _ref_dse()
        out["ranks"] = ranks_run.result()
    torch.set_num_threads(threads)
    return out


# ----------------------------------------------------------------------
# the simulator examples
# ----------------------------------------------------------------------
def test_mesh_endpoints_matches_the_reference_example(runs):
    ref = _load_reference("mesh_endpoints")
    sim = ref.build(J.MeshConfig(nx=NX, ny=NY, mem_words=32), "numpy")
    cycle = sim.run_until_drained()
    got = runs["endpoints"]
    assert got["cycle"] == cycle
    Telemetry.of(sim).assert_bit_identical(got["telemetry"])
    np.testing.assert_array_equal(got["mem"], np.asarray(sim.mem))
    dma = sim.endpoints[(0, 0)]
    assert got["dma"] == (dma.sent, dma.acked, dma.peak_inflight)
    mc = sim.endpoints[(0, NY - 1)]
    assert got["chaser"] == (list(mc.visited), list(mc.latencies))
    prog = sim.injection_trace_program()
    assert got["packets"] == int((prog["op"] >= 0).sum())


def _ref_patterns():
    """Each pattern through the reference example's own backend (the JAX
    simulator, one compile for every pattern), which
    ``tests/test_netsim_jax.py`` holds cycle-exact to the numpy oracle."""
    cfg = J.MeshConfig(nx=NX, ny=NY, max_out_credits=32)
    want = {}
    for name in sorted(J.PATTERNS):
        entries = J.make_traffic(name, NX, NY, TRAFFIC_CYCLES, seed=0)
        sim = J.Simulator(cfg, backend="jax").attach(entries)
        sim.run(TRAFFIC_CYCLES)
        want[name] = sim.telemetry().throughput(warmup=TRAFFIC_CYCLES // 3)
    return want


def _ref_credits(credits, hops=8, cycles=400):
    """The reference example's ``vmapped_credit_sweep`` (``jax.vmap`` of
    ``init_state`` and ``simulate``): per-cycle completions averaged after
    the first quarter, one value a credit allowance."""
    cfg = J.MeshConfig(nx=hops + 1, ny=1, max_out_credits=64,
                       router_fifo=32).to_sim()
    prog = j_load_program(torch_netsim_traffic.credit_program(hops, cycles))
    states = jax.vmap(lambda c: j_init_state(cfg, max_credits=c))(
        jnp.asarray(credits))
    _, per = jax.vmap(lambda s: j_simulate(cfg, prog, s, cycles))(states)
    return [float(row[cycles // 4:].mean()) for row in np.asarray(per)]


def _ref_load_latency():
    """The reference example's record of the same sweep."""
    out = j_sweep(LL["pattern"], NX, NY, list(LL["rates"]),
                  warmup=LL["warmup"], measure=LL["measure"],
                  drain=LL["drain"], cfg=j_sweep_config(NX, NY), seed=0)
    return {"name": "load_latency_curves", "mesh": f"{NX}x{NY}",
            "curves": {LL["pattern"]: json.loads(json.dumps(
                j_curve_record(out), default=str))}}


def _ref_dse():
    spec = JSweepSpec(nx=NX, ny=NY, fifo_depths=DSE["fifo_depths"],
                      credits=DSE["credits"], patterns=("uniform",),
                      loads=DSE["loads"], topologies=("mesh",),
                      warmup=100, measure=200, drain=200, name="example")
    return j_frontier_artifact(j_run_sweep(spec, cache_dir=None))


def test_netsim_traffic_patterns_match_the_reference_example(runs):
    assert runs["patterns"] == runs["ref patterns"]
    assert len(runs["patterns"]) == len(J.PATTERNS)   # 4x4: none skipped


def test_netsim_traffic_credit_sweep_matches_the_reference_example(runs):
    """The port's one lane-batched run of 7 credit allowances against the
    reference example's vmapped sweep."""
    credits, thr = runs["credits"]
    assert credits == [1, 2, 4, 8, 16, 2 * 8 + 5, 32]
    assert thr == runs["ref credits"]
    assert thr[-1] > thr[0]


def test_load_latency_record_matches_the_reference(runs):
    got, want = runs["load_latency"], runs["ref load_latency"]
    assert got.keys() == want.keys()
    assert (got["name"], got["mesh"]) == (want["name"], want["mesh"])
    g, w = got["curves"][LL["pattern"]], want["curves"][LL["pattern"]]
    assert g.keys() == w.keys()
    for key, a in w.items():
        floats = isinstance(a, float) or (
            isinstance(a, list) and a and isinstance(a[0], float))
        if floats:
            np.testing.assert_array_max_ulp(np.float32(g[key]),
                                            np.float32(a), maxulp=1)
        else:
            assert g[key] == a, key


def test_dse_frontier_matches_the_reference(runs):
    got, want = runs["dse"], runs["ref dse"]
    assert got["frontiers"].keys() == want["frontiers"].keys() == {"mesh"}
    g, w = got["frontiers"]["mesh"], want["frontiers"]["mesh"]
    assert len(g["points"]) == 4
    assert json.loads(json.dumps(g["frontier"], default=str)) == \
        json.loads(json.dumps(w["frontier"], default=str))
    assert g["monotone"] == w["monotone"]


# ----------------------------------------------------------------------
# the rank examples (one spawn of 8 gloo ranks)
# ----------------------------------------------------------------------
def _per_rank(runs, example):
    return [r[example] for r in runs["ranks"]]


def test_ranks_of_the_examples_import_nothing_of_jax_or_repro(runs):
    assert all(r["modules"] == [] for r in runs["ranks"])


def test_pgas_memory_matches_the_reference_image(runs):
    res = torch_pgas_scatter_gather.report(_per_rank(runs, "pgas"))
    T, W = torch_pgas_scatter_gather.T, torch_pgas_scatter_gather.WORDS
    addr, data, mask = torch_pgas_scatter_gather.scatter_batches()
    want = j_expected_memory(addr, data, mask, torch_pgas_scatter_gather.NX,
                             torch_pgas_scatter_gather.NY,
                             mem_words=W).reshape(T, W)
    np.testing.assert_array_equal(res["scatter_mem"].astype(np.int64), want)
    assert res["winners"] == 1


def test_pipeline_loss_matches_the_reference_loss_ref(runs):
    res = torch_pipeline_parallel.report(_per_rank(runs, "pipeline"))
    want, _ = runs["ref pipeline"]
    assert abs(res["l_pipe"] - want) < 1e-5
    assert abs(res["l_ref"] - want) < 1e-5


def test_pipeline_sgd_matches_jax_grad_sgd(runs):
    losses = _per_rank(runs, "pipeline")[0][2]
    _, want = runs["ref pipeline"]
    assert len(losses) == len(want) == 10
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_serve_decode_matches_one_process_server(runs):
    res = torch_serve_decode.report(_per_rank(runs, "serve"))
    cfg = torch_serve_decode.default_config()
    server = Server(cfg, slots=torch_serve_decode.SLOTS,
                    max_seq=torch_serve_decode.MAX_SEQ, device="cpu")
    ticks, done = torch_serve_decode.serve(server, cfg)
    assert len(done) == torch_serve_decode.REQUESTS == 10
    assert res["tokens"] == [d[2] for d in done]
    assert res["ticks"] == ticks


def test_quickstart_trains_and_decodes(runs):
    got = _per_rank(runs, "quickstart")
    res = torch_quickstart.report(got)
    assert len(res["decoded"]) == QUICK_DECODE
    assert all(math.isfinite(v) for v in res["metrics"].values())
    assert got[0][0] > 0                      # the parameter count


def test_train_lm_learns_through_faults_and_reshard(runs):
    got = _per_rank(runs, "train_lm")
    res = torch_train_lm.report(got)
    steps = TRAIN_LM["steps"]
    assert len(res["losses"]) == steps
    kinds = [e["kind"] for e in res["events"]]
    assert kinds == ["step_failure", "step_failure", "reshard"]
    failed = [e["step"] for e in res["events"] if e["kind"] ==
              "step_failure"]
    assert failed == [torch_train_lm.at_fraction(steps, s)
                      for s in torch_train_lm.REF_FAULTS]
    reshard = res["events"][-1]
    assert (reshard["step"], reshard["from_chips"], reshard["to_chips"]) \
        == (steps // 2, 8, 4)
    # ranks 4-7 left the mesh at the re-shard and trained no further
    assert all(len(r[0]) == steps // 2 for r in got[4:])
    assert all(r[0] == res["losses"] for r in got[1:4])


# ----------------------------------------------------------------------
# no card: every example raises unless given --device cpu
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,argv", [
    ("torch_netsim_traffic", ["--nx", "4", "--ny", "4", "--cycles", "8"]),
    ("torch_load_latency", ["--nx", "4", "--ny", "4"]),
    ("torch_mesh_endpoints", ["--nx", "2", "--ny", "2"]),
    ("torch_dse_sweep", []),
    ("torch_pgas_scatter_gather", []),
    ("torch_pipeline_parallel", []),
    ("torch_quickstart", []),
    ("torch_serve_decode", []),
    ("torch_train_lm", []),
])
def test_example_raises_without_a_card(name, argv, tmp_path):
    extra = {"torch_load_latency": ["--out", str(tmp_path / "ll.json")],
             "torch_dse_sweep": ["--cache", str(tmp_path / "cache"),
                                 "--out", str(tmp_path / "dse.json")],
             "torch_train_lm": ["--ckpt-dir", str(tmp_path / "ck")]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sys.modules[name].main(argv + extra.get(name, []))
    assert not list(tmp_path.iterdir())      # nothing written
