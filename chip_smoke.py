"""Chip smoke test of the PyTorch/CUDA port: drive the port's main path on
one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):

1. print the card (``nvidia-smi`` name and power limit), build every CUDA
   source of ``src/repro_torch/kernels/csrc`` and print the build time;
2. kernel against plain: the router-step kernel and its plain PyTorch
   version on the paper's 512-core array (16x32, sweep widths), one batch
   of lanes per topology plus one with ``resp_latency=3``, 300 cycles of
   uniform traffic in launches of 8 cycles; every state leaf and every
   per-cycle ``done`` / ``drained`` value must be identical;
3. the main path at full width: the 12-rate load–latency sweep on 16x32
   (12 lanes x 1000 cycles, one kernel call per phase), with the kernel's
   launch count read around it; then the sweep's own inputs (programs,
   phase windows, calls) through the kernel and the plain version side by
   side, every leaf and column identical and the plain version's
   statistics equal to the sweep's; and a 4x4 sweep on the card against
   the same sweep on the CPU;
4. the reference's recorded knees: 16x16 uniform, 300/500/500 phases,
   seed 0 — saturation at 0.25 on the mesh and 0.40 on the torus;
5. the facade: 16x32 tornado, 512 entries per tile, run until drained;
6. times: the kernel per mesh cycle at 12 lanes x 16x32 with CUDA events,
   in calls of 400 cycles (as the sweep's measure and drain phases) and
   of 1 cycle (as a drain with ``check_every=1``), the plain version the
   same way, and the kernels' device time from the profiler; then the
   ``kernels`` JSON line and the ``ok`` line.

It needs a card: without one it prints the reason to stderr and exits 1.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SWEEP_PHASES = (200, 400, 400)  # load_latency_sweep's warmup, measure, drain
H100_BYTES_PER_S = 3.35e12     # HBM3, SXM data sheet
H100_OPS_PER_S = 67e12         # non-tensor 32-bit rate (fp32 figure), an upper bound for int32
INT_OPS_PER_TILE_CYCLE = 500   # integer operations per tile and lane, counted from the source


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def build_kernels():
    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    paths = build.build(names)
    secs = time.perf_counter() - t0
    print(f"[build] {names} built with nvcc in {secs:.1f} s")
    for name, path in paths.items():
        for line in open(str(path) + ".log"):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return secs


def kernel_vs_plain(device, nx=16, ny=32, cycles=300, cycles_per_call=8):
    """Kernel and plain version side by side, every leaf and column;
    returns the largest absolute difference seen (0 when identical)."""
    import torch
    from repro_torch.kernels.router_step import (router_step_call,
                                                 router_step_plain)
    from repro_torch.mesh import Topology, make_traffic
    from repro_torch.netsim.measure import sweep_config
    from repro_torch.netsim.sim import (STATE_LEAVES, flatten_state,
                                        init_state, launch_sizes,
                                        load_program, stack_programs)
    lanes = ((16, 128, 0.15), (4, 8, 0.4), (2, 3, 0.9))
    worst = 0
    for spec, lat in (("mesh", 1), ("torus", 1), ("ring_mesh", 1),
                      ("multi_chip:2:4", 1), ("mesh", 3)):
        topo = Topology.parse(spec)
        cfg = sweep_config(nx, ny, topo).replace(resp_latency=lat).to_sim()
        length = int(max(r for _, _, r in lanes) * cycles) + 1
        prog = stack_programs([
            load_program(make_traffic("uniform", nx, ny, length, rate=r,
                                      seed=i, topology=topo), device)
            for i, (_, _, r) in enumerate(lanes)])
        depths = [d for d, _, _ in lanes]
        credits = [c for _, c, _ in lanes]
        ks = init_state(cfg, depths, credits, device=device)
        ps = init_state(cfg, depths, credits, device=device)
        sizes = launch_sizes(cycles, cycles_per_call)
        check(sizes[-1] != cycles_per_call, "no remainder launch")
        cols = []
        for c in sizes:
            ks, kd, kr = router_step_call(cfg, prog, ks, c)
            ps, pd, pr = router_step_plain(cfg, prog, ps, c)
            cols.append((kd, pd, kr, pr))
        for kd, pd, kr, pr in cols:
            worst = max(worst, int((kd - pd).abs().max()),
                        int((kr - pr).abs().max()))
        bad = []
        for name, a, b in zip(STATE_LEAVES, flatten_state(ks),
                              flatten_state(ps)):
            d = int((a.long() - b.long()).abs().max())
            worst = max(worst, d)
            if d:
                bad.append(name)
        done = int(ks.completed.sum())
        print(f"[kernel-vs-plain] {spec} resp_latency={lat} lanes={len(lanes)} "
              f"{nx}x{ny} {cycles} cycles: completions {done}, "
              f"mismatched leaves {bad}")
        check(not bad and worst == 0,
              f"kernel differs from plain on {spec}: {bad}")
        check(done > 0, f"nothing completed on {spec}")
    return worst


def main_path(device, nx=16, ny=32):
    """The load–latency sweep at full width with the kernel's launch
    count read around it; returns (record, wall seconds, launches, the
    launches its cycles call for)."""
    from repro_torch.kernels.router_step import router_step_call
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            load_latency_sweep,
                                            stack_rate_programs, sweep_config)
    from repro_torch.netsim.sim import launch_sizes
    router_step_call.launches = 0
    t0 = time.perf_counter()
    out = load_latency_sweep("uniform", nx, ny, DEFAULT_SWEEP_RATES,
                             cfg=sweep_config(nx, ny), device=device)
    wall = time.perf_counter() - t0
    launches = router_step_call.launches
    want = sum(len(launch_sizes(c, None)) for c in SWEEP_PHASES)
    t0 = time.perf_counter()            # the sweep's set-up on its own
    stack_rate_programs("uniform", nx, ny, DEFAULT_SWEEP_RATES,
                        sum(SWEEP_PHASES), device=device)
    setup = time.perf_counter() - t0
    print(f"[main path] uniform {nx}x{ny}, 12 lanes x 1000 cycles: knee at "
          f"rate {out['saturation_rate']} (index {out['saturation_index']}), "
          f"zero-load latency {out['zero_load_latency']:.4f} cycles, "
          f"wall {wall:.3f} s (building and copying its programs alone: "
          f"{setup:.3f} s), router_step launches {launches} "
          f"(expected {want})")
    import numpy as np
    for k in ("offered", "accepted", "lat_mean", "lat_p99"):
        check(out[k].shape == (12,) and bool(np.isfinite(out[k]).all()),
              f"{k} not 12 finite values")
    check(out["saturation_index"] is not None, "the sweep never saturated")
    check(bool(out["monotone"]), "the load-latency curve is not monotone")
    weight = (np.arange(out["hist"].shape[1]) * out["hist"].astype(np.int64)) \
        .sum(1).max()
    print(f"[main path] largest latency sum of a lane {weight} "
          f"({'above' if weight > 2 ** 24 else 'below'} 2**24, where a "
          f"float32 sum stops being exact)")
    return out, wall, launches, want


def sweep_against_plain(device, out, nx=16, ny=32):
    """The main path's own inputs through the kernel and the plain
    version: the sweep's programs and phase windows, one call per phase as
    the sweep makes them.  Every state leaf and per-cycle ``done`` /
    ``drained`` column must be identical after each phase, and the plain
    version's statistics must equal the sweep's ``out``.  Returns the
    largest absolute difference seen (0 when identical)."""
    import numpy as np
    from repro_torch.kernels.router_step import (router_step_call,
                                                 router_step_plain)
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            reduce_window_stats, sweep_config,
                                            stack_rate_programs)
    from repro_torch.netsim.sim import (STATE_LEAVES, flatten_state,
                                        init_state)
    cfg = sweep_config(nx, ny).to_sim()
    warmup, measure, drain = SWEEP_PHASES
    rates = sorted(DEFAULT_SWEEP_RATES)
    prog = stack_rate_programs("uniform", nx, ny, rates, sum(SWEEP_PHASES),
                               topology=cfg.topology, device=device)
    B = len(rates)

    def fresh():
        st = init_state(cfg, lanes=B, device=device)
        return st._replace(measure_start=st.cycle + warmup,
                           measure_stop=st.cycle + (warmup + measure))

    def snapshot(s):
        return (s.prog_ptr.sum((1, 2)).int(), s.completed.sum((1, 2)).int(),
                s.link_util.clone())

    ks, ps = fresh(), fresh()
    worst = 0
    snaps = []
    for phase, n in zip(("warmup", "measure", "drain"), SWEEP_PHASES):
        ks, kd, kr = router_step_call(cfg, prog, ks, n)
        ps, pd, pr = router_step_plain(cfg, prog, ps, n)
        worst = max(worst, int((kd - pd).abs().max()),
                    int((kr - pr).abs().max()))
        bad = []
        for name, a, b in zip(STATE_LEAVES, flatten_state(ks),
                              flatten_state(ps)):
            d = int((a.long() - b.long()).abs().max())
            worst = max(worst, d)
            if d:
                bad.append(name)
        check(not bad and worst == 0,
              f"16x32 sweep, {phase}: kernel differs from plain on {bad}")
        snaps.append(snapshot(ps))
    (inj0, comp0, util0), (inj1, comp1, util1) = snaps[0], snaps[1]
    stats = reduce_window_stats(nx * ny, measure, ps.lat_hist.clone(),
                                inj1 - inj0, comp1 - comp0, util1 - util0)
    for k, v in stats._asdict().items():
        check(np.array_equal(v.cpu().numpy(), out[k]),
              f"16x32 sweep: plain {k} differs from the sweep's")
    print(f"[main path] the sweep's inputs through kernel and plain "
          f"({B} lanes x {nx}x{ny}, phases {SWEEP_PHASES}, one call per "
          f"phase): every leaf and column identical, the plain version's "
          f"statistics equal the sweep's (max_abs_err {worst})")
    return worst


def small_sweep_against_cpu(device):
    """A 4x4 sweep on ``device`` equals the same sweep on the CPU."""
    import numpy as np
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            load_latency_sweep)
    kw = dict(warmup=50, measure=100, drain=100, seed=1)
    a = load_latency_sweep("uniform", 4, 4, DEFAULT_SWEEP_RATES,
                           device=device, **kw)
    b = load_latency_sweep("uniform", 4, 4, DEFAULT_SWEEP_RATES,
                           device="cpu", **kw)
    check(np.array_equal(a["hist"], b["hist"]), "4x4 histograms differ")
    for k in ("offered", "accepted", "lat_mean", "hops"):
        check(np.array_equal(a[k], b[k]), f"4x4 {k} differs")
    print(f"[main path] 4x4 sweep on {device} equals the CPU's "
          f"(knee index {a['saturation_index']})")


def recorded_knees(device, nx=16, ny=16):
    """Uniform knees on the mesh and the torus (the reference recorded
    0.25 and 0.40 on 16x16)."""
    from repro_torch.mesh import Topology
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            load_latency_sweep, sweep_config)
    knees = {}
    for kind, want in (("mesh", 0.25), ("torus", 0.40)):
        topo = Topology.parse(kind)
        out = load_latency_sweep("uniform", nx, ny, DEFAULT_SWEEP_RATES,
                                 warmup=300, measure=500, drain=500,
                                 cfg=sweep_config(nx, ny, topo), seed=0,
                                 device=device)
        knees[kind] = out["saturation_rate"]
        print(f"[knees] {kind} {nx}x{ny}: saturation rate "
              f"{out['saturation_rate']} (reference {want}), monotone "
              f"{out['monotone']}")
    return knees


def facade(device, nx=16, ny=32, length=512):
    from repro_torch.mesh import MeshConfig, Simulator, make_traffic
    prog = make_traffic("tornado", nx, ny, length, rate=0.8, seed=0)
    t0 = time.perf_counter()
    sim = Simulator(MeshConfig(nx=nx, ny=ny, max_out_credits=32),
                    device=device).attach(prog)
    cyc = sim.run_until_drained()
    wall = time.perf_counter() - t0
    entries = int((prog["op"] >= 0).sum())
    done = int(sim.completed.sum())
    t = sim.telemetry()
    print(f"[facade] tornado {nx}x{ny}, {entries} entries: drained at cycle "
          f"{cyc}, {done} completions, wall {wall:.3f} s, mean latency "
          f"{t.mean_latency():.4f}")
    check(done == entries, f"completed {done} != program entries {entries}")
    check(int(t.lat_hist.sum()) == entries, "histogram misses packets")
    return cyc


def timings(device, nx=16, ny=32, kernel_cycles=800, plain_cycles=20):
    """Kernel and plain version per mesh cycle at 12 lanes (CUDA events,
    warmed up), plus the profiler's device time per kernel."""
    import torch
    from repro_torch.kernels.router_step import (cycle_bytes,
                                                 router_step_call,
                                                 router_step_plain)
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES, sweep_config,
                                            stack_rate_programs)
    from repro_torch.netsim.sim import init_state
    cfg = sweep_config(nx, ny).to_sim()
    B = len(DEFAULT_SWEEP_RATES)
    # programs long enough that no lane runs dry in the ~1550 cycles below
    prog = stack_rate_programs("uniform", nx, ny, DEFAULT_SWEEP_RATES, 2000,
                               seed=0, device=device)

    def timed(fn, st, cycles, per_call):
        fn(cfg, prog, st, per_call)                    # warm up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(cycles // per_call):
            st, _, _ = fn(cfg, prog, st, per_call)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / cycles, st

    st = init_state(cfg, lanes=B, device=device)
    st, _, _ = router_step_call(cfg, prog, st, 200)    # into steady state
    ms_kernel, st = timed(router_step_call, st, kernel_cycles, 400)
    ms_kernel_c1, st = timed(router_step_call, st, 100, 1)
    ms_plain, _ = timed(router_step_plain, init_state(cfg, lanes=B,
                                                      device=device),
                        plain_cycles, plain_cycles)
    nbytes = cycle_bytes(cfg, B)
    ops = INT_OPS_PER_TILE_CYCLE * B * nx * ny
    bound_ms = max(nbytes / H100_BYTES_PER_S, ops / H100_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / H100_BYTES_PER_S >= ops / H100_OPS_PER_S \
        else "operations"

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, _, _ = router_step_call(cfg, prog, st, 50)
        torch.cuda.synchronize()
    dev_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if ("arbitrate" in ev.key or "advance" in ev.key) and us:
            dev_us["arbitrate" if "arbitrate" in ev.key else "advance"] = \
                us / 50
    card = card_line()
    print(f"[times] {card}: router_step kernel {ms_kernel * 1e3:.3f} us per "
          f"mesh cycle in calls of 400 cycles, {ms_kernel_c1 * 1e3:.3f} us "
          f"in calls of 1 cycle; plain PyTorch version "
          f"{ms_plain * 1e3:.1f} us per cycle; 12 lanes x {nx}x{ny}")
    print(f"[times] {card}: bound {bound_ms * 1e3:.3f} us per cycle "
          f"({nbytes} B at 3.35 TB/s; {ops} int ops), bound by {bound_by}; "
          f"device time per cycle from the profiler: "
          + (", ".join(f"{k} {v:.3f} us" for k, v in sorted(dev_us.items()))
             or "not measured"))
    return ms_kernel, ms_plain, bound_ms, bound_by, dev_us


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs an "
              "NVIDIA H100", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print(f"[card] {card_line()}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    build_kernels()
    worst = kernel_vs_plain("cuda")
    out, _, launches, want = main_path("cuda")
    check(launches == want, f"router_step launches {launches} != {want}")
    worst = max(worst, sweep_against_plain("cuda", out))
    small_sweep_against_cpu("cuda")
    knees = recorded_knees("cuda")
    check(knees == {"mesh": 0.25, "torus": 0.40},
          f"16x16 knees {knees} != mesh 0.25, torus 0.40")
    facade("cuda")
    ms, plain_ms, bound_ms, bound_by, _ = timings("cuda")
    print(json.dumps({"kernels": [{
        "name": "router_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/router_step.cu",
        "replaces": "src/repro/kernels/router_step.py:114",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "checked_against_plain": True}]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
