"""Chip smoke test of the PyTorch/CUDA port: drive the port's main path on
one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):

1. print the card (``nvidia-smi`` name and power limit), build every CUDA
   source of ``src/repro_torch/kernels/csrc`` and print the build time;
2. kernel against plain: both variants of the router-step kernel
   (``direct`` on the state's own leaves, ``packed`` on its tile-innermost
   working copies) and its plain PyTorch version on the paper's 512-core
   array (16x32, sweep widths), one batch of lanes per topology plus one
   with ``resp_latency=3``, 300 cycles of uniform traffic in launches of
   8 cycles; every state leaf and every per-cycle ``done`` / ``drained``
   value must be identical;
3. the main path at full width: the 12-rate load–latency sweep on 16x32
   (12 lanes x 1000 cycles, one kernel call per phase), with the kernel's
   launch count (each of the variant ``router_variant`` chooses for its
   call length) read around it; then the sweep's own inputs (programs,
   phase windows, calls) through the kernel and the plain version side by
   side, every leaf and column identical and the plain version's
   statistics equal to the sweep's; and a 4x4 sweep on the card against
   the same sweep on the CPU;
4. the reference's recorded knees: 16x16 uniform, 300/500/500 phases,
   seed 0 — saturation at 0.25 on the mesh and 0.40 on the torus;
5. the facade: 16x32 tornado, 512 entries per tile, run until drained
   (one call a cycle);
6. times: the kernel per mesh cycle at 12 lanes x 16x32 with CUDA events,
   in calls of 400 cycles (as the sweep's measure and drain phases) and
   of 1 cycle (as a drain with ``check_every=1``); the cut-over between
   the variants (both in turns at calls of 1 to 400 cycles, the pack
   included, from 1 to 12 lanes of 16x32, at 12 lanes of 16x16, and at
   1 lane of 16x16 and 4x4, where the card is nearly empty); the pack and
   unpack of the working layout; the plain version; each kernel's device
   time from the profiler; and the facade drain's wall time from phase 5;
7. the model kernels against their plain versions (flash attention, SSD
   scan, grouped matmul) at the shapes of the full-width Jamba prefill's
   first call and at the decode GMM's, in fp32 and in bf16; each bf16
   main-path shape must go through its tensor-core variant (flash
   ``wgmma_tma``, SSD ``tensor_core``, GMM ``tma`` in prefill and
   ``decode`` in decode), fp32 SSD through ``cuda_core``;
8. the reduced Jamba (fp32) on the card through the kernels against the
   CPU through the plain versions, and teacher-forced ``decode_step``
   against ``forward`` on the card;
9. the main path of the model stack at full width: Jamba v0.1's widths
   with one period of 8 layers (13.27 B parameters, bf16, drawn on the
   card), a 1 x 4096-token prefill through ``prefill_step`` (1 flash,
   7 SSD and 12 GMM launches: the SSD's all ``tensor_core``, the GMM's
   all ``tma``), then the
   continuous-batching ``Server`` on the same weights (8 requests of 16
   prompt tokens, 16 new tokens each, 4 slots; 12 ``decode``-variant GMM
   launches per tick), each with the launch counts set to 0 just before it
   and read just after; no ``ragged`` GMM launch in either;
10. where the time goes: the profiler over a warm prefill and over 10
   server ticks (device time by kernel category, the device's idle share);
   times of the model kernels at those shapes, the GMM at its prefill
   gate/up, prefill down and decode shapes (kernel, plain version, library
   call, bound), the SSD beside the models' own chunked PyTorch
   (``models/mamba2.py::ssd_chunked``, a yardstick, not a library call);
   each kernel's registers, spills and shared memory; then
   the ``kernels`` JSON line (one entry per kernel variant on the main
   paths) and the ``ok`` line.

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
ROUTER_KERNELS = ("arbitrate_kernel", "advance_kernel", "pack_kernel")


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
            if any(w in line for w in ("entry function", "Used ", "spill",
                                       "Performance Loss", "C7518")):
                print(f"[build] {name}: {line.strip()}")
    # the router's instructions per thread: what bounds a cycle when the
    # card is nearly empty (cuobjdump from the toolkit that built it)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(paths["router_step"])],
                              capture_output=True, text=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = next((k for k in ROUTER_KERNELS if k in line), None)
                if fn and "ILb" in line:         # the template's PACKED
                    fn += " packed" if "ILb1E" in line else " direct"
            elif fn and "/*" in line and ";" in line:
                counts[fn] = counts.get(fn, 0) + 1
        print(f"[build] router_step SASS instructions per kernel: {counts}")


def kernel_vs_plain(device, nx=16, ny=32, cycles=300, cycles_per_call=8):
    """Kernel and plain version side by side, every leaf and column;
    returns the largest absolute difference seen (0 when identical)."""
    from repro_torch.kernels.router_step import (VARIANTS, _launch,
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
        ks = {v: init_state(cfg, depths, credits, device=device)
              for v in VARIANTS}
        ps = init_state(cfg, depths, credits, device=device)
        sizes = launch_sizes(cycles, cycles_per_call)
        check(sizes[-1] != cycles_per_call, "no remainder launch")
        cols = []
        for c in sizes:
            ps, pd, pr = router_step_plain(cfg, prog, ps, c)
            for v in VARIANTS:
                ks[v], kd, kr = _launch(cfg, prog, ks[v], c, v)
                cols.append((kd, pd, kr, pr))
        for kd, pd, kr, pr in cols:
            worst = max(worst, int((kd - pd).abs().max()),
                        int((kr - pr).abs().max()))
        for v in VARIANTS:
            bad = []
            for name, a, b in zip(STATE_LEAVES, flatten_state(ks[v]),
                                  flatten_state(ps)):
                d = int((a.long() - b.long()).abs().max())
                worst = max(worst, d)
                if d:
                    bad.append(name)
            done = int(ks[v].completed.sum())
            print(f"[kernel-vs-plain] {spec} resp_latency={lat} "
                  f"lanes={len(lanes)} {nx}x{ny} {cycles} cycles, {v}: "
                  f"completions {done}, mismatched leaves {bad}")
            check(not bad and worst == 0,
                  f"kernel ({v}) differs from plain on {spec}: {bad}")
            check(done > 0, f"nothing completed on {spec}")
    return worst


def main_path(device, nx=16, ny=32):
    """The load–latency sweep at full width with the kernel's launch
    count read around it; returns (record, wall seconds, launches, the
    launches its cycles call for, launches by variant)."""
    from repro_torch.kernels.router_step import (router_step_call,
                                                 router_variant)
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            load_latency_sweep,
                                            stack_rate_programs, sweep_config)
    from repro_torch.netsim.sim import launch_sizes
    router_step_call.launches = 0
    router_step_call.launches_by_variant = dict.fromkeys(
        router_step_call.launches_by_variant, 0)
    t0 = time.perf_counter()
    out = load_latency_sweep("uniform", nx, ny, DEFAULT_SWEEP_RATES,
                             cfg=sweep_config(nx, ny), device=device)
    wall = time.perf_counter() - t0
    launches = router_step_call.launches
    by_variant = dict(router_step_call.launches_by_variant)
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
          f"(expected {want}) by variant {by_variant}")
    calls = [c for n in SWEEP_PHASES for c in launch_sizes(n, None)]
    cfg = sweep_config(nx, ny).to_sim()
    check(by_variant == {v: sum(router_variant(cfg, 12, c) == v
                                for c in calls) for v in by_variant},
          f"the sweep's launches {by_variant} are not of the variants "
          f"router_variant chooses for calls of {calls}")
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
    return out, wall, launches, want, by_variant


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
    """The facade's drain, one kernel call a cycle, with the router's
    launch counts set to 0 just before it and read just after; returns
    (drain cycle, wall seconds, launches)."""
    from repro_torch.kernels.router_step import router_step_call
    from repro_torch.mesh import MeshConfig, Simulator, make_traffic
    prog = make_traffic("tornado", nx, ny, length, rate=0.8, seed=0)
    router_step_call.launches = 0
    router_step_call.launches_by_variant = dict.fromkeys(
        router_step_call.launches_by_variant, 0)
    t0 = time.perf_counter()
    sim = Simulator(MeshConfig(nx=nx, ny=ny, max_out_credits=32),
                    device=device).attach(prog)
    cyc = sim.run_until_drained()
    wall = time.perf_counter() - t0
    entries = int((prog["op"] >= 0).sum())
    done = int(sim.completed.sum())
    launches = router_step_call.launches
    by_variant = dict(router_step_call.launches_by_variant)
    t = sim.telemetry()
    print(f"[facade] tornado {nx}x{ny}, {entries} entries: drained at cycle "
          f"{cyc}, {done} completions, wall {wall:.3f} s, mean latency "
          f"{t.mean_latency():.4f}; router_step launches {launches} by "
          f"variant {by_variant}")
    check(done == entries, f"completed {done} != program entries {entries}")
    check(int(t.lat_hist.sum()) == entries, "histogram misses packets")
    check(launches > 0 and by_variant["direct"] == launches,
          f"the drain's 1-cycle calls made {by_variant} launches, not all "
          f"direct")
    return cyc, wall, launches


def timings(device, facade_wall, nx=16, ny=32, plain_cycles=20):
    """The router kernel per mesh cycle (CUDA events, warmed up), every
    run of a configuration from the same state 200 cycles into its sweep
    traffic: the main path's variant in calls of 400 cycles (as the
    sweep's measure and drain phases) and the wrapper in calls of 1 cycle
    (as a drain with ``check_every=1``) at 12 lanes x 16x32; the cut-over
    between the variants (both, in turns, in calls of 1 to 400 cycles, the
    pack included, from 1 to 12 lanes of 16x32, at 12 lanes of 16x16 and
    at 1 lane of 16x16 and 4x4); the pack and unpack; the plain version;
    each kernel's device time from the profiler; and the facade drain's
    wall time (phase 5)."""
    import torch
    from repro_torch.kernels import router_step as rs
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES, sweep_config,
                                            stack_rate_programs)
    from repro_torch.netsim.sim import (flatten_state, init_state,
                                        unflatten_state)
    card = card_line()

    def warm_state(n, rates):
        cfg = sweep_config(n[0], n[1]).to_sim()
        # programs long enough that no lane runs dry in any run below
        prog = stack_rate_programs("uniform", n[0], n[1], rates, 4000,
                                   seed=0, device=device)
        st = init_state(cfg, lanes=len(rates), device=device)
        st, _, _ = rs.router_step_call(cfg, prog, st, 200)
        warm = [t.clone() for t in flatten_state(st)]
        return cfg, prog, lambda: unflatten_state([t.clone() for t in warm])

    def per_cycle(fn, cfg, prog, fresh, C, cycles):
        st = fresh()
        st, _, _ = fn(cfg, prog, st, C)                # warm up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        calls = max(cycles // C, 1)
        t0.record()
        for _ in range(calls):
            st, _, _ = fn(cfg, prog, st, C)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / (calls * C)

    def of(v):
        return lambda c, p, s, n: rs._launch(c, p, s, n, v)

    B = len(DEFAULT_SWEEP_RATES)
    cfg, prog, fresh = warm_state((nx, ny), DEFAULT_SWEEP_RATES)
    variant = rs.router_variant(cfg, B, 400)
    ms_kernel = per_cycle(rs.router_step_call, cfg, prog, fresh, 400, 800)
    ms_kernel_c1 = per_cycle(rs.router_step_call, cfg, prog, fresh, 1, 100)
    # the cut-over: both variants in turns at each call length, from 1 lane
    # to the sweep's 12 lanes of 16x32, the knees' 12 lanes of 16x16, and
    # 1 lane of 16x16 and 4x4 (the card nearly empty)
    cut = {}
    for lanes, n in ((1, (nx, ny)), (2, (nx, ny)), (4, (nx, ny)),
                     (8, (nx, ny)), (B, (nx, ny)), (B, (16, 16)),
                     (1, (16, 16)), (1, (4, 4))):
        if (lanes, n) == (B, (nx, ny)):
            cfg_l, prog_l, fresh_l = cfg, prog, fresh
        else:
            rates = DEFAULT_SWEEP_RATES if lanes == B else \
                DEFAULT_SWEEP_RATES[3:3 + lanes]
            cfg_l, prog_l, fresh_l = warm_state(n, rates)
        if (lanes, n) == (1, (nx, ny)):   # the facade's shape
            cfg1, prog1, fresh1 = cfg_l, prog_l, fresh_l
        for C in (1, 16, 64, 128, 256, 400):
            ab = {v: [] for v in rs.VARIANTS}
            for v in rs.VARIANTS + rs.VARIANTS[::-1]:
                ab[v].append(per_cycle(of(v), cfg_l, prog_l, fresh_l, C,
                                       100 if C == 1 else max(2 * C, 400)))
            cut[lanes, n, C] = ab
            print(f"[router cut-over] {card}: {lanes} lane(s) x "
                  f"{n[0]}x{n[1]} ({lanes * n[0] * n[1]} lanes x tiles), "
                  f"calls of {C}: " + ", ".join(
                      f"{v} " + " / ".join(f"{ms * 1e3:.3f}" for ms in runs)
                      for v, runs in ab.items())
                  + f" us per cycle; router_variant chooses "
                  f"{rs.router_variant(cfg_l, lanes, C)}")
    ms_plain = per_cycle(rs.router_step_plain, cfg, prog, fresh,
                         plain_cycles, plain_cycles)
    ms_plain1 = per_cycle(rs.router_step_plain, cfg1, prog1, fresh1, 1,
                          plain_cycles)
    st = fresh()
    packed = rs.pack_state(st)
    pack = rs._pack_call(rs._library(), st, packed)
    sid = torch.cuda.current_stream().cuda_stream
    ms_pack = _event_ms(lambda: pack(False, sid), 20)
    ms_unpack = _event_ms(lambda: pack(True, sid), 20)
    bounds = {lanes: _bound(rs.cycle_bytes(cfg, lanes),
                            INT_OPS_PER_TILE_CYCLE * lanes * nx * ny,
                            H100_OPS_PER_S) for lanes in (B, 1)}

    from torch.profiler import ProfilerActivity, profile
    dev_us = {}
    for v in rs.VARIANTS:
        st = fresh()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st, _, _ = rs._launch(cfg, prog, st, 100, v)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            name = next((k for k in ROUTER_KERNELS if k in ev.key), None)
            if name and us:
                dev_us[f"{v} {name}"] = us / 100
    print(f"[times] {card}: router_step kernel ({variant}) "
          f"{ms_kernel * 1e3:.3f} us per mesh cycle in calls of 400 cycles; "
          f"through the wrapper in calls of 1 cycle "
          f"({rs.router_variant(cfg, B, 1)}) {ms_kernel_c1 * 1e3:.3f} us; "
          f"plain PyTorch version {ms_plain * 1e3:.1f} us per cycle; "
          f"12 lanes x {nx}x{ny}")
    print(f"[times] {card}: pack {ms_pack * 1e3:.1f} us, unpack "
          f"{ms_unpack * 1e3:.1f} us a call (12 lanes x {nx}x{ny}); facade "
          f"tornado drain (phase 5, one call a cycle, "
          f"{rs.router_variant(cfg1, 1, 1)}) wall {facade_wall:.3f} s")
    print(f"[times] {card}: bound {bounds[B][0] * 1e3:.3f} us per cycle "
          f"at 12 lanes ({rs.cycle_bytes(cfg, B)} B at 3.35 TB/s), "
          f"{bounds[1][0] * 1e3:.3f} us at 1 lane, by {bounds[B][1]}; "
          f"1 lane through the plain version {ms_plain1 * 1e3:.1f} us per "
          f"cycle; device time per cycle from the profiler (calls of 100): "
          + (", ".join(f"{k} {v:.3f} us" for k, v in sorted(dev_us.items()))
             or "not measured"))
    # one entry per variant, each at its own path's shape: packed at the
    # sweep's (12 lanes, calls of 400), direct at the facade's (1 lane,
    # calls of 1)
    return {variant: dict(ms=ms_kernel, plain_ms=ms_plain, bound=bounds[B]),
            "direct": dict(ms=cut[1, (nx, ny), 1]["direct"][0],
                           plain_ms=ms_plain1, bound=bounds[1])}


# ----------------------------------------------------------------------
# the model stack: Jamba served through the flash, SSD and GMM kernels
# ----------------------------------------------------------------------
JAMBA = "jamba-v0.1-52b"
PREFILL_TOKENS = 4096          # batch 1 x 4096 tokens
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core rate, SXM data sheet
MODEL_KERNELS = ("flash_attention", "ssd_scan", "moe_gmm")


def _wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan,
            "moe_gmm": gmm.grouped_matmul}


def zero_counts():
    for w in _wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_by_variant"):
            w.launches_by_variant = dict.fromkeys(w.launches_by_variant, 0)


def read_counts():
    return {k: w.launches for k, w in _wrappers().items()}


def read_variants():
    """{kernel: {variant: launches}} of the kernels that have variants."""
    return {k: dict(w.launches_by_variant) for k, w in _wrappers().items()
            if hasattr(w, "launches_by_variant")}


def _variant_of(wrapper, fn):
    """Run ``fn`` and return the one variant of ``wrapper`` it launched."""
    before = dict(wrapper.launches_by_variant)
    out = fn()
    moved = [k for k, v in wrapper.launches_by_variant.items()
             if v != before[k]]
    check(len(moved) == 1, f"expected one launch of one variant, got {moved}")
    return out, moved[0]


def _bound(nbytes, ops, ops_per_s):
    tb, to = nbytes / H100_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def _compare(name, note, got, want):
    """Kernel against plain on the same inputs.  fp32: 1e-4 absolute plus
    1e-4 relative (the sums run in another order).  bf16: one bf16 ulp of
    the plain result (both sides compute in fp32 from the same bf16 inputs
    and round once) plus 1e-3 of the result's RMS (fp32 sums in another
    order, near zero, can straddle a rounding boundary).  Returns
    max_abs_err."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        tol, why = 1e-4 + 1e-4 * w.abs(), "1e-4 abs + 1e-4 rel"
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(2.0 ** -126))) - 7)
        tol = ulp + 1e-3 * float(w.square().mean().sqrt())
        why = "1 bf16 ulp + 1e-3 RMS"
    worst = float(err.max())
    ok = bool((err <= tol).all()) and bool(torch.isfinite(g).all())
    print(f"[model kernels] {name} {note} {str(got.dtype)[6:]}: "
          f"max_abs_err {worst:.3e} (tolerance {why}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {note} {got.dtype}: kernel differs from plain")
    return worst


def _model_inputs(device, dtype, seed=0):
    """Each kernel's inputs at the shapes of the full-width prefill's
    first call (batch 1 x 4096 tokens of Jamba v0.1), and the decode GMM's
    (4 slots).  The SSD's A is the model's initial -linspace(1, 16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    cfg = get_config(JAMBA)
    g = torch.Generator(device).manual_seed(seed)
    S, H, K, hd = PREFILL_TOKENS, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = cfg.ssm
    nh, G = s.num_heads(cfg.d_model), s.num_groups
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device)
                * scale).to(dtype)

    flash = dict(q=rnd(1, H, S, hd), k=rnd(1, K, S, hd), v=rnd(1, K, S, hd))
    ssd = dict(x=rnd(1, nh, S, s.head_dim, scale=0.5),
               dt=(F.softplus(torch.randn(1, nh, S, generator=g,
                                          device=device)) * 0.1).to(dtype),
               B=rnd(1, G, S, s.state_dim, scale=0.5),
               C=rnd(1, G, S, s.state_dim, scale=0.5),
               A=-torch.linspace(1.0, 16.0, nh, device=device))
    gmm = {}
    for name, m, k, n in (("prefill gate/up", capacity(S, cfg.moe), D, Fe),
                          ("prefill down", capacity(S, cfg.moe), Fe, D),
                          ("decode gate/up", capacity(4, cfg.moe), D, Fe),
                          ("decode down", capacity(4, cfg.moe), Fe, D)):
        gmm[name] = (rnd(E, m, k), rnd(E, k, n, scale=k ** -0.5))
    return flash, ssd, gmm, s.chunk


def model_kernels_vs_plain(device):
    """Each new kernel against its plain version at the main path's
    shapes, in fp32 and in bf16.  Returns {kernel: bf16 max_abs_err}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    worst = {}
    want_gmm = {"prefill gate/up": "tma", "prefill down": "tma",
                "decode gate/up": "decode", "decode down": "decode"}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        flash, ssd, gmm, chunk = _model_inputs(device, dtype)
        out, var = _variant_of(fa.flash_attention, lambda: fa.flash_attention(
            **flash, causal=True))
        check(var == ("wgmma_tma" if bf16 else "f32"),
              f"flash_attention ran the {var} variant")
        err = _compare("flash_attention", f"(1,32,4096,128) causal, 8 KV "
                       f"heads [{var}]", out,
                       ref.flash_attention_ref(**flash, causal=True))
        del out
        y, var = _variant_of(ssd_mod.ssd_scan, lambda: ssd_mod.ssd_scan(
            **ssd, chunk=chunk))
        check(var == ("tensor_core" if bf16 else "cuda_core"),
              f"ssd_scan ran the {var} variant")
        err_s = _compare("ssd_scan", f"(1,128,4096,64) N=16 chunk {chunk} "
                         f"[{var}]", y, ref.ssd_scan_ref(**ssd))
        del y
        err_g = {"tma": 0.0, "decode": 0.0}
        for name, (lhs, rhs) in gmm.items():
            out, var = _variant_of(gmm_mod.grouped_matmul,
                                   lambda: gmm_mod.grouped_matmul(lhs, rhs))
            check(var == (want_gmm[name] if bf16 else "f32"),
                  f"moe_gmm {name} ran the {var} variant")
            e = _compare("moe_gmm", f"{name} {tuple(lhs.shape)}@"
                         f"{tuple(rhs.shape)} [{var}]", out,
                         ref.grouped_matmul_ref(lhs, rhs))
            err_g[want_gmm[name]] = max(err_g[want_gmm[name]], e)
            del out
        if bf16:
            # the ragged variant (WMMA) on the prefill's operands: an lhs
            # one element off 16-byte alignment, which TMA cannot take
            lhs, rhs = gmm["prefill gate/up"]
            buf = torch.empty(lhs.numel() + 1, dtype=dtype, device=device)
            off = buf[1:].view(lhs.shape).copy_(lhs)
            out, var = _variant_of(gmm_mod.grouped_matmul,
                                   lambda: gmm_mod.grouped_matmul(off, rhs))
            check(var == "ragged", f"moe_gmm misaligned lhs ran the {var} "
                  "variant")
            _compare("moe_gmm", f"prefill gate/up, lhs 1 element off "
                     f"alignment {tuple(lhs.shape)}@{tuple(rhs.shape)} "
                     f"[{var}]", out, ref.grouped_matmul_ref(lhs, rhs))
            del out, off, buf
        worst = {"flash_attention": err, "ssd_scan": err_s,
                 "moe_gmm": err_g["tma"], "moe_gmm_decode": err_g["decode"]}
        del flash, ssd, gmm
        torch.cuda.empty_cache()
    return worst


def reduced_end_to_end(device, seq=40):
    """The reduced Jamba (fp32, 2 periods of 2 layers, capacity factor 8 so
    no token drops) on the card through the kernels against the CPU
    through the plain versions; then teacher-forced ``decode_step`` on the
    card against ``forward`` on the card (2e-4, the tolerance of
    tests/test_models.py).  Returns the largest logit difference."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_params
    cfg = reduced_config(get_config(JAMBA))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    Model = get_model(cfg)
    card = Model(cfg, device, params={k: v.to(device)
                                      for k, v in cpu_params.items()})
    cpu = Model(cfg, "cpu", params=cpu_params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, seq)))
    zero_counts()
    on_card, _ = card(tokens.to(device))
    torch.cuda.synchronize()
    counts = read_counts()
    on_cpu, _ = cpu(tokens)
    err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"[reduced] Jamba {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"fp32, 2 x {seq} tokens: card (kernels, launches {counts}) vs CPU "
          f"(plain versions) max logit difference {err:.3e} (tolerance 2e-4)")
    check(all(counts[k] > 0 for k in MODEL_KERNELS),
          f"the reduced forward missed a kernel: {counts}")
    check(err <= 2e-4, f"reduced Jamba: card and CPU logits differ by {err}")
    cache = card.init_cache(2, seq)
    steps = []
    for i in range(seq):
        lg, cache = card.decode_step(cache, tokens[:, i].to(device))
        steps.append(lg)
    derr = float((torch.stack(steps, 1) - on_card).abs().max())
    print(f"[reduced] teacher-forced decode_step vs forward on the card: max "
          f"logit difference {derr:.3e} (tolerance 2e-4)")
    check(derr <= 2e-4, f"reduced Jamba: decode differs from forward by "
          f"{derr}")
    return max(err, derr)


def full_width_prefill(device):
    """The main path at full width: Jamba v0.1's widths, one period of 8
    layers, bf16 weights from ``init_params`` on the card, batch 1 x 4096
    tokens through ``prefill_step``.  Returns (cfg, params, record)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.step import prefill_step
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_params
    cfg = dataclasses.replace(get_config(JAMBA), num_layers=8)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    model = get_model(cfg)(cfg, device, params=params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS))).to(device)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits = prefill_step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    variants = read_variants()
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"prefill logits {tuple(logits.shape)} not finite of (1, V)")
    t0 = time.perf_counter()
    again = prefill_step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(torch.equal(again, logits), "two prefills of the same tokens differ")
    print(f"[prefill] Jamba widths, 8 layers ({cfg.param_count() / 1e9:.2f} B "
          f"parameters, {nbytes / 2**30:.2f} GiB bf16, drawn in {init_s:.1f} "
          f"s): 1 x {PREFILL_TOKENS} tokens, wall {wall:.3f} s "
          f"({PREFILL_TOKENS / wall:.0f} tokens/s); again {warm:.3f} s "
          f"({PREFILL_TOKENS / warm:.0f} tokens/s); launches {counts} "
          f"by variant {variants}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check(counts == {"flash_attention": 1, "ssd_scan": 7, "moe_gmm": 12},
          f"prefill launches {counts} != 1 flash, 7 SSD, 12 GMM")
    check(variants["flash_attention"]["wgmma_tma"] == 1
          and variants["moe_gmm"]["tma"] == 12
          and variants["moe_gmm"]["ragged"] == 0
          and variants["ssd_scan"]["tensor_core"] == 7,
          f"prefill variants {variants} != 1 wgmma_tma flash, 12 tma GMM, "
          "7 tensor_core SSD")
    del model, logits, again
    return cfg, params, {"wall": wall, "warm": warm, "counts": counts,
                         "variants": variants}


def full_width_server(device, cfg, params, requests=8, prompt=16,
                      max_new=16, slots=4, max_seq=64):
    """The continuous-batching ``Server`` at full width on the prefill's
    weights: every request completes, every tick's 12 expert FFN products
    go through the GMM kernel."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Request, Server
    server = Server(cfg, slots=slots, max_seq=max_seq, device=device,
                    params=params)
    rng = np.random.default_rng(1)
    for r in range(requests):
        server.submit(Request(rid=r, max_new=max_new, prompt=rng.integers(
            0, cfg.vocab_size, size=prompt).astype(np.int32)))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    ticks = server.run(tick_limit=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    variants = read_variants()
    done = sorted(server.completed, key=lambda r: r.rid)
    toks = sum(len(r.out) for r in done)
    print(f"[server] {requests} requests x {prompt} prompt tokens, max_new "
          f"{max_new}, {slots} slots, max_seq {max_seq}: {len(done)} "
          f"completed, {toks} tokens in {ticks} ticks, wall {wall:.3f} s "
          f"({toks / wall:.1f} generated tokens/s, "
          f"{wall / ticks * 1e3:.1f} ms per tick); launches {counts} "
          f"by variant {variants} (GMM per tick "
          f"{counts['moe_gmm'] / ticks:g})")
    check(len(done) == requests and all(len(r.out) == max_new for r in done),
          "not every request completed")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "a token outside the vocabulary")
    check(counts["moe_gmm"] == 12 * ticks,
          f"GMM launches {counts['moe_gmm']} != 12 per tick x {ticks}")
    check(variants["moe_gmm"]["decode"] == 12 * ticks
          and variants["moe_gmm"]["ragged"] == 0,
          f"server GMM variants {variants['moe_gmm']} != 12 decode per tick")
    return {"ticks": ticks, "wall": wall, "counts": counts,
            "variants": variants, "tokens": toks}


_CATEGORIES = (("flash kernel", ("flash_wgmma_kernel", "flash_fwd_kernel")),
               ("SSD kernel", ("ssd_state_", "ssd_pass_", "ssd_out_")),
               ("GMM kernel", ("gmm_tma_kernel", "gmm_decode_kernel",
                               "gmm_bf16_kernel", "gmm_f32_kernel")),
               ("cuBLAS matmuls", ("gemm", "cutlass", "xmma", "nvjet",
                                   "cublas")))


def _device_breakdown(prof, wall_s):
    """Device time of the profiled window by kernel category, and the
    device's busy share of the host wall time."""
    from torch.autograd import DeviceType
    cats = {name: 0.0 for name, _ in _CATEGORIES}
    cats["other kernels (elementwise, reductions, copies)"] = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        name = ev.name.lower()
        for cat, keys in _CATEGORIES:
            if any(k in name for k in keys):
                cats[cat] += us
                break
        else:
            cats["other kernels (elementwise, reductions, copies)"] += us
    busy = sum(cats.values()) / 1e6
    return cats, busy, 1.0 - busy / wall_s


def model_profile(device, cfg, params, ticks=10):
    """Where the time goes: ``torch.profiler`` over one warm full-width
    prefill and over ``ticks`` steady server ticks (4 slots generating),
    device time by kernel category and the device's idle share of the
    host wall time (the profiler's own cost is in the wall time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.step import prefill_step
    from repro_torch.models import get_model
    card = card_line()
    model = get_model(cfg)(cfg, device, params=params)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, PREFILL_TOKENS))).to(device)
    prefill_step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    server = Server(cfg, slots=4, max_seq=64, device=device, params=params)
    rng = np.random.default_rng(3)
    for r in range(4):
        server.submit(Request(rid=r, max_new=40, prompt=rng.integers(
            0, cfg.vocab_size, size=4).astype(np.int32)))
    for _ in range(6):                   # past the prompts: all generating
        server.tick()
    torch.cuda.synchronize()
    out = {}
    for what, fn, n in (("prefill 1 x 4096", lambda: prefill_step(
            model, {"tokens": tokens}), 1),
            (f"server, {ticks} ticks of 4 slots", server.tick, ticks)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cats, busy, idle = _device_breakdown(prof, wall)
        parts = ", ".join(f"{k} {v / 1e3 / n:.2f} ms"
                          for k, v in sorted(cats.items(),
                                             key=lambda kv: -kv[1]))
        print(f"[where the time goes] {card}: {what}: wall {wall / n * 1e3:.1f}"
              f" ms per {'step' if n == 1 else 'tick'} under the profiler, "
              f"device busy {busy / n * 1e3:.1f} ms (idle share {idle:.3f}); "
              f"{parts}")
        out[what] = dict(wall=wall / n, busy=busy / n, idle=idle,
                         cats={k: v / 1e3 / n for k, v in cats.items()})
    return out


def _event_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up
    (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def model_timings(device):
    """Kernel, plain version and library call at the main path's shapes
    (bf16), with CUDA events, beside each kernel's bound.  Returns
    {entry: record}: ``moe_gmm`` is the prefill gate/up shape,
    ``moe_gmm_down`` the prefill down shape (both the ``tma`` variant),
    ``moe_gmm_decode`` and ``moe_gmm_decode_down`` the decode shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.mamba2 import ssd_chunked
    card = card_line()
    flash, ssd, gmm, chunk = _model_inputs(device, torch.bfloat16, seed=1)
    out = {}
    q, k, v = flash["q"], flash["k"], flash["v"]
    nb, ops = fa.flash_bound(q, k, causal=True)
    out["flash_attention"] = dict(
        ms=_event_ms(lambda: fa.flash_attention(q, k, v, causal=True), 5),
        plain_ms=_event_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                           causal=True), 2),
        library_ms=_event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10),
        bound=_bound(nb, ops, BF16_OPS_PER_S), nbytes=nb, ops=ops,
        shape="q (1,32,4096,128), k/v (1,8,4096,128), causal")
    nb, ops = ssd_mod.ssd_bound(ssd["x"], ssd["B"], chunk)
    models_layout = [ssd[k].transpose(1, 2) for k in ("x", "dt", "B", "C")]
    out["ssd_scan"] = dict(
        ms=_event_ms(lambda: ssd_mod.ssd_scan(**ssd, chunk=chunk), 10),
        plain_ms=_event_ms(lambda: ref.ssd_scan_ref(**ssd), 1),
        library_ms=None, bound=_bound(nb, ops, BF16_OPS_PER_S), nbytes=nb,
        ops=ops, shape=f"x (1,128,4096,64), N=16, chunk {chunk}",
        yardstick_ms=_event_ms(lambda: ssd_chunked(
            *models_layout, ssd["A"], chunk=chunk), 3))
    for name, key in (("prefill gate/up", "moe_gmm"),
                      ("prefill down", "moe_gmm_down"),
                      ("decode gate/up", "moe_gmm_decode"),
                      ("decode down", "moe_gmm_decode_down")):
        lhs, rhs = gmm[name]
        nb, ops = gmm_mod.gmm_bound(lhs, rhs)
        out[key] = dict(
            ms=_event_ms(lambda: gmm_mod.grouped_matmul(lhs, rhs), 5),
            plain_ms=_event_ms(lambda: ref.grouped_matmul_ref(lhs, rhs), 3),
            library_ms=_event_ms(lambda: torch.bmm(lhs, rhs), 5),
            bound=_bound(nb, ops, BF16_OPS_PER_S), nbytes=nb, ops=ops,
            shape=f"{name} {tuple(lhs.shape)}@{tuple(rhs.shape)}")
    # the SSD's three passes, each kernel's device time (profiler, 5 calls)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ssd_mod.ssd_scan(**ssd, chunk=chunk)
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        name = next((k for k in ("ssd_state_", "ssd_pass_", "ssd_out_")
                     if k in ev.key), None)
        if name and us:
            passes[name.strip("_")] = us / 5
    print(f"[times] {card}: ssd_scan device time per call by pass: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in passes.items()))
    for key, r in out.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        yard = "" if "yardstick_ms" not in r else \
            (f"; yardstick (not a library call): the models' plain chunked "
             f"PyTorch (models/mamba2.py::ssd_chunked, cuBLAS) "
             f"{r['yardstick_ms']:.4f} ms")
        print(f"[times] {card}: {key} {r['shape']} bf16: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound'][0]:.4f} ms by {r['bound'][1]} "
              f"({r['nbytes']} B, {r['ops']} FLOP){yard}")
    return out


def gmm_cutover(device, rows=(8, 16, 32, 64)):
    """Where ``decode`` should hand over to ``tma``: both variants on the
    decode tick's two products (Jamba's K/N) at M = ``rows``, the widths of
    the swapped product, each checked against the plain version and timed
    with CUDA events.  ``moe_gmm.DECODE_MAX_M`` is set from these times."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    cfg = get_config(JAMBA)
    card = card_line()
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    g = torch.Generator(device).manual_seed(4)
    for k, n, what in ((D, Fe, "gate/up"), (Fe, D, "down")):
        rhs = (torch.randn(E, k, n, generator=g, device=device)
               * k ** -0.5).to(torch.bfloat16)
        for m in rows:
            lhs = torch.randn(E, m, k, generator=g, device=device
                              ).to(torch.bfloat16)
            want = ref.grouped_matmul_ref(lhs, rhs)
            out = torch.empty(E, m, n, dtype=lhs.dtype, device=device)
            ms = {}
            for variant, mp in (("decode", m), ("tma", 0)):
                def run(variant=variant, mp=mp):
                    return gmm_mod._launch(lhs, rhs, out, variant, mp)
                _compare("moe_gmm", f"cut-over {what} {tuple(lhs.shape)}@"
                         f"{tuple(rhs.shape)} [{variant}]", run(), want)
                ms[variant] = _event_ms(run, 10)
            print(f"[cut-over] {card}: {what} M={m}: decode "
                  f"{ms['decode']:.4f} ms, tma {ms['tma']:.4f} ms; "
                  f"gmm_variant chooses {gmm_mod.gmm_variant(m, k, n)}")
            del lhs, want, out
        del rhs
        torch.cuda.empty_cache()


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
    out, _, launches, want, sweep_by_variant = main_path("cuda")
    check(launches == want, f"router_step launches {launches} != {want}")
    worst = max(worst, sweep_against_plain("cuda", out))
    small_sweep_against_cpu("cuda")
    knees = recorded_knees("cuda")
    check(knees == {"mesh": 0.25, "torus": 0.40},
          f"16x16 knees {knees} != mesh 0.25, torus 0.40")
    _, facade_wall, facade_launches = facade("cuda")
    router = timings("cuda", facade_wall)
    # the sweep's long calls run packed and its short ones direct, the
    # facade's drain direct (phases 3 and 5)
    kernels = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/router_step.cu",
        "replaces": "src/repro/kernels/router_step.py:114",
        "launches": n, "max_abs_err": worst, "ms": router[v]["ms"],
        "plain_ms": router[v]["plain_ms"], "bound_ms": router[v]["bound"][0],
        "bound_by": router[v]["bound"][1], "library_ms": None,
        "checked_against_plain": True, "variant": v, "shape": shape}
        for name, v, n, shape in (
            ("router_step", "packed", sweep_by_variant["packed"],
             "12 lanes x 16x32, calls of 400 cycles (the sweep)"),
            ("router_step_direct", "direct",
             sweep_by_variant["direct"] + facade_launches,
             "1 lane x 16x32, calls of 1 cycle (the facade's drain; "
             "the sweep's 200-cycle warm-up also runs direct)"))]
    check(all(k["launches"] > 0 for k in kernels),
          f"a router variant was never launched on the main paths: "
          f"{[(k['name'], k['launches']) for k in kernels]}")

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    errs = model_kernels_vs_plain("cuda")
    reduced_end_to_end("cuda")
    cfg, params, pre = full_width_prefill("cuda")
    srv = full_width_server("cuda", cfg, params)
    model_profile("cuda", cfg, params)
    del params
    torch.cuda.empty_cache()
    times = model_timings("cuda")
    gmm_cutover("cuda")
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:86",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:83",
                "moe_gmm": "src/repro/kernels/moe_gmm.py:44"}
    # (entry, kernel, variant): one entry per kernel variant on the main
    # path, its launches those of that variant in the prefill and server
    entries = (("flash_attention", "flash_attention", "wgmma_tma"),
               ("ssd_scan", "ssd_scan", "tensor_core"),
               ("moe_gmm", "moe_gmm", "tma"),
               ("moe_gmm_decode", "moe_gmm", "decode"))
    for key, name, variant in entries:
        t = times[key]
        if variant is None:
            lp, ls = pre["counts"][name], srv["counts"][name]
        else:
            lp = pre["variants"][name][variant]
            ls = srv["variants"][name][variant]
        check(lp + ls > 0, f"{key} was never launched on the main path")
        entry = {
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": lp + ls,
            "max_abs_err": errs[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "checked_against_plain": True, "launches_prefill": lp,
            "launches_server": ls, "shape": t["shape"]}
        if variant is not None:
            entry["variant"] = variant
        if "yardstick_ms" in t:
            entry["yardstick_ms"] = t["yardstick_ms"]
        if key.startswith("moe_gmm"):
            d = times[key + "_down"]
            entry["down"] = {"shape": d["shape"], "ms": d["ms"],
                             "plain_ms": d["plain_ms"],
                             "library_ms": d["library_ms"],
                             "bound_ms": d["bound"][0],
                             "bound_by": d["bound"][1]}
        kernels.append(entry)
    print(f"[summary] {card_line()}: prefill 1 x {PREFILL_TOKENS} tokens "
          f"{pre['wall']:.3f} s (again {pre['warm']:.3f} s); server "
          f"{srv['ticks']} ticks {srv['wall']:.3f} s, "
          f"{srv['tokens'] / srv['wall']:.1f} generated tokens/s")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
