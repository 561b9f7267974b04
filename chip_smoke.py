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
   (one call a cycle); then the paper's reactive endpoints on 16x32
   through the facade on the card (the trace-to-program bridge: the numpy
   oracle calls the endpoints, the card replays the traced program): 8
   ``DmaEndpoint``s streaming 256 words each (window 8), 8
   ``MemoryControllerEndpoint``s chasing 64 pointers each through rings
   seeded with ``set_mem``, background uniform loads elsewhere; drain
   cycle, Telemetry, memory and every chaser's replies identical to the
   same scenario on the numpy backend, router launches during the replay;
   then the design-space exploration and the workload library, each path
   with the router's counts set to 0 just before it and read just after:
   - ``[dse]``: the canonical 16x16 fleet sweep exactly as
     ``benchmarks/bench_dse.py`` defines it (576 points, 2 topologies x 4
     depths x 3 credits x (uniform and tornado x 12 loads), seed 0,
     300/500/500) through ``run_sweep`` with a temporary result cache:
     576 points in 2 buckets of 288 lanes, 2 compiles, one ``packed``
     router call per phase and bucket; a resubmission simulates 0 (576
     cache hits, 0 compiles); the baseline point (fifo 16, credits 128,
     uniform) gives the knees mesh 0.25 and torus 0.40; both frontiers
     non-empty and monotone; every bucket whole (288 lanes, calls of
     300/500/500, each ``packed``) through the kernel and the plain
     version side by side: every state leaf, ``done`` / ``drained``
     column and ``PhaseStats`` field identical, and the plain version's
     records equal to the sweep's; the same sweep at ``chunk=16`` and at
     ``devices=2`` (one card: it warns and falls back) with identical
     records; the wall time split into host program building and kernel
     time (CUDA events), the lane-cycles per second, and the router per
     cycle at each bucket's shape against its bound and the plain
     version;
   - ``[dse 16x32]``: the paper's 16x32 array with the four workload
     families (48 points, 10 buckets by program length); every record
     equal to its point run alone through ``batched_phased_stats``;
   - ``[workloads]``: the reference benchmark's 8x8 battery (ring
     all-reduce, MoE uniform and hot, pipeline, PGAS) with
     ``backend="both"`` (the card against the port's numpy oracle,
     bit-identical), ``calibrate(8, 8)`` on the card equal to the
     oracle's, and the DSE's four workload instances at 16x32 on the card
     (MoE and a PGAS scatter also against the oracle);
   - ``[service]``: the simulation service (``repro_torch.sim_service``).
     Eight concurrent ``SimRequest``s on 16x32 (``router_fifo`` 16,
     credits 128; uniform at 0.3, seeds 0-7, 200/400/400, ``check_every``
     100, four fifo/credit pairs twice): 1 batch, 10 ticks, 10 ``direct``
     router calls, 80 chunks; each response equal to its request's direct
     ``phased_stats`` on the card, each request's chunks summing to its
     totals; the same batch through ``BatchRunner`` and the plain version
     on the same 10 blocks, every state leaf and ``PhaseStats`` field
     identical.  The same requests at ``check_every`` 500: 1 ``direct``
     (200) and 2 ``packed`` (400) calls, equal responses, and the batch
     on those 3 blocks against the plain version leaf for leaf.  Two
     ``SweepRequest``s on 16x16 (mesh, torus; 12 rates, 300/500/500): 2
     buckets, each a batch of 8 lanes then 4, 26 ticks of one ``direct``
     call per bucket, knees 0.25 / 0.40, each curve equal to
     ``load_latency_sweep``.  Backpressure (``queue_limit`` 8 refuses the
     12-lane sweep and a 9th lane, and reopens after the drain), two
     async ``Ticket.stream()`` consumers equal to the sync facade, a warm
     instance with 0 new shapes, and two processes on a fresh
     ``compile_cache_dir``: the first builds the router library, the
     second loads it.  Times, not gated: the service against 8 direct
     runs, ms per tick, the router's device time per block (the
     profiler) against the tick's host time, the host's program building
     at submit, and what padding 5 lanes to 8 costs;
6. times: the kernel per mesh cycle at 12 lanes x 16x32 with CUDA events,
   in calls of 400 cycles (as the sweep's measure and drain phases) and
   of 1 cycle (as a drain with ``check_every=1``); the cut-over between
   the variants (both in turns at calls of 1 to 400 cycles, the pack
   included, from 1 to 12 lanes of 16x32, at 12 lanes of 16x16, and at
   1 lane of 16x16 and 4x4, where the card is nearly empty); the pack and
   unpack of the working layout; the plain version; each kernel's device
   time from the profiler; and the facade drain's wall time from phase 5;
7. the model kernels against their plain versions, in fp32 and in bf16,
   at every main path's shapes (``FLASH_CASES``, ``GMM_CASES``,
   ``SSD_CASES``): flash at Jamba's, Mixtral's (1 x 8192 with its 4096
   window), Qwen2-VL's (GQA 64/8) and StableLM's (hd 80) prefill and at
   Whisper's three (4 clips, hd 64: the encoder's 1500 x 1500 and the
   decoder's cross-attention, 448 queries against 1500 keys, non-causal;
   the decoder's causal 448 x 448); the GMM
   at Jamba's and Mixtral's prefill and decode and Moonshot's prefill (E
   64, N 1408); the SSD at Jamba's (N 16) and Mamba-2 370M's (N 128)
   prefill.  Each bf16 call must go through its tensor-core variant
   (flash ``wgmma_tma``, SSD ``tensor_core``, GMM ``tma`` in prefill and
   ``decode`` in decode), fp32 through ``f32`` / ``cuda_core``; and the
   GMM's ``ragged`` variant on an lhs TMA cannot describe;
8. the reduced Jamba, Mixtral (window 16, 50 tokens: decode wraps its
   cache three times), Qwen2-VL (distinct (3, B, S) positions), Mamba-2
   LM and Whisper (encoder_seq 20) (fp32) on the card through the kernels
   against the CPU through the plain versions, and teacher-forced
   ``decode_step`` against ``forward`` on the card (Whisper's cross KV
   filled from the card's encoder output);
9. the model stack's main paths at full width, one model at a time, each
   freed before the next, bf16 weights drawn on the card; for each a
   prefill through ``prefill_step``, then the continuous-batching
   ``Server`` on the same weights, each with the launch counts set to 0
   just before it and read just after (every kernel and variant not named
   here 0), then where the time goes (the profiler over a warm prefill and
   over 10 server ticks: device time by kernel category, the device's
   idle share):
   - Jamba v0.1's widths, one period of 8 layers (13.27 B parameters):
     1 x 4096 tokens, 1 ``wgmma_tma`` flash, 7 ``tensor_core`` SSD and 12
     ``tma`` GMM; ``Server`` of 8 requests of 8 prompt tokens, 8 new
     tokens each, 4 slots: 12 ``decode`` GMM a tick;
   - Mixtral-8x7B's widths, 8 of 32 layers (11.87 B): 1 x 8192 tokens,
     8 ``wgmma_tma`` flash and 24 ``tma`` GMM; the same ``Server``: 24
     ``decode`` GMM a tick;
   - Qwen2-VL-72B's widths, 4 of 80 layers (6.00 B): 1 x 4096 tokens
     with (3, 1, S) positions, 4 ``wgmma_tma`` flash; a ``Server`` of 4
     requests (no kernel in decode);
   - Mamba-2 370M whole (48 layers): 1 x 4096 tokens, 48 ``tensor_core``
     SSD; the ``Server`` of 8 requests (its decode is plain recurrence);
   - whisper-large-v3 whole (32 encoder + 32 decoder layers, 2.02 B): 4
     clips of 1500 frames and 4 x 448 decoder tokens, 96 ``wgmma_tma``
     flash (32 encoder, 32 decoder self, 32 cross); the ``Server`` of 8
     requests (no kernel in decode);
10. times of the model kernels at the shapes of phase 7 (kernel, plain
   version, library call, bound): flash beside SDPA (with a window, the
   band as an explicit mask, naming the kernel SDPA ran, and the kernel
   without the window), the GMM beside ``torch.bmm``, the SSD beside the
   models' own chunked PyTorch (``models/mamba2.py::ssd_chunked``, a
   yardstick, not a library call) with its passes' device time and its
   fp32 (``cuda_core``) time; the decode/tma cut-over; then the ``kernels`` JSON line (one entry per
   kernel variant and shape on the main paths, the router's with its
   launches by path and one at the DSE bucket's shape) and the ``ok``
   line;
11. ``[train]``, training through the kernels' backward passes (phase 7
   and 10 also hold and time flash at Moonshot's training shape and the
   SSD at Mamba-2's training batch of 8):
   (1) each autograd op of ``kernels/ops.py`` against its plain version
   by autograd on the card, fp32 and bf16, at the training shapes plus a
   GQA and a ragged case: the gradient of a fixed random projection of
   the output, each forward one kernel launch of its variant, the GMM's
   backward two more GMM launches; (2) the reduced Jamba, Mixtral,
   Qwen2-VL, Mamba-2 LM and Whisper (fp32): loss, every gradient and one
   ``train_step`` on the card equal to the CPU's; (3) through ``Trainer``
   and ``launch/train.py``'s code, bf16 weights drawn on the card, full
   remat, each model freed before the next: Mamba-2 370M whole, 8 x 4096
   tokens, 6 steps, checkpoints at 5 and 6 (96 ``tensor_core`` SSD
   launches a step: 48 forward and 48 rematerialised; an injected fault
   at step 2 retried), and Moonshot's widths, 2 of 48 layers, 1 x 4096,
   10 steps (4 ``wgmma_tma`` flash and 24 ``tma`` GMM a step: 6 forward,
   6 rematerialised, 12 in the backward), the launches asserted at every
   step and the loss falling; then Moonshot again from the same weights
   and batch for 3 steps under ``remat="dots"`` (the launches of full
   remat; the losses equal the full run's bit for bit) and ``"none"``
   (2 flash and 18 GMM a step), with the peak memory and the cuBLAS
   matmuls' device time a step of all three; (4) Mamba-2's checkpoint of
   step 5 restored by a fresh ``Trainer``, whose next step's loss equals
   the uninterrupted run's step 6; (5) times, not gated: ms per warm step,
   tokens/s, model FLOP/s, peak memory, the profiler's device time by
   category over 3 warm steps and the idle share, and the GMM's backward
   products beside ``torch.bmm`` with their transposed copies;
12. ``[spmd]``, serving on a mesh: 4 ranks (data 2 x model 2) started
   by ``repro_torch.launch.mesh.spawn`` share the card and talk over gloo
   (NCCL refuses two ranks of one communicator on one device; the ops
   gloo takes only on the host are printed), so nothing here measures an
   interconnect: (1) the mechanisms on CUDA tensors (XY all-to-all,
   all-reduce, reduce-scatter and all-gather, ``all_reduce(max)``, the
   ring shift, remote store / load / CAS, the mutex, the barrier), each
   equal to the same result computed in one process; (2) Qwen2-72B's
   widths, 2 of 80 layers, a 2 x 4096 prefill under manual TP, the counts
   set to 0 just before and read just after on every rank (2
   ``wgmma_tma`` flash a rank, no GMM), the gathered logits against the
   same model unsharded on the card (within 2e-2 of the largest logit,
   the bf16 bar of ``[train ops]``); (3) Mixtral's widths, 2 of 32
   layers, a 2 x 8192 prefill in the ``xy``, ``ep`` and ``local``
   dispatch modes at the published capacity factor (2 flash and 6 ``tma``
   GMM a rank each, the drops printed) and again at a factor that drops
   nothing (2 x 4096 tokens), where the three modes' logits agree within
   2e-2; (4) each rank's distinct flash and GMM calls against their plain
   versions at its local shapes; (5) the fp32 mesh ``Server`` at
   Mixtral's widths (8 requests, 4 slots: rows over ``data``, the KV
   cache over ``model``, the MoE ``ep``; 6 ``f32`` GMM a tick a rank),
   its tokens identical to the single-card ``Server``'s; then the times
   of each local shape's kernel, plain version, library call and bound on
   the card alone, and the per-rank launches in the ``kernels`` line.
   Every time is labelled as 4 ranks time-sharing one card.
13. ``[spmd train]``, training on a mesh: (1) the yardstick on one card
   first: ``make_trainer`` of Moonshot's widths (2 of 48 layers), 2 x
   4096 tokens, full remat, 2 steps on the pipeline's batch 0 from
   ``init(seed=0)``; its step-1 gradients and step-2 parameters to the
   host, the card freed; (2) 4 ranks (data 2 x model 2) sharing the card
   over gloo, each ``make_trainer(..., mesh=mesh)`` under
   ``cell_rules``' ``baseline`` (ZeRO-1 over ``data``, full remat), the
   same 2 steps from the same seed, once with its ``xy`` dispatch (the
   main path) and once with ``ep`` (which runs one card's global FIFO):
   on every rank each step's launches by variant and by forward, remat
   and backward (4 ``wgmma_tma`` flash, 24 ``tma`` GMM: 6 forward, 6
   remat, 12 backward), the collectives a step by phase (loss, backward,
   optimizer), ms a step, peak memory, each loss within 2e-2 of one
   card's; on both runs each parameter's step-2 block within 3e-2
   relative L2 of its cut of one card's (every error finite), on the
   ``ep`` run each step-1 gradient bank too (``xy`` drops other
   assignments than one card's FIFO: its gradient errors are printed);
   each rank's kernel calls and its flash and GMM ops (forward
   and backward) at its local shapes against plain, one rank at a time;
   (3) the kernel times at those shapes on the card alone, and the
   per-rank training launches in the ``kernels`` line.
14. ``[spmd pipeline]``, the rest of SPMD training, one spawn of 4 ranks
   (data 2 x model 2) sharing the card over gloo after a one-card
   yardstick: (1) ``parallel/pipeline.py::pipeline_apply`` at Moonshot's
   widths, 4 layers in 2 stages of 2 on ``model`` (the stage body the
   port's transformer layer, ``layer_apply``: flash, then the MoE at the
   published capacity factor through the GMM, each layer under full
   remat: without it four ranks' activations do not fit the card), rows
   over ``data``, 4 microbatches of 1 x 4096 a data rank; forward, then
   the backward of a fixed random projection of the outputs: on every
   rank 10 flash and 30 GMM launches forward (2 layers x 5 ticks, the
   bubble ticks included), as many again in the remat and 60 GMM in the
   backward wave, one ``ppermute`` a tick and one
   ``ppermute.bwd`` a tick but the last, the bubble fraction, the peak
   memory (at most 18 GiB a rank), the outputs bit-identical to the
   same 4 layers run microbatch by microbatch on one card (at most 1
   bf16 ulp), each stage gradient summed over ``data`` within 1e-2
   relative L2 of one card's; (2) ``optim/compress.py::cross_pod_psum``
   over ``data`` on those gradients (the attention, norms and router
   whole, 4 of each expert weight's 64 experts) in int8 and bf16 with
   error feedback over two rounds, each round within its codec's bound
   of the exact all-reduce, the wire's bytes the fp32 bytes; (3)
   ``Trainer.reshard`` on CUDA tensors: the reduced Moonshot at capacity
   factor 8 (``ep``), 2 steps on (2, 2), re-sharded to (1, 2) on ranks
   0-1, 2 more steps (ranks 2-3 idle): the 4 losses within 1e-3 of one
   card's, the move's time and bytes; the phase's entries in the
   ``kernels`` line.
15. ``[spmd families]``, Mamba-2, Whisper and Jamba on a mesh: (1) each on
   the card alone first, freed before the next: a bf16 prefill at the
   published widths and capacity factor (Mamba-2 370M whole and Jamba
   v0.1's one period, 8 layers, at 2 x 4096; whisper-large-v3 whole at 4
   clips of 1500 frames + 4 x 448 tokens) and an fp32 one (Jamba at
   capacity factor E / top_k = 8, which drops nothing, and 2 x 1024),
   each with its launches asserted; Jamba's 16 fp32 decode ticks of 2
   rows; the fp32 ``Server`` (8 requests of 4 + 4 tokens on 4 slots;
   Whisper 4) and 3 fp32 training steps (Mamba-2 8 layers at 2 x 4096,
   Whisper 4 + 4 layers at 2 x 448, full remat) of Mamba-2 and Whisper;
   (2) one spawn of 4 ranks sharing the card over gloo, Mamba-2 and
   Whisper on data 2 x model 2, Jamba on data 1 x model 4, the same runs:
   on every rank each prefill's launches by variant (bf16: Mamba-2 48
   ``tensor_core`` SSD at 16 local heads; Whisper 96 ``wgmma_tma`` flash
   at 10; Jamba 1 flash, 7 SSD at 32 heads and 12 ``tma`` GMM at 4 local
   experts; fp32 the same through the fp32 variants), the fp32 logits
   within 2e-2 of the card alone's largest (random-init models amplify
   bf16 rounding: the bf16 errors are printed, see ``FAM_JAMBA_FP32_SEQ``),
   nothing dropped at capacity factor 8 (the drops at the published 1.25
   printed); each of Jamba's 16 decode ticks within 2e-2; the fp32 mesh
   ``Server``'s tokens identical to the card alone's; each training loss
   within 2e-2 and every parameter block within 3e-2 relative L2 after
   step 3, the zero-initialised ones after step 1 (``FAM_TRAIN_LAYERS``
   says why, and why Mamba-2 trains 8 layers); the
   collectives of each island a call (the mixer's weight gathers and
   gate-norm all-reduce among them), wall and peak memory a rank; each
   rank's kernels of the bf16 prefills against plain at its local
   shapes, one rank at a time; (3) those kernels' times on the card
   alone, and the phase's entries in the ``kernels`` line.

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


def phases_against_plain(cfg, prog, fresh, phases, what, check_every=None):
    """The phases ``(warmup, measure, drain)`` through the kernel's wrapper
    and through the plain version side by side, each from its own
    ``fresh()`` state with the measure window set: one call per phase as
    ``phased_stats`` makes them, or with ``check_every`` one call per
    fence block as the service's ``BatchRunner`` makes them.  Every state
    leaf and every per-cycle ``done`` / ``drained`` column must be
    identical after each call, and so must every ``PhaseStats`` field.
    Returns (the plain version's ``PhaseStats``, the largest absolute
    difference seen (0 when identical), the variant of each kernel call,
    the plain version's final state)."""
    import torch
    from repro_torch.kernels.router_step import (router_step_call,
                                                 router_step_plain,
                                                 router_variant)
    from repro_torch.netsim.measure import (phase_schedule,
                                            reduce_window_stats)
    from repro_torch.netsim.sim import STATE_LEAVES, flatten_state
    warmup, measure, drain = phases
    schedule = phase_schedule(warmup, measure, drain,
                              check_every or max(phases))

    def windowed():
        st = fresh()
        return st._replace(measure_start=st.cycle + warmup,
                           measure_stop=st.cycle + (warmup + measure))

    def snapshot(s):
        return (s.prog_ptr.sum((1, 2)).int(), s.completed.sum((1, 2)).int(),
                s.link_util.clone())

    ks, ps = windowed(), windowed()
    B = ks.cycle.shape[0]
    worst = 0
    snaps = {"kernel": {}, "plain": {}}
    variants = []
    for i, (phase, n) in enumerate(schedule):
        variants.append(router_variant(cfg, B, n))
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
              f"{what}, {phase} block {i}: kernel differs from plain on "
              f"{bad}")
        if i + 1 == len(schedule) or schedule[i + 1][0] != phase:
            snaps["kernel"][phase] = snapshot(ks)
            snaps["plain"][phase] = snapshot(ps)
    stats = {}
    for side, st in (("kernel", ks), ("plain", ps)):
        (i0, c0, u0), (i1, c1, u1) = (snaps[side]["warmup"],
                                      snaps[side]["measure"])
        stats[side] = reduce_window_stats(cfg.nx * cfg.ny, measure,
                                          st.lat_hist.clone(), i1 - i0,
                                          c1 - c0, u1 - u0)
    for f in stats["plain"]._fields:
        a, b = getattr(stats["kernel"], f), getattr(stats["plain"], f)
        worst = max(worst, float((a.double() - b.double()).abs().max()))
        check(torch.equal(a, b), f"{what}: kernel {f} differs from plain")
    return stats["plain"], worst, variants, ps


def sweep_against_plain(device, out, nx=16, ny=32):
    """The main path's own inputs through the kernel and the plain
    version: the sweep's programs and phase windows, one call per phase as
    the sweep makes them (:func:`phases_against_plain`); the plain
    version's statistics must equal the sweep's ``out``.  Returns the
    largest absolute difference seen (0 when identical)."""
    import numpy as np
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            sweep_config,
                                            stack_rate_programs)
    from repro_torch.netsim.sim import init_state
    cfg = sweep_config(nx, ny).to_sim()
    rates = sorted(DEFAULT_SWEEP_RATES)
    prog = stack_rate_programs("uniform", nx, ny, rates, sum(SWEEP_PHASES),
                               topology=cfg.topology, device=device)
    B = len(rates)
    stats, worst, _, _ = phases_against_plain(
        cfg, prog, lambda: init_state(cfg, lanes=B, device=device),
        SWEEP_PHASES, "16x32 sweep")
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
# design-space exploration and the workload library, through the router
# ----------------------------------------------------------------------
def router_counts():
    """(launches, launches by variant) of the router kernel since the
    last :func:`zero_router`."""
    from repro_torch.kernels.router_step import router_step_call
    return (router_step_call.launches,
            dict(router_step_call.launches_by_variant))


def zero_router():
    from repro_torch.kernels.router_step import router_step_call
    router_step_call.launches = 0
    router_step_call.launches_by_variant = dict.fromkeys(
        router_step_call.launches_by_variant, 0)


# the baseline point's knees (router_fifo 16, credits 128, uniform), as
# benchmarks/bench_dse.py expects them
DSE_KNEES = {"mesh": 0.25, "torus": 0.40}


def dse_spec():
    """The repo's canonical 16x16 fleet sweep, exactly as
    ``benchmarks/bench_dse.py::dse_spec`` defines it: 2 topologies x 4
    depths x 3 credits x (2 patterns x 12 loads) = 576 points, seed 0,
    300/500/500 phases."""
    from repro_torch.dse import SweepSpec
    from repro_torch.netsim.measure import DEFAULT_SWEEP_RATES
    return SweepSpec(nx=16, ny=16, fifo_depths=(2, 4, 8, 16),
                     credits=(8, 32, 128), patterns=("uniform", "tornado"),
                     loads=DEFAULT_SWEEP_RATES,
                     topologies=("mesh", "torus"), warmup=300, measure=500,
                     drain=500, seed=0, name="16x16_fleet")


def _lanes(device, pts, length):
    """The bucket's programs for ``pts``, as run_sweep builds them, one
    lane each, with their depths and credits."""
    from repro_torch.dse import runner
    from repro_torch.netsim.sim import Program
    progs, rows = runner.bucket_programs(pts, length, device)
    return (Program(progs.buf[rows], progs.length[rows]),
            [p.fifo_depth for p in pts], [p.credits for p in pts])


def dse_canonical(device):
    """``[dse]``: the canonical 576-point sweep through ``run_sweep`` on the
    card, with the router's counts set to 0 just before it and read just
    after; then its checks (see the module docstring) and the router per
    cycle at each bucket's shape."""
    import tempfile
    import warnings
    import torch
    from repro_torch.dse import frontier_artifact, run_sweep
    from repro_torch.dse import runner
    from repro_torch.kernels import router_step as rs
    card = card_line()
    spec = dse_spec()
    with tempfile.TemporaryDirectory() as tmp:
        zero_router()
        first = run_sweep(spec, cache_dir=tmp, device=device)
        launches, by_variant = router_counts()
        again = run_sweep(spec, cache_dir=tmp, device=device)
    horizon = spec.horizon
    print(f"[dse] {card}: {spec.describe()}")
    print(f"[dse] {card}: {first.n_points} points in {first.buckets} "
          f"buckets, {first.compiles} compiles, wall {first.wall_s:.2f} s: "
          f"building and copying programs {first.program_s:.3f} s (host), "
          f"simulation {first.simulate_s:.4f} s (CUDA events); "
          f"{first.n_points * horizon / first.wall_s:.4g} lane-cycles/s of "
          f"wall ({first.n_points * horizon / first.simulate_s:.4g} of "
          f"kernel time); router_step launches {launches} by variant "
          f"{by_variant}")
    print(f"[dse] resubmission: simulated {again.simulated}, cache hits "
          f"{again.cache_hits}, compiles {again.compiles}, wall "
          f"{again.wall_s:.2f} s")
    check(first.n_points == 576 and first.buckets == 2,
          f"canonical sweep: {first.n_points} points in {first.buckets} "
          f"buckets, not 576 in 2")
    check(first.compiles == 2, f"canonical sweep: {first.compiles} compiles")
    want = {v: sum(rs.router_variant(key.cfg, len(pts), c) == v
                   for (key, _), pts in runner.buckets(spec).items()
                   for c in (spec.warmup, spec.measure, spec.drain))
            for v in rs.VARIANTS}
    check(by_variant == want, f"canonical sweep: launches {by_variant}, "
          f"not one call per phase and bucket of the variants "
          f"router_variant chooses ({want})")
    check(again.simulated == 0 and again.cache_hits == 576
          and again.compiles == 0 and again.records == first.records,
          "canonical sweep: the resubmission was not a pure cache replay")
    art = frontier_artifact(first)
    knees = {}
    for topo in ("mesh", "torus"):
        f = art["frontiers"][topo]
        knees[topo] = next(p["saturation_rate"] for p in f["points"]
                           if (p["fifo_depth"], p["credits"]) == (16, 128))
        check(bool(f["frontier"]) and f["monotone"],
              f"canonical sweep: the {topo} frontier is empty or not "
              f"monotone")
        print(f"[dse] {topo}: baseline knee {knees[topo]}, frontier "
              f"{len(f['frontier'])}/{len(f['points'])} configurations, "
              f"monotone {f['monotone']}")
    check(knees == DSE_KNEES,
          f"canonical sweep: baseline knees {knees} != mesh 0.25, torus 0.40")
    chunked = run_sweep(spec, chunk=16, device=device)
    check(chunked.records == first.records,
          "canonical sweep: chunk=16 changed the records")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fanned = run_sweep(spec, devices=2, device=device)
    check(any("falling back" in str(w.message) for w in caught)
          and fanned.devices == 1 and fanned.records == first.records,
          "canonical sweep: devices=2 on one card did not warn and match")
    print(f"[dse] chunk=16: identical records, wall {chunked.wall_s:.2f} s "
          f"(simulation {chunked.simulate_s:.4f} s); devices=2 on "
          f"{torch.cuda.device_count()} card(s): warned, identical records, "
          f"wall {fanned.wall_s:.2f} s")

    # every bucket whole, at the sweep's shape and calls (each ``packed``),
    # through the kernel and the plain version side by side; the plain
    # version's records must be the sweep's
    from repro_torch.netsim.sim import init_state
    by_point = dict(zip(spec.points(), first.records))
    worst = 0.0
    timing = {}
    for (key, length), pts in runner.buckets(spec).items():
        topo = key.cfg.topology.spec
        progs, depths, credits = _lanes(device, pts, length)
        before = router_counts()[1]["packed"]
        t0 = time.perf_counter()
        plain, err, variants, _ = phases_against_plain(
            key.cfg, progs,
            lambda: init_state(key.cfg, depths, credits, device=device),
            (key.warmup, key.measure, key.drain), f"[dse] {topo} bucket")
        wall = time.perf_counter() - t0
        check(variants == ["packed"] * 3
              and router_counts()[1]["packed"] - before == 3,
              f"[dse] {topo}: the bucket's calls ran {variants}, not "
              f"packed")
        worst = max(worst, err)
        for i, p in enumerate(pts):
            stats = {f: float(getattr(plain, f)[i]) for f in
                     runner.STAT_FIELDS}
            check(runner.point_record(p, stats) == by_point[p],
                  f"[dse] {p.label()}: the sweep's record differs from the "
                  f"plain version's")
        print(f"[dse] {topo}: the whole bucket ({len(pts)} lanes x "
              f"{key.cfg.nx}x{key.cfg.ny}, calls of {key.warmup}/"
              f"{key.measure}/{key.drain}, variants {variants}) through "
              f"kernel and plain side by side in {wall:.1f} s: every leaf, "
              f"column and PhaseStats field identical (max_abs_err {err}), "
              f"the plain version's {len(pts)} records equal the sweep's")
        timing[topo] = dse_bucket_timing(device, key, length, pts)
    stream_and_compile(device, spec, by_point)
    return {"launches": launches, "by_variant": by_variant,
            "max_abs_err": worst, "timing": timing, "wall": first.wall_s,
            "program_s": first.program_s, "simulate_s": first.simulate_s}


def stream_and_compile(device, spec, by_point, check_every=100):
    """The baseline point of the mesh streamed one fence block at a time
    on the card: its chunks sum to its window, and its final stats give
    the sweep's record; then ``compile_sweep`` for the mesh's 12-rate
    baseline curve, whose ``load_latency_sweep`` knee is 0.25."""
    import numpy as np
    from repro_torch.dse import runner
    from repro_torch.mesh.traffic import make_traffic
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            compile_sweep,
                                            load_latency_sweep,
                                            stack_rate_programs,
                                            stream_phased_stats)
    p = next(q for q in by_point if q.topology.spec == "mesh"
             and (q.fifo_depth, q.credits, q.traffic, q.load)
             == (16, 128, "uniform", DSE_KNEES["mesh"]))
    cfg = spec.bucket_config(p.topology)
    gen = stream_phased_stats(
        cfg, make_traffic("uniform", 16, 16, spec.traffic_length(),
                          rate=p.load, seed=p.seed, topology=p.topology),
        warmup=spec.warmup, measure=spec.measure, drain=spec.drain,
        check_every=check_every, fifo_depth=p.fifo_depth,
        max_credits=p.credits, device=device)
    t0 = time.perf_counter()
    chunks = []
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            final = stop.value
            break
    wall = time.perf_counter() - t0
    stats = {f: float(getattr(final, f)[0]) for f in runner.STAT_FIELDS}
    check(runner.point_record(p, stats) == by_point[p],
          "[dse] the streamed baseline differs from the sweep's record")
    check(sum(c.delivered for c in chunks) == int(final.hist.sum())
          and np.array_equal(sum(c.hist for c in chunks),
                             final.hist[0].cpu().numpy()),
          "[dse] the streamed chunks do not sum to the window")
    progs = stack_rate_programs("uniform", 16, 16, DEFAULT_SWEEP_RATES,
                                spec.horizon, topology=p.topology,
                                device=device)
    compiled, secs = compile_sweep(cfg, progs, warmup=spec.warmup,
                                   measure=spec.measure, drain=spec.drain)
    out = load_latency_sweep("uniform", 16, 16, DEFAULT_SWEEP_RATES,
                             warmup=spec.warmup, measure=spec.measure,
                             drain=spec.drain, cfg=cfg, compiled=compiled,
                             device=device)
    check(out["saturation_rate"] == DSE_KNEES["mesh"],
          f"[dse] the compiled sweep's knee {out['saturation_rate']}")
    print(f"[dse] {card_line()}: the baseline {p.label()} streamed in "
          f"{len(chunks)} fence blocks of {check_every} cycles in "
          f"{wall:.3f} s, its stats equal to the sweep's record; "
          f"compile_sweep {secs:.4f} s (the router library loaded), its "
          f"12-rate curve's knee {out['saturation_rate']}")


def dse_bucket_timing(device, key, length, pts, plain_cycles=5):
    """The router per mesh cycle at the DSE bucket's shape (all its lanes,
    16x16, calls of 300/500/500 from a fresh state, as run_sweep makes
    them; CUDA events), the whole bucket's ``batched_phased_stats`` (state
    set-up, the three calls and the statistics, as ``run_sweep`` times a
    bucket), the plain version's per cycle at the same shape, and the
    byte and operation bounds."""
    import torch
    from repro_torch.kernels import router_step as rs
    from repro_torch.netsim.measure import batched_phased_stats
    from repro_torch.netsim.sim import init_state
    cfg, B = key.cfg, len(pts)
    progs, depths, credits = _lanes(device, pts, length)
    calls = (key.warmup, key.measure, key.drain)

    def run(fn, sizes):
        st = init_state(cfg, depths, credits, device=device)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for c in sizes:
            st, _, _ = fn(cfg, progs, st, c)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / sum(sizes)

    def bucket():
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        batched_phased_stats(key, progs, depths, credits)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    run(rs.router_step_call, (8,))                      # warm up
    runs = [run(rs.router_step_call, calls) for _ in range(3)]
    whole = [bucket() for _ in range(3)]
    variants = [rs.router_variant(cfg, B, c) for c in calls]
    plain = run(rs.router_step_plain, (plain_cycles,))
    nbytes = rs.cycle_bytes(cfg, B)
    bound = _bound(nbytes, INT_OPS_PER_TILE_CYCLE * B * cfg.nx * cfg.ny,
                   H100_OPS_PER_S)
    print(f"[dse] {card_line()}: router_step at the {cfg.topology.spec} "
          f"bucket's shape ({B} "
          f"lanes x {cfg.nx}x{cfg.ny} = {B * cfg.nx * cfg.ny} lanes x "
          f"tiles, calls of {calls}, variants {variants}): "
          + " / ".join(f"{ms * 1e3:.3f}" for ms in runs)
          + f" us per mesh cycle; plain version {plain * 1e3:.1f} us; bound "
          f"{bound[0] * 1e3:.3f} us by {bound[1]} ({nbytes} B a cycle at "
          f"3.35 TB/s); the whole bucket's batched_phased_stats "
          + " / ".join(f"{ms:.2f}" for ms in whole)
          + f" ms ({min(whole) / sum(calls) * 1e3:.3f} us a cycle)")
    return {"ms": min(runs), "plain_ms": plain, "bound": bound,
            "variants": variants, "bucket_ms": min(whole),
            "shape": f"{B} lanes x {cfg.nx}x{cfg.ny}, calls of "
                     f"{'/'.join(map(str, calls))} cycles (the DSE's bucket)"}


def dse_16x32(device):
    """``[dse 16x32]``: the paper's 16x32 array with the workload families
    through ``run_sweep`` on the card (the router's counts set to 0 just
    before and read just after); every record must equal its point run
    alone through ``batched_phased_stats`` on the card."""
    from repro_torch.dse import WORKLOAD_FAMILIES, SweepSpec, run_sweep
    from repro_torch.dse import runner
    from repro_torch.dse.spec import workload_entries
    from repro_torch.mesh.traffic import make_traffic
    from repro_torch.netsim.measure import batched_phased_stats
    from repro_torch.netsim.sim import load_program
    spec = SweepSpec(nx=16, ny=32, fifo_depths=(4, 16), credits=(32, 128),
                     patterns=("uniform",), loads=(0.1, 0.25),
                     topologies=("mesh", "torus"),
                     workloads=WORKLOAD_FAMILIES, warmup=300, measure=500,
                     drain=500)
    zero_router()
    res = run_sweep(spec, device=device)
    launches, by_variant = router_counts()
    entries = {}
    for p, rec in zip(spec.points(), res.records):
        if p.is_workload:
            if p.family not in entries:
                entries[p.family] = workload_entries(p.family, p.nx, p.ny,
                                                     p.seed)
            ent = entries[p.family]
        else:
            ent = make_traffic(p.traffic, p.nx, p.ny, spec.traffic_length(),
                               rate=p.load, seed=p.seed, topology=p.topology)
        alone = batched_phased_stats(spec.sweep_key(p.topology),
                                     load_program(ent, device),
                                     [p.fifo_depth], [p.credits])
        stats = {f: float(getattr(alone, f)[0]) for f in runner.STAT_FIELDS}
        check(runner.point_record(p, stats) == rec,
              f"[dse 16x32] {p.label()}: differs from the point run alone")
    wl = [r for r in res.records if r["point"]["traffic"].startswith("wl:")]
    print(f"[dse 16x32] {card_line()}: {spec.describe()}")
    print(f"[dse 16x32] {res.n_points} points in {res.buckets} buckets "
          f"(by program length), wall {res.wall_s:.2f} s: programs "
          f"{res.program_s:.3f} s (host), simulation {res.simulate_s:.4f} s "
          f"(CUDA events); router_step launches {launches} by variant "
          f"{by_variant}; every record equal to its point run alone; "
          f"workload points' accepted rate "
          f"{min(r['stats']['accepted'] for r in wl):.4f}-"
          f"{max(r['stats']['accepted'] for r in wl):.4f}")
    check(res.n_points == 48 and res.buckets == 10,
          f"[dse 16x32] {res.n_points} points in {res.buckets} buckets")
    return {"launches": launches, "by_variant": by_variant}


def workloads_phase(device):
    """``[workloads]``: the reference benchmark's 8x8 battery with
    ``backend="both"`` (the card against the port's numpy oracle,
    bit-identical), ``calibrate(8, 8)`` on the card against the oracle, and
    the DSE's four workload instances at 16x32 on the card (MoE and a PGAS
    scatter also against the oracle).  The router's counts are set to 0
    just before and read just after."""
    from repro_torch.dse import WORKLOAD_FAMILIES, workload_instance
    from repro_torch.workloads import (calibrate, moe_all_to_all,
                                       pgas_scatter, pipeline_p2p,
                                       ring_all_reduce, run_workload)
    card = card_line()
    zero_router()
    t0 = time.perf_counter()
    ar = ring_all_reduce(8, 8, 64)
    battery = {name: run_workload(w, backend="both", device=device)
               for name, w in (
                   ("allreduce", ar),
                   ("moe_uniform", moe_all_to_all(8, 8, 8, imbalance=0.0,
                                                  seed=0)),
                   ("moe_hot", moe_all_to_all(8, 8, 8, imbalance=0.5,
                                              seed=0)),
                   ("pipeline", pipeline_p2p(8, 8, n_micro=8, act_words=8,
                                             backward=True)),
                   ("pgas", pgas_scatter(8, 8, 8)))}
    for name, r in battery.items():
        print(f"[workloads] 8x8 {name} (card == numpy oracle, bit-identical): "
              f"{r.summary()}")
    chunk, r = ar.meta["chunk"], battery["allreduce"]
    check(r.delivered == r.injected and chunk <= r.cycles_per_step
          <= 16 * chunk + 16, "[workloads] the 8x8 all-reduce's steps")
    uni, hot = battery["moe_uniform"], battery["moe_hot"]
    check(hot.cycles >= uni.cycles and hot.peak_link_util >=
          uni.peak_link_util, "[workloads] the hot expert is not hotter")
    check(battery["pipeline"].cycles >= battery["pipeline"].n_steps,
          "[workloads] the pipeline ran faster than its ticks")
    t1 = time.perf_counter()
    card_fit = calibrate(8, 8, backend="torch", device=device)
    t2 = time.perf_counter()
    host_fit = calibrate(8, 8, backend="numpy")
    t3 = time.perf_counter()
    check(card_fit.to_json() == host_fit.to_json(),
          "[workloads] calibrate on the card differs from the oracle's")
    print(f"[workloads] calibrate(8, 8): card {t2 - t1:.2f} s, numpy "
          f"{t3 - t2:.2f} s, coefficients equal: "
          + ", ".join(f"{k} ({a:.3f}, {b:.2f})"
                      for k, (a, b) in card_fit.coeffs.items()))
    big = {}
    for fam in WORKLOAD_FAMILIES + ("pgas",):
        t = time.perf_counter()
        w = pgas_scatter(16, 32, 8) if fam == "pgas" else \
            workload_instance(fam, 16, 32)
        built = time.perf_counter() - t
        t = time.perf_counter()
        r = run_workload(w, device=device)
        wall = time.perf_counter() - t
        big[fam] = r
        line = (f"[workloads] {card}: 16x32 {w.name}: {w.n_packets} "
                f"packets, {w.n_steps} steps; drain cycle {r.cycles}, "
                f"{r.cycles_per_step} cycles per step; built in "
                f"{built:.2f} s (host), run on the card {wall:.3f} s")
        if fam in ("moe", "pgas"):
            t = time.perf_counter()
            both = run_workload(w, backend="both", device=device)
            check(both.cycles == r.cycles, f"[workloads] 16x32 {fam}")
            line += (f"; against the numpy oracle bit-identical "
                     f"({time.perf_counter() - t:.2f} s)")
        print(line)
    launches, by_variant = router_counts()
    print(f"[workloads] wall {time.perf_counter() - t0:.1f} s; router_step "
          f"launches {launches} by variant {by_variant}")
    return {"launches": launches, "by_variant": by_variant,
            "cycles": {k: r.cycles for k, r in big.items()}}


# ----------------------------------------------------------------------
# the simulation service, every fence block through the router
# ----------------------------------------------------------------------
# (fifo_depth, max_credits) of the eight concurrent requests, seeds 0-7
SERVICE_KNOBS = ((None, None), (2, 8), (8, 32), (4, 16)) * 2


def service_requests(check_every, nx=16, ny=32):
    """``[service]``'s eight concurrent requests on the paper's array:
    uniform at 0.3, seeds 0-7, phases 200/400/400, the knobs of
    :data:`SERVICE_KNOBS`."""
    from repro_torch.mesh import MeshConfig
    from repro_torch.sim_service import SimRequest
    cfg = MeshConfig(nx=nx, ny=ny, router_fifo=16, max_out_credits=128)
    return [SimRequest(cfg=cfg, pattern="uniform", load=0.3, seed=s,
                       warmup=200, measure=400, drain=400,
                       check_every=check_every, fifo_depth=d, max_credits=c)
            for s, (d, c) in enumerate(SERVICE_KNOBS)]


def _same_stats(a, b) -> bool:
    """Two ``PhaseStats`` of one lane (numpy leaves or one-lane tensors)
    equal in every field."""
    import numpy as np

    def host(v):
        return v[0].cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    return all(np.array_equal(host(getattr(a, f)), host(getattr(b, f)))
               for f in a._fields)


def _same_chunks(a, b) -> bool:
    """Two lists of ``TelemetryChunk``s with equal fence-block deltas."""
    import numpy as np
    return len(a) == len(b) and all(
        x.chunk[:-1] == y.chunk[:-1]
        and np.array_equal(x.chunk.hist, y.chunk.hist) for x, y in zip(a, b))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def service_phase(device):
    """``[service]``: the simulation service on the card (see the module
    docstring), each service run with the router's counts set to 0 just
    before it and read just after.  Returns (the service's launches by
    variant, its times)."""
    import asyncio
    import numpy as np
    from repro_torch.mesh import Topology, make_traffic
    from repro_torch.netsim.measure import (DEFAULT_SWEEP_RATES,
                                            load_latency_sweep,
                                            phased_stats, sweep_config)
    from repro_torch.netsim.sim import (STATE_LEAVES, flatten_state,
                                        init_state, load_program)
    from repro_torch.kernels.router_step import cycle_bytes
    from repro_torch.sim_service import (BatchRunner, ServiceOverloaded,
                                         SimServer, SimService,
                                         SweepRequest, bucket_key)
    from repro_torch.sim_service.bucketing import stack_lanes
    card = card_line()
    total = {"direct": 0, "packed": 0}

    def counted(fn):
        zero_router()
        out = fn()
        by_variant = router_counts()[1]
        for v, n in by_variant.items():
            total[v] += n
        return out, by_variant

    # (1) eight concurrent requests, one batch, one call per fence block
    reqs = service_requests(100)
    svc = SimService(max_batch=8, device=device)
    ticks = []

    def run_ticks():
        t0 = time.perf_counter()
        tickets = [svc.submit(r) for r in reqs]
        while not svc.server.idle:
            t = time.perf_counter()
            svc.server.tick()
            ticks.append(time.perf_counter() - t)
        return tickets, time.perf_counter() - t0
    (tickets, wall), by_variant = counted(run_ticks)
    m = svc.metrics
    print(f"[service] {card}: 8 requests x 16x32 (uniform 0.3, seeds 0-7, "
          f"200/400/400, check_every 100): {m.batches} batch, {m.ticks} "
          f"ticks, {m.blocks} blocks, {m.chunks} chunks, new shapes "
          f"{m.sim_compiles} block + {m.aux_compiles} init/reduce; "
          f"router_step launches by variant {by_variant}")
    check(m.batches == 1 and m.ticks == 10 and m.blocks == 10
          and m.chunks == 80 and m.completed == 8,
          f"[service] 8 requests: {m.snapshot()}")
    check(by_variant == {"direct": 10, "packed": 0},
          f"[service] 8 requests ran {by_variant}, not 10 direct calls")
    ntiles = 16 * 32
    for r, t in zip(reqs, tickets):
        st, ch = t.response.stats, t.chunks
        hist = np.asarray(st.hist)
        check(len(ch) == 10
              and sum(c.chunk.delivered for c in ch) == int(hist.sum())
              and (sum(c.chunk.hist for c in ch) == hist).all()
              and sum(c.chunk.injected for c in ch
                      if c.chunk.phase == "measure")
              == round(float(st.offered) * ntiles * 400),
              f"[service] seed {r.seed}: the chunks do not sum to the "
              f"totals")
    # each request alone, direct, on the card (not the service: uncounted)
    direct, t0 = [], time.perf_counter()
    for r in reqs:
        cfg = r.cfg.to_sim()
        prog = load_program(make_traffic(
            r.pattern, r.cfg.nx, r.cfg.ny, int(np.ceil(r.load * r.horizon))
            + 1, rate=r.load, seed=r.seed, topology=r.cfg.topology), device)
        st = init_state(cfg, r.fifo_depth, r.max_credits, lanes=1,
                        device=device)
        direct.append(phased_stats(cfg, prog, st, 200, 400, 400))
        _sync(device)
    direct_s = time.perf_counter() - t0
    for r, t, d in zip(reqs, tickets, direct):
        check(_same_stats(d, t.response.stats),
              f"[service] seed {r.seed}: the response differs from its "
              f"direct phased_stats on the card")
    print("[service] every response equals its request's direct "
          "phased_stats on the card, every field; each request's 10 "
          "chunks sum to its totals")

    # the same batch through the service's BatchRunner and the plain
    # version on the same schedule (comparison launches: uncounted)
    lanes = [ln for r in reqs for ln in r.lanes()]
    key = reqs[0].sweep_key()
    runner = BatchRunner(bucket_key(key, lanes[0].program, 100), lanes, 8,
                         device)
    while not runner.done:
        runner.advance()
    run_stats = runner.finalize()
    t0 = time.perf_counter()
    plain, err, variants, plain_state = phases_against_plain(
        key.cfg, runner.progs,
        lambda: init_state(key.cfg, [ln.fifo_depth for ln in lanes],
                           [ln.max_credits for ln in lanes], device=device),
        (200, 400, 400), "[service] batch", check_every=100)
    bad = [n for n, a, b in zip(STATE_LEAVES, flatten_state(runner.states),
                                flatten_state(plain_state))
           if not bool((a == b).all())]
    check(not bad, f"[service] the service batch's state differs from "
                   f"the plain version's on {bad}")
    for i, t in enumerate(tickets):
        lane = type(plain)(*(f[i:i + 1] for f in plain))
        check(_same_stats(lane, run_stats[i])
              and _same_stats(lane, t.response.stats),
              f"[service] lane {i}: PhaseStats differ from the plain "
              f"version's")
    print(f"[service] the batch (8 lanes x 16x32, 10 blocks of 100, "
          f"variants {sorted(set(variants))}) through BatchRunner and "
          f"router_step_plain side by side in "
          f"{time.perf_counter() - t0:.1f} s: every state leaf and "
          f"PhaseStats field identical (max_abs_err {err}), and equal to "
          f"the service's responses")

    # (2) the same requests at check_every 500: blocks of 200, 400, 400
    reqs500 = service_requests(500)
    svc500 = SimService(max_batch=8, device=device)
    got500, by_variant500 = counted(lambda: svc500.run(reqs500))
    print(f"[service] check_every 500: {svc500.metrics.ticks} ticks, "
          f"router_step launches by variant {by_variant500}")
    check(by_variant500 == {"direct": 1, "packed": 2},
          f"[service] check_every 500 ran {by_variant500}, not 1 direct "
          f"(200) + 2 packed (400, 400)")
    check(all(_same_stats(a.stats, t.response.stats)
              for a, t in zip(got500, tickets)),
          "[service] check_every 500 changed a response")
    # its blocks of 200, 400 and 400 (the two packed) through BatchRunner
    # and the plain version side by side (comparison launches: uncounted)
    runner = BatchRunner(bucket_key(key, lanes[0].program, 500), lanes, 8,
                         device)
    while not runner.done:
        runner.advance()
    run500 = runner.finalize()
    t0 = time.perf_counter()
    plain500, err500, variants500, plain_state = phases_against_plain(
        key.cfg, runner.progs,
        lambda: init_state(key.cfg, [ln.fifo_depth for ln in lanes],
                           [ln.max_credits for ln in lanes], device=device),
        (200, 400, 400), "[service] batch at check_every 500",
        check_every=500)
    check(variants500 == ["direct", "packed", "packed"],
          f"[service] check_every 500 compared {variants500}")
    bad = [n for n, a, b in zip(STATE_LEAVES, flatten_state(runner.states),
                                flatten_state(plain_state))
           if not bool((a == b).all())]
    check(not bad, f"[service] the check_every 500 batch's state differs "
                   f"from the plain version's on {bad}")
    for i, a in enumerate(got500):
        lane = type(plain500)(*(f[i:i + 1] for f in plain500))
        check(_same_stats(lane, run500[i]) and _same_stats(lane, a.stats),
              f"[service] check_every 500, lane {i}: PhaseStats differ "
              f"from the plain version's")
    print(f"[service] the check_every 500 batch (blocks of 200, 400, 400: "
          f"{variants500}) through BatchRunner and router_step_plain side "
          f"by side in {time.perf_counter() - t0:.1f} s: every state leaf "
          f"and PhaseStats field identical (max_abs_err {err500}), and "
          f"equal to the service's responses")

    # (3) two sweeps on 16x16, mesh and torus: 2 buckets of 8 + 4 lanes
    sweeps = [SweepRequest(cfg=sweep_config(16, 16, Topology.parse(k)),
                           warmup=300, measure=500, drain=500, seed=0)
              for k in ("mesh", "torus")]
    svc3 = SimService(max_batch=8, device=device)
    t0 = time.perf_counter()
    curves, by_variant3 = counted(lambda: svc3.run(sweeps))
    sweep_wall = time.perf_counter() - t0
    m3 = svc3.metrics
    buckets = {c.metrics["bucket"] for c in curves}
    print(f"[service] {card}: 2 SweepRequests (16x16 mesh and torus, 12 "
          f"rates, 300/500/500): {len(buckets)} buckets, {m3.batches} "
          f"batches, {m3.ticks} ticks, {m3.blocks} blocks, wall "
          f"{sweep_wall:.3f} s; router_step launches by variant "
          f"{by_variant3}; knees mesh {curves[0].curve['saturation_rate']}"
          f", torus {curves[1].curve['saturation_rate']}")
    check(len(buckets) == 2 and m3.batches == 4 and m3.ticks == 26
          and m3.blocks == 52 and all(c.metrics["batch_width"] == 4
                                      for c in curves),
          f"[service] sweeps: {m3.snapshot()}, buckets {buckets}")
    check(by_variant3 == {"direct": 52, "packed": 0},
          f"[service] sweeps ran {by_variant3}, not one direct call per "
          f"bucket per tick")
    knees = {k: c.curve["saturation_rate"]
             for k, c in zip(("mesh", "torus"), curves)}
    check(knees == DSE_KNEES, f"[service] sweep knees {knees}")
    for k, c in zip(("mesh", "torus"), curves):
        ref = load_latency_sweep("uniform", 16, 16, DEFAULT_SWEEP_RATES,
                                 warmup=300, measure=500, drain=500,
                                 cfg=sweep_config(16, 16, Topology.parse(k)),
                                 seed=0, device=device)
        for f in c.stats[0]._fields:
            check(all(np.array_equal(np.asarray(getattr(s, f)), ref[f][i])
                      for i, s in enumerate(c.stats)),
                  f"[service] {k} sweep: {f} differs from "
                  f"load_latency_sweep's")
        check(c.curve["saturation_index"] == ref["saturation_index"]
              and c.curve["monotone"] == ref["monotone"],
              f"[service] {k} curve summary differs")
    print("[service] each curve equals load_latency_sweep on the card, "
          "field by field and rate by rate")

    # (4) backpressure, then the async surface
    def backpressure():
        small = SimService(max_batch=8, queue_limit=8, device=device)
        refused = []
        for req in [sweeps[0]] + reqs + [reqs[0]]:
            try:
                small.submit(req)
            except ServiceOverloaded:
                refused.append(req)
        small.server.run_until_idle()
        again = small.submit(reqs[0])
        small.server.run_until_idle()
        return small, refused, again
    (small, refused, again), _ = counted(backpressure)
    check(len(refused) == 2 and refused[0] is sweeps[0]
          and small.metrics.rejected == 2
          and small.metrics.peak_pending == 8 and again.done
          and _same_stats(again.response.stats, tickets[0].response.stats),
          f"[service] backpressure: {small.metrics.snapshot()}")

    async def two_consumers():
        server = SimServer(max_batch=8, device=device)
        t1, t2 = server.submit(reqs[0]), server.submit(reqs[0])
        serve = asyncio.ensure_future(server.serve(until_idle=True))

        async def consume(t):
            return [c async for c in t.stream()], await t.result()
        out = await asyncio.gather(consume(t1), consume(t2))
        await serve
        return out
    streamed, _ = counted(lambda: asyncio.run(two_consumers()))
    check(all(_same_chunks(c, tickets[0].chunks)
              and _same_stats(r.stats, tickets[0].response.stats)
              for c, r in streamed),
          "[service] the async consumers differ from the sync facade")
    print("[service] queue_limit 8: the 12-lane sweep and a 9th lane "
          "refused (ServiceOverloaded), admission reopened after the "
          "drain; two Ticket.stream() consumers under serve(until_idle="
          "True) got the sync facade's chunks and stats")

    # (5) cold and warm: a second instance, then two fresh processes
    warm = SimService(max_batch=8, device=device)
    warm_ticks = []

    def run_warm():
        t0 = time.perf_counter()
        got = [warm.submit(r) for r in reqs]
        submit = time.perf_counter() - t0
        while not warm.server.idle:
            t = time.perf_counter()
            warm.server.tick()
            warm_ticks.append(time.perf_counter() - t)
        return got, submit, time.perf_counter() - t0
    (again8, warm_submit, warm_wall), _ = counted(run_warm)
    check(warm.metrics.sim_compiles == 0 and warm.metrics.aux_compiles == 0
          and all(_same_stats(a.response.stats, t.response.stats)
                  for a, t in zip(again8, tickets)),
          f"[service] the warm instance: {warm.metrics.snapshot()}")
    cold = service_processes()
    print(f"[service] a second SimService in this process: 0 new shapes "
          f"(the first: {m.sim_compiles} + {m.aux_compiles}); two "
          f"processes on a fresh compile_cache_dir: {cold}")

    # (6) times, written down and not gated: the first run in the process
    # pays the CUDA modules' first loads, so the per-tick times are the
    # warm instance's; its first tick forms the batch, its last reduces.
    # The device's share of a block comes from the profiler over one more
    # warm batch of the same shape (its blocks only), apart from the
    # unprofiled ticks: the router's kernels, and all of the device's work
    # (the kernels and the block's read to the host)
    bkey = bucket_key(key, lanes[0].program, 100)
    runner = BatchRunner(bkey, lanes, 8, device)
    router_ms, busy_ms = _profiled_blocks(runner)
    tick_ms = [t * 1e3 for t in warm_ticks]
    steady = float(np.mean(tick_ms[1:-1]))
    padded = padded_lane_cost(device, key, lanes)
    t0 = time.perf_counter()                  # the first tick's host part
    stack_lanes(lanes, bkey.prog_len, 8)
    stack_ms = (time.perf_counter() - t0) * 1e3
    bound_us = cycle_bytes(key.cfg, 8) / H100_BYTES_PER_S * 1e6
    if router_ms:
        device_part = (
            f"per block the router's kernels {router_ms:.4f} ms of device "
            f"time (the profiler, the 10 blocks' mean; {router_ms * 10:.3f} "
            f"us a cycle against a byte bound of {bound_us:.4f} us), all "
            f"of the block's device work {busy_ms:.4f} ms, against a steady "
            f"tick's host wall {steady:.3f} ms (host share "
            f"{1 - busy_ms / steady:.3f})")
    else:
        device_part = ("per block the router's device time not measured "
                       "(the profiler saw no device work)")
    print(f"[service] {card}: 8 requests through the service: first run "
          f"{wall:.3f} s (first tick {ticks[0] * 1e3:.1f} ms, last "
          f"{ticks[-1] * 1e3:.1f} ms), warm {warm_wall:.3f} s, of which "
          f"submit (building 8 programs on the host) {warm_submit:.3f} s; "
          f"8 sequential direct phased_stats runs {direct_s:.3f} s")
    print(f"[service] {card}: warm ticks {np.mean(tick_ms):.3f} ms on "
          f"average: the first (forming the batch: programs padded, "
          f"stacked, copied; the state made) {tick_ms[0]:.3f} ms, the last "
          f"(block + reduce + responses) {tick_ms[-1]:.3f} ms, the 8 "
          f"between {steady:.3f} ms; padding and stacking the 8 programs "
          f"on the host alone {stack_ms:.3f} ms; {device_part}; padded "
          f"lanes: {padded}")
    return total, {"wall": wall, "warm_wall": warm_wall,
                   "submit_s": warm_submit, "direct_s": direct_s,
                   "tick_ms": steady, "block_router_ms": router_ms,
                   "block_device_ms": busy_ms}


def _profiled_blocks(runner):
    """Run ``runner``'s fence blocks under ``torch.profiler``; returns the
    device time per block, in ms, of the router's kernels and of all the
    device's work (0.0 where the profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    blocks = len(runner.schedule)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while not runner.done:
            runner.advance()
        torch.cuda.synchronize()
    router = busy = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy += us
        if any(k in ev.name for k in ROUTER_KERNELS):
            router += us
    return router / 1e3 / blocks, busy / 1e3 / blocks


def padded_lane_cost(device, key, lanes, real=5, width=8):
    """The router's device time per block (the profiler) for ``real`` of
    the requests' lanes run unpadded and padded to ``width`` (lane 0
    repeated), in turns: padded, unpadded, unpadded, padded."""
    import numpy as np
    from repro_torch.sim_service import BatchRunner, bucket_key
    bkey = bucket_key(key, lanes[0].program, 100)
    ms = {real: [], width: []}
    for w in (width, real, real, width):
        ms[w].append(_profiled_blocks(BatchRunner(bkey, lanes[:real], w,
                                                  device))[0])
    a, b = np.mean(ms[real]), np.mean(ms[width])
    if not a:
        return "not measured (the profiler saw no device work)"
    return (f"{real} lanes padded to {width}: {b:.4f} ms a block against "
            f"{a:.4f} ms unpadded (+{(b / a - 1) * 100:.1f}% for "
            f"{width - real} padded lanes)")


SERVICE_PROCESS = """
import json, sys
from repro_torch.mesh import MeshConfig
from repro_torch.sim_service import SimRequest, SimService
svc = SimService(max_batch=8, compile_cache_dir=sys.argv[1])
r = svc.run_one(SimRequest(cfg=MeshConfig(nx=16, ny=32, router_fifo=16,
                                          max_out_credits=128),
                           load=0.3, check_every=100))
snap = svc.metrics.snapshot()
print(json.dumps({"cache": snap["compilation_cache"],
                  "new_shapes": snap["sim_compiles"] + snap["aux_compiles"],
                  "lat_mean": float(r.stats.lat_mean)}))
"""


def service_processes():
    """Two processes, one after the other, each serving one request with
    the same fresh ``compile_cache_dir``: the first builds the router
    library there, the second loads it without building."""
    import tempfile
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_TORCH_BUILD_DIR"}
    env["PYTHONPATH"] = os.path.join(HERE, "src")
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", SERVICE_PROCESS, tmp],
                               capture_output=True, text=True, timeout=600,
                               env=env)
            check(p.returncode == 0, f"[service] a service process failed:"
                                     f"\n{p.stderr[-3000:]}")
            out = json.loads(p.stdout.strip().splitlines()[-1])
            out["wall_s"] = round(time.perf_counter() - t0, 2)
            outs.append(out)
    first, second = (o["cache"] for o in outs)
    check(first["built"] == 1 and first["loaded"] == 0
          and second["built"] == 0 and second["loaded"] == 1
          and first["entries"] == second["entries"] == 1
          and outs[0]["lat_mean"] == outs[1]["lat_mean"],
          f"[service] compile_cache_dir across processes: {outs}")
    return (f"the first built the router library ({outs[0]['wall_s']} s "
            f"wall), the second loaded it from disk without nvcc "
            f"({outs[1]['wall_s']} s), equal responses: {outs}")


# ----------------------------------------------------------------------
# the model stack: Jamba served through the flash, SSD and GMM kernels
# ----------------------------------------------------------------------
JAMBA, MIXTRAL = "jamba-v0.1-52b", "mixtral-8x7b"
QWEN2_VL, MAMBA2 = "qwen2-vl-72b", "mamba2-370m"
MOONSHOT, STABLELM = "moonshot-v1-16b-a3b", "stablelm-3b"
WHISPER = "whisper-large-v3"
PREFILL_TOKENS = 4096          # batch 1 x 4096 tokens
MIXTRAL_TOKENS = 8192          # twice Mixtral's 4096-token window
WHISPER_CLIPS = 4              # 4 clips of 1500 frames each
WHISPER_TOKENS = 448           # Whisper's published decoder context
WHISPER_FRAMES = 1500          # its encoder_seq: 30 s of audio
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core rate, SXM data sheet
# The training paths (phase 11): Mamba-2 370M whole at 8 x 4096 tokens,
# Moonshot's widths (2 of 48 layers) at 1 x 4096, both with full remat.
TRAIN_SEQ = 4096
MAMBA2_TRAIN_BATCH, MAMBA2_TRAIN_STEPS = 8, 6
# checkpoints at 5 and 6 (the last; each write, async, slows the next
# step, so the warm steps timed are 3 and 4); step 5 resumed
MAMBA2_CKPT_EVERY = 5
MAMBA2_FAULT_AT = 2            # a fault injected at this step, retried
MOONSHOT_TRAIN_LAYERS, MOONSHOT_TRAIN_STEPS = 2, 10
# Moonshot again under each other remat policy, 3 steps from the same
# weights on the same batch: losses against the full-remat run's first 3
MOONSHOT_REMAT_STEPS = 3
# The model kernels' shapes on the main paths: (name, arch, batch, Sq, Sk,
# causal) of each flash call of a prefill or a training step, (name, arch,
# tokens) of each expert FFN's GMM pair (gate/up and down at the capacity
# of ``tokens``: a prefill or a training step's forward, or a decode tick
# of 4 slots) and (name, arch, S, batch) of each SSD call of a prefill or
# a training step.
FLASH_CASES = (
    ("Jamba prefill", JAMBA, 1, PREFILL_TOKENS, PREFILL_TOKENS, True),
    ("Mixtral prefill", MIXTRAL, 1, MIXTRAL_TOKENS, MIXTRAL_TOKENS, True),
    ("Qwen2-VL prefill", QWEN2_VL, 1, PREFILL_TOKENS, PREFILL_TOKENS, True),
    ("StableLM hd 80", STABLELM, 1, PREFILL_TOKENS, PREFILL_TOKENS, True),
    ("Whisper encoder", WHISPER, WHISPER_CLIPS, WHISPER_FRAMES,
     WHISPER_FRAMES, False),
    ("Whisper cross", WHISPER, WHISPER_CLIPS, WHISPER_TOKENS, WHISPER_FRAMES,
     False),
    ("Whisper decoder self", WHISPER, WHISPER_CLIPS, WHISPER_TOKENS,
     WHISPER_TOKENS, True),
    ("Moonshot train", MOONSHOT, 1, TRAIN_SEQ, TRAIN_SEQ, True))
GMM_CASES = (("Jamba prefill", JAMBA, PREFILL_TOKENS),
             ("Jamba decode", JAMBA, 4),
             ("Mixtral prefill", MIXTRAL, MIXTRAL_TOKENS),
             ("Mixtral decode", MIXTRAL, 4),
             ("Moonshot prefill", MOONSHOT, PREFILL_TOKENS))
SSD_CASES = (("Jamba", JAMBA, PREFILL_TOKENS, 1),
             ("Mamba-2", MAMBA2, PREFILL_TOKENS, 1),
             ("Mamba-2 train", MAMBA2, TRAIN_SEQ, MAMBA2_TRAIN_BATCH))


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


def _rnd(device, dtype, seed):
    import torch
    g = torch.Generator(device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device)
                * scale).to(dtype)
    return rnd, g


def _flash_inputs(device, dtype, arch, B, Sq, Sk, seed):
    """q (B, H, Sq, hd), k, v (B, K, Sk, hd) at ``arch``'s widths, and its
    window."""
    from repro_torch.configs import get_config
    c = get_config(arch)
    rnd, _ = _rnd(device, dtype, seed)
    H, K, hd = c.num_heads, c.num_kv_heads, c.head_dim
    return (rnd(B, H, Sq, hd), rnd(B, K, Sk, hd), rnd(B, K, Sk, hd),
            c.sliding_window)


def _gmm_inputs(device, dtype, arch, tokens, seed):
    """{"gate/up": (lhs, rhs), "down": (lhs, rhs)} of ``arch``'s expert FFN
    at the capacity of ``tokens`` tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    c = get_config(arch)
    rnd, _ = _rnd(device, dtype, seed)
    m, D, Fe = capacity(tokens, c.moe), c.d_model, c.moe.d_ff_expert
    E = c.moe.num_experts
    return {"gate/up": (rnd(E, m, D), rnd(E, D, Fe, scale=D ** -0.5)),
            "down": (rnd(E, m, Fe), rnd(E, Fe, D, scale=Fe ** -0.5))}


def _ssd_inputs(device, dtype, arch, S, seed, batch=1):
    """(x, dt, B, C, A as kwargs, chunk) of one of ``arch``'s SSD calls on
    ``batch`` sequences of S tokens; A is the models' initial
    -linspace(1, 16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    c = get_config(arch)
    s = c.ssm
    rnd, g = _rnd(device, dtype, seed)
    nh, G = s.num_heads(c.d_model), s.num_groups
    return dict(x=rnd(batch, nh, S, s.head_dim, scale=0.5),
                dt=(F.softplus(torch.randn(batch, nh, S, generator=g,
                                           device=device)) * 0.1).to(dtype),
                B=rnd(batch, G, S, s.state_dim, scale=0.5),
                C=rnd(batch, G, S, s.state_dim, scale=0.5),
                A=-torch.linspace(1.0, 16.0, nh, device=device)), s.chunk


def kernels_vs_plain(device):
    """Each model kernel against its plain version at every main path's
    shapes (FLASH_CASES, GMM_CASES, SSD_CASES), in fp32 and in bf16, each
    asserting the variant it ran (bf16: flash ``wgmma_tma``, SSD
    ``tensor_core``, GMM ``tma`` in prefill and ``decode`` in decode; fp32:
    ``f32`` and ``cuda_core``); and the GMM's ``ragged`` variant on an lhs
    TMA cannot describe.  Returns {case: bf16 max_abs_err}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for name, arch, B, Sq, Sk, causal in FLASH_CASES:
            q, k, v, window = _flash_inputs(device, dtype, arch, B, Sq, Sk, 0)
            out, var = _variant_of(fa.flash_attention, lambda: fa
                                   .flash_attention(q, k, v, causal=causal,
                                                    window=window))
            check(var == ("wgmma_tma" if bf16 else "f32"),
                  f"flash_attention {name} ran the {var} variant")
            errs["flash " + name] = _compare(
                "flash_attention", f"{name} q {tuple(q.shape)} k/v "
                f"{tuple(k.shape)} {'causal' if causal else 'non-causal'} "
                f"window {window} [{var}]", out,
                ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window))
            del q, k, v, out
            torch.cuda.empty_cache()
        for name, arch, tokens in GMM_CASES:
            for part, (lhs, rhs) in _gmm_inputs(device, dtype, arch, tokens,
                                                0).items():
                out, var = _variant_of(gmm_mod.grouped_matmul,
                                       lambda: gmm_mod.grouped_matmul(lhs,
                                                                      rhs))
                want = "f32" if not bf16 else \
                    "decode" if "decode" in name else "tma"
                check(var == want, f"moe_gmm {name} {part} ran the {var} "
                      "variant")
                errs[f"gmm {name} {part}"] = _compare(
                    "moe_gmm", f"{name} {part} {tuple(lhs.shape)}@"
                    f"{tuple(rhs.shape)} [{var}]", out,
                    ref.grouped_matmul_ref(lhs, rhs))
                del lhs, rhs, out
            torch.cuda.empty_cache()
        if bf16:
            # the ragged variant (WMMA) on Jamba's prefill operands: an lhs
            # one element off 16-byte alignment, which TMA cannot take
            lhs, rhs = _gmm_inputs(device, dtype, JAMBA, PREFILL_TOKENS,
                                   0)["gate/up"]
            buf = torch.empty(lhs.numel() + 1, dtype=dtype, device=device)
            off = buf[1:].view(lhs.shape).copy_(lhs)
            out, var = _variant_of(gmm_mod.grouped_matmul,
                                   lambda: gmm_mod.grouped_matmul(off, rhs))
            check(var == "ragged", f"moe_gmm misaligned lhs ran the {var} "
                  "variant")
            _compare("moe_gmm", f"Jamba prefill gate/up, lhs 1 element off "
                     f"alignment {tuple(lhs.shape)}@{tuple(rhs.shape)} "
                     f"[{var}]", out, ref.grouped_matmul_ref(lhs, rhs))
            del out, off, buf, lhs, rhs
        for name, arch, S, batch in SSD_CASES:
            ssd, chunk = _ssd_inputs(device, dtype, arch, S, 0, batch)
            y, var = _variant_of(ssd_mod.ssd_scan, lambda: ssd_mod.ssd_scan(
                **ssd, chunk=chunk))
            check(var == ("tensor_core" if bf16 else "cuda_core"),
                  f"ssd_scan {name} ran the {var} variant")
            errs["ssd " + name] = _compare(
                "ssd_scan", f"{name} x {tuple(ssd['x'].shape)} N="
                f"{ssd['B'].shape[-1]} chunk {chunk} [{var}]", y,
                ref.ssd_scan_ref(**ssd))
            del y, ssd
        torch.cuda.empty_cache()
    return errs


def reduced_end_to_end(device, arch=JAMBA, seq=40, positions=False):
    """The reduced model of ``arch`` (fp32, capacity factor 8 so no token
    drops) on the card through the kernels against the CPU through the
    plain versions (logits within 2e-4, the tolerance of
    tests/test_models.py), every kernel of the model launched; then
    teacher-forced ``decode_step`` on the card against ``forward`` on the
    card (for the reduced Mixtral, window 16, at ``seq`` 50: the cache
    wraps three times).  ``positions``: distinct (3, B, S) M-RoPE
    positions, forward only.  Whisper (encoder_seq 20, so its cross KV is
    padded to 32) runs on frames from a seed, and decodes against a cache
    whose cross KV is filled from the card's encoder output.  Returns the
    largest logit difference."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_params
    cfg = reduced_config(get_config(arch))
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, encoder_seq=20))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    Model = get_model(cfg)
    card = Model(cfg, device, params={k: v.to(device)
                                      for k, v in cpu_params.items()})
    cpu = Model(cfg, "cpu", params=cpu_params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, seq)))
    pos, frames = None, {}
    if positions:
        i = torch.arange(seq)
        pos = torch.stack([i // 4, i // 2, i])[:, None].expand(3, 2, seq) \
            + torch.tensor([0, 1])[None, :, None]
    if cfg.encdec is not None:
        frames = {"frames": torch.from_numpy(np.random.default_rng(1)
                                             .standard_normal(
            (2, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32))}
    zero_counts()
    on_card, _ = card(tokens.to(device),
                      positions=None if pos is None else pos.to(device),
                      **{k: v.to(device) for k, v in frames.items()})
    torch.cuda.synchronize()
    counts = read_counts()
    on_cpu, _ = cpu(tokens, positions=pos, **frames)
    err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"[reduced] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, window {cfg.sliding_window}, fp32, 2 x {seq} "
          f"tokens{', distinct (3, B, S) positions' if positions else ''}: "
          f"card (kernels, launches {counts}) vs CPU (plain versions) max "
          f"logit difference {err:.3e} (tolerance 2e-4)")
    want = {"flash_attention": cfg.family != "ssm",
            "ssd_scan": cfg.ssm is not None,
            "moe_gmm": cfg.moe is not None}
    check({k: n > 0 for k, n in counts.items()} == want,
          f"the reduced forward's kernels {counts}, expected {want}")
    check(err <= 2e-4, f"reduced {arch}: card and CPU logits differ by {err}")
    if positions:
        return err
    if frames:
        cache = card.init_cache(2, seq, enc_out=card.encode(
            frames["frames"].to(device)))
    else:
        cache = card.init_cache(2, seq)
    steps = []
    for i in range(seq):
        lg, cache = card.decode_step(cache, tokens[:, i].to(device))
        steps.append(lg)
    derr = float((torch.stack(steps, 1) - on_card).abs().max())
    held = f"{cache['k'].shape[2]} KV cache slots" if "k" in cache else \
        "the recurrent state"
    print(f"[reduced] {cfg.name}: teacher-forced decode_step vs forward on "
          f"the card ({held}): max logit difference {derr:.3e} (tolerance "
          f"2e-4)")
    check(derr <= 2e-4, f"reduced {arch}: decode differs from forward by "
          f"{derr}")
    return max(err, derr)


def draw_params(device, cfg):
    """``init_params`` of ``cfg`` on the card: (params, bytes, seconds)."""
    import torch
    from repro_torch.models.convert import init_params
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    return params, nbytes, time.perf_counter() - t0


def _prefill_batch(device, cfg, B, seq, seed, positions=False):
    """The batch of a full-width prefill: B x ``seq`` tokens from a seed,
    with (3, B, S) text positions when ``positions``, and for the audio
    family B clips of ``encoder_seq`` bf16 frames (the stubbed frontend's
    embeddings) from the same seed."""
    import numpy as np
    import torch
    batch = {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, seq))).to(device)}
    if positions:
        batch["positions"] = torch.arange(seq, device=device).expand(3, B, seq)
    if cfg.encdec is not None:
        g = torch.Generator(device).manual_seed(seed)
        batch["frames"] = torch.randn(
            B, cfg.encdec.encoder_seq, cfg.d_model, generator=g,
            device=device).to(cfg.param_dtype)
    return batch


def prefill_path(device, cfg, params, seq, want, label, positions=False,
                 B=1):
    """The main path's prefill at full width: batch B x ``seq`` tokens
    through ``prefill_step`` (:func:`_prefill_batch`), the launch counts
    set to 0 just before and read just after; ``want`` {kernel: {variant:
    launches}} must be exactly what ran (every other kernel and variant
    0).  Two prefills of the same batch must be equal.  Returns its
    record."""
    import torch
    from repro_torch.launch.step import prefill_step
    from repro_torch.models import get_model
    model = get_model(cfg)(cfg, device, params=params)
    batch = _prefill_batch(device, cfg, B, seq, 0, positions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits = prefill_step(model, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    variants = read_variants()
    check(tuple(logits.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"{label} prefill logits {tuple(logits.shape)} not finite of "
          f"({B}, V)")
    t0 = time.perf_counter()
    again = prefill_step(model, batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(torch.equal(again, logits), f"{label}: two prefills of the same "
          "tokens differ")
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    nparams = sum(p.numel() for p in params.values())
    clips = f" and {B} x {cfg.encdec.encoder_seq} frames" \
        if cfg.encdec is not None else ""
    print(f"[prefill] {label} ({nparams / 1e9:.2f} B parameters, "
          f"{nbytes / 2**30:.2f} GiB bf16): {B} x {seq} tokens{clips}, wall "
          f"{wall:.3f} s ({B * seq / wall:.0f} tokens/s); again {warm:.3f} s "
          f"({B * seq / warm:.0f} tokens/s); launches {counts} by variant "
          f"{variants}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for k, n in counts.items():
        check(n == sum(want.get(k, {}).values()), f"{label} prefill: {k} "
              f"launched {n} times, expected {want.get(k, {})}")
        for v, m in want.get(k, {}).items():
            check(variants[k][v] == m, f"{label} prefill: {k} variants "
                  f"{variants[k]}, expected {want[k]}")
    del model, logits, again
    return {"wall": wall, "warm": warm, "counts": counts,
            "variants": variants, "seq": seq, "batch": B}


def server_path(device, cfg, params, per_tick, label, requests=8, prompt=8,
                max_new=8, slots=4, max_seq=64):
    """The continuous-batching ``Server`` at full width on the prefill's
    weights, the launch counts set to 0 just before and read just after:
    every request completes, and each tick launches exactly ``per_tick``
    {kernel: {variant: launches}} (every other kernel and variant 0)."""
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
    print(f"[server] {label}: {requests} requests x {prompt} prompt tokens, "
          f"max_new {max_new}, {slots} slots, max_seq {max_seq}: "
          f"{len(done)} completed, {toks} tokens in {ticks} ticks, wall "
          f"{wall:.3f} s ({toks / wall:.1f} generated tokens/s, "
          f"{wall / ticks * 1e3:.1f} ms per tick); launches {counts} by "
          f"variant {variants}")
    check(len(done) == requests and all(len(r.out) == max_new for r in done),
          f"{label}: not every request completed")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f"{label}: a token outside the vocabulary")
    for k, n in counts.items():
        check(n == ticks * sum(per_tick.get(k, {}).values()),
              f"{label} server: {k} launched {n} times in {ticks} ticks, "
              f"expected {per_tick.get(k, {})} per tick")
        for v, m in per_tick.get(k, {}).items():
            check(variants[k][v] == m * ticks, f"{label} server: {k} "
                  f"variants {variants[k]}, expected {per_tick[k]} per tick")
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


def model_profile(device, cfg, params, label, seq=PREFILL_TOKENS,
                  ticks=10, positions=False, B=1):
    """Where the time goes: ``torch.profiler`` over one warm full-width
    prefill of B x ``seq`` tokens and over ``ticks`` steady server ticks
    (4 slots generating), device time by kernel category and the device's
    idle share of the host wall time (the profiler's own cost is in the
    wall time)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.step import prefill_step
    from repro_torch.models import get_model
    card = card_line()
    model = get_model(cfg)(cfg, device, params=params)
    batch = _prefill_batch(device, cfg, B, seq, 2, positions)
    prefill_step(model, batch)
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
    for what, fn, n in ((f"prefill {B} x {seq}", lambda: prefill_step(
            model, batch), 1),
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
        print(f"[where the time goes] {card}: {label}: {what}: wall "
              f"{wall / n * 1e3:.1f} ms per {'step' if n == 1 else 'tick'} "
              f"under the profiler, device busy {busy / n * 1e3:.1f} ms "
              f"(idle share {idle:.3f}); {parts}")
        out[what] = dict(wall=wall / n, busy=busy / n, idle=idle,
                         cats={k: v / 1e3 / n for k, v in cats.items()})
    del model, server
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


def kernel_timings(device):
    """Kernel, plain version, library call and bound at every main path's
    shapes (bf16, CUDA events): flash beside SDPA (causal; with a window,
    the band as an explicit mask, and the kernel at the same shape without
    the window), naming the kernel SDPA ran; the GMM beside ``torch.bmm``;
    the SSD with no library call, beside the models' own chunked PyTorch
    (``models/mamba2.py::ssd_chunked``, a yardstick), its three passes'
    device time from the profiler and its fp32 (``cuda_core``) time.
    Returns {case: record}."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models.mamba2 import ssd_chunked
    card = card_line()
    out = {}
    for name, arch, B, Sq, Sk, causal in FLASH_CASES:
        q, k, v, window = _flash_inputs(device, torch.bfloat16, arch, B, Sq,
                                        Sk, 1)
        nb, ops = fa.flash_bound(q, k, causal=causal, window=window)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
            libname = (f"scaled_dot_product_attention("
                       f"{'is_causal, ' if causal else ''}enable_gqa)")
        else:
            i = torch.arange(Sq, device=device)
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=band, enable_gqa=True)
            libname = "scaled_dot_product_attention(band attn_mask, " \
                "enable_gqa)"
        r = dict(ms=_event_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), 5),
            plain_ms=_event_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window), 1),
            library_ms=_event_ms(lib, 5), library=libname,
            library_kernel=_sdpa_backend(lib),
            bound=_bound(nb, ops, BF16_OPS_PER_S), nbytes=nb, ops=ops,
            shape=f"{name}: q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
                  f"{'causal' if causal else 'non-causal'}, window {window}")
        if window is not None:
            r["no_window_ms"] = _event_ms(lambda: fa.flash_attention(
                q, k, v, causal=True), 5)
            r["no_window_bound"] = _bound(*fa.flash_bound(q, k, causal=True),
                                          BF16_OPS_PER_S)
        out["flash " + name] = r
        del q, k, v, lib
        torch.cuda.empty_cache()
    for name, arch, tokens in GMM_CASES:
        for part, (lhs, rhs) in _gmm_inputs(device, torch.bfloat16, arch,
                                            tokens, 1).items():
            nb, ops = gmm_mod.gmm_bound(lhs, rhs)
            out[f"gmm {name} {part}"] = dict(
                ms=_event_ms(lambda: gmm_mod.grouped_matmul(lhs, rhs), 5),
                plain_ms=_event_ms(lambda: ref.grouped_matmul_ref(lhs, rhs),
                                   2),
                library_ms=_event_ms(lambda: torch.bmm(lhs, rhs), 5),
                library="torch.bmm", bound=_bound(nb, ops, BF16_OPS_PER_S),
                nbytes=nb, ops=ops,
                shape=f"{name} {part} {tuple(lhs.shape)}@{tuple(rhs.shape)}")
            del lhs, rhs
    for name, arch, S, batch in SSD_CASES:
        ssd, chunk = _ssd_inputs(device, torch.bfloat16, arch, S, 1, batch)
        nb, ops = ssd_mod.ssd_bound(ssd["x"], ssd["B"], chunk)
        models_layout = [ssd[k].transpose(1, 2) for k in ("x", "dt", "B",
                                                          "C")]
        out["ssd " + name] = dict(
            ms=_event_ms(lambda: ssd_mod.ssd_scan(**ssd, chunk=chunk), 10),
            plain_ms=_event_ms(lambda: ref.ssd_scan_ref(**ssd), 1),
            library_ms=None, library=None,
            bound=_bound(nb, ops, BF16_OPS_PER_S), nbytes=nb, ops=ops,
            shape=f"{name} x {tuple(ssd['x'].shape)}, N="
                  f"{ssd['B'].shape[-1]}, chunk {chunk}",
            yardstick_ms=_event_ms(lambda: ssd_chunked(
                *models_layout, ssd["A"], chunk=chunk), 3))
        # the fp32 inputs take ``cuda_core``, at its own chunk
        ssd32 = {k: v.float() for k, v in ssd.items()}
        out["ssd " + name].update(
            fp32_ms=_event_ms(lambda: ssd_mod.ssd_scan(**ssd32, chunk=chunk),
                              3),
            fp32_chunk=ssd_mod.cuda_core_chunk(chunk, ssd["x"].shape[-1],
                                               ssd["B"].shape[-1]))
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
            kind = next((k for k in ("ssd_state_", "ssd_pass_", "ssd_out_")
                         if k in ev.key), None)
            if kind and us:
                passes[kind.strip("_")] = us / 5
        print(f"[times] {card}: ssd_scan {name} device time per call by "
              f"pass: " + ", ".join(f"{k} {v:.1f} us"
                                    for k, v in passes.items()))
        del ssd, ssd32, models_layout
    for key, r in out.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library']} {r['library_ms']:.4f} ms"
        extra = ""
        if "library_kernel" in r:
            extra += f" (its longest kernel: {r['library_kernel']})"
        if "no_window_ms" in r:
            extra += (f"; the kernel without the window "
                      f"{r['no_window_ms']:.4f} ms, bound "
                      f"{r['no_window_bound'][0]:.4f} ms")
        if "yardstick_ms" in r:
            extra += (f"; yardstick (not a library call): the models' plain "
                      f"chunked PyTorch (models/mamba2.py::ssd_chunked, "
                      f"cuBLAS) {r['yardstick_ms']:.4f} ms")
        if "fp32_ms" in r:
            extra += (f"; fp32 (cuda_core, chunk {r['fp32_chunk']}) "
                      f"{r['fp32_ms']:.4f} ms")
        print(f"[times] {card}: {key}, {r['shape']}, bf16: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound'][0]:.4f} ms by {r['bound'][1]} "
              f"({r['nbytes']} B, {r['ops']} FLOP){extra}")
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


def _sdpa_backend(fn, reps=3):
    """The attention kernel a PyTorch call ran, by the profiler's name of
    its longest device kernel over ``reps`` calls; where the profiler
    caught no device kernel, the backend op SDPA dispatched to."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    longest, ops = {}, set()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            longest[ev.name] = longest.get(ev.name, 0) + \
                ev.time_range.elapsed_us()
        elif ev.name.startswith("aten::_scaled_dot_product_"):
            ops.add(ev.name)
    if longest:
        return max(longest, key=longest.get)[:80]
    return (", ".join(sorted(ops)) or "not measured") + \
        " (no device kernel in the profile)"


def endpoint_scenario(device, nx=16, ny=32, words=256, seed=0):
    """The paper's reactive endpoints on the 16x32 array through the
    facade on the card, against the same scenario on the numpy backend.

    From ``seed``: 16 distinct endpoint tiles and 16 distinct target
    tiles; 8 ``DmaEndpoint``s each stream 256 random int32 words into a
    target's memory, at most 8 stores outstanding; 8
    ``MemoryControllerEndpoint``s each chase 64 pointers through a ring
    (``mem[a] = (a + stride) % words``, odd strides) seeded with
    ``set_mem`` before the attach; a background ``uniform`` program of
    loads at rate 0.1, 64 entries a tile, runs on every tile without an
    endpoint.  Both backends must drain at the same cycle with
    bit-identical Telemetry and memory, every chaser see the same
    addresses and latencies (and follow its ring), every DMA buffer land;
    the router's launches are set to 0 just before the card's run and
    read just after, and must be more than 0.  Then the trace program
    replayed alone, for the device's share of the time.  Returns the
    record."""
    import numpy as np
    from repro_torch.core.netsim import OP_LOAD
    from repro_torch.kernels.router_step import router_step_call
    from repro_torch.mesh import (DmaEndpoint, MemoryControllerEndpoint,
                                  MeshConfig, Simulator, make_traffic)
    cfg = MeshConfig(nx=nx, ny=ny, mem_words=words)
    rng = np.random.default_rng(seed)
    tiles = [(int(t % nx), int(t // nx))
             for t in rng.permutation(nx * ny)[:32]]
    at, dst = tiles[:16], tiles[16:]
    prog = make_traffic("uniform", nx, ny, 64, rate=0.1, op=OP_LOAD,
                        mem_words=words, seed=seed)
    for x, y in at:
        for k in prog:
            prog[k][y, x] = -1 if k == "op" else 0
    mem = np.zeros((ny, nx, words), np.int64)
    strides = [2 * i + 1 for i in range(8)]
    for (x, y), stride in zip(dst[8:], strides):
        mem[y, x] = (np.arange(words) + stride) % words
    bufs = [rng.integers(0, 2 ** 31 - 1, 256) for _ in range(8)]
    starts = [int(a) for a in rng.integers(0, words, 8)]

    def build(**kw):
        sim = Simulator(cfg, **kw)
        sim.set_mem(mem)
        sim.attach({k: v.copy() for k, v in prog.items()})
        eps = [DmaEndpoint(dst_x=dx, dst_y=dy, data=buf, max_inflight=8)
               for (dx, dy), buf in zip(dst[:8], bufs)]
        eps += [MemoryControllerEndpoint(dst_x=dx, dst_y=dy, start_addr=a,
                                         n_requests=64, mem_words=words)
                for (dx, dy), a in zip(dst[8:], starts)]
        for xy, ep in zip(at, eps):
            sim.attach(ep, at=xy)
        return sim, eps

    host, host_eps = build(backend="numpy")
    t0 = time.perf_counter()
    n_host = host.run_until_drained()
    host_s = time.perf_counter() - t0
    card, card_eps = build(backend="torch", device=device)
    router_step_call.launches = 0
    router_step_call.launches_by_variant = dict.fromkeys(
        router_step_call.launches_by_variant, 0)
    t0 = time.perf_counter()
    n_card = card.run_until_drained()
    card_s = time.perf_counter() - t0
    launches = router_step_call.launches
    by_variant = dict(router_step_call.launches_by_variant)
    check(n_card == n_host, f"endpoints: the card drained at {n_card}, the "
          f"numpy backend at {n_host}")
    tel = card.telemetry()
    host.telemetry().assert_bit_identical(tel)
    check(np.array_equal(card.mem, host.mem), "endpoints: memories differ")
    for i, (a, b) in enumerate(zip(host_eps, card_eps)):
        if isinstance(a, MemoryControllerEndpoint):
            check(a.visited == b.visited and a.latencies == b.latencies,
                  f"endpoints: chaser {i} saw other replies")
            want = [(starts[i - 8] + strides[i - 8] * j) % words
                    for j in range(64)]
            check(b.visited == want, f"endpoints: chaser {i} left its ring")
        else:
            x, y = dst[i]
            check(b.acked == 256 and np.array_equal(card.mem[y, x], bufs[i]),
                  f"endpoints: DMA {i}'s buffer did not land")
    check(launches > 0, "endpoints: the replay launched no router kernel")
    # the device's share alone: the trace program replayed as the facade
    # replays it (one fence block of the drain's length)
    trace = card.injection_trace_program()
    alone = Simulator(cfg, device=device, check_every=n_card)
    alone.set_mem(mem)
    alone.attach(trace)
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(alone.run_until_drained() == n_card, "endpoints: the trace "
          "program alone drained elsewhere")
    replay_s = time.perf_counter() - t0
    alone.telemetry().assert_bit_identical(tel)
    lat = [x for e in card_eps if hasattr(e, "latencies")
           for x in e.latencies]
    print(f"[endpoints] {card_line()}: {nx}x{ny}, 8 DMA x 256 words "
          f"(window 8) + 8 chasers x 64 loads + background uniform loads "
          f"(rate 0.1, 64 a tile): drained at cycle {n_card} on both "
          f"backends, {int(tel.completed.sum())} completions, telemetry and "
          f"memory bit-identical, chasers identical (mean chase latency "
          f"{np.mean(lat):.2f} cycles); numpy backend {host_s:.3f} s; torch "
          f"backend on the card {card_s:.3f} s (oracle trace + replay), "
          f"router_step launches {launches} by variant {by_variant}; the "
          f"trace program ({int((trace['op'] >= 0).sum())} entries) "
          f"replayed alone {replay_s:.3f} s")
    return {"cycles": n_card, "launches": launches, "by_variant": by_variant,
            "host_s": host_s, "card_s": card_s, "replay_s": replay_s}


def family_paths(device):
    """The model stack's main paths at full width, one model at a time
    (each freed before the next): Jamba v0.1's widths (one period, 8 of 32
    layers), Mixtral-8x7B's (8 of 32), Qwen2-VL-72B's (4 of 80), Mamba-2
    370M whole and whisper-large-v3 whole (32 + 32 layers); for each, the
    weights drawn on the card, a prefill (1 x 4096 tokens; Mixtral 1 x
    8192, twice its window; Qwen2-VL with (3, 1, S) positions; Whisper 4
    clips of 1500 frames and 4 x 448 decoder tokens), the ``Server``, each
    with its kernels' launches by variant asserted, and the profile.
    Returns {arch: (prefill record, server record)}."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    paths = {}
    for arch, layers, B, seq, want, per_tick, srv_kw, positions in (
            (JAMBA, 8, 1, PREFILL_TOKENS,
             {"flash_attention": {"wgmma_tma": 1},
              "ssd_scan": {"tensor_core": 7}, "moe_gmm": {"tma": 12}},
             {"moe_gmm": {"decode": 12}}, {}, False),
            (MIXTRAL, 8, 1, MIXTRAL_TOKENS,
             {"flash_attention": {"wgmma_tma": 8}, "moe_gmm": {"tma": 24}},
             {"moe_gmm": {"decode": 24}}, {}, False),
            (QWEN2_VL, 4, 1, PREFILL_TOKENS,
             {"flash_attention": {"wgmma_tma": 4}}, {},
             dict(requests=4, prompt=8, max_new=8), True),
            (MAMBA2, None, 1, PREFILL_TOKENS,
             {"ssd_scan": {"tensor_core": 48}}, {}, {}, False),
            # 32 encoder, 32 decoder self- and 32 cross-attention calls
            (WHISPER, None, WHISPER_CLIPS, WHISPER_TOKENS,
             {"flash_attention": {"wgmma_tma": 96}}, {}, {}, False)):
        full = get_config(arch)
        cfg = full if layers is None else \
            dataclasses.replace(full, num_layers=layers)
        label = (f"{arch} widths, {cfg.num_layers} of {full.num_layers} "
                 f"layers")
        if cfg.encdec is not None:
            label += f" (+ {cfg.encdec.encoder_layers} encoder layers)"
        params, nbytes, init_s = draw_params(device, cfg)
        nparams = sum(p.numel() for p in params.values())
        print(f"[params] {label}: {nparams / 1e9:.3f} B parameters, "
              f"{nbytes / 2**30:.2f} GiB bf16, drawn on the card in "
              f"{init_s:.1f} s")
        pre = prefill_path(device, cfg, params, seq, want, label, positions,
                           B=B)
        srv = server_path(device, cfg, params, per_tick, label, **srv_kw)
        model_profile(device, cfg, params, label, seq=seq,
                      positions=positions, B=B)
        paths[arch] = (pre, srv)
        del params
        torch.cuda.empty_cache()
    return paths


# ----------------------------------------------------------------------
# training on the card: the kernels' backward passes, AdamW, the data
# pipeline, checkpoints and the fault-tolerant Trainer
# ----------------------------------------------------------------------
def _t(x):
    return x.transpose(1, 2)


def _plain_op(kind, args, kw):
    """The op of ``kind`` in the models' layouts through its kernel's plain
    version, differentiable by autograd alone (the SSD token by token)."""
    from repro_torch.kernels import ref
    if kind == "flash":
        q, k, v = args
        return _t(ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw))
    if kind == "ssd":
        x, dt, B, C, A = args
        return _t(ref.ssd_scan_ref(_t(x), _t(dt), _t(B), _t(C), A))
    return ref.grouped_matmul_ref(*args)


def _train_op_cases(device, dtype):
    """(name, kind, args, op kwargs, plain kwargs) of phase 11's op checks:
    flash at Moonshot's training shape (1 x 4096, 16 heads of 128, causal)
    and with Qwen2-VL's GQA 64/8 (1 x 2048); the SSD at Mamba-2's (one
    4096-token sequence of the training batch, N 128, chunk 256) and
    ragged (1000 steps); the GMM at Moonshot's training forward (gate/up
    and down at capacity(4096) = 488) and with a ragged M (100)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity
    rnd, g = _rnd(device, dtype, 7)

    def leaf(t):
        return t.requires_grad_()

    moon, qwen, mamba = (get_config(a) for a in (MOONSHOT, QWEN2_VL, MAMBA2))
    out = []
    for name, c, S in (("Moonshot train", moon, TRAIN_SEQ),
                       ("Qwen2-VL GQA 64/8", qwen, 2048)):
        H, K, hd = c.num_heads, c.num_kv_heads, c.head_dim
        out.append((f"flash {name}", "flash",
                    [leaf(rnd(1, S, H, hd)), leaf(rnd(1, S, K, hd)),
                     leaf(rnd(1, S, K, hd))], dict(causal=True),
                    dict(causal=True)))
    s = mamba.ssm
    nh = s.num_heads(mamba.d_model)
    for name, S in (("Mamba-2 train (one sequence)", TRAIN_SEQ),
                    ("Mamba-2 ragged", 1000)):
        args = [leaf(rnd(1, S, nh, s.head_dim, scale=0.5)),
                leaf((F.softplus(torch.randn(1, S, nh, generator=g,
                                             device=device)) * 0.1).to(dtype)),
                leaf(rnd(1, S, s.num_groups, s.state_dim, scale=0.5)),
                leaf(rnd(1, S, s.num_groups, s.state_dim, scale=0.5)),
                leaf(-torch.linspace(1.0, 16.0, nh, device=device))]
        out.append((f"ssd {name}", "ssd", args, dict(chunk=s.chunk), {}))
    E, D, Fe = moon.moe.num_experts, moon.d_model, moon.moe.d_ff_expert
    m = capacity(TRAIN_SEQ, moon.moe)
    for name, (mm, k, n) in (("Moonshot train gate/up", (m, D, Fe)),
                             ("Moonshot train down", (m, Fe, D)),
                             ("Moonshot ragged M", (100, D, Fe))):
        out.append((f"gmm {name}", "gmm",
                    [leaf(rnd(E, mm, k)), leaf(rnd(E, k, n, scale=k ** -0.5))],
                    {}, {}))
    return out


def train_ops_vs_plain(device):
    """Phase 11 (1): each autograd op of ``kernels/ops.py`` against its
    plain version by autograd, on the same card tensors, in fp32 and bf16
    (:func:`_train_op_cases`): the gradient of a fixed random projection of
    the output through both.  Each forward must launch its kernel once
    (bf16: flash ``wgmma_tma``, SSD ``tensor_core``, GMM ``tma``; fp32:
    ``f32`` / ``cuda_core``); the backward launches no flash or SSD kernel
    (it recomputes) and two GMMs (``d_lhs``, ``d_rhs``), each of the
    variant ``gmm_variant`` gives its shape (the ragged M's ``d_rhs`` has
    K = 100, 200-byte rows TMA cannot describe: ``ragged``).  Tolerance on each gradient, against its largest magnitude:
    fp32 1e-3 (the SSD's recompute is the chunked algorithm, the plain
    version token by token), bf16 2e-2 (bf16 rounds the output and the
    gradients).  Returns {case: bf16 max_abs_err}."""
    import torch
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ops
    wrappers = _wrappers()
    key = {"flash": "flash_attention", "ssd": "ssd_scan", "gmm": "moe_gmm"}
    op_of = {"flash": ops.flash_attention_op, "ssd": ops.ssd_scan_op,
             "gmm": ops.grouped_matmul}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for name, kind, args, kw, plain_kw in _train_op_cases(device, dtype):
            w = wrappers[key[kind]]
            want_var = {"flash": "wgmma_tma" if bf16 else "f32",
                        "ssd": "tensor_core" if bf16 else "cuda_core",
                        "gmm": "tma" if bf16 else "f32"}[kind]
            out, var = _variant_of(w, lambda: op_of[kind](*args, **kw))
            check(var == want_var, f"{name} forward ran {var}")
            g = torch.Generator(device).manual_seed(11)
            proj = torch.randn(out.shape, generator=g, device=device)
            before = dict(w.launches_by_variant)
            got = torch.autograd.grad((out.float() * proj).sum(), args)
            torch.cuda.synchronize()
            bwd = {k: n - before[k] for k, n in w.launches_by_variant.items()
                   if n != before[k]}
            want_bwd = {}
            if kind == "gmm":       # d_lhs (E, m, n)@(E, n, k), d_rhs
                e, m, k = args[0].shape         # (E, k, m)@(E, m, n)
                n = args[1].shape[-1]
                for mm, kk, nn in ((m, n, k), (k, m, n)):
                    v = gmm_mod.gmm_variant(mm, kk, nn) if bf16 else "f32"
                    want_bwd[v] = want_bwd.get(v, 0) + 1
            check(bwd == want_bwd, f"{name} backward launched {bwd}, "
                  f"expected {want_bwd}")
            del out
            want = torch.autograd.grad((_plain_op(kind, args, plain_kw)
                                        .float() * proj).sum(), args)
            rel = 2e-2 if bf16 else 1e-3
            worst, ok = 0.0, True
            for a, b in zip(got, want):
                err = float((a.float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                ok &= err <= rel * scale and bool(torch.isfinite(a).all())
                worst = max(worst, err / max(scale, 1e-30))
            print(f"[train ops] {name} {str(dtype)[6:]}: "
                  f"{' '.join(str(tuple(a.shape)) for a in args)}; forward "
                  f"[{var}], backward launches {bwd or 'none (recompute)'}; "
                  f"gradient max error {worst:.3e} of its largest "
                  f"magnitude (tolerance {rel}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} {dtype}: the op's gradient differs from the "
                  "plain version's")
            if bf16:
                errs[name] = worst
            del got, want, args, proj
            torch.cuda.empty_cache()
    return errs


def reduced_training(device, arch, seq=32):
    """Phase 11 (2): the reduced model of ``arch`` (fp32, capacity factor
    8 so no token drops) on the card through the kernels and their
    backward, against the CPU through the plain versions: the loss (1e-4
    relative), every parameter's gradient (1e-3 of its largest magnitude
    plus 1e-3 relative) and the parameters after one ``train_step`` (every
    one within 2 lr of the CPU's, all but 1% within 1e-5: Adam's first
    update is g / (|g| + eps), so a gradient near zero moves its parameter
    by what its rounding decides)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.step import train_step
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_params
    cfg = reduced_config(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = synthetic_batch(cfg, ShapeConfig("t", seq, 2, "train"), 0)
    if cfg.mrope_sections is not None:
        i = np.arange(seq, dtype=np.int32)
        batch["positions"] = np.broadcast_to(
            np.stack([i // 4, i // 2, i])[:, None], (3, 2, seq)).copy()
    opt = optim.OptConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    res = {}
    for dev in (device, "cpu"):
        model = get_model(cfg)(cfg, dev, params={
            k: v.to(dev, copy=True) for k, v in cpu_params.items()})
        model.requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        zero_counts()
        loss, _ = model.loss(tb)
        loss.backward()
        counts = read_counts()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        state = optim.init(dict(model.named_parameters()))
        m = train_step(model, opt, state, tb)
        res[dev] = (loss.item(), grads, {k: p.detach().cpu() for k, p
                                         in model.named_parameters()},
                    float(m["lr"]), counts)
    (lc, gc, pc, lr, counts), (lx, gx, px, _lr, _c) = res[device], res["cpu"]
    gerr = max(float((gc[k] - gx[k]).abs().max())
               / max(float(gx[k].abs().max()), 1e-30) for k in gx)
    gok = all(bool(((gc[k] - gx[k]).abs() <= 1e-3 * gx[k].abs().max()
                    + 1e-3 * gx[k].abs()).all()) for k in gx)
    diffs = torch.cat([(pc[k] - px[k]).abs().ravel() for k in px])
    beyond = float((diffs > 1e-5).float().mean())
    print(f"[train reduced] {cfg.name}: fp32, 2 x {seq} tokens: loss card "
          f"{lc:.6f} vs CPU {lx:.6f}; gradients max error {gerr:.3e} of "
          f"their largest magnitude (tolerance 1e-3 + 1e-3 relative); one "
          f"train_step: parameters max difference {float(diffs.max()):.3e} "
          f"(bound 2 lr = {2 * lr:.1e}), {beyond:.2e} beyond 1e-5 "
          f"(tolerance 1e-2); loss and backward "
          f"launches {counts}")
    want = {"flash_attention": cfg.family != "ssm",
            "ssd_scan": cfg.ssm is not None, "moe_gmm": cfg.moe is not None}
    check({k: n > 0 for k, n in counts.items()} == want,
          f"reduced {arch} training launched {counts}, expected {want}")
    check(abs(lc - lx) <= 1e-4 * abs(lx), f"reduced {arch}: loss {lc} on "
          f"the card, {lx} on the CPU")
    check(gok, f"reduced {arch}: gradients differ by {gerr} of their "
          "magnitude")
    check(float(diffs.max()) <= 2 * lr and beyond <= 1e-2,
          f"reduced {arch}: parameters after one step differ")
    return gerr


_TRAIN_CATEGORIES = (
    "model kernels (forward and remat forward)",
    "flash/SSD backward (plain recompute)",
    "backward GMMs (kernel)", "backward GMMs' transposed copies",
    "cross entropy", "optimizer", "cuBLAS matmuls (dense layers, LM head)",
    "other (elementwise, norms, embedding, casts)")
_OURS = ("flash_wgmma_kernel", "flash_fwd_kernel", "ssd_state_",
         "ssd_pass_", "ssd_out_", "gmm_tma_kernel", "gmm_decode_kernel",
         "gmm_bf16_kernel", "gmm_f32_kernel")
_CUBLAS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def _train_breakdown(prof, wall_s):
    """Device time of a profiled window of training steps by category.
    Each device kernel or copy counts once (the ranges' own device-side
    annotations excluded) and is attributed by its launching op's chain of
    ancestors (the custom ops' backward nodes ``_FlashBackward``,
    ``_SSDBackward``, ``_GMMBackward``; ``train_step``'s ranges; the cross
    entropy's range and its backward nodes) and by its name; the chain is
    found through the launching op's list of kernels, matched by name and
    duration (a kernel the profiler lists under two ops is counted once).
    Returns (categories in us, busy s, idle share, backward GMM
    launches)."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    chains = defaultdict(list)
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        chain, p = [ev.name], ev.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in ev.kernels:
            chains[(k.name, k.duration)].append(" | ".join(chain))
    cats = dict.fromkeys(_TRAIN_CATEGORIES + ("unattributed",), 0.0)
    bwd_gmm = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        us = ev.time_range.elapsed_us()
        found = chains.get((ev.name, us))
        joined = found.pop() if found else None
        name = ev.name.lower()
        ours = any(x in name for x in _OURS)
        if joined is None:
            cat = "unattributed"
        elif "_GMMBackward" in joined:
            cat = _TRAIN_CATEGORIES[2] if ours else _TRAIN_CATEGORIES[3]
            bwd_gmm += ours
        elif "_FlashBackward" in joined or "_SSDBackward" in joined:
            cat = _TRAIN_CATEGORIES[1]
        elif ours:
            cat = _TRAIN_CATEGORIES[0]
        elif "train_step: optimizer" in joined:
            cat = _TRAIN_CATEGORIES[5]
        elif "cross_entropy" in joined or "LogsumexpBackward" in joined \
                or "GatherBackward" in joined:
            cat = _TRAIN_CATEGORIES[4]
        elif any(x in name for x in _CUBLAS):
            cat = _TRAIN_CATEGORIES[6]
        else:
            cat = _TRAIN_CATEGORIES[7]
        cats[cat] += us
    busy = sum(cats.values()) / 1e6
    return cats, busy, 1.0 - busy / wall_s, bwd_gmm


def _model_flops(cfg, batch, seq):
    """Model FLOPs of one training step: 6 x the parameters a token
    multiplies by (the active ones: top-k of the experts; the embedding
    lookup excluded) x tokens, plus 12 hd H per (query, key) pair of each
    causal attention layer (QK^T and PV, forward and backward)."""
    tokens = batch * seq
    dense = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    attn_layers = 0 if cfg.family == "ssm" else cfg.num_layers
    pairs = seq * (seq + 1) // 2
    return 6 * dense * tokens + 12 * cfg.head_dim * cfg.num_heads * pairs \
        * batch * attn_layers


def _run_on(trainer, batch, on_step):
    """``trainer.run`` on ``batch`` (numpy) repeated, through the data
    pipeline's ``Prefetcher`` (a host thread; the copy to the card on this
    one).  The stream's own batches would not do for the falling-loss
    check at these vocabularies: its documents start at uniform random
    token offsets, so no batch teaches the next one much in 10 or 20 steps
    from random weights, and a batch's own difficulty moves its loss by
    more (PERF.md §6); one batch repeated must be learnt."""
    import itertools
    from repro_torch.data.pipeline import Prefetcher
    data = Prefetcher(itertools.repeat(batch))
    try:
        return trainer.run(iter(data), on_step)
    finally:
        data.close()


def train_path(device, cfg, label, batch, steps, per_step, ckpt_dir=None,
               fault_at=None, ckpt_every=10):
    """Phase 11 (3): train ``cfg`` at full width through ``Trainer`` and
    ``launch/train.py``'s ``make_trainer`` (AdamW at the launcher's 3e-4
    peak after 10 warmup steps), bf16 weights drawn on the card, full
    remat, on the data pipeline's batch 0 of ``batch`` x 4096 tokens
    repeated (:func:`_run_on`) for ``steps`` steps.  The launch counts are
    set to 0 before the run and read after each step: each step must
    launch exactly ``per_step`` {kernel: {variant: n}} (every other kernel
    and variant 0).  Every loss finite, the mean of the last 3 below the
    mean of the first 3 (``tests/test_runtime.py``'s test).  ``fault_at``:
    one injected fault at that step, retried.  Then 3 warm
    ``train_step``s under the profiler.  Returns (trainer, record)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.step import train_step
    from repro_torch.launch.train import make_trainer
    from repro_torch.runtime import FaultInjector
    card = card_line()
    params, nbytes, init_s = draw_params(device, cfg)
    nparams = sum(p.numel() for p in params.values())
    trainer = make_trainer(
        cfg, TRAIN_SEQ, batch, steps, device=device, remat="full",
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        fault_injector=None if fault_at is None else FaultInjector(
            {fault_at: 1}))
    trainer.init(params=params)
    del params
    data = synthetic_batch(cfg, trainer.shape, 0)
    # the GMM's backward launches, attributed by wrapping the op's backward
    gmm = _wrappers()["moe_gmm"]
    bwd_gmm = [0]
    backward = ops._GMM.backward

    def counted_backward(ctx, g):
        before = gmm.launches
        out = backward(ctx, g)
        bwd_gmm[0] += gmm.launches - before
        return out

    losses, variants, stamps = [], [], []

    def on_step(step, m):
        losses.append(float(m["loss"]))
        variants.append(read_variants())
        zero_counts()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops._GMM.backward = staticmethod(counted_backward)
    zero_counts()
    try:
        t0 = time.perf_counter()
        _run_on(trainer, data, on_step)
        wall = time.perf_counter() - t0
    finally:
        ops._GMM.backward = staticmethod(backward)
    peak = torch.cuda.max_memory_allocated()
    step_s = np.diff([t0] + stamps)
    # the warm steps: after the first, neither retrying the injected fault
    # nor writing a checkpoint, nor after one (the async write slows it)
    clean = [s for s in range(2, steps + 1) if s != fault_at
             and (ckpt_dir is None or s < ckpt_every)]
    warm = float(np.median(step_s[[s - 1 for s in clean]]))
    tokens = batch * TRAIN_SEQ
    flops = _model_flops(cfg, batch, TRAIN_SEQ)
    for i, v in enumerate(variants):
        for k, n in v.items():
            for var, c in n.items():
                check(c == per_step.get(k, {}).get(var, 0),
                      f"{label} step {i + 1}: {k} launched {n}, expected "
                      f"{per_step.get(k, {})}")
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f"{label}: losses {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"{label}: the loss did not fall: {losses}")
    failures = [e for e in trainer.events if e["kind"] == "step_failure"]
    if fault_at is not None:
        check([e["step"] for e in failures] == [fault_at],
              f"{label}: step failures {failures}")
    total = {k: {var: sum(v[k][var] for v in variants)
                 for var in variants[0][k]} for k in variants[0]}
    print(f"[train] {card}: {label} ({nparams / 1e9:.3f} B parameters, "
          f"{nbytes / 2**30:.2f} GiB bf16, drawn in {init_s:.1f} s): "
          f"{batch} x {TRAIN_SEQ} tokens, {steps} steps, remat full: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; launches per step "
          f"{per_step} (asserted at every step), total "
          f"{ {k: {a: b for a, b in v.items() if b} for k, v in total.items()} }, "
          f"of them GMM launches in the backward {bwd_gmm[0]}; events "
          f"{[(e['kind'], e['step']) for e in trainer.events]}")
    print(f"[train] {card}: {label}: wall {wall:.2f} s for {steps} steps; "
          f"warm step (median of steps {clean}) {warm * 1e3:.1f} ms, "
          f"{tokens / warm:.0f} tokens/s, model {flops / warm / 1e12:.1f} "
          f"TFLOP/s ({flops / warm / BF16_OPS_PER_S:.3f} of 989 bf16; "
          f"{flops / 1e12:.2f} TFLOP a step: 6 x active non-embedding "
          f"parameters x tokens + attention); first step "
          f"{step_s[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.1f} GiB")
    # where the time goes: 3 warm steps of the same step function
    bts = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in data.items()}] * 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b in bts:
            m = train_step(trainer.model, trainer.opt_cfg, trainer.opt_state,
                           b, trainer.remat)
        float(m["loss"])
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    cats, busy, idle, prof_bwd_gmm = _train_breakdown(prof, pwall)
    parts = ", ".join(f"{k} {v / 1e3 / 3:.2f} ms" for k, v in
                      sorted(cats.items(), key=lambda kv: -kv[1]))
    print(f"[where the time goes] {card}: {label} training, 3 warm steps "
          f"under the profiler: {pwall / 3 * 1e3:.1f} ms a step, device busy "
          f"{busy / 3 * 1e3:.1f} ms (idle share {idle:.3f}); {parts}; "
          f"backward GMM kernels in the profile {prof_bwd_gmm / 3:.0f} a "
          f"step")
    del bts, prof
    rec = dict(losses=losses, total=total, data=data, warm=warm, wall=wall, peak=peak,
               tokens=tokens, flops=flops, cats={k: v / 1e3 / 3 for k, v
                                                 in cats.items()},
               busy=busy / 3, idle=idle, pwall=pwall / 3,
               bwd_gmm=bwd_gmm[0], nparams=nparams)
    return trainer, rec


def checkpoint_resume(device, cfg, ckpt_dir, losses, data,
                      at=MAMBA2_CKPT_EVERY):
    """Phase 11 (4): the Mamba-2 run's checkpoint of step ``at`` (written
    by its ``AsyncCheckpointer``; the later step's directory is removed)
    restored by a fresh ``Trainer`` (``resume_or_init``), which takes the
    next step on the run's batch ``data``: its loss must equal the
    uninterrupted run's step ``at + 1`` within 1e-5 relative (the same
    parameters, bit for bit, and the same batch; the forward's sums may
    run in another order)."""
    import shutil
    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import make_trainer
    card = card_line()
    for d in sorted(os.listdir(ckpt_dir)):
        if d.startswith("step_") and int(d[5:13]) > at:
            shutil.rmtree(os.path.join(ckpt_dir, d))
    check(latest_step(ckpt_dir) == at, f"no checkpoint of step {at}")
    t0 = time.perf_counter()
    tr = make_trainer(cfg, TRAIN_SEQ, MAMBA2_TRAIN_BATCH, at + 1,
                      device=device, remat="full", ckpt_dir=ckpt_dir,
                      ckpt_every=MAMBA2_CKPT_EVERY)
    tr.resume_or_init()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(tr.step == at and {"kind": "resume", "step": at} in tr.events,
          f"resumed at {tr.step}, events {tr.events}")
    got = []
    _run_on(tr, data, lambda s, m: got.append(float(m["loss"])))
    tr.close()
    rel = abs(got[0] - losses[at]) / abs(losses[at])
    print(f"[train checkpoint] {card}: {cfg.name}: restored step {at} in "
          f"{restore_s:.1f} s; the next step's loss {got[0]:.6f} against "
          f"the uninterrupted run's {losses[at]:.6f} (relative difference "
          f"{rel:.2e}, tolerance 1e-5)")
    check(rel <= 1e-5, "the resumed step's loss differs from the "
          "uninterrupted run's")
    del tr


def train_paths(device):
    """Phase 11 (3) and (4): Mamba-2 370M whole (8 x 4096 tokens, 6
    steps, a fault injected at step 2, checkpoints at 5 and 6, the
    resume of 5), then Moonshot's widths, 2 of 48 layers (1 x 4096, 10 steps,
    no checkpoint: its 25 GiB of state would take most of a minute to
    write), one model at a time.  Returns {arch: record}."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    out = {}
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        print(f"[train checkpoint] checkpoints under {ckpt_dir} "
              f"({free / 2**30:.0f} GiB free)")
        cfg = get_config(MAMBA2)
        label = f"{MAMBA2} whole ({cfg.num_layers} layers)"
        trainer, rec = train_path(
            device, cfg, label, MAMBA2_TRAIN_BATCH, MAMBA2_TRAIN_STEPS,
            {"ssd_scan": {"tensor_core": 2 * cfg.num_layers}},
            ckpt_dir=ckpt_dir, fault_at=MAMBA2_FAULT_AT,
            ckpt_every=MAMBA2_CKPT_EVERY)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
        checkpoint_resume(device, cfg, ckpt_dir, rec["losses"], rec["data"])
        out[MAMBA2] = rec
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    full = get_config(MOONSHOT)
    cfg = dataclasses.replace(full, num_layers=MOONSHOT_TRAIN_LAYERS)
    label = (f"{MOONSHOT} widths, {cfg.num_layers} of {full.num_layers} "
             f"layers")
    L = cfg.num_layers
    trainer, rec = train_path(
        device, cfg, label, 1, MOONSHOT_TRAIN_STEPS,
        {"flash_attention": {"wgmma_tma": 2 * L}, "moe_gmm": {"tma": 12 * L}})
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    rec["remat"] = remat_paths(device, cfg, label, rec)
    out[MOONSHOT] = rec
    return out


def remat_paths(device, cfg, label, full):
    """Phase 11 (3b): Moonshot's widths again under ``remat="dots"`` (the
    reference's ``checkpoint_dots_with_no_batch_dims``: the backward
    reruns everything but the products with no batch dimensions) and
    ``"none"``, each :data:`MOONSHOT_REMAT_STEPS` steps from the same
    weights (``draw_params``) on the same batch as the full-remat run
    ``full`` (the launcher's schedule of its 10 steps).  Each step's
    launches asserted: dots as full (flash 2 a layer: forward and remat;
    GMM 12: 3 forward, 3 remat, 6 backward), none without the remat
    (flash 1, GMM 9).  The dots losses must equal the full run's first
    ones bit for bit (remat changes no arithmetic); none's are printed
    beside them.  Then 2 warm steps under the profiler: the cuBLAS
    matmuls' device time a step, and the peak memory, beside full's.
    Each step's launches are split by forward (within the model's
    ``loss``), backward (within the GMM's backward) and remat (the rest),
    each asserted.  Returns {remat: record}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.step import train_step
    from repro_torch.launch.train import make_trainer
    card = card_line()
    L = cfg.num_layers
    cublas = _TRAIN_CATEGORIES[6]
    # a step's launches by (forward, remat, backward): flash, GMM
    split = {"dots": ((L, 3 * L), (L, 3 * L), (0, 6 * L)),
             "none": ((L, 3 * L), (0, 0), (0, 6 * L))}
    n = MOONSHOT_REMAT_STEPS
    out = {}
    for remat, parts in split.items():
        want = {"flash_attention": {"wgmma_tma": sum(p[0] for p in parts)},
                "moe_gmm": {"tma": sum(p[1] for p in parts)}}
        params, _nbytes, _init_s = draw_params(device, cfg)
        tr = make_trainer(cfg, TRAIN_SEQ, 1, MOONSHOT_TRAIN_STEPS,
                          device=device, remat=remat, ckpt_dir=None)
        tr.tcfg.total_steps = n            # the 10-step run's schedule
        tr.init(params=params)
        del params
        data = synthetic_batch(cfg, tr.shape, 0)
        losses, variants, fwd, bwd = [], [], [], []
        real_loss, real_bwd = tr.model.loss, ops._GMM.backward
        gmm = _wrappers()["moe_gmm"]

        def loss(*a, **kw):
            before = read_variants()
            got = real_loss(*a, **kw)
            now = read_variants()
            fwd.append((now["flash_attention"]["wgmma_tma"]
                        - before["flash_attention"]["wgmma_tma"],
                        now["moe_gmm"]["tma"] - before["moe_gmm"]["tma"]))
            return got

        def gmm_backward(ctx, g):
            before = gmm.launches
            got = real_bwd(ctx, g)
            bwd.append(gmm.launches - before)
            return got

        def on_step(step, m):
            losses.append(float(m["loss"]))
            variants.append(read_variants())
            zero_counts()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tr.model.loss = loss
        ops._GMM.backward = staticmethod(gmm_backward)
        try:
            _run_on(tr, data, on_step)
        finally:
            tr.model.loss = real_loss
            ops._GMM.backward = staticmethod(real_bwd)
        peak = torch.cuda.max_memory_allocated()
        for i, v in enumerate(variants):
            for k, d in v.items():
                for var, c in d.items():
                    check(c == want.get(k, {}).get(var, 0),
                          f"{label} remat {remat} step {i + 1}: {k} "
                          f"launched {d}, expected {want.get(k, {})}")
            b = sum(bwd[i * 3 * L:(i + 1) * 3 * L])
            got = (fwd[i], (v["flash_attention"]["wgmma_tma"] - fwd[i][0],
                            v["moe_gmm"]["tma"] - fwd[i][1] - b), (0, b))
            check(got == parts and len(bwd) == 3 * L * n,
                  f"{label} remat {remat} step {i + 1}: launches by "
                  f"forward, remat, backward {got}, expected {parts}")
        bts = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in data.items()}] * 2
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for b in bts:
                m = train_step(tr.model, tr.opt_cfg, tr.opt_state, b,
                               tr.remat)
            float(m["loss"])
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
        cats, busy, idle, _ = _train_breakdown(prof, pwall)
        total = {k: sum(v[k].get(var, 0) for v in variants)
                 for k, var in (("flash_attention", "wgmma_tma"),
                                ("moe_gmm", "tma"))}
        out[remat] = dict(losses=losses, peak=peak, launches=total,
                          split=parts,
                          cublas_ms=cats[cublas] / 1e3 / 2,
                          busy_ms=busy * 1e3 / 2, step_ms=pwall * 1e3 / 2,
                          idle=idle, variants={
                              k: {a: b for a, b in d.items() if b}
                              for k, d in variants[0].items() if any(
                                  d.values())})
        tr.close()
        del tr, bts, prof
        torch.cuda.empty_cache()
    ref = full["losses"][:n]
    same = out["dots"]["losses"] == ref
    none_diff = max(abs(a - b) / abs(b)
                    for a, b in zip(out["none"]["losses"], ref))
    rows = {"none": out["none"], "dots": out["dots"],
            "full": dict(peak=full["peak"], cublas_ms=full["cats"][cublas],
                         busy_ms=full["busy"] * 1e3,
                         step_ms=full["pwall"] * 1e3)}
    print(f"[train remat] {card}: {label}, 1 x {TRAIN_SEQ}, {n} steps from "
          f"the full-remat run's weights and batch: dots losses "
          f"{out['dots']['losses']}, full's {ref} "
          f"({'bit-identical' if same else 'DIFFERENT'}); none's "
          f"{out['none']['losses']} (largest relative difference "
          f"{none_diff:.2e}); launches a step dots "
          f"{out['dots']['variants']}, none {out['none']['variants']}; "
          f"(flash, GMM) by forward, remat and backward: dots "
          f"{out['dots']['split']}, none {out['none']['split']} (asserted "
          f"at every step)")
    print(f"[train remat] {card}: {label}: peak memory "
          + ", ".join(f"{k} {r['peak'] / 2**30:.2f} GiB"
                      for k, r in rows.items())
          + "; cuBLAS matmuls' device time a step (the profiler) "
          + ", ".join(f"{k} {r['cublas_ms']:.2f} ms" for k, r in rows.items())
          + "; device busy a step "
          + ", ".join(f"{k} {r['busy_ms']:.1f} ms" for k, r in rows.items())
          + "; profiled step "
          + ", ".join(f"{k} {r['step_ms']:.1f} ms" for k, r in rows.items()))
    check(same, f"{label}: remat dots losses {out['dots']['losses']} differ "
          f"from full remat's {ref}")
    return out


def train_kernel_timings(device):
    """Phase 11 (5): the GMM's backward products at Moonshot's training
    shapes (bf16, CUDA events): ``d_lhs = gmm(g, rhsᵀ)`` and ``d_rhs =
    gmm(lhsᵀ, g)`` of the gate/up and the down products, each kernel
    against the plain version (checked) and ``torch.bmm`` on the same
    operands, with its bound; and the ``.contiguous()`` copies of the
    transposed operands that the backward makes.  Returns {case:
    record}."""
    import torch
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    card = card_line()
    out = {}
    for part, (lhs, rhs) in _gmm_inputs(device, torch.bfloat16, MOONSHOT,
                                        TRAIN_SEQ, 3).items():
        g = torch.randn(lhs.shape[0], lhs.shape[1], rhs.shape[2],
                        device=device).to(torch.bfloat16)
        copy_ms = {"rhsᵀ": _event_ms(lambda: _t(rhs).contiguous(), 5),
                   "lhsᵀ": _event_ms(lambda: _t(lhs).contiguous(), 5)}
        rhs_t, lhs_t = _t(rhs).contiguous(), _t(lhs).contiguous()
        for prod, a, b in (("d_lhs", g, rhs_t), ("d_rhs", lhs_t, g)):
            got, var = _variant_of(gmm_mod.grouped_matmul,
                                   lambda: gmm_mod.grouped_matmul(a, b))
            check(var == "tma", f"backward {part} {prod} ran {var}")
            err = _compare("moe_gmm", f"Moonshot train backward {part} {prod} "
                           f"{tuple(a.shape)}@{tuple(b.shape)} [{var}]", got,
                           ref.grouped_matmul_ref(a, b))
            nb, ops_ = gmm_mod.gmm_bound(a, b)
            r = dict(ms=_event_ms(lambda: gmm_mod.grouped_matmul(a, b), 5),
                     plain_ms=_event_ms(lambda: ref.grouped_matmul_ref(a, b),
                                        2),
                     library_ms=_event_ms(lambda: torch.bmm(a, b), 5),
                     bound=_bound(nb, ops_, BF16_OPS_PER_S), err=err,
                     shape=f"Moonshot train backward {part} {prod} "
                           f"{tuple(a.shape)}@{tuple(b.shape)}",
                     copy_ms=copy_ms["rhsᵀ" if prod == "d_lhs" else "lhsᵀ"])
            out[f"{part} {prod}"] = r
            print(f"[times] {card}: moe_gmm {r['shape']}, bf16: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, torch.bmm "
                  f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
                  f"{r['bound'][1]}; its transposed operand's contiguous copy "
                  f"{r['copy_ms']:.4f} ms")
        del lhs, rhs, g, rhs_t, lhs_t
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# [spmd]: serving on a mesh of ranks sharing the card
# ----------------------------------------------------------------------
QWEN2 = "qwen2-72b"
SPMD_WORLD, SPMD_MESH = 4, (2, 2)        # (data, model)
SPMD_LAYERS, SPMD_BATCH = 2, 2
SPMD_QWEN_TOKENS, SPMD_MIXTRAL_TOKENS = 4096, 8192
SPMD_MODES = ("xy", "ep", "local")
# Mixtral's E / top_k: a FIFO of T * top_k * cf / E slots holds every
# token (a token takes an expert at most once), so no layout drops; at
# 2 x 4096 tokens, where its (E, T, F) expert activations fit four ranks
SPMD_NO_DROP_CF, SPMD_NO_DROP_TOKENS = 4.0, 4096
SPMD_LABEL = (f"{SPMD_WORLD} ranks (data {SPMD_MESH[0]} x model "
              f"{SPMD_MESH[1]}) time-sharing one card through gloo")


def _spmd_cfg(arch, **moe):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=SPMD_LAYERS)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _spmd_tokens(cfg, seq):
    import numpy as np
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SPMD_BATCH, seq)).astype(np.int64)


def _spmd_collectives(mesh):
    """The paper's mechanisms on CUDA tensors, each against the same
    result computed in this process from every rank's inputs: the XY
    all-to-all (fp32 and int32), the XY all-reduce, reduce-scatter then
    all-gather, all_reduce(max), the ring shift (host-staged on gloo),
    remote store, load and CAS (the mutex), and the barrier.  Returns
    {case: ok}."""
    import torch
    from repro_torch.core import pgas, routing, sync
    from repro_torch.parallel import comm
    dev, T, r = mesh.device, mesh.size, mesh.rank
    g = torch.Generator().manual_seed(5)
    A = torch.randn(T, T, 3, generator=g)
    Ai = torch.randint(0, 1000, (T, 2 * T), generator=g, dtype=torch.int32)
    X = torch.randn(T, 2 * T, 3, generator=g)
    on = lambda t: t.to(dev)                                # noqa: E731
    ok = {}
    ok["xy_all_to_all"] = torch.equal(routing.xy_all_to_all(
        on(A[r]), mesh, "model", "data").cpu(), A[:, r])
    ok["xy_all_to_all int32"] = torch.equal(routing.xy_all_to_all(
        on(Ai[r]), mesh, "model", "data").cpu(),
        Ai.reshape(T, T, 2)[:, r].reshape(-1))
    ok["xy_all_reduce"] = torch.allclose(routing.xy_all_reduce(
        on(X[r]), mesh, "model", "data").cpu(), X.sum(0), atol=1e-5)
    ok["reduce_scatter + all_gather"] = torch.allclose(routing.xy_all_gather(
        routing.xy_reduce_scatter(on(X[r]), mesh, "model", "data"), mesh,
        "model", "data").cpu(), X.sum(0), atol=1e-5)
    ok["all_reduce max"] = torch.equal(comm.all_reduce(
        on(X[r]), mesh, ("data", "model"), "max").cpu(), X.amax(0))
    nx = mesh.axis_size("model")
    y, x = divmod(r, nx)
    ok["shift (ppermute)"] = torch.equal(routing.shift(
        on(A[r]), mesh, "model").cpu(), A[y * nx + (x - 1) % nx])
    mem = torch.zeros(16, device=dev)
    pk = pgas.PacketBatch(
        addr=torch.full((T, 2), r, dtype=torch.int32, device=dev),
        data=torch.full((T, 2), r + 1.0, device=dev),
        mask=torch.ones((T, 2), dtype=torch.bool, device=dev))
    got, credits = pgas.remote_store(mem, pk, mesh, "model", "data")
    want = torch.zeros(16)
    want[:T] = torch.arange(T) + 1.0
    ok["remote_store"] = torch.equal(got.cpu(), want) and \
        torch.equal(credits.cpu(), torch.full((T,), 2, dtype=torch.int32))
    data, valid = pgas.remote_load(got, pk, mesh, "model", "data")
    ok["remote_load"] = bool(valid.all()) and torch.equal(
        data.cpu(), (want[r] * torch.ones(T, 2)))
    m1, won = sync.mutex_try_acquire(mem, 1, 0, mesh, "model", "data", T)
    wins = comm.all_reduce(won.to(torch.int32), mesh, ("data", "model"))
    ok["remote_cas mutex"] = int(wins) == 1 and bool(won) == (r == 0) and \
        (r != 1 or float(m1[0]) == 1.0)
    b = sync.barrier_arrive(mem, 0, 0, mesh, "model", "data", T)
    ok["barrier"] = (r != 0 or bool(sync.barrier_done(b, 0, T))) and \
        int(sync.spmd_barrier(mesh, "model", "data")) == T
    return ok


def _spmd_gather_times(device, mib=16, reps=3):
    """Seconds of one gloo all-gather of ``mib`` MiB of bf16 a rank over
    all ranks, on the ranks' CUDA tensors and staged through the host
    (the last of ``reps``, each between barriers): the cost of staging
    an op through the host (``comm.HOST_STAGED``, chosen by what gloo
    takes on the card) against gloo's own CUDA path."""
    import torch
    import torch.distributed as dist
    x = torch.ones(mib * 2**20 // 2, dtype=torch.bfloat16, device=device)
    out = torch.empty(dist.get_world_size() * x.numel(), dtype=x.dtype,
                      device=device)
    times = {}
    for where in ("cuda", "host"):
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            if where == "cuda":
                dist.all_gather_into_tensor(out, x)
            else:
                host = torch.empty(out.shape, dtype=x.dtype)
                dist.all_gather_into_tensor(host, x.cpu())
                out.copy_(host)
            torch.cuda.synchronize()
            times[where] = time.perf_counter() - t0
    return times


def _spmd_layer_comm(log):
    """Per-layer collective stats: wrap the islands so each layer's
    calls (attention and MLP) accumulate in ``log``."""
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import comm

    def wrap(fn):
        def run(*a, **kw):
            before = comm.comm_stats()
            out = fn(*a, **kw)
            for op, v in comm.comm_stats().items():
                b = before.get(op, {"calls": 0, "bytes": 0})
                d = log.setdefault(op, {"calls": 0, "bytes": 0})
                d["calls"] += v["calls"] - b["calls"]
                d["bytes"] += v["bytes"] - b["bytes"]
            return out
        return run
    tf._attn_manual = wrap(tf._attn_manual)
    tf.Transformer._spmd_mlp = wrap(tf.Transformer._spmd_mlp)


def _spmd_prefill(model, tokens, rules, mesh):
    """One prefill of ``tokens`` (or of a batch, a dict with Whisper's
    ``frames``) on every rank in lockstep, the counts set to 0 just
    before and read just after: (logits, wall, launches by variant,
    collective stats, drops)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.step import prefill_step
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    torch.cuda.synchronize()
    dist.barrier()
    zero_counts()
    comm.reset_comm_stats()
    t0 = time.perf_counter()
    with moe.counting_drops() as drops:
        logits = prefill_step(model, tokens if isinstance(tokens, dict)
                              else {"tokens": tokens}, rules)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    variants, stats = read_variants(), comm.comm_stats()
    dist.barrier()
    return logits, wall, variants, stats, int(sum(int(d) for d in drops))


def _flash_mask(opts):
    """(causal, window) of a logged flash call's options: its window
    (causal), or Whisper's (causal, window)."""
    return opts if isinstance(opts, tuple) else (True, opts)


def _ssd_at(device, shapes, seed):
    """SSD inputs (kernel layout) at a logged call's (x, B) shapes: x, B,
    C of scale 0.5, dt a softplus times 0.1, A the models' initial
    -linspace(1, 16)."""
    import torch
    import torch.nn.functional as F
    rnd, g = _rnd(device, torch.bfloat16, seed)
    (b, h, S, P), (_b, G, _S, N) = shapes
    return dict(x=rnd(b, h, S, P, scale=0.5),
                dt=(F.softplus(torch.randn(b, h, S, generator=g,
                                           device=device)) * 0.1).to(
                    torch.bfloat16),
                B=rnd(b, G, S, N, scale=0.5), C=rnd(b, G, S, N, scale=0.5),
                A=-torch.linspace(1.0, 16.0, h, device=device))


def _spmd_kernel_checks(log, device, seed):
    """Each distinct kernel call a rank made (``log`` of ops-level
    shapes: flash with its window or (causal, window), the GMM, the SSD
    with its chunk), again on random inputs at that shape, against the
    plain version: {shape: max_abs_err}."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.kernels.ssd_scan import ssd_scan
    errs = {}
    for kind, shapes, opts in log:
        if (kind, shapes) in errs:
            continue
        rnd, _ = _rnd(device, torch.bfloat16, seed)
        if kind == "flash":
            q, k, v = (rnd(*s) for s in shapes)
            causal, window = _flash_mask(opts)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
        elif kind == "ssd":
            ssd = _ssd_at(device, shapes, seed)
            got = ssd_scan(**ssd, chunk=opts)
            want = ref.ssd_scan_ref(**ssd)
        else:
            lhs = rnd(*shapes[0])
            rhs = rnd(*shapes[1], scale=shapes[1][1] ** -0.5)
            got = grouped_matmul(lhs, rhs)
            want = ref.grouped_matmul_ref(lhs, rhs)
        errs[(kind, shapes)] = _compare(
            f"[spmd rank] {kind}", f"{shapes} "
            f"{'chunk' if kind == 'ssd' else 'window'} {opts}", got, want)
    return errs


def _spmd_rank(rank, plan):
    """The [spmd] program of one rank (4 ranks sharing the card over
    gloo): the mechanisms on CUDA tensors, Qwen2-72B's widths (2 layers)
    in a manual-TP prefill, Mixtral's widths (2 layers) prefilled in the
    xy, ep and local dispatch modes (at the published capacity factor and
    at one that drops nothing), and the fp32 mesh ``Server``.  Returns
    its records (CPU numbers and numpy logits)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.step import cell_rules
    from repro_torch.models import moe
    from repro_torch.models.convert import init_params
    from repro_torch.models.transformer import Transformer, _decode_rules
    from repro_torch.parallel import comm
    device = str(resolve_device(plan["device"]))
    mesh = make_test_mesh(SPMD_MESH, ("data", "model"), device)
    out = {"collectives": _spmd_collectives(mesh),
           "gather_s": _spmd_gather_times(device)}
    calls = []

    def flash_log(q, k, v, **kw):
        calls.append(("flash", (tuple(q.shape), tuple(k.shape),
                                tuple(v.shape)), kw.get("window")))
        return real_flash(q, k, v, **kw)

    def gmm_log(lhs, rhs):
        calls.append(("gmm", (tuple(lhs.shape), tuple(rhs.shape)), None))
        return real_gmm(lhs, rhs)
    real_flash, real_gmm = ops.flash_attention, ops._gmm_kernel
    ops.flash_attention, ops._gmm_kernel = flash_log, gmm_log
    layer_comm = {}
    _spmd_layer_comm(layer_comm)

    # Qwen2-72B's widths, 2 of 80 layers, 2 x 4096, manual TP
    cfg = _spmd_cfg(QWEN2)
    rules = cell_rules(mesh, cfg, ShapeConfig(
        "prefill", SPMD_QWEN_TOKENS, SPMD_BATCH, "prefill"))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device, rules=rules)
    model = Transformer(cfg, device, params=params, rules=rules)
    tokens = torch.from_numpy(_spmd_tokens(cfg, SPMD_QWEN_TOKENS)).to(device)
    torch.cuda.synchronize()
    draw = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    calls.clear()
    layer_comm.clear()
    logits, wall, variants, stats, _ = _spmd_prefill(model, tokens, rules,
                                                     mesh)
    per_layer = {k: {f: v[f] // cfg.num_layers for f in v}
                 for k, v in layer_comm.items()}
    _, warm, _, _, _ = _spmd_prefill(model, tokens, rules, mesh)
    out["qwen2"] = dict(
        logits=logits.float().cpu().numpy(), wall=wall, warm=warm,
        variants=variants, comm=stats, comm_per_layer=per_layer, draw=draw,
        peak=torch.cuda.max_memory_allocated(),
        bytes=sum(p.numel() * p.element_size() for p in params.values()),
        calls=sorted(set(calls)))
    del model, params, logits
    torch.cuda.empty_cache()

    # Mixtral's widths, 2 of 32 layers, 2 x 8192 (window 4096), three modes
    cfg = _spmd_cfg(MIXTRAL)
    free = _spmd_cfg(MIXTRAL, capacity_factor=SPMD_NO_DROP_CF)
    tokens = {label: torch.from_numpy(_spmd_tokens(cfg, n)).to(device)
              for label, n in (("published", SPMD_MIXTRAL_TOKENS),
                               ("no drop", SPMD_NO_DROP_TOKENS))}
    shape = ShapeConfig("prefill", SPMD_MIXTRAL_TOKENS, SPMD_BATCH,
                        "prefill")
    held = {}
    out["mixtral"] = {}
    torch.cuda.reset_peak_memory_stats()
    for mode in SPMD_MODES:
        rules = cell_rules(mesh, cfg, shape, dispatch=mode)
        key = "ff" if mode == "local" else "experts"
        if key not in held:
            held.clear()
            torch.cuda.empty_cache()
            held[key] = init_params(cfg, torch.Generator(device)
                                    .manual_seed(0), device, rules=rules)
        calls.clear()
        layer_comm.clear()
        rec = {}
        for label, c in (("published", cfg), ("no drop", free)):
            model = Transformer(c, device, params=held[key], rules=rules)
            logits, wall, variants, stats, drops = _spmd_prefill(
                model, tokens[label], rules, mesh)
            rec[label] = dict(logits=logits.float().cpu().numpy(),
                              wall=wall, variants=variants, comm=stats,
                              drops=drops)
            if label == "published":
                rec[label]["calls"] = sorted(set(calls))
                rec[label]["comm_per_layer"] = {
                    k: {f: v[f] // cfg.num_layers for f in v}
                    for k, v in layer_comm.items()}
            del model, logits
        out["mixtral"][mode] = rec
    out["mixtral_peak"] = torch.cuda.max_memory_allocated()
    del held
    torch.cuda.empty_cache()

    # each distinct kernel call of the runs above, against its plain
    # version at that local shape (not counted: the paths are read)
    ops.flash_attention, ops._gmm_kernel = real_flash, real_gmm
    seen = [c for c in out["qwen2"]["calls"]]
    for rec in out["mixtral"].values():
        seen += rec["published"]["calls"]
    # one rank at a time: the plain attention materialises its scores
    import torch.distributed as dist
    for turn in range(mesh.size):
        if turn == rank:
            out["kernel_errs"] = _spmd_kernel_checks(sorted(set(seen)),
                                                     device, 10 + rank)
            torch.cuda.empty_cache()
        dist.barrier()

    # the fp32 mesh Server at Mixtral's widths, 2 layers: 8 requests, 4
    # slots (rows over data, the KV cache over model, the MoE through ep)
    cfg32 = dataclasses.replace(_spmd_cfg(MIXTRAL), dtype="float32")
    server = Server(cfg32, slots=4, max_seq=64, device=device, mesh=mesh)
    for req in plan["requests"]:
        server.submit(Request(rid=req[0], prompt=req[1], max_new=req[2]))
    torch.cuda.synchronize()
    zero_counts()
    comm.reset_comm_stats()
    t0 = time.perf_counter()
    ticks = server.run(tick_limit=1000)
    torch.cuda.synchronize()
    out["server"] = dict(
        outs=[r.out for r in sorted(server.completed, key=lambda r: r.rid)],
        ticks=ticks, wall=time.perf_counter() - t0,
        variants=read_variants(), comm=comm.comm_stats(),
        batch=server.rules._clean(server.rules.batch),
        kv_seq=server.rules._clean(server.rules.kv_seq),
        mode=moe.moe_mode(cfg32, _decode_rules(server.rules)))
    del server
    torch.cuda.empty_cache()
    return out


def _spmd_times(device, calls):
    """Kernel, plain version, library call and bound at the ranks' local
    shapes, on the card alone after the ranks have exited (bf16, CUDA
    events): {(kind, shapes, window): record}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    out = {}
    for kind, shapes, opts in calls:
        rnd, _ = _rnd(device, torch.bfloat16, 1)
        if kind == "ssd":
            ssd = _ssd_at(device, shapes, 1)
            nb, ops = ssd_mod.ssd_bound(ssd["x"], ssd["B"], opts)
            out[(kind, shapes, opts)] = dict(
                ms=_event_ms(lambda: ssd_mod.ssd_scan(**ssd, chunk=opts), 5),
                plain_ms=_event_ms(lambda: ref.ssd_scan_ref(**ssd), 1),
                library_ms=None, library=None,
                bound=_bound(nb, ops, BF16_OPS_PER_S))
            del ssd
        elif kind == "flash":
            q, k, v = (rnd(*s) for s in shapes)
            causal, window = _flash_mask(opts)
            nb, ops = fa.flash_bound(q, k, causal=causal, window=window)
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, enable_gqa=True)
            else:
                i = torch.arange(q.shape[2], device=device)
                band = (i[None, :] <= i[:, None]) & \
                    (i[None, :] > i[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=band, enable_gqa=True)
            out[(kind, shapes, opts)] = dict(
                ms=_event_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, window=window), 5),
                plain_ms=_event_ms(lambda: ref.flash_attention_ref(
                    q, k, v, causal=causal, window=window), 1),
                library_ms=_event_ms(lib, 5),
                library="scaled_dot_product_attention",
                bound=_bound(nb, ops, BF16_OPS_PER_S))
            del q, k, v, lib
        else:
            lhs = rnd(*shapes[0])
            rhs = rnd(*shapes[1], scale=shapes[1][1] ** -0.5)
            nb, ops = gmm_mod.gmm_bound(lhs, rhs)
            out[(kind, shapes, opts)] = dict(
                ms=_event_ms(lambda: gmm_mod.grouped_matmul(lhs, rhs), 5),
                plain_ms=_event_ms(lambda: ref.grouped_matmul_ref(lhs, rhs),
                                   2),
                library_ms=_event_ms(lambda: torch.bmm(lhs, rhs), 5),
                library="torch.bmm", bound=_bound(nb, ops, BF16_OPS_PER_S))
            del lhs, rhs
        torch.cuda.empty_cache()
    return out


def _rel_err(a, b):
    """max |a - b| over max |b| (numpy arrays)."""
    import numpy as np
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def spmd_phase(device):
    """Phase 12, ``[spmd]``: serving on a mesh.  4 ranks (data 2 x model
    2) share the card and talk over gloo (NCCL refuses two ranks of one
    communicator on one device), so nothing here measures an
    interconnect.  Checks: the mechanisms on CUDA tensors; every flash and
    GMM launch on every rank by variant; each rank's kernel outputs
    against their plain versions at its local shapes; the gathered
    Qwen2-72B prefill logits against the same model unsharded on the
    card; the xy / ep / local Mixtral logits against each other at a
    capacity factor that drops nothing; the fp32 mesh ``Server``'s tokens
    identical to the single-card ``Server``'s.  Returns its records."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import Request, Server
    from repro_torch.launch.step import prefill_step
    from repro_torch.models.convert import init_params
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel import comm
    card = card_line()
    rng = np.random.default_rng(1)
    vocab = _spmd_cfg(MIXTRAL).vocab_size
    requests = [(r, rng.integers(0, vocab, size=16).astype(np.int32), 16)
                for r in range(8)]
    print(f"[spmd] {card}: {SPMD_LABEL}; backend gloo, ops staged through "
          f"the host on it: {sorted(comm.HOST_STAGED['gloo'])}; this process "
          f"holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    kind = torch.device(device).type
    ranks = spawn(_spmd_rank, SPMD_WORLD, "gloo", device=kind,
                  args=({"requests": requests, "device": kind},),
                  timeout=600)
    ranks_wall = time.perf_counter() - t_phase
    for r, rec in enumerate(ranks):
        bad = [k for k, ok in rec["collectives"].items() if not ok]
        check(not bad, f"[spmd] rank {r}: collectives differ from the "
              f"single-process result: {bad}")
    print(f"[spmd] collectives on CUDA tensors equal the single-process "
          f"result on every rank: {sorted(ranks[0]['collectives'])}")
    g = ranks[0]["gather_s"]
    print(f"[spmd] {card}: a gloo all-gather of 16 MiB a rank into "
          f"{16 * SPMD_WORLD} MiB ({SPMD_LABEL}): on the CUDA tensors "
          f"{g['cuda']:.3f} s, staged through the host {g['host']:.3f} s")

    # Qwen2-72B: 2 wgmma_tma flash a rank, no GMM; logits vs unsharded
    L = SPMD_LAYERS
    for r, rec in enumerate(ranks):
        q = rec["qwen2"]
        check(q["variants"]["flash_attention"] == {
            "wgmma_tma": L, "wgmma_loads": 0, "f32": 0}
            and sum(q["variants"]["moe_gmm"].values()) == 0,
            f"[spmd] rank {r} qwen2 prefill launched {q['variants']}")
        print(f"[spmd] {card}: {QWEN2} widths, {L} layers, "
              f"{SPMD_BATCH} x {SPMD_QWEN_TOKENS} prefill, manual TP, rank "
              f"{r} ({SPMD_LABEL}): {q['bytes'] / 2**30:.2f} GiB of "
              f"weights drawn in {q['draw']:.1f} s; wall {q['wall']:.3f} s "
              f"(again {q['warm']:.3f} s); launches {q['variants']}; local "
              f"kernel calls {q['calls']}; collectives per layer "
              f"{q['comm_per_layer']}; whole prefill {q['comm']}; peak "
              f"memory {q['peak'] / 2**30:.2f} GiB")
    cfg = _spmd_cfg(QWEN2)
    full = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    model = Transformer(cfg, device, params=full)
    tokens = torch.from_numpy(_spmd_tokens(cfg, SPMD_QWEN_TOKENS)).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = prefill_step(model, {"tokens": tokens}).float().cpu().numpy()
    single_wall = time.perf_counter() - t0
    del model, full
    torch.cuda.empty_cache()
    qerr = max(_rel_err(rec["qwen2"]["logits"], single) for rec in ranks)
    print(f"[spmd] {card}: {QWEN2} gathered prefill logits (every rank) vs "
          f"the same model unsharded on the card (one process, wall "
          f"{single_wall:.3f} s): max error {qerr:.3e} of the largest "
          f"logit (tolerance 2e-2, the bf16 bar of [train ops]); argmax "
          f"equal on {int((ranks[0]['qwen2']['logits'].argmax(-1) == single.argmax(-1)).sum())}"
          f"/{SPMD_BATCH} rows")
    check(qerr <= 2e-2 and all(np.isfinite(rec["qwen2"]["logits"]).all()
                               for rec in ranks),
          f"[spmd] sharded qwen2 logits differ from unsharded by {qerr}")

    # Mixtral: per mode and rank 6 tma GMM, 2 flash; no-drop logits agree
    want = {"flash_attention": {"wgmma_tma": L, "wgmma_loads": 0, "f32": 0},
            "moe_gmm": {"tma": 3 * L, "decode": 0, "ragged": 0, "f32": 0}}
    for r, rec in enumerate(ranks):
        for mode, m in rec["mixtral"].items():
            for label, run in m.items():
                got = {k: run["variants"][k] for k in want}
                check(got == want and run["variants"]["ssd_scan"] ==
                      dict.fromkeys(run["variants"]["ssd_scan"], 0),
                      f"[spmd] rank {r} mixtral {mode} {label} launched "
                      f"{run['variants']}, expected {want}")
            print(f"[spmd] {card}: {MIXTRAL} widths, {L} layers, "
                  f"{SPMD_BATCH} x {SPMD_MIXTRAL_TOKENS} prefill (window "
                  f"4096), dispatch {mode}, rank {r} ({SPMD_LABEL}): "
                  f"capacity factor 1.25: wall {m['published']['wall']:.3f}"
                  f" s, {m['published']['drops']} assignments dropped, "
                  f"launches {m['published']['variants']}, local kernel "
                  f"calls {m['published']['calls']}, collectives per layer "
                  f"{m['published']['comm_per_layer']}; capacity factor "
                  f"{SPMD_NO_DROP_CF} at {SPMD_BATCH} x "
                  f"{SPMD_NO_DROP_TOKENS}: wall {m['no drop']['wall']:.3f} "
                  f"s, {m['no drop']['drops']} dropped")
            check(m["no drop"]["drops"] == 0, f"[spmd] {mode} dropped "
                  f"at capacity factor {SPMD_NO_DROP_CF}")
        print(f"[spmd] rank {r} peak memory: qwen2 "
              f"{rec['qwen2']['peak'] / 2**30:.2f} GiB, mixtral "
              f"{rec['mixtral_peak'] / 2**30:.2f} GiB")
    base = ranks[0]["mixtral"]["xy"]["no drop"]["logits"]
    merr = max(_rel_err(rec["mixtral"][mode]["no drop"]["logits"], base)
               for rec in ranks for mode in SPMD_MODES)
    print(f"[spmd] {MIXTRAL} logits of {SPMD_BATCH} x {SPMD_NO_DROP_TOKENS} "
          f"tokens at capacity factor {SPMD_NO_DROP_CF} (nothing dropped), "
          f"every mode and rank vs xy on rank 0: max "
          f"error {merr:.3e} of the largest logit (tolerance 2e-2)")
    check(merr <= 2e-2, f"[spmd] mixtral modes disagree by {merr}")
    kerr = max(e for rec in ranks for e in rec["kernel_errs"].values())

    # the fp32 mesh Server vs the single-card Server
    cfg32 = dataclasses.replace(_spmd_cfg(MIXTRAL), dtype="float32")
    server = Server(cfg32, slots=4, max_seq=64, device=device)
    for rid, prompt, max_new in requests:
        server.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    t0 = time.perf_counter()
    server.run(tick_limit=1000)
    single_server = time.perf_counter() - t0
    alone = [r.out for r in sorted(server.completed, key=lambda r: r.rid)]
    ticks = server.ticks
    del server
    torch.cuda.empty_cache()
    for r, rec in enumerate(ranks):
        s = rec["server"]
        per_tick = {k: {v: n / max(s["ticks"], 1) for v, n in d.items()
                        if n} for k, d in s["variants"].items()}
        print(f"[spmd] {card}: fp32 {MIXTRAL} widths, {L} layers, mesh "
              f"Server rank {r} ({SPMD_LABEL}; rows over {s['batch']}, KV "
              f"cache over {s['kv_seq']}, MoE {s['mode']}): 8 requests x 16 "
              f"prompt tokens, 16 new, 4 slots: {s['ticks']} ticks, wall "
              f"{s['wall']:.3f} s ({s['wall'] / s['ticks'] * 1e3:.1f} ms a "
              f"tick; one card alone {single_server / ticks * 1e3:.1f} ms); "
              f"launches per tick {per_tick}; collectives {s['comm']}")
        check(s["outs"] == alone and s["ticks"] == ticks,
              f"[spmd] rank {r}: mesh Server tokens differ from the "
              f"single-card Server's")
        check(s["variants"]["moe_gmm"]["f32"] == 3 * L * s["ticks"],
              f"[spmd] rank {r}: server GMM launches {s['variants']}")
    print(f"[spmd] mesh Server tokens identical to the single-card Server "
          f"on every rank ({ticks} ticks)")

    calls = sorted({c for rec in ranks for c in rec["qwen2"]["calls"]} |
                   {c for rec in ranks for m in rec["mixtral"].values()
                    for c in m["published"]["calls"]})
    times = _spmd_times(device, calls)
    for key, t in times.items():
        print(f"[spmd times] {card}: {key[0]} at a rank's local shape "
              f"{key[1]} window {key[2]} (the card alone): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"{t['library']} {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.4f} ms by {t['bound'][1]}")
    print(f"[spmd] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"(the ranks {ranks_wall:.1f} s of it)")
    return {"ranks": ranks, "times": times, "kernel_err": kerr}


def spmd_entries(spmd, replaces):
    """The ``kernels`` entries of the [spmd] paths: one per kernel and
    local shape of the published runs (Qwen2-72B's prefill; each Mixtral
    dispatch mode's prefill at capacity factor 1.25), its launches summed
    over the ranks (``launches_by_rank`` beside), its error the worst
    rank's against the plain version, its times at that local shape on
    the card alone."""
    ranks, times = spmd["ranks"], spmd["times"]
    runs = [("qwen2", None, lambda rec: rec["qwen2"])] + \
        [(f"mixtral_{m}", m, lambda rec, m=m: rec["mixtral"][m]["published"])
         for m in SPMD_MODES]
    out = []
    for label, mode, get in runs:
        calls = sorted({c for rec in ranks for c in get(rec)["calls"]})
        for kind in ("flash", "gmm"):
            mine = [c for c in calls if c[0] == kind]
            if not mine or (kind == "flash" and mode not in (None, "xy")):
                continue         # the modes share one flash shape: one entry
            name = "flash_attention" if kind == "flash" else "moe_gmm"
            variant = "wgmma_tma" if kind == "flash" else "tma"
            key = mine[0]
            by_rank = [get(rec)["variants"][name][variant] for rec in ranks]
            if kind == "flash" and mode == "xy":     # every mode's launches
                by_rank = [sum(rec["mixtral"][m]["published"]["variants"]
                               [name][variant] for m in SPMD_MODES)
                           for rec in ranks]
            t = times[key]
            entry = {
                "name": f"{name}_spmd_{label if kind == 'gmm' else label.split('_')[0]}",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces[name], "launches": sum(by_rank),
                "launches_by_rank": by_rank,
                "max_abs_err": max(rec["kernel_errs"][key[:2]]
                                   for rec in ranks),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"], "library": t["library"],
                "checked_against_plain": True, "variant": variant,
                "path": f"[spmd] {label} prefill, {SPMD_LABEL}",
                "shape": f"local {key[1]} window {key[2]}"}
            if kind == "gmm" and len(mine) > 1:
                d = times[mine[1]]
                entry["down"] = {"shape": f"local {mine[1][1]}",
                                 "ms": d["ms"], "plain_ms": d["plain_ms"],
                                 "library_ms": d["library_ms"],
                                 "bound_ms": d["bound"][0],
                                 "bound_by": d["bound"][1],
                                 "max_abs_err": max(
                                     rec["kernel_errs"][mine[1][:2]]
                                     for rec in ranks)}
            check(entry["launches"] > 0, f"{entry['name']} never launched")
            out.append(entry)
    return out


# ----------------------------------------------------------------------
# [spmd train]: training on a mesh of ranks sharing the card
# ----------------------------------------------------------------------
SPMD_TRAIN_BATCH, SPMD_TRAIN_STEPS = 2, 2
SPMD_TRAIN_BAR = 3e-2        # relative L2 a parameter, bf16
# the dispatch modes run: xy (baseline) is the main path; ep runs the
# global FIFO, one card's, so it drops nearly the assignments one card
# drops (the bf16 router inputs differ in their last bits on a mesh, so a
# few near-tied choices differ) and is the run whose step-1 gradients are
# held to one card's too (xy's own FIFOs drop other assignments: at this
# random initialisation about 45% of them drop at the published capacity
# factor, in either layout); both runs' last-step parameters are held
SPMD_TRAIN_MODES = ("xy", "ep")


def _spmd_train_cfg():
    """Moonshot's published widths, 2 of 48 layers (as phase 11)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOONSHOT),
                               num_layers=MOONSHOT_TRAIN_LAYERS)


def _tap_adam(taps, step_of):
    """Wrap ``optim.adamw._adam`` so that on step 1 (``step_of()``) each
    gradient it is handed (the clipped, reduced gradient of a parameter
    or of this rank's bank of it, fp32) is kept in ``taps`` as bf16 on
    the host; returns the restore function."""
    import torch
    from repro_torch.optim import adamw
    real = adamw._adam

    def tapped(cfg, name, g, state, lr, b1c, b2c):
        if step_of() == 0:
            taps[name] = g.to(torch.bfloat16).cpu()
        return real(cfg, name, g, state, lr, b1c, b2c)
    adamw._adam = tapped
    return lambda: setattr(adamw, "_adam", real)


def _leaf_file(path, t):
    """A tensor to ``path`` (.npy) in its own dtype: bf16 as its uint16
    bits, fp32 as float32."""
    import numpy as np
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        np.save(path, t.view(torch.int16).numpy().view(np.uint16))
    else:
        np.save(path, t.float().numpy())


def _leaf_block(path, where):
    """``where`` of the array of ``path`` (written by :func:`_leaf_file`),
    as fp32 (torch)."""
    import numpy as np
    import torch
    raw = np.array(np.load(path, mmap_mode="r")[where])
    if raw.dtype == np.uint16:
        return torch.from_numpy(raw.view(np.int16)).view(
            torch.bfloat16).float()
    return torch.from_numpy(raw).float()


def _worst(errs):
    """(name, error) of the largest of ``errs``, a non-finite one first."""
    import numpy as np
    name = max(errs, key=lambda k: errs[k] if np.isfinite(errs[k]) else np.inf)
    return name, errs[name]


def _all_within(errs, bar):
    """Every error of ``errs`` finite and at most ``bar``."""
    import numpy as np
    return all(np.isfinite(v) and v <= bar for v in errs.values())


def spmd_train_yardstick(device, out):
    """[spmd train] (1): the yardstick on one card, first, in this
    process: ``make_trainer`` of Moonshot's widths (2 layers), 2 x 4096
    tokens, full remat, 2 steps on the pipeline's batch 0 from
    ``init(seed=0)``.  The step-1 gradients (clipped, as AdamW takes
    them, and unclipped again by the step's norm, as bf16) and the step-2
    parameters (each in its own dtype: the router fp32, the rest bf16) go
    to ``out`` as ``.npy``; the card is freed.
    Returns (losses, grad norms, wall per step)."""
    import os
    import numpy as np
    import torch
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.train import make_trainer
    from repro_torch.models import moe
    cfg = _spmd_train_cfg()
    tr = make_trainer(cfg, TRAIN_SEQ, SPMD_TRAIN_BATCH, SPMD_TRAIN_STEPS,
                      device=device, remat="full", ckpt_dir=None)
    tr.init(seed=0)
    data = synthetic_batch(cfg, tr.shape, 0)
    taps, losses, norms, stamps = {}, [], [], []
    restore = _tap_adam(taps, lambda: len(losses))

    def on_step(step, m):
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with moe.counting_drops() as dropped:
            _run_on(tr, data, on_step)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    drops = int(sum(int(d) for d in dropped))
    scale = min(1.0, tr.opt_cfg.clip_norm / max(norms[0], 1e-12))
    os.makedirs(os.path.join(out, "grads"))
    os.makedirs(os.path.join(out, "params"))
    for name, g in taps.items():
        _leaf_file(os.path.join(out, "grads", name.replace("/", "@")),
                   (g.float() / scale).to(torch.bfloat16))
    for name, p in tr.model.named_parameters():
        _leaf_file(os.path.join(out, "params", name.replace("/", "@")), p)
    tr.close()
    del tr, taps
    torch.cuda.empty_cache()
    return dict(losses=losses, norms=norms, peak=peak, drops=drops,
                step_s=list(np.diff([t0] + stamps)))


def _spmd_train_rank(rank, plan):
    """The [spmd train] program of one rank (4 ranks sharing the card over
    gloo): ``make_trainer(..., mesh=mesh)`` of the yardstick's config and
    batch, 2 steps; the launches by forward, remat and backward, the
    collectives by phase and the wall of every step; its step-1
    gradient banks and step-2 parameter blocks against its cut of the
    yardstick's; then, one rank at a time, each distinct kernel call it
    made and its flash and GMM ops (forward and backward) at its local
    shapes against the plain versions."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_trainer
    from repro_torch.models import moe
    from repro_torch.models.convert import state_layout
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import block_of
    device = str(resolve_device(plan["device"]))
    mesh = make_test_mesh(SPMD_MESH, ("data", "model"), device)
    cfg = _spmd_train_cfg()
    t0 = time.perf_counter()
    tr = make_trainer(cfg, TRAIN_SEQ, SPMD_TRAIN_BATCH, SPMD_TRAIN_STEPS,
                      device=device, ckpt_dir=None, mesh=mesh,
                      dispatch=plan["dispatch"])
    tr.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rules = tr.rules
    data = synthetic_batch(cfg, tr.shape, 0)
    calls, fwd_calls, in_fwd = [], set(), [False]

    def log(call):
        calls.append(call)
        if in_fwd[0]:
            fwd_calls.add(call)

    def flash_log(q, k, v, **kw):
        log(("flash", (tuple(q.shape), tuple(k.shape), tuple(v.shape)),
             kw.get("window")))
        return real_flash(q, k, v, **kw)

    def gmm_log(lhs, rhs):
        log(("gmm", (tuple(lhs.shape), tuple(rhs.shape)), None))
        return real_gmm(lhs, rhs)
    real_flash, real_gmm = ops.flash_attention, ops._gmm_kernel
    ops.flash_attention, ops._gmm_kernel = flash_log, gmm_log
    # launches in the forward (the loss) and in the GMM's backward
    fwd, bwd = [], []
    real_loss, real_bwd = tr.model.loss, ops._GMM.backward

    def loss(*a, **kw):
        before = read_variants()
        in_fwd[0] = True
        try:
            out = real_loss(*a, **kw)
        finally:
            in_fwd[0] = False
        fwd.append({k: {v: n - before[k][v] for v, n in d.items()}
                    for k, d in read_variants().items()})
        return out

    def gmm_backward(ctx, g):
        before = _wrappers()["moe_gmm"].launches
        out = real_bwd(ctx, g)
        bwd.append(_wrappers()["moe_gmm"].launches - before)
        return out
    tr.model.loss = loss
    ops._GMM.backward = staticmethod(gmm_backward)
    taps, losses, variants, phases, stamps = {}, [], [], [], []
    restore = _tap_adam(taps, lambda: len(losses))

    def on_step(step, m):
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        variants.append(read_variants())
        phases.append(comm.phase_stats())
        zero_counts()
        comm.reset_comm_stats()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()
    comm.reset_comm_stats()
    t1 = time.perf_counter()
    try:
        with moe.counting_drops() as dropped:
            _run_on(tr, data, on_step)
    finally:
        restore()
        ops.flash_attention, ops._gmm_kernel = real_flash, real_gmm
        ops._GMM.backward = staticmethod(real_bwd)
    peak = torch.cuda.max_memory_allocated()
    drops = int(sum(int(d) for d in dropped))
    step_s = list(np.diff([t1] + stamps))
    # against the yardstick: this rank's banks / blocks of its arrays
    scale = min(1.0, tr.opt_cfg.clip_norm / max(losses[0][1], 1e-12))
    banks = state_layout(cfg, rules)
    specs = tr.model.param_specs(cfg, rules)
    grad_err, param_err = {}, {}
    for name, p in tr.model.named_parameters():
        f = name.replace("/", "@") + ".npy"
        g = taps[name].float() / scale
        want = _leaf_block(os.path.join(plan["dir"], "grads", f),
                           block_of(mesh, banks[name], tuple(g.shape))[1])
        grad_err[name] = float((g - want).norm() / want.norm().clamp_min(
            1e-30))
        got = p.detach().float().cpu()
        want = _leaf_block(os.path.join(plan["dir"], "params", f),
                           block_of(mesh, specs[name], tuple(got.shape))[1])
        param_err[name] = float((got - want).norm() / want.norm().clamp_min(
            1e-30))
    held = sum(p.numel() for p in tr.model.parameters())
    state_n = sum(t.numel() for q in ("master", "m", "v")
                  for t in tr.opt_state[q].values())
    tr.close()
    del tr, taps
    torch.cuda.empty_cache()
    # one rank at a time: each distinct kernel call, then the ops'
    # forward and backward at the local shapes, against plain
    seen = sorted(set(calls))
    errs, op_errs = {}, {}
    for turn in range(mesh.size):
        if turn == rank:
            errs = _spmd_kernel_checks(seen, device, 20 + rank)
            op_errs = _spmd_train_op_checks(sorted(fwd_calls), device,
                                            30 + rank)
            torch.cuda.empty_cache()
        dist.barrier()
    return dict(
        rules=dict(dispatch=rules.dispatch, zero1=rules.zero1,
                   remat=rules.remat, batch=rules._clean(rules.batch)),
        losses=losses, step_s=step_s, init_s=init_s, variants=variants,
        drops=drops,
        fwd=fwd, bwd=bwd, phases=phases, peak=peak, held=held, state_n=state_n,
        grad_err=grad_err, param_err=param_err, calls=seen,
        fwd_calls=sorted(fwd_calls),
        kernel_errs=errs, op_errs=op_errs)


def _spmd_train_op_checks(seen, device, seed):
    """The flash and GMM autograd ops at each local forward call of
    ``seen`` (kernel layouts), forward and backward against the plain
    versions by autograd (bf16; the output and each gradient within 2e-2
    of its largest magnitude, the bar of ``[train ops]``): {(kind,
    shapes): worst relative error}."""
    import torch
    from repro_torch.kernels import ops
    out = {}
    rnd, g = _rnd(device, torch.bfloat16, seed)
    for kind, shapes, window in seen:
        if kind == "flash":
            (B, H, S, hd), (_, K, _, _) = shapes[0], shapes[1]
            args = [rnd(B, S, H, hd).requires_grad_(),
                    rnd(B, S, K, hd).requires_grad_(),
                    rnd(B, S, K, hd).requires_grad_()]
            kw = dict(causal=True, window=window)
            got = ops.flash_attention_op(*args, **kw)
        else:
            (E, m, k), (_, _, n) = shapes
            args = [rnd(E, m, k).requires_grad_(),
                    rnd(E, k, n, scale=k ** -0.5).requires_grad_()]
            kw = {}
            got = ops.grouped_matmul(*args)
        proj = torch.randn(got.shape, generator=g, device=device)
        dg = torch.autograd.grad((got.float() * proj).sum(), args)
        want = _plain_op(kind, args, kw)
        dw = torch.autograd.grad((want.float() * proj).sum(), args)
        got, want = got.detach().float(), want.detach().float()
        worst = float((got - want).abs().max()
                      / want.abs().max().clamp_min(1e-30))
        for a, b in zip(dg, dw):
            worst = max(worst, float((a.float() - b.float()).abs().max()
                                     / b.float().abs().max().clamp_min(
                                         1e-30)))
        print(f"[spmd train rank] {kind} op at the local shape {shapes}: "
              f"forward and backward vs plain, max error {worst:.3e} of "
              f"the largest magnitude (tolerance 2e-2)")
        check(worst <= 2e-2 and bool(torch.isfinite(got).all()),
              f"[spmd train] {kind} op at {shapes} differs from plain")
        out[(kind, shapes)] = worst
        del args, got, want, dg, dw, proj
    return out


# what each counted collective runs on the wire (a backward is its
# forward's transpose), for the staging table
_WIRE_OP = {"all_gather": "all_gather", "all_gather.bwd": "reduce_scatter",
            "reduce_scatter": "reduce_scatter",
            "reduce_scatter.bwd": "all_gather",
            "all_reduce_sum": "all_reduce_sum",
            "all_reduce_sum.bwd": "all_reduce_sum",
            "all_reduce_max": "all_reduce_max", "all_to_all": "all_to_all",
            "all_to_all.bwd": "all_to_all", "ppermute": "ppermute",
            "ppermute.bwd": "ppermute"}


def spmd_train_phase(device):
    """Phase 13, ``[spmd train]``: training on a mesh.  The yardstick runs
    first on one card (:func:`spmd_train_yardstick`) and frees it; then 4
    ranks (data 2 x model 2) share the card over gloo, each a
    ``make_trainer(..., mesh=mesh)`` under ``cell_rules``' ``baseline``
    (ZeRO-1 over ``data``, full remat), 2 steps on the same batch from the
    same seed: with its ``xy`` dispatch (the main path), then with ``ep``
    (:data:`SPMD_TRAIN_MODES`).  Checks on every rank of both runs: the
    rules; each step's launches by variant (flash 2 ``wgmma_tma`` a
    layer, forward and remat; GMM 12 ``tma`` a layer: 3 forward, 3 remat,
    6 backward); each step's loss within 2e-2 relative of one card's;
    each kernel call and each op's forward and backward at its local
    shapes against plain; each parameter's step-2 block within 3e-2
    relative L2 of its cut of one card's, finite.  On the ``ep`` run,
    whose global FIFO drops nearly what one card's drops, each
    parameter's step-1 gradient bank too.  Returns its records."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.parallel import comm
    card = card_line()
    L = MOONSHOT_TRAIN_LAYERS
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="spmd_train_")
    runs, walls = {}, {}
    try:
        yard = spmd_train_yardstick(device, out)
        print(f"[spmd train] {card}: yardstick, one card alone: {MOONSHOT} "
              f"widths, {L} of 48 layers, {SPMD_TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens, full remat, {SPMD_TRAIN_STEPS} steps on batch 0: "
              f"losses {yard['losses']}, grad norms {yard['norms']}; "
              f"{' '.join(f'{t * 1e3:.1f}' for t in yard['step_s'])} ms a "
              f"step; peak memory {yard['peak'] / 2**30:.2f} GiB; "
              f"{yard['drops']} assignments dropped over the "
              f"{SPMD_TRAIN_STEPS} steps' {4 * SPMD_TRAIN_STEPS} "
              f"MoE calls (forward and remat) of "
              f"{12 * SPMD_TRAIN_BATCH * TRAIN_SEQ * 6}")
        print(f"[spmd train] {SPMD_LABEL}: backend gloo (chosen "
              f"explicitly: NCCL refuses two ranks of one communicator on "
              f"one device); ops staged through the host on it: "
              f"{sorted(comm.HOST_STAGED['gloo'])}")
        torch.cuda.empty_cache()
        kind = torch.device(device).type
        for mode in SPMD_TRAIN_MODES:
            t0 = time.perf_counter()
            runs[mode] = spawn(_spmd_train_rank, SPMD_WORLD, "gloo",
                               device=kind, args=({"device": kind, "dir": out,
                                                   "dispatch": mode},),
                               timeout=900)
            walls[mode] = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    want = {"flash_attention": {"wgmma_tma": 2 * L},
            "moe_gmm": {"tma": 12 * L}, "ssd_scan": {}}
    fwd_want = {"flash_attention": {"wgmma_tma": L},
                "moe_gmm": {"tma": 3 * L}}
    for mode, ranks in runs.items():
        for r, rec in enumerate(ranks):
            _spmd_train_checks(mode, r, rec, yard, want, fwd_want, card, L)
        print(f"[spmd train] {mode}: assignments dropped over the "
              f"{SPMD_TRAIN_STEPS} steps a "
              f"rank {[rec['drops'] for rec in ranks]} (one card "
              f"{yard['drops']}; ep runs one card's global FIFO on every "
              f"rank, xy a FIFO a rank at each of its three stages)")
    ops_seen = sorted({op for ranks in runs.values() for rec in ranks
                       for st in rec["phases"] for d in st.values()
                       for op in d})
    print(f"[spmd train] collectives run, each with what it runs on the "
          f"wire and whether gloo stages it through the host for CUDA "
          f"tensors: " + ", ".join(
              f"{op} ({_WIRE_OP[op]}, "
              f"{'staged' if _WIRE_OP[op] in comm.HOST_STAGED['gloo'] else 'on the CUDA tensors'})"
              for op in ops_seen))
    calls = sorted({c for ranks in runs.values() for rec in ranks
                    for c in rec["calls"]})
    times = _spmd_times(device, calls)
    for key, t in times.items():
        print(f"[spmd train times] {card}: {key[0]} at a rank's local "
              f"training shape {key[1]} (the card alone): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"{t['library']} {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.4f} ms by {t['bound'][1]}")
    print(f"[spmd train] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"(the ranks: {', '.join(f'{m} {w:.1f} s' for m, w in walls.items())})")
    return {"runs": runs, "times": times, "yard": yard}


def _spmd_train_checks(mode, r, rec, yard, want, fwd_want, card, L):
    """[spmd train]'s checks and lines for rank ``r``'s record of the run
    in dispatch ``mode``."""
    import numpy as np
    check(rec["rules"]["dispatch"] == mode and rec["rules"]["remat"]
          == "full" and rec["rules"]["zero1"] == "data",
          f"[spmd train] {mode} rank {r} rules {rec['rules']}")
    for i, v in enumerate(rec["variants"]):
        for k, d in v.items():
            for var, n in d.items():
                check(n == want[k].get(var, 0),
                      f"[spmd train] {mode} rank {r} step {i + 1}: {k} "
                      f"launched {d}, expected {want[k]}")
        for k, d in fwd_want.items():
            check({a: b for a, b in rec["fwd"][i][k].items() if b} == d,
                  f"[spmd train] {mode} rank {r} step {i + 1} forward "
                  f"launched {rec['fwd'][i]}, expected {fwd_want}")
    check(len(rec["bwd"]) == 3 * L * SPMD_TRAIN_STEPS
          and all(n == 2 for n in rec["bwd"]),
          f"[spmd train] {mode} rank {r}: backward GMM launches {rec['bwd']}")
    for i, ((loss, _n), ref) in enumerate(zip(rec["losses"],
                                              yard["losses"])):
        rel = abs(loss - ref) / abs(ref)
        check(np.isfinite(loss) and rel <= 2e-2,
              f"[spmd train] {mode} rank {r} step {i + 1} loss {loss} vs "
              f"one card's {ref}")
    worst_g, g = _worst(rec["grad_err"])
    worst_p, p = _worst(rec["param_err"])
    per_step = {f"step {i + 1}": {
        ph: {op: f"{d['calls']} calls, {d['bytes'] / 2**20:.1f} MiB"
             for op, d in sorted(ops_.items())}
        for ph, ops_ in st.items()} for i, st in enumerate(rec["phases"])}
    grads_held = mode == "ep"
    print(f"[spmd train] {card}: {MOONSHOT} widths, {L} layers, "
          f"{SPMD_TRAIN_BATCH} x {TRAIN_SEQ} tokens, dispatch {mode}, rank "
          f"{r} ({SPMD_LABEL}; rows over {rec['rules']['batch']}, ZeRO-1 "
          f"over data, remat full): {rec['held'] / 1e9:.3f} B parameters "
          f"held, {rec['state_n'] / 1e9:.3f} B optimizer elements a rank "
          f"(init {rec['init_s']:.1f} s); losses "
          f"{[round(x[0], 6) for x in rec['losses']]} (one card "
          f"{[round(x, 6) for x in yard['losses']]}); ms a step "
          f"{' '.join(f'{t * 1e3:.1f}' for t in rec['step_s'])}; peak "
          f"memory {rec['peak'] / 2**30:.2f} GiB; launches a step "
          f"{rec['variants'][0]} (forward {rec['fwd'][0]}, backward GMM "
          f"{sum(rec['bwd']) // SPMD_TRAIN_STEPS}, the rest the remat); "
          f"{rec['drops']} assignments dropped; step-1 gradient banks vs "
          f"one card's: worst relative L2 {g:.3e} ({worst_g}) "
          + (f"(tolerance {SPMD_TRAIN_BAR})" if grads_held else
             "(not held: this layout drops other assignments than one "
             "card's FIFO)")
          + f"; step-{SPMD_TRAIN_STEPS} parameter blocks: worst {p:.3e} "
          f"({worst_p}) "
          f"(tolerance {SPMD_TRAIN_BAR})")
    print(f"[spmd train] {mode} rank {r} relative L2 a parameter vs one "
          f"card's: step-1 gradients "
          f"{ {k: float(f'{v:.3e}') for k, v in rec['grad_err'].items()} }"
          f"; step-{SPMD_TRAIN_STEPS} parameters "
          f"{ {k: float(f'{v:.3e}') for k, v in rec['param_err'].items()} }")
    print(f"[spmd train] {mode} rank {r} collectives by phase: {per_step}")
    check(_all_within(rec["param_err"], SPMD_TRAIN_BAR),
          f"[spmd train] {mode} rank {r}: step-{SPMD_TRAIN_STEPS} parameters "
          f"{rec['param_err']} not all within {SPMD_TRAIN_BAR} of one card's")
    if grads_held:
        check(_all_within(rec["grad_err"], SPMD_TRAIN_BAR),
              f"[spmd train] {mode} rank {r}: step-1 gradients "
              f"{rec['grad_err']} not all within {SPMD_TRAIN_BAR} of one "
              f"card's")


def spmd_train_entries(st, replaces):
    """The ``kernels`` entries of [spmd train]: flash at the ranks' local
    training shape (forward and remat launches of both runs), and per run
    the GMM's forward (gate/up, with down beside; forward and remat
    launches) and its backward products (the first shape, the others
    beside), each with its launches summed over the ranks and steps (by
    rank beside), its error the worst rank's against plain, its times on
    the card alone."""
    times = st["times"]
    out = []
    for mode, ranks in st["runs"].items():
        fwd = sorted({c for rec in ranks for c in rec["fwd_calls"]})
        bwd = sorted({c for rec in ranks for c in rec["calls"]} - set(fwd))
        label = (f"[spmd train] {MOONSHOT} widths, dispatch {mode}, "
                 f"{SPMD_LABEL}")
        rows = [
            (f"moe_gmm_spmd_train_{mode}", "gmm",
             [c for c in fwd if c[0] == "gmm"],
             lambda r: sum(v["moe_gmm"]["tma"] for v in ranks[r]["variants"])
             - sum(ranks[r]["bwd"])),
            (f"moe_gmm_spmd_train_{mode}_backward", "gmm", bwd,
             lambda r: sum(ranks[r]["bwd"]))]
        if mode == SPMD_TRAIN_MODES[0]:          # both runs' flash shape
            rows.insert(0, (
                "flash_attention_spmd_train", "flash",
                [c for c in fwd if c[0] == "flash"],
                lambda r: sum(v["flash_attention"]["wgmma_tma"]
                              for rs in st["runs"].values()
                              for v in rs[r]["variants"])))
        for name, kind, mine, n_of in rows:
            check(bool(mine), f"{name}: no kernel call logged")
            key = mine[0]
            t = times[key]
            by_rank = [n_of(r) for r in range(len(ranks))]
            kernel = "flash_attention" if kind == "flash" else "moe_gmm"
            entry = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{kernel}.cu",
                "replaces": replaces[kernel], "launches": sum(by_rank),
                "launches_by_rank": by_rank,
                "max_abs_err": max(rec["kernel_errs"][key[:2]]
                                   for rec in ranks),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"], "library": t["library"],
                "checked_against_plain": True,
                "variant": "wgmma_tma" if kind == "flash" else "tma",
                "path": label, "shape": f"local {key[1]}"}
            if not name.endswith("_backward"):
                entry["op_grad_rel_err_vs_plain"] = max(
                    rec["op_errs"].get(key[:2], 0.0) for rec in ranks)
            if len(mine) > 1:
                entry["other_shapes"] = {
                    str(c[1]): {"ms": times[c]["ms"],
                                "plain_ms": times[c]["plain_ms"],
                                "library_ms": times[c]["library_ms"],
                                "bound_ms": times[c]["bound"][0],
                                "bound_by": times[c]["bound"][1],
                                "max_abs_err": max(rec["kernel_errs"][c[:2]]
                                                   for rec in ranks)}
                    for c in mine[1:]}
            check(entry["launches"] > 0, f"{name} never launched")
            out.append(entry)
    return out


# ----------------------------------------------------------------------
# [spmd pipeline]: the rest of SPMD training on ranks sharing the card
# ----------------------------------------------------------------------
# Moonshot's widths, 4 layers: 2 stages of 2 on ``model``, rows over
# ``data``, 4 microbatches of 1 x 4096 tokens a data rank
PIPE_LAYERS, PIPE_MICRO = 4, 4
# the stage body's remat (each layer): without it four ranks' activations
# of 10 layer applications each (~19 GiB a rank) do not fit the card
PIPE_REMAT = "full"
PIPE_PEAK_GIB = 18.0         # four ranks share the card's 80 GB
PIPE_GRAD_BAR = 1e-2         # relative L2 a stage gradient vs one card
# cross_pod_psum over ``data``: every gradient of a stage's attention,
# norms and router, and this many of the 64 experts of each expert
# weight (all 64 would send 4.56 GB of fp32 a rank a reduction through
# gloo, ~0.5-1 GB/s here)
PIPE_EXPERTS_COMPRESSED = 4
# Trainer.reshard: the reduced Moonshot at a capacity factor at which
# nothing drops (the CPU tests' 8), 2 steps on (2, 2), 2 on (1, 2)
RESHARD_SEQ, RESHARD_BATCH, RESHARD_STEPS, RESHARD_CF = 64, 4, 4, 8.0
RESHARD_MESH = (1, 2)
RESHARD_BAR = 1e-3
# ``ep`` (one card's global FIFO and its load-balance loss over the global
# tokens): ``xy``'s aux loss is its islands' mean (the reference's
# ``_pmean_all``), not one card's, so its losses differ from one card's
# by ~1e-3 relative at this size (its cross entropy by ~4e-6)
RESHARD_DISPATCH = "ep"


def _pipe_cfg():
    """Moonshot's published widths, :data:`PIPE_LAYERS` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOONSHOT), num_layers=PIPE_LAYERS)


def _reshard_cfg():
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config(MOONSHOT))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=RESHARD_CF))


def _pipe_layers(cfg, device, stage=None):
    """The ``layers/`` parameters of ``draw_params(cfg)`` under their
    short names, each (L, ...); with ``stage``, that stage's (L / 2, ...)
    slice (the rest freed)."""
    import torch
    params, _nbytes, _s = draw_params(device, cfg)
    n = cfg.num_layers // SPMD_MESH[1]
    out = {}
    for name in sorted(params):
        t = params.pop(name)
        if name.startswith("layers/"):
            out[name.split("/", 1)[1]] = t if stage is None else \
                t[stage * n:(stage + 1) * n].clone()
        del t
    torch.cuda.empty_cache()
    return out


def _pipe_microbatch(device, cfg, g):
    """Global microbatch ``g``: (its input (1, 4096, D), the fixed random
    projection its output's loss takes), bf16, seeded by ``g``."""
    import torch
    gen = torch.Generator(device).manual_seed(1000 + g)
    shape = (1, TRAIN_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=device)
    ct = torch.randn(shape, generator=gen, device=device)
    return x.to(torch.bfloat16), ct.to(torch.bfloat16)


def _pipe_body(cfg, device, remat):
    """The stage body: the port's transformer layer (``layer_apply``:
    flash, then the MoE through the GMM) over the stage's layers, each
    under ``remat``."""
    import torch
    from repro_torch.models.base import run_layer
    from repro_torch.models.transformer import layer_apply
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32,
                       device=device).expand(1, TRAIN_SEQ)

    def layer(h, lp):
        return layer_apply(h, lp, cfg, pos)[0]

    def body(sp, h):
        for i in range(next(iter(sp.values())).shape[0]):
            h = run_layer(layer, remat, h, {k: v[i] for k, v in sp.items()})
        return h
    return body


def _pipe_loss(y, ct):
    return (y.float() * ct.float()).sum()


def pipeline_yardstick(device, out):
    """[spmd pipeline] (1a): one card first, in this process: the 4 layers
    microbatch by microbatch (the 8 global microbatches of the pipeline's
    two data rows) with the same kernels, each microbatch's loss
    backward in turn (the gradients summed); the outputs (bf16) and the
    layer gradients (bf16) to ``out`` as ``.npy``; the card freed.  Also
    the reshard's one-card reference: the reduced Moonshot's
    :data:`RESHARD_STEPS` steps."""
    import os
    import torch
    from repro_torch.launch.train import make_trainer, train
    cfg = _pipe_cfg()
    layers = _pipe_layers(cfg, device)
    for t in layers.values():
        t.requires_grad_(True)
    body = _pipe_body(cfg, device, PIPE_REMAT)
    os.makedirs(os.path.join(out, "outs"))
    os.makedirs(os.path.join(out, "grads"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for g in range(SPMD_MESH[0] * PIPE_MICRO):
        x, ct = _pipe_microbatch(device, cfg, g)
        y = body(layers, x)
        _pipe_loss(y, ct).backward()
        _leaf_file(os.path.join(out, "outs", str(g)), y)
        del x, ct, y
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_variants()
    peak = torch.cuda.max_memory_allocated()
    for name, t in layers.items():
        _leaf_file(os.path.join(out, "grads", name), t.grad)
    del layers
    torch.cuda.empty_cache()
    rcfg = _reshard_cfg()
    tr = make_trainer(rcfg, RESHARD_SEQ, RESHARD_BATCH, RESHARD_STEPS,
                      device=device, ckpt_dir=None)
    tr.init(seed=0)
    losses = []
    train(tr, lambda s, m: losses.append(float(m["loss"])))
    tr.close()
    del tr
    torch.cuda.empty_cache()
    return dict(wall=wall, peak=peak, variants=counts,
                reshard_losses=losses)


def _bf16_ulps(a, b):
    """The largest distance between two bf16 tensors in units in the last
    place (their bits mapped to integers in the floats' order)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def _pipe_rank(rank, plan):
    """The [spmd pipeline] program of one rank (4 ranks sharing the card
    over gloo, data 2 x model 2):

    1. ``pipeline_apply`` of the stage body over ``model``, rows over
       ``data``: this rank's stage's 2 layers, its 4 microbatches of 1 x
       4096; forward, then the backward of its copy of the loss; the
       launches by forward and backward, the hops, the peak memory; the
       outputs against the yardstick's (bit for bit, or in bf16 ulps)
       and the stage's gradients, summed over ``data``, against its
       slice of the yardstick's (relative L2);
    2. ``cross_pod_psum`` over ``data`` of the stage's gradients (fp32;
       :data:`PIPE_EXPERTS_COMPRESSED` experts of the expert weights) in
       int8 and bf16, error feedback over two rounds, against the exact
       all-reduce of what each round compresses: the largest error over
       its bound (int8: the two ranks' half quantization steps, each its
       chunk's max / 127 / 2; bf16: 2^-8 of the sum of magnitudes), the
       bytes on the wire;
    3. ``Trainer.reshard``: the reduced Moonshot (capacity factor 8) 2
       steps on (2, 2), re-sharded to (1, 2) on ranks 0-1, 2 more steps
       (ranks 2-3 idle): the losses, the move's time and bytes."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import make_trainer, train
    from repro_torch.models import get_model
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    device = str(resolve_device(plan["device"]))
    mesh = make_test_mesh(SPMD_MESH, ("data", "model"), device)
    small = make_test_mesh(RESHARD_MESH, ("data", "model"), device,
                           ranks=range(RESHARD_MESH[0] * RESHARD_MESH[1]))
    cfg = _pipe_cfg()
    d, s = mesh.index("data"), mesh.index("model")
    n_stages, n = mesh.axis_size("model"), cfg.num_layers // SPMD_MESH[1]
    stage = _pipe_layers(cfg, device, stage=s)
    for t in stage.values():
        t.requires_grad_(True)
    body = _pipe_body(cfg, device, PIPE_REMAT)
    rows = [m * SPMD_MESH[0] + d for m in range(PIPE_MICRO)]
    xs, cts = zip(*(_pipe_microbatch(device, cfg, g) for g in rows))
    x, ct = torch.stack(xs), torch.stack(cts)
    del xs, cts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    zero_counts()
    comm.reset_comm_stats()
    t0 = time.perf_counter()
    y = pipeline_apply(body, stage, x, mesh, "model", "data")
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd = read_variants()
    _pipe_loss(y, ct).backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0 - fwd_s
    total = read_variants()
    hops = comm.comm_stats()
    peak = torch.cuda.max_memory_allocated()
    # the outputs against the yardstick's, microbatch by microbatch
    same, ulps = 0, 0
    for m, g in enumerate(rows):
        want = _leaf_block(os.path.join(plan["dir"], "outs", f"{g}.npy"),
                           ()).to(device=device, dtype=torch.bfloat16)
        got = y[m].detach()
        same += int(torch.equal(got, want))
        ulps = max(ulps, _bf16_ulps(got, want))
        del want
    del y, x, ct
    torch.cuda.empty_cache()
    # the stage's gradients, summed over data, against the yardstick's
    grad_err = {}
    part = {"wq", "wk", "wv", "wo", "router", "attn_norm", "mlp_norm"}
    for name in sorted(stage):
        g = comm.all_reduce(stage[name].grad.float(), mesh, "data")
        want = _leaf_block(os.path.join(plan["dir"], "grads",
                                        f"{name}.npy"),
                           (slice(s * n, (s + 1) * n),)).to(device)
        grad_err[name] = float((g - want).norm()
                               / want.norm().clamp_min(1e-30))
        del g, want
    # cross_pod_psum on real gradients
    comp, grads = {}, {}
    for name in sorted(stage):
        g = stage[name].grad.float()
        grads[name] = g if name in part else \
            g[:, :PIPE_EXPERTS_COMPRESSED].contiguous()
        del g
    for t in stage.values():
        t.grad = None
    for mode in ("int8", "bf16"):
        err = optim.init_error_state(grads)
        worst, wire = 0.0, 0
        for rnd in range(2):
            for name, g in grads.items():
                gf = g + err[name]
                comm.reset_comm_stats()
                got, err[name] = optim.cross_pod_psum(g, mesh, "data", mode,
                                                      err[name])
                wire += comm.comm_stats()["all_reduce_sum"]["bytes"]
                want = comm.all_reduce(gf, mesh, "data")
                # the codec's bound a value, summed over the ranks, with
                # the fp32 rounding of its arithmetic and of the sum
                if mode == "int8":
                    _q, scale = optim.quantize_int8(gf)
                    half = (scale * (0.5 + 2 ** -12)).expand(
                        -1, 1024).reshape(-1)[:gf.numel()]
                    bound = comm.all_reduce(half.reshape(gf.shape), mesh,
                                            "data")
                else:
                    bound = comm.all_reduce(gf.abs(), mesh, "data") * 2 ** -8
                bound = bound + 2 ** -22 * want.abs()
                over = (got - want).abs() / bound.clamp_min(1e-30)
                worst = max(worst, float(over.max()))
                del gf, got, want, bound, over
        n_el = sum(g.numel() for g in grads.values())
        comp[mode] = dict(worst=worst, wire=wire, fp32_bytes=2 * 4 * n_el,
                          elements=n_el)
        del err
    del grads, stage
    torch.cuda.empty_cache()
    # Trainer.reshard on CUDA tensors
    rcfg = _reshard_cfg()
    tr = make_trainer(rcfg, RESHARD_SEQ, RESHARD_BATCH, RESHARD_STEPS,
                      device=device, ckpt_dir=None, mesh=mesh,
                      dispatch=RESHARD_DISPATCH)
    tr.init(seed=0)
    tr.tcfg.total_steps = RESHARD_STEPS // 2
    losses = []
    train(tr, lambda st, m: losses.append(float(m["loss"])))
    dist.barrier()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.reshard(small)
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t1
    tr.tcfg.total_steps = RESHARD_STEPS
    train(tr, lambda st, m: losses.append(float(m["loss"])))
    model = get_model(rcfg)
    move_bytes = sum(int(np.prod(shape)) * (
        torch.finfo(model.param_dtype(rcfg, k)).bits // 8 + 12)
        for k, shape in model.param_table(rcfg).items())
    active, events = tr.active, tr.events
    tr.close()
    return dict(fwd=fwd, total=total, hops={k: v["calls"] for k, v in
                                            hops.items()},
                hop_bytes={k: v["bytes"] for k, v in hops.items()},
                peak=peak, fwd_s=fwd_s, bwd_s=bwd_s, same=same, ulps=ulps,
                grad_err=grad_err, comp=comp, stage=s, data=d,
                bubble=bubble_fraction(PIPE_MICRO, n_stages),
                reshard=dict(losses=losses, move_s=move_s,
                             move_bytes=move_bytes, active=active,
                             events=events))


def spmd_pipeline_phase(device):
    """``[spmd pipeline]``: the rest of SPMD training.  The yardstick on
    one card first (:func:`pipeline_yardstick`), then one spawn of 4
    ranks (data 2 x model 2) sharing the card over gloo
    (:func:`_pipe_rank`).  Checks on every rank: the launches (flash 2
    ``wgmma_tma`` a tick forward and again in the remat, none in the
    backward; GMM 6 ``tma`` a tick forward, again in the remat, and 2
    more for each in the backward), one ``ppermute`` a
    tick and one ``ppermute.bwd`` a tick but the last, the peak memory
    under :data:`PIPE_PEAK_GIB`; the outputs bit-identical to one card's
    (or within 1 bf16 ulp); every stage gradient within
    :data:`PIPE_GRAD_BAR`; ``cross_pod_psum`` within its codec's bound,
    its wire bytes the fp32 bytes; the re-sharded run's 4 losses within
    :data:`RESHARD_BAR` of one card's, ranks 2-3 idle after the move.
    Returns its records."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    card = card_line()
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="spmd_pipeline_")
    try:
        yard = pipeline_yardstick(device, out)
        print(f"[spmd pipeline] {card}: yardstick, one card alone: "
              f"{MOONSHOT} widths, {PIPE_LAYERS} layers, "
              f"{SPMD_MESH[0] * PIPE_MICRO} microbatches of 1 x {TRAIN_SEQ} "
              f"one after another, remat {PIPE_REMAT}: {yard['wall']:.2f} s, "
              f"peak {yard['peak'] / 2**30:.2f} GiB, launches "
              f"{ {k: {a: b for a, b in v.items() if b} for k, v in yard['variants'].items()} }")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(_pipe_rank, SPMD_WORLD, "gloo",
                      device=torch.device(device).type,
                      args=({"device": torch.device(device).type,
                             "dir": out},), timeout=900)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ticks = PIPE_MICRO + SPMD_MESH[1] - 1
    n = PIPE_LAYERS // SPMD_MESH[1]
    remat_runs = 2 if PIPE_REMAT != "none" else 1
    fwd_want = {"flash_attention": {"wgmma_tma": n * ticks},
                "moe_gmm": {"tma": 3 * n * ticks}}
    want = {"flash_attention": {"wgmma_tma": remat_runs * n * ticks},
            "moe_gmm": {"tma": (remat_runs + 2) * 3 * n * ticks}}
    for r, rec in enumerate(ranks):
        fwd = {k: {a: b for a, b in v.items() if b}
               for k, v in rec["fwd"].items() if k != "ssd_scan"}
        tot = {k: {a: b for a, b in v.items() if b}
               for k, v in rec["total"].items() if k != "ssd_scan"}
        print(f"[spmd pipeline] {card}: rank {r} (data {rec['data']}, stage "
              f"{rec['stage']}; {SPMD_LABEL}): {n} layers a stage, "
              f"{PIPE_MICRO} microbatches of 1 x {TRAIN_SEQ}, {ticks} ticks, "
              f"bubble fraction {rec['bubble']:.3f}; forward {rec['fwd_s']:.2f}"
              f" s, backward {rec['bwd_s']:.2f} s; launches forward {fwd}, "
              f"forward and backward {tot}; hops {rec['hops']}; peak memory "
              f"{rec['peak'] / 2**30:.2f} GiB; outputs bit-identical to one "
              f"card's in {rec['same']} of {PIPE_MICRO} microbatches (largest "
              f"difference {rec['ulps']} bf16 ulps); stage gradients (summed "
              f"over data) vs one card's, worst relative L2 "
              f"{max(rec['grad_err'].values()):.3e} "
              f"({max(rec['grad_err'], key=rec['grad_err'].get)}; tolerance "
              f"{PIPE_GRAD_BAR})")
        check(fwd == fwd_want, f"[spmd pipeline] rank {r}: forward launches "
              f"{fwd}, expected {fwd_want}")
        check(tot == want, f"[spmd pipeline] rank {r}: launches {tot}, "
              f"expected {want}")
        check(rec["hops"].get("ppermute") == ticks
              and rec["hops"].get("ppermute.bwd") == ticks - 1,
              f"[spmd pipeline] rank {r}: hops {rec['hops']}")
        check(abs(rec["bubble"] - (SPMD_MESH[1] - 1) / ticks) < 1e-12,
              "bubble fraction")
        check(rec["peak"] <= PIPE_PEAK_GIB * 2**30,
              f"[spmd pipeline] rank {r}: peak {rec['peak'] / 2**30:.2f} GiB")
        check(rec["ulps"] <= 1, f"[spmd pipeline] rank {r}: outputs "
              f"{rec['ulps']} bf16 ulps from one card's")
        check(_all_within(rec["grad_err"], PIPE_GRAD_BAR),
              f"[spmd pipeline] rank {r}: gradients {rec['grad_err']}")
        for mode, c in rec["comp"].items():
            print(f"[spmd pipeline] rank {r}: cross_pod_psum over data, "
                  f"{mode}, error feedback over 2 rounds, {c['elements']} "
                  f"gradient elements: the largest error against the exact "
                  f"all-reduce is {c['worst']:.6f} of the codec's bound; "
                  f"{c['wire']} bytes on the wire (fp32: {c['fp32_bytes']})")
            check(c["worst"] <= 1.0, f"[spmd pipeline] rank {r} {mode}: "
                  f"error {c['worst']} of its bound")
            check(c["wire"] == c["fp32_bytes"], f"[spmd pipeline] rank {r} "
                  f"{mode}: wire {c['wire']} bytes, fp32 {c['fp32_bytes']}")
        rs = rec["reshard"]
        one = yard["reshard_losses"]
        small = r < RESHARD_MESH[0] * RESHARD_MESH[1]
        expect = one if small else one[:RESHARD_STEPS // 2]
        rel = max(abs(a - b) / abs(b) for a, b in zip(rs["losses"], expect))
        print(f"[spmd pipeline] {card}: rank {r}: Trainer.reshard of the "
              f"reduced {MOONSHOT} (capacity factor {RESHARD_CF}, dispatch "
              f"{RESHARD_DISPATCH}), "
              f"{SPMD_MESH} -> {RESHARD_MESH} after {RESHARD_STEPS // 2} "
              f"steps: losses {rs['losses']} against one card's {one} "
              f"(largest relative difference {rel:.2e}, tolerance "
              f"{RESHARD_BAR}); the move {rs['move_s'] * 1e3:.1f} ms, "
              f"{rs['move_bytes']} bytes of parameters and optimizer state "
              f"sent whole; in the new mesh: {rs['active']}; events "
              f"{rs['events']}")
        check(len(rs["losses"]) == len(expect) and rel <= RESHARD_BAR,
              f"[spmd pipeline] rank {r}: reshard losses {rs['losses']}")
        check(rs["active"] == small and rs["events"] == [{
            "kind": "reshard", "step": RESHARD_STEPS // 2,
            "from_chips": SPMD_WORLD,
            "to_chips": RESHARD_MESH[0] * RESHARD_MESH[1]}],
            f"[spmd pipeline] rank {r}: reshard events {rs['events']}")
    wall = time.perf_counter() - t_phase
    print(f"[spmd pipeline] phase wall {wall:.1f} s (the ranks {ranks_s:.1f} "
          f"s)")
    return {"ranks": ranks, "yard": yard,
            "bwd_gmm": [sum(rec["total"]["moe_gmm"].values())
                        - sum(rec["fwd"]["moe_gmm"].values()) * remat_runs
                        for rec in ranks]}


def spmd_pipeline_entries(pipe, times, errs, bwd_times, replaces):
    """The ``kernels`` entries of [spmd pipeline]: flash and the GMM's
    forward and backward products at the stage body's shapes (those of
    Moonshot's 1 x 4096 training step: phase 7 holds them against plain,
    phase 10 and 11 time them in this run), with the launches summed over
    the ranks (by rank beside)."""
    ranks = pipe["ranks"]
    out = []
    fwd_gmm = [sum(r["total"]["moe_gmm"].values()) - b
               for r, b in zip(ranks, pipe["bwd_gmm"])]
    for name, kernel, t, err, by_rank in (
            ("flash_attention_spmd_pipeline", "flash_attention",
             times["flash Moonshot train"], errs["flash Moonshot train"],
             [sum(r["total"]["flash_attention"].values()) for r in ranks]),
            ("moe_gmm_spmd_pipeline", "moe_gmm",
             times["gmm Moonshot prefill gate/up"],
             errs["gmm Moonshot prefill gate/up"], fwd_gmm),
            ("moe_gmm_spmd_pipeline_backward", "moe_gmm",
             bwd_times["gate/up d_lhs"], bwd_times["gate/up d_lhs"]["err"],
             pipe["bwd_gmm"])):
        check(sum(by_rank) > 0, f"{name} never launched")
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kernel}.cu",
            "replaces": replaces[kernel], "launches": sum(by_rank),
            "launches_by_rank": by_rank, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            "library": t.get("library", "torch.bmm"),
            "checked_against_plain": True,
            "variant": "wgmma_tma" if kernel == "flash_attention" else "tma",
            "path": f"[spmd pipeline] {MOONSHOT} widths, {PIPE_LAYERS} "
                    f"layers in 2 stages, {SPMD_LABEL}",
            "shape": t["shape"]})
    return out


# ----------------------------------------------------------------------
# [spmd families]: Mamba-2, whisper-large-v3 and Jamba on a mesh of ranks
# sharing the card
# ----------------------------------------------------------------------
FAM_WORLD = 4
FAMILIES = (MAMBA2, WHISPER, JAMBA)
# (data, model) of each family's mesh: Jamba's one period is 24.7 GiB in
# bf16, whole on every data row, so it runs on 1 x 4 (6.2 GiB a rank)
FAM_MESH = {MAMBA2: (2, 2), WHISPER: (2, 2), JAMBA: (1, 4)}
FAM_BATCH, FAM_SEQ, FAM_STEPS = 2, 4096, 3
# The training runs' depths and the leaves held at step 1.  Whisper
# trains 4 + 4 layers at full width, Mamba-2 8 of its 48.  Mamba-2's
# zero-initialised ``dt_bias`` and ``conv_b`` hold nothing but AdamW's
# updates, each about the sign of its gradient times ``lr``, so their
# relative L2 counts sign flips, and after step 1 the model amplifies
# rounding into the gradients: at 48 layers a 1e-7 relative perturbation
# of one weight moves the fp32 gradients by 2e-4 and, after 3 steps,
# these two leaves by 0.35 and 0.33 relative L2 on one device
# (``benchmarks/torch_rounding_spread.py``, 2 x 64 tokens on the CPU); a
# mesh at 16 layers moved them by 0.035-0.044 here.  So the leaves that
# start at zero are held after their first update (a flip there needs a
# gradient within rounding of zero), every other leaf after step 3; the
# zero leaves' step-3 errors are printed.
FAM_TRAIN_LAYERS = {MAMBA2: 8, WHISPER: 4}
FAM_JAMBA_LAYERS, FAM_TICKS = 8, 16
# Jamba's E / top_k: a FIFO of T * top_k * cf / E slots holds every token
# (a token takes an expert at most once), so no layout drops
FAM_JAMBA_NO_DROP_CF = 8.0
# The gates compare fp32 runs.  At random initialisation these models
# amplify bf16 rounding: Mamba-2 370M's own bf16 logits differ from its
# fp32 logits by 0.58 of the largest (2 x 64 tokens, on the CPU:
# ``benchmarks/torch_rounding_spread.py``; this phase prints the card's),
# and a bf16 mesh, whose partial sums round in another order, as much; so
# a bf16 run could meet a 2e-2 bar only bit for bit.  The bf16 runs give the
# tensor-core kernels' launches, local shapes and times, their errors
# printed.  Jamba's fp32 prefill takes 2 x 1024 tokens: its 49.4 GiB of
# fp32 weights leave no room for 2 x 4096's fp32 expert activations.
FAM_JAMBA_FP32_SEQ = 1024
FAM_BAR = 2e-2                   # logits (of the largest), losses (relative)
# the fp32 Servers' (requests, prompt, new tokens): a mesh tick is
# 0.53 s (Mamba-2) and 1.35 s (Whisper) of ~200 and ~450 gloo calls
FAM_SERVERS = {MAMBA2: (8, 4, 4), WHISPER: (4, 4, 4)}
FAM_LABEL = f"{FAM_WORLD} ranks time-sharing one card through gloo"


def _fam_cfg(arch, dtype=None, train=False, cf=None):
    """The phase's config of ``arch``: Mamba-2 and whisper-large-v3 whole
    (their training depth ``FAM_TRAIN_LAYERS``), Jamba one period (8 of 32
    layers) at capacity factor ``cf`` (default the published 1.25); in
    ``dtype``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == JAMBA:
        cfg = dataclasses.replace(
            cfg, num_layers=FAM_JAMBA_LAYERS, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf or cfg.moe.capacity_factor))
    if train:
        cfg = dataclasses.replace(cfg, num_layers=FAM_TRAIN_LAYERS[arch])
    if arch == WHISPER and train:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, encoder_layers=FAM_TRAIN_LAYERS[arch]))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _fam_runs(arch):
    """The prefills of a family, on the card alone and on the mesh:
    (label, config, tokens a row): ``bf16`` at the published widths and
    capacity factor (launches asserted, errors printed) and ``fp32`` (the
    gated run; Jamba at the capacity factor that drops nothing)."""
    return (("bf16", _fam_cfg(arch), FAM_SEQ),
            ("fp32", _fam_cfg(arch, "float32", cf=FAM_JAMBA_NO_DROP_CF),
             FAM_JAMBA_FP32_SEQ if arch == JAMBA else FAM_SEQ))


def _fam_batch(device, cfg, seq):
    """A prefill batch (``_prefill_batch``, seed 0): 2 x ``seq`` tokens,
    or Whisper's 4 clips of 1500 frames and 4 x 448 tokens."""
    if cfg.encdec is not None:
        return _prefill_batch(device, cfg, WHISPER_CLIPS, WHISPER_TOKENS, 0)
    return _prefill_batch(device, cfg, FAM_BATCH, seq, 0)


def _fam_launches(arch, label):
    """{kernel: {variant: launches}} of a family's prefill on every rank
    (and on the card alone): Mamba-2 48 SSD, whisper-large-v3 96 flash
    (32 encoder, 32 decoder self, 32 cross), Jamba's period 1 flash, 7
    SSD and 12 GMM (3 in each of 4 MoE layers); bf16 through the tensor
    cores, fp32 through the fp32 variants; every other 0."""
    tc = label == "bf16"
    flash, ssd, gmm = (("wgmma_tma", "tensor_core", "tma") if tc else
                       ("f32", "cuda_core", "f32"))
    want = {MAMBA2: {"ssd_scan": {ssd: 48}},
            WHISPER: {"flash_attention": {flash: 96}},
            JAMBA: {"flash_attention": {flash: 1}, "ssd_scan": {ssd: 7},
                    "moe_gmm": {gmm: 12}}}[arch]
    return {k: {v: want.get(k, {}).get(v, 0) for v in vs}
            for k, vs in read_variants().items()}


def _fam_requests(arch):
    import numpy as np
    n, prompt, new = FAM_SERVERS[arch]
    rng = np.random.default_rng(2)
    vocab = _fam_cfg(arch).vocab_size
    return [(r, rng.integers(0, vocab, size=prompt).astype(np.int32), new)
            for r in range(n)]


def _fam_ticks(cfg):
    """The fixed token stream of Jamba's decode: (ticks, rows)."""
    import numpy as np
    return np.random.default_rng(3).integers(
        0, cfg.vocab_size, (FAM_TICKS, FAM_BATCH)).astype(np.int64)


def _fam_server(device, arch, mesh=None):
    """The fp32 ``Server`` of ``arch`` (the seeded draw) on the card alone,
    or on ``mesh``: (outs, ticks, wall, launches by variant, collectives,
    the rules' batch and KV axes)."""
    import torch
    from repro_torch.launch.serve import Request, Server
    from repro_torch.parallel import comm
    server = Server(_fam_cfg(arch, "float32"), slots=4, max_seq=64,
                    device=device, mesh=mesh)
    for rid, prompt, new in _fam_requests(arch):
        server.submit(Request(rid=rid, prompt=prompt, max_new=new))
    torch.cuda.synchronize()
    zero_counts()
    comm.reset_comm_stats()
    t0 = time.perf_counter()
    ticks = server.run(tick_limit=1000)
    torch.cuda.synchronize()
    rec = dict(outs=[r.out for r in sorted(server.completed,
                                            key=lambda r: r.rid)],
               ticks=ticks, wall=time.perf_counter() - t0,
               variants=read_variants(), comm=comm.comm_stats())
    if mesh is not None:
        rec.update(batch=server.rules._clean(server.rules.batch),
                   kv_seq=server.rules._clean(server.rules.kv_seq))
    del server
    torch.cuda.empty_cache()
    return rec


def _fam_train(device, arch, out_dir, mesh=None):
    """``make_trainer`` of the family's fp32 training config (Mamba-2 8
    layers, Whisper 4 + 4), 2 x 4096 tokens (Whisper 2 x 448 and 2
    clips), full remat, 3 steps on the
    pipeline's batch 0 from ``init(seed=0)``, on the card alone (the
    step-3 parameters written to ``out_dir``) or on ``mesh`` (each block
    against its cut of the parameters in ``out_dir``): its record."""
    import os
    import numpy as np
    import torch
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.train import make_trainer
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import block_of
    cfg = _fam_cfg(arch, "float32", train=True)
    seq = WHISPER_TOKENS if arch == WHISPER else FAM_SEQ
    tr = make_trainer(cfg, seq, FAM_BATCH, FAM_STEPS, device=device,
                      ckpt_dir=None, mesh=mesh,
                      **({"remat": "full"} if mesh is None else {}))
    tr.init(seed=0)
    data = synthetic_batch(cfg, tr.shape, 0)
    losses, stamps, variants, phases, first = [], [], [], [], {}
    zeros = [k for k in tr.model.param_table(cfg)
             if tr.model.init_rule(k) == "zeros"]

    def on_step(step, m):
        losses.append(float(m["loss"]))
        variants.append(read_variants())
        phases.append(comm.phase_stats())
        zero_counts()
        comm.reset_comm_stats()
        if len(losses) == 1:
            first.update({k: tr.model._p(k).detach().float().cpu()
                          for k in zeros})
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    comm.reset_comm_stats()
    t0 = time.perf_counter()
    _run_on(tr, data, on_step)
    rec = dict(losses=losses, step_s=[round(float(t), 3) for t in
                                      np.diff([t0] + stamps)],
               peak=torch.cuda.max_memory_allocated(), variants=variants,
               phases=phases, remat=tr.remat)
    step3 = {k: p.detach() for k, p in tr.model.named_parameters()}
    for part, leaves in (("params", step3), ("step1", first)):
        where = os.path.join(out_dir, part)
        if mesh is None:
            os.makedirs(where)
            for name, p in leaves.items():
                _leaf_file(os.path.join(where, name.replace("/", "@")), p)
            continue
        specs = tr.model.param_specs(cfg, tr.rules)
        errs = {}
        for name, p in leaves.items():
            got = p.float().cpu()
            want = _leaf_block(
                os.path.join(where, name.replace("/", "@") + ".npy"),
                block_of(mesh, specs[name], tuple(got.shape))[1])
            errs[name] = float((got - want).norm()
                               / want.norm().clamp_min(1e-30))
        rec[part + "_err"] = errs
    rec["zeros"] = zeros
    tr.close()
    del tr
    torch.cuda.empty_cache()
    return rec


def families_yardstick(device, out):
    """[spmd families] (1): each family on the card alone first, each
    model freed before the next: the bf16 and fp32 prefills of
    :func:`_fam_runs` (Mamba-2 370M whole and Jamba's one period at 2 x
    4096, Jamba's fp32 at 2 x 1024; whisper-large-v3 whole at 4 clips of
    1500 frames + 4 x 448 tokens), each with its launches asserted;
    Jamba's 16 fp32 decode ticks of 2 rows on a fixed token stream (each
    tick's logits to ``out``); the fp32 ``Server`` and 3 fp32 training
    steps of Mamba-2 (8 layers) and Whisper (4 + 4 layers).  Returns the
    records (logits as numpy)."""
    import os
    import numpy as np
    import torch
    from repro_torch.launch.step import prefill_step
    from repro_torch.models import get_model, moe
    rec = {}
    for arch in FAMILIES:
        r = {}
        for label, cfg, seq in _fam_runs(arch):
            params, nbytes, draw_s = draw_params(device, cfg)
            model = get_model(cfg)(cfg, device, params=params)
            batch = _fam_batch(device, cfg, seq)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            with moe.counting_drops() as drops:
                logits = prefill_step(model, batch)
                torch.cuda.synchronize()
            r[label] = dict(
                logits=logits.float().cpu().numpy(),
                wall=time.perf_counter() - t0, bytes=nbytes, draw_s=draw_s,
                peak=torch.cuda.max_memory_allocated(),
                drops=int(sum(int(d) for d in drops)))
            check(read_variants() == _fam_launches(arch, label),
                  f"[spmd families] {arch} {label} prefill on the card "
                  f"alone launched {read_variants()}")
            if arch == JAMBA and label == "fp32":
                cache = model.init_cache(FAM_BATCH, 64)
                ticks = []
                t0 = time.perf_counter()
                for tok in _fam_ticks(cfg):
                    step, cache = model.decode_step(cache, torch.from_numpy(
                        tok).to(device))
                    ticks.append(step.float().cpu().numpy())
                r["tick_s"] = (time.perf_counter() - t0) / FAM_TICKS
                np.save(os.path.join(out, "jamba_ticks.npy"), np.stack(ticks))
                del cache
            del model, params, logits, batch
            torch.cuda.empty_cache()
        if arch != JAMBA:
            r["server"] = _fam_server(device, arch)
            os.makedirs(os.path.join(out, arch))
            r["train"] = _fam_train(device, arch, os.path.join(out, arch))
        rec[arch] = r
        b16, f32 = r["bf16"], r["fp32"]
        print(f"[spmd families] {card_line()}: {arch} on the card alone: "
              f"bf16 prefill {b16['wall']:.3f} s ({b16['bytes'] / 2**30:.2f}"
              f" GiB drawn in {b16['draw_s']:.1f} s, peak "
              f"{b16['peak'] / 2**30:.2f} GiB, {b16['drops']} dropped); fp32 "
              f"prefill {f32['wall']:.3f} s ({f32['bytes'] / 2**30:.2f} GiB, "
              f"peak {f32['peak'] / 2**30:.2f} GiB, {f32['drops']} dropped)"
              + (f"; fp32 Server {r['server']['ticks']} ticks "
                 f"{r['server']['wall']:.3f} s; fp32 training losses "
                 f"{r['train']['losses']} ({r['train']['step_s']} s a step, "
                 f"peak {r['train']['peak'] / 2**30:.2f} GiB)"
                 if arch != JAMBA else
                 f"; {FAM_TICKS} fp32 decode ticks of {FAM_BATCH} rows, "
                 f"{r['tick_s'] * 1e3:.1f} ms a tick"))
    return rec


def _fam_comm_log(log, targets):
    """Wrap each (module, attribute, label) of ``targets`` so that its
    calls' collectives accumulate under ``log[label]`` (with a count of
    the calls); returns the restore function."""
    from repro_torch.parallel import comm
    saved = [(m, a, getattr(m, a)) for m, a, _label in targets]

    def wrap(fn, label):
        def run(*a, **kw):
            before = comm.comm_stats()
            out = fn(*a, **kw)
            d = log.setdefault(label, {"n": 0})
            d["n"] += 1
            for op, v in comm.comm_stats().items():
                b = before.get(op, {"calls": 0, "bytes": 0})
                if v["calls"] > b["calls"]:
                    e = d.setdefault(op, {"calls": 0, "bytes": 0})
                    e["calls"] += v["calls"] - b["calls"]
                    e["bytes"] += v["bytes"] - b["bytes"]
            return out
        return run
    for (m, a, fn), (_m, _a, label) in zip(saved, targets):
        setattr(m, a, wrap(fn, label))

    def restore():
        for m, a, fn in saved:
            setattr(m, a, fn)
    return restore


def _per_call(log):
    """``log`` (:func:`_fam_comm_log`) as collectives per call of each
    label: {label: {op: (calls, bytes)}}."""
    return {label: {op: (v["calls"] / d["n"], round(v["bytes"] / d["n"]))
                    for op, v in d.items() if op != "n"}
            for label, d in log.items()}


def _families_rank(rank, plan):
    """The [spmd families] program of one rank (4 ranks sharing the card
    over gloo): Mamba-2 and whisper-large-v3 on (data 2 x model 2), Jamba's
    one period on (data 1 x model 4); each family's bf16 and fp32
    prefills (:func:`_fam_runs`), Jamba's 16 fp32 decode ticks against
    the card alone's, the fp32 mesh ``Server`` and 3 fp32 training steps
    of Mamba-2 and Whisper; then, one rank at a time, each distinct
    kernel call of the bf16 prefills against the plain version at its
    local shape.  Returns its records."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.step import cell_rules
    from repro_torch.models import get_model, jamba, mamba2, moe, whisper
    from repro_torch.models.convert import init_params
    device = str(resolve_device(plan["device"]))
    meshes = {shape: make_test_mesh(shape, ("data", "model"), device)
              for shape in sorted(set(FAM_MESH.values()))}
    calls = []

    def flash_log(q, k, v, **kw):
        calls.append(("flash", (tuple(q.shape), tuple(k.shape),
                                tuple(v.shape)),
                      (kw.get("causal", True), kw.get("window"))))
        return real["flash"](q, k, v, **kw)

    def gmm_log(lhs, rhs):
        calls.append(("gmm", (tuple(lhs.shape), tuple(rhs.shape)), None))
        return real["gmm"](lhs, rhs)

    def ssd_log(x, dt, B, C, A, chunk):
        calls.append(("ssd", (tuple(x.shape), tuple(B.shape)), chunk))
        return real["ssd"](x, dt, B, C, A, chunk=chunk)
    real = {"flash": ops.flash_attention, "gmm": ops._gmm_kernel,
            "ssd": ops.ssd_scan}
    ops.flash_attention, ops._gmm_kernel, ops.ssd_scan = \
        flash_log, gmm_log, ssd_log
    log = {}
    restore = _fam_comm_log(log, [
        (mamba2, "mixer_spmd", "mixer"),
        (mamba2, "mixer_decode_spmd", "mixer decode"),
        (jamba, "attn_island", "attention"),
        (jamba, "dense_mlp", "dense MLP"),
        (moe, "moe_block", "MoE"),
        (whisper, "attn_island", "attention"),
        (whisper, "dense_mlp", "MLP")])
    out = {}
    try:
        for arch in FAMILIES:
            mesh = meshes[FAM_MESH[arch]]
            r = {}
            for label, cfg, seq in _fam_runs(arch):
                batch = _fam_batch(device, cfg, seq)
                B, S = batch["tokens"].shape
                rules = cell_rules(mesh, cfg, ShapeConfig("prefill", S, B,
                                                          "prefill"))
                t0 = time.perf_counter()
                params = init_params(cfg, torch.Generator(device)
                                     .manual_seed(0), device, rules=rules)
                model = get_model(cfg)(cfg, device, params=params,
                                       rules=rules)
                torch.cuda.synchronize()
                rr = dict(draw_s=time.perf_counter() - t0, bytes=sum(
                    p.numel() * p.element_size() for p in params.values()))
                torch.cuda.reset_peak_memory_stats()
                calls.clear()
                log.clear()
                logits, rr["wall"], rr["variants"], rr["comm"], \
                    rr["drops"] = _spmd_prefill(model, batch, rules, mesh)
                rr["logits"] = logits.float().cpu().numpy()
                rr["calls"] = list(calls) if label == "bf16" else []
                rr["per_call"] = _per_call(log)
                rr["peak"] = torch.cuda.max_memory_allocated()
                del logits
                if arch == JAMBA and label == "fp32":
                    # 16 decode ticks under the decode cell's rules,
                    # against the card alone's logits, tick by tick
                    drules = cell_rules(mesh, cfg, ShapeConfig(
                        "decode", 64, FAM_BATCH, "decode"))
                    dm = get_model(cfg)(cfg, device, params=params,
                                        rules=drules)
                    cache = dm.init_cache(FAM_BATCH, 64)
                    want = np.load(os.path.join(plan["dir"],
                                                "jamba_ticks.npy"))
                    log.clear()
                    zero_counts()
                    dist.barrier()
                    t0 = time.perf_counter()
                    errs = []
                    for i, tok in enumerate(_fam_ticks(cfg)):
                        step, cache = dm.decode_step(
                            cache, torch.from_numpy(tok).to(device))
                        errs.append(_rel_err(step.float().cpu().numpy(),
                                             want[i]))
                    rr["tick_s"] = (time.perf_counter() - t0) / FAM_TICKS
                    rr["tick_errs"] = errs
                    rr["tick_variants"] = read_variants()
                    rr["tick_per_call"] = _per_call(log)
                    del dm, cache
                del model, params
                torch.cuda.empty_cache()
                r[label] = rr
            if arch != JAMBA:
                log.clear()
                r["server"] = _fam_server(device, arch, mesh)
                r["server"]["per_call"] = _per_call(log)
                r["train"] = _fam_train(device, arch,
                                        os.path.join(plan["dir"], arch),
                                        mesh)
            out[arch] = r
    finally:
        restore()
        ops.flash_attention, ops._gmm_kernel, ops.ssd_scan = \
            real["flash"], real["gmm"], real["ssd"]
    # one rank at a time: each distinct kernel call of the bf16 prefills
    # against its plain version at that local shape (not counted)
    seen = sorted({c for r in out.values() for c in r["bf16"]["calls"]})
    for turn in range(FAM_WORLD):
        if turn == rank:
            out["kernel_errs"] = _spmd_kernel_checks(seen, device, 40 + rank)
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _xy_buffers(cfg, tokens, R, C):
    """(cap1, cap2, cap3, bytes of one (E/C, cap3, F) bf16 expert
    activation) of the ``xy`` dispatch of ``tokens`` tokens a rank on R x
    C (``models/moe.py::_moe_xy``)."""
    m = cfg.moe
    A = tokens * m.top_k
    cap1 = max(8, -(-int(A / R * m.capacity_factor) // 8) * 8)
    cap2 = max(8, -(-int(R * cap1 / C) // 8) * 8)
    e_loc = m.num_experts // C
    cap3 = max(8, -(-int(C * cap2 / e_loc) // 8) * 8)
    return cap1, cap2, cap3, e_loc * cap3 * m.d_ff_expert * 2


def spmd_families_phase(device):
    """Phase 15, ``[spmd families]``: Mamba-2 370M, whisper-large-v3 and
    Jamba's one period on a mesh.  (1) each on the card alone first
    (:func:`families_yardstick`); (2) one spawn of 4 ranks sharing the card
    over gloo (:func:`_families_rank`; Mamba-2 and Whisper on data 2 x
    model 2, Jamba on data 1 x model 4).  Gates: every prefill's launches
    by variant on every rank; the fp32 prefills' logits within 2e-2 of
    the card alone's largest (the bf16 ones' printed: see
    ``FAM_JAMBA_FP32_SEQ``'s comment); Jamba's capacity factor E / top_k
    drops nothing, and each of its 16 fp32 decode ticks within 2e-2; the
    fp32 mesh ``Server``'s tokens identical to the card alone's (Mamba-2,
    Whisper); fp32 training losses within 2e-2 and every step-3
    parameter block within 3e-2 relative L2 of the card alone's, every
    error finite; each rank's kernels against plain at its local shapes.
    (3) the kernel times at those shapes on the card alone.  Returns its
    records."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.moe import capacity
    card = card_line()
    t_phase = time.perf_counter()
    for label, c, seq in (("bf16", _fam_cfg(JAMBA), FAM_SEQ),
                          ("fp32", _fam_runs(JAMBA)[1][1],
                           FAM_JAMBA_FP32_SEQ)):
        T = FAM_BATCH * seq
        one = capacity(T, c.moe)
        act = c.moe.num_experts * one * c.moe.d_ff_expert * (
            2 if label == "bf16" else 4)
        cap1, cap2, cap3, nb = _xy_buffers(c, T // 4, *FAM_MESH[JAMBA])
        print(f"[spmd families] {JAMBA} one period, {label}, {FAM_BATCH} x "
              f"{seq} tokens at capacity factor {c.moe.capacity_factor}: "
              f"the card alone's FIFO {one} slots an expert ("
              f"{act / 2**30:.2f} GiB an (E, slots, F) expert activation); "
              f"xy on data {FAM_MESH[JAMBA][0]} x model {FAM_MESH[JAMBA][1]}"
              f": cap1 {cap1}, cap2 {cap2}, cap3 {cap3}, "
              f"{nb * (1 if label == 'bf16' else 2) / 2**30:.2f} GiB an "
              f"(E/4, cap3, F) activation a rank")
    out = tempfile.mkdtemp(prefix="spmd_families_")
    try:
        yard = families_yardstick(device, out)
        torch.cuda.empty_cache()
        print(f"[spmd families] {card}: {FAM_LABEL}; this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        t0 = time.perf_counter()
        kind = torch.device(device).type
        ranks = spawn(_families_rank, FAM_WORLD, "gloo", device=kind,
                      args=({"device": kind, "dir": out},), timeout=900)
        ranks_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for arch in FAMILIES:
        want = yard[arch]
        shape = FAM_MESH[arch]
        for r, rec in enumerate(ranks):
            got = rec[arch]
            for label in ("bf16", "fp32"):
                g, w = got[label], want[label]
                check(g["variants"] == _fam_launches(arch, label),
                      f"[spmd families] rank {r} {arch} {label} prefill "
                      f"launched {g['variants']}, expected "
                      f"{_fam_launches(arch, label)}")
                g["err"] = _rel_err(g["logits"], w["logits"])
                check(np.isfinite(g["logits"]).all(), f"[spmd families] "
                      f"rank {r} {arch} {label} logits not finite")
            f32, b16 = got["fp32"], got["bf16"]
            check(f32["err"] <= FAM_BAR and f32["drops"] == 0,
                  f"[spmd families] rank {r} {arch} fp32 logits differ from "
                  f"the card alone's by {f32['err']} ({f32['drops']} "
                  f"dropped)")
            print(f"[spmd families] {card}: {arch} prefill, rank {r} (data "
                  f"{shape[0]} x model {shape[1]}, {FAM_LABEL}): bf16 "
                  f"{b16['bytes'] / 2**30:.2f} GiB of weights drawn in "
                  f"{b16['draw_s']:.1f} s, wall {b16['wall']:.3f} s (the "
                  f"card alone {want['bf16']['wall']:.3f} s), logits "
                  f"{b16['err']:.3e} of the card alone's largest (not gated), "
                  f"{b16['drops']} dropped, launches {b16['variants']}, "
                  f"collectives a call {b16['per_call']}, whole prefill "
                  f"{b16['comm']}, peak {b16['peak'] / 2**30:.2f} GiB; fp32 "
                  f"wall {f32['wall']:.3f} s (the card alone "
                  f"{want['fp32']['wall']:.3f} s), logits within "
                  f"{f32['err']:.3e} of the card alone's largest (tolerance "
                  f"{FAM_BAR}), peak {f32['peak'] / 2**30:.2f} GiB")
            if arch == JAMBA:
                worst = max(f32["tick_errs"])
                check(all(np.isfinite(e) and e <= FAM_BAR
                          for e in f32["tick_errs"]),
                      f"[spmd families] rank {r} Jamba decode ticks differ "
                      f"from the card alone's: {f32['tick_errs']}")
                print(f"[spmd families] {card}: {JAMBA} {FAM_TICKS} fp32 "
                      f"decode ticks of {FAM_BATCH} rows on rank {r}: "
                      f"{f32['tick_s'] * 1e3:.1f} ms a tick (the card alone "
                      f"{want['tick_s'] * 1e3:.1f}), every tick's logits "
                      f"within {worst:.3e} of the card alone's largest; "
                      f"launches {f32['tick_variants']}; collectives a call "
                      f"{f32['tick_per_call']}")
                continue
            s, alone = got["server"], want["server"]
            check(s["outs"] == alone["outs"] and s["ticks"] == alone["ticks"],
                  f"[spmd families] rank {r} {arch}: the mesh Server's "
                  f"tokens differ from the card alone's")
            print(f"[spmd families] {card}: fp32 {arch} mesh Server, rank "
                  f"{r} (rows over {s['batch']}, KV over {s['kv_seq']}): "
                  f"{len(s['outs'])} requests, {s['ticks']} ticks, "
                  f"{s['wall'] / s['ticks'] * 1e3:.1f} ms a tick (the card "
                  f"alone {alone['wall'] / alone['ticks'] * 1e3:.1f}); tokens "
                  f"identical; collectives a call {s['per_call']}")
            t, ta = got["train"], want["train"]
            lerr = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(t["losses"], ta["losses"]))
            held = {k: e for k, e in t["params_err"].items()
                    if k not in t["zeros"]}
            held.update({k + " (step 1)": e
                         for k, e in t["step1_err"].items()})
            name, perr = _worst(held)
            check(len(t["losses"]) == FAM_STEPS and lerr <= FAM_BAR
                  and _all_within(held, SPMD_TRAIN_BAR),
                  f"[spmd families] rank {r} {arch} training: losses "
                  f"{t['losses']} vs {ta['losses']}, worst parameter "
                  f"{name} {perr}")
            print(f"[spmd families] {card}: fp32 {arch} training on rank {r}"
                  f" ({FAM_TRAIN_LAYERS[arch]} layers, remat {t['remat']}): "
                  f"losses {t['losses']} (the card alone {ta['losses']}, "
                  f"within {lerr:.3e}); parameters within {perr:.3e} "
                  f"relative L2 ({name}; bar {SPMD_TRAIN_BAR}; the zero-"
                  f"initialised leaves after step 1, the rest after step "
                  f"3; the zero leaves after step 3, not held: "
                  f"{ {k: round(t['params_err'][k], 6) for k in t['zeros']} });"
                  f" {t['step_s']} s a step (the card alone {ta['step_s']}); "
                  f"peak {t['peak'] / 2**30:.2f} GiB; launches a step "
                  f"{t['variants'][-1]}; collectives a step by phase "
                  f"{t['phases'][-1]}")
        print(f"[spmd families] {arch}: the bf16 prefill logits of the card "
              f"alone vs its fp32 ones: {_rel_err(want['bf16']['logits'], want['fp32']['logits']) if arch != JAMBA else float('nan'):.3e}"
              f" of the largest (the rounding's own spread; Jamba's runs "
              f"differ in length and capacity factor)")
    kerr = max(e for rec in ranks for e in rec["kernel_errs"].values())
    calls = sorted({c for rec in ranks for a in FAMILIES
                    for c in rec[a]["bf16"]["calls"]})
    times = _spmd_times(device, calls)
    for key, t in times.items():
        lib = "none" if t["library_ms"] is None else \
            f"{t['library']} {t['library_ms']:.4f} ms"
        print(f"[spmd families times] {card}: {key[0]} at a rank's local "
              f"shape {key[1]} ({'chunk' if key[0] == 'ssd' else 'mask'} "
              f"{key[2]}; the card alone): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {lib}, bound "
              f"{t['bound'][0]:.4f} ms by {t['bound'][1]}")
    print(f"[spmd families] phase wall {time.perf_counter() - t_phase:.1f} s "
          f"(the ranks {ranks_wall:.1f} s of it); worst kernel error vs "
          f"plain {kerr:.3e}")
    return {"ranks": ranks, "times": times}


def spmd_families_entries(fam, replaces):
    """The ``kernels`` entries of [spmd families]: one per family, kernel
    and local shape of the prefills, its launches that shape's calls
    summed over the ranks, its error the worst rank's against the plain
    version, its times at that shape on the card alone."""
    import collections
    ranks, times = fam["ranks"], fam["times"]
    names = {"flash": ("flash_attention", "wgmma_tma"),
             "ssd": ("ssd_scan", "tensor_core"), "gmm": ("moe_gmm", "tma")}
    out = []
    for arch, label in ((MAMBA2, "mamba2"), (WHISPER, "whisper"),
                        (JAMBA, "jamba")):
        by_rank = [collections.Counter(rec[arch]["bf16"]["calls"])
                   for rec in ranks]
        keys = sorted(set().union(*by_rank))
        for kind in ("flash", "ssd", "gmm"):
            mine = [k for k in keys if k[0] == kind]
            for i, key in enumerate(mine):
                if kind == "gmm" and i:
                    continue                     # the down product, below
                name, variant = names[kind]
                t = times[key]
                role = ""
                if arch == WHISPER:      # by the attention's (Sq, Sk, mask)
                    (q, k, _v), (causal, _w) = key[1], _flash_mask(key[2])
                    role = "_self" if causal else \
                        "_cross" if q[2] != k[2] else "_encoder"
                entry = {
                    "name": f"{name}_spmd_{label}{role}",
                    "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                    "replaces": replaces[name],
                    "launches": sum(c[key] for c in by_rank),
                    "launches_by_rank": [c[key] for c in by_rank],
                    "max_abs_err": max(rec["kernel_errs"][key[:2]]
                                       for rec in ranks),
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                    "library_ms": t["library_ms"], "library": t["library"],
                    "checked_against_plain": True, "variant": variant,
                    "path": f"[spmd families] {arch} prefill, data "
                            f"{FAM_MESH[arch][0]} x model {FAM_MESH[arch][1]}"
                            f", {FAM_LABEL}",
                    "shape": f"local {key[1]} "
                             + (f"chunk {key[2]}" if kind == "ssd" else
                                "causal {} window {}".format(
                                    *_flash_mask(key[2]))
                                if kind == "flash" else "")}
                if kind == "gmm" and len(mine) > 1:
                    d = times[mine[1]]
                    entry["down"] = {
                        "shape": f"local {mine[1][1]}", "ms": d["ms"],
                        "plain_ms": d["plain_ms"],
                        "library_ms": d["library_ms"],
                        "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
                        "launches": sum(c[mine[1]] for c in by_rank),
                        "max_abs_err": max(rec["kernel_errs"][mine[1][:2]]
                                           for rec in ranks)}
                check(entry["launches"] > 0,
                      f"{entry['name']} never launched")
                out.append(entry)
    return out


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
    endpoints = endpoint_scenario("cuda")
    dse = dse_canonical("cuda")
    dse_wide = dse_16x32("cuda")
    loads = workloads_phase("cuda")
    service, _ = service_phase("cuda")
    check(dse["launches"] > 0 and dse_wide["launches"] > 0
          and loads["launches"] > 0 and sum(service.values()) > 0,
          "a DSE, workload or service path launched no router kernel")
    router = timings("cuda", facade_wall)
    router["dse"] = dse["timing"]["mesh"]
    # the sweep's long calls run packed and its short ones direct, the
    # facade's drain direct (phases 3 and 5); the DSE's buckets packed
    # (16x32 buckets of 4 lanes direct), the workloads' 256-cycle fence
    # blocks on one lane direct; the service's fence blocks direct, its
    # 400-cycle blocks at check_every 500 packed
    paths = (dse, dse_wide, loads, {"by_variant": service})
    kernels = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/router_step.cu",
        "replaces": "src/repro/kernels/router_step.py:114",
        "launches": n, "max_abs_err": err, "ms": router[v]["ms"],
        "plain_ms": router[v]["plain_ms"], "bound_ms": router[v]["bound"][0],
        "bound_by": router[v]["bound"][1], "library_ms": None,
        "checked_against_plain": True, "variant": variant,
        "shape": router[v].get("shape", shape), "launches_by_path": by_path}
        for name, v, variant, n, err, shape, by_path in (
            ("router_step", "packed", "packed",
             sweep_by_variant["packed"]
             + sum(p["by_variant"]["packed"] for p in paths), worst,
             "12 lanes x 16x32, calls of 400 cycles (the sweep)",
             {"sweep": sweep_by_variant["packed"],
              "dse": dse["by_variant"]["packed"],
              "dse_16x32": dse_wide["by_variant"]["packed"],
              "workloads": loads["by_variant"]["packed"],
              "service": service["packed"]}),
            ("router_step_direct", "direct", "direct",
             sweep_by_variant["direct"] + facade_launches
             + endpoints["by_variant"]["direct"]
             + sum(p["by_variant"]["direct"] for p in paths), worst,
             "1 lane x 16x32, calls of 1 cycle (the facade's drain; "
             "the sweep's 200-cycle warm-up, the endpoint scenario's "
             "replay, the 16x32 DSE's small buckets, the workloads' "
             "256-cycle fence blocks and the service's fence blocks also "
             "run direct)",
             {"sweep": sweep_by_variant["direct"],
              "facade": facade_launches,
              "endpoints": endpoints["by_variant"]["direct"],
              "dse": dse["by_variant"]["direct"],
              "dse_16x32": dse_wide["by_variant"]["direct"],
              "workloads": loads["by_variant"]["direct"],
              "service": service["direct"]}),
            ("router_step_dse_bucket", "dse", "packed", dse["launches"],
             dse["max_abs_err"], None, {"dse": dse["launches"]}))]
    # the DSE entry's times are the mesh bucket's; both buckets' beside them
    kernels[-1]["ms_by_bucket"] = {t: d["ms"]
                                   for t, d in dse["timing"].items()}
    kernels[-1]["bucket_ms_by_bucket"] = {t: d["bucket_ms"]
                                          for t, d in dse["timing"].items()}
    check(all(k["launches"] > 0 for k in kernels),
          f"a router variant was never launched on the main paths: "
          f"{[(k['name'], k['launches']) for k in kernels]}")

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    errs = kernels_vs_plain("cuda")
    for arch, seq, pos in ((JAMBA, 40, False), (MIXTRAL, 50, False),
                           (QWEN2_VL, 50, True), (MAMBA2, 50, False),
                           (WHISPER, 40, False)):
        reduced_end_to_end("cuda", arch, seq=seq, positions=pos)
    paths = family_paths("cuda")
    times = kernel_timings("cuda")
    gmm_cutover("cuda")
    grad_errs = train_ops_vs_plain("cuda")
    for arch in (JAMBA, MIXTRAL, QWEN2_VL, MAMBA2, WHISPER):
        reduced_training("cuda", arch)
    trains = train_paths("cuda")
    bwd_times = train_kernel_timings("cuda")
    spmd = spmd_phase("cuda")
    spmd_train = spmd_train_phase("cuda")
    pipe = spmd_pipeline_phase("cuda")
    fam = spmd_families_phase("cuda")
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:86",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:83",
                "moe_gmm": "src/repro/kernels/moe_gmm.py:44"}
    # one entry per kernel variant and shape on the main paths: (entry,
    # kernel, variant, case of its times and errors, path); its launches
    # are that variant's in the path's prefill and server
    for key, name, variant, case, arch in (
            ("flash_attention", "flash_attention", "wgmma_tma",
             "flash Jamba prefill", JAMBA),
            ("ssd_scan", "ssd_scan", "tensor_core", "ssd Jamba", JAMBA),
            ("moe_gmm", "moe_gmm", "tma", "gmm Jamba prefill", JAMBA),
            ("moe_gmm_decode", "moe_gmm", "decode", "gmm Jamba decode",
             JAMBA),
            ("flash_attention_mixtral_window", "flash_attention",
             "wgmma_tma", "flash Mixtral prefill", MIXTRAL),
            ("flash_attention_qwen2_vl", "flash_attention", "wgmma_tma",
             "flash Qwen2-VL prefill", QWEN2_VL),
            ("ssd_scan_mamba2_n128", "ssd_scan", "tensor_core",
             "ssd Mamba-2", MAMBA2),
            ("moe_gmm_mixtral", "moe_gmm", "tma", "gmm Mixtral prefill",
             MIXTRAL),
            ("moe_gmm_decode_mixtral", "moe_gmm", "decode",
             "gmm Mixtral decode", MIXTRAL),
            ("flash_attention_whisper_encoder", "flash_attention",
             "wgmma_tma", "flash Whisper encoder", WHISPER),
            ("flash_attention_whisper_cross", "flash_attention",
             "wgmma_tma", "flash Whisper cross", WHISPER)):
        pre, srv = paths[arch]
        lp = pre["variants"][name][variant]
        ls = srv["variants"][name][variant]
        check(lp + ls > 0, f"{key} was never launched on the {arch} path")
        head = case + " gate/up" if name == "moe_gmm" else case
        t = times[head]
        entry = {
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": lp + ls,
            "max_abs_err": errs[head], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "library": t["library"], "checked_against_plain": True,
            "variant": variant, "path": arch, "launches_prefill": lp,
            "launches_server": ls, "shape": t["shape"]}
        for extra in ("library_kernel", "no_window_ms", "yardstick_ms"):
            if extra in t:
                entry[extra] = t[extra]
        if name == "moe_gmm":
            d = times[case + " down"]
            entry["down"] = {"shape": d["shape"], "ms": d["ms"],
                             "plain_ms": d["plain_ms"],
                             "library_ms": d["library_ms"],
                             "bound_ms": d["bound"][0],
                             "bound_by": d["bound"][1],
                             "max_abs_err": errs[case + " down"]}
        kernels.append(entry)
    # the training paths' kernels (phase 11): launches from the two runs;
    # the GMM's split into the backward's (d_lhs and d_rhs, one each per
    # forward GMM) and the rest (forward and remat forward)
    moon, mamba = trains[MOONSHOT], trains[MAMBA2]
    moon_tma = moon["total"]["moe_gmm"]["tma"]
    train_entries = (
        ("flash_attention_moonshot_train", "flash_attention", "wgmma_tma",
         times["flash Moonshot train"], errs["flash Moonshot train"],
         moon["total"]["flash_attention"]["wgmma_tma"], MOONSHOT,
         grad_errs["flash Moonshot train"]),
        ("ssd_scan_mamba2_train", "ssd_scan", "tensor_core",
         times["ssd Mamba-2 train"], errs["ssd Mamba-2 train"],
         mamba["total"]["ssd_scan"]["tensor_core"], MAMBA2,
         grad_errs["ssd Mamba-2 train (one sequence)"]),
        ("moe_gmm_moonshot_train", "moe_gmm", "tma",
         times["gmm Moonshot prefill gate/up"],
         errs["gmm Moonshot prefill gate/up"], moon_tma - moon["bwd_gmm"],
         MOONSHOT, grad_errs["gmm Moonshot train gate/up"]))
    for key, name, variant, t, err, n, arch, gerr in train_entries:
        check(n > 0, f"{key} was never launched on the {arch} training path")
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": n, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "library": t["library"],
            "checked_against_plain": True, "variant": variant,
            "path": f"{arch} training", "shape": t["shape"],
            "grad_rel_err_vs_plain": gerr})
        if arch == MOONSHOT:
            # every launch (forward, remat, backward) of Moonshot's 3 steps
            # under remat "dots" and "none" (phase 11 (3b))
            kernels[-1]["launches_in_remat_runs"] = {
                r: rec["launches"][name] for r, rec in moon["remat"].items()}
    for prod in ("d_lhs", "d_rhs"):
        t = bwd_times[f"gate/up {prod}"]
        d = bwd_times[f"down {prod}"]
        check(moon["bwd_gmm"] > 0, "no backward GMM on the Moonshot path")
        kernels.append({
            "name": f"moe_gmm_moonshot_backward_{prod}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": replaces["moe_gmm"], "launches": moon["bwd_gmm"] // 2,
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "library": "torch.bmm",
            "checked_against_plain": True, "variant": "tma",
            "path": f"{MOONSHOT} training (the GMM's backward)",
            "shape": t["shape"], "transposed_copy_ms": t["copy_ms"],
            "down": {"shape": d["shape"], "ms": d["ms"],
                     "plain_ms": d["plain_ms"], "library_ms": d["library_ms"],
                     "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
                     "max_abs_err": d["err"],
                     "transposed_copy_ms": d["copy_ms"]}})
    kernels += spmd_entries(spmd, replaces)
    kernels += spmd_train_entries(spmd_train, replaces)
    kernels += spmd_pipeline_entries(pipe, times, errs, bwd_times, replaces)
    kernels += spmd_families_entries(fam, replaces)
    for arch, r in trains.items():
        print(f"[summary] {card_line()}: {arch} training {r['tokens']} tokens "
              f"a step: warm step {r['warm'] * 1e3:.1f} ms, "
              f"{r['tokens'] / r['warm']:.0f} tokens/s, model "
              f"{r['flops'] / r['warm'] / 1e12:.1f} TFLOP/s, peak memory "
              f"{r['peak'] / 2**30:.1f} GiB, idle share {r['idle']:.3f}; "
              f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}")
    for arch, (pre, srv) in paths.items():
        toks = pre["batch"] * pre["seq"]
        print(f"[summary] {card_line()}: {arch} prefill {pre['batch']} x "
              f"{pre['seq']} tokens {pre['wall']:.3f} s (again "
              f"{pre['warm']:.3f} s, {toks / pre['warm']:.0f} tokens/s); "
              f"server "
              f"{srv['ticks']} ticks {srv['wall']:.3f} s, "
              f"{srv['tokens'] / srv['wall']:.1f} generated tokens/s, "
              f"{srv['wall'] / srv['ticks'] * 1e3:.1f} ms per tick")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
