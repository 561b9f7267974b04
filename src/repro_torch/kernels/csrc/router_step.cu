// One mesh cycle of the cycle-level network simulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/router_step.py::router_step_call
// (its body _router_kernel traces repro/netsim_jax/sim.py::_step_core).
// It computes what repro_torch/netsim/sim.py::step_core computes, bit for
// bit, over a batch of independent lanes.  The Python wrapper is
// repro_torch/kernels/router_step.py; it owns the layouts (the leaf order
// of RouterArgs, the dimensions in RouterDims, the packing) and checks
// every operand.
//
// What bounds it.  A cycle is an integer state machine with cross-tile
// data flow and almost no arithmetic: a thread makes one to two hundred
// word accesses a cycle, many of them at addresses that earlier loads
// return (a FIFO's head pointer, then its head packet; a winner, then its
// packet; a request, then the memory word it names).  The byte bound is
// ~1.4 us a cycle at 12 lanes of a 16x32 mesh (the state, ~23 MB, lives in
// the 50 MB L2).  Measured on an H100 (PERF.md), a cycle costs about as
// much with one lane of 4x4 as with 12 lanes of 16x32: what bounds it is
// each phase's chain of dependent L2 round trips and one thread's path of
// instructions between them (chip_smoke.py prints the SASS counts), not
// mainly the bytes or the launches.  Loads written after stores through
// the same pointers cannot be hoisted by the compiler, so a load written
// after a store begins a new round trip.
//
// Design.
//  * Gather first.  Each phase issues every load it needs before its
//    first store, in at most three rounds of independent loads (the
//    second and third at addresses the first returned), then computes in
//    registers, then stores.
//  * Two phases a cycle, two launches.  arbitrate runs one thread per
//    (lane, network, tile): it routes the head packet of each of the
//    tile's five input FIFOs, runs the round-robin arbitration from
//    start-of-cycle state (the neighbours' FIFO counts only) and writes
//    the winner and its packet per output into the scratch.  advance runs
//    one thread per (lane, tile): it finalizes the port-P deliver gates,
//    pops, services the endpoint, pulls the neighbours' winners into its
//    own input FIFOs (REV before FWD, as the reference does), injects and
//    updates telemetry, writing only its own tile's state.  At 12 lanes
//    of 16x32 that is 12,288 and 6,144 threads in blocks of 64 and 32:
//    192 blocks each, more than the 132 SMs.
//  * Two layouts of the same phases (the template parameter PACKED),
//    chosen by the wrapper before the launch from the cycles per call.
//    `packed` works on private copies with the tile index innermost in
//    the leaves a cycle touches most, so neighbouring threads touch
//    neighbouring words: the port leaves (net_head, net_count, rr,
//    link_util, fifo_hwm) as (B, 2, 5, T) and net_buf as
//    (B, F, 2, 5, cap, T), T = ny * nx; pack_kernel (a tiled transpose,
//    coalesced on both sides) copies them in at the start of a call and
//    back at its end.  `direct` works on the state's own leaves, (B, 2,
//    ny, nx, 5) and (B, F, 2, ny, nx, 5, cap), and packs nothing.  The
//    packed layout makes a loaded card's cycle cheaper and costs a pack
//    and an unpack a call, so it pays only in long calls (PERF.md has the
//    A/B).  The other leaves are tile-innermost already and the scratch
//    is private, (B, 2, 5, SCR, T), in both.  The index helpers below are
//    the layouts' definition; tests/test_torch_router_step.py evaluates
//    them against the public leaves and the wrapper's packing.
// Per-lane reductions (completions per cycle, the latency histogram, the
// count of tiles not drained after the cycle) use integer atomicAdd, which
// is exact in any order; the two per-cycle counters are summed over a
// warp's threads of one lane first.  Signed overflow is undefined in C++,
// so the counters that may wrap (as int32 does in the reference) add
// unsigned.  Remainders of possibly negative numbers use floor_mod; a FIFO
// pointer that is at most one lap past its depth wraps by one compare
// (lap).  Offsets are 32-bit: the wrapper refuses a leaf of 2**31 words.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NP = 5;                                  // ports, bsg_noc_pkg order
constexpr int P_ = 0, W_ = 1, E_ = 2, N_ = 3, S_ = 4;
constexpr int NF = 5;                                  // packet lanes
constexpr int HDR = 0, ADDR = 1, DATA = 2, CMP = 3, TAG = 4;
constexpr int NOT_BEFORE = 4;                          // program lane 4
constexpr int FWD = 0, REV = 1;
constexpr int LAT_BINS = 512;
constexpr int COORD_BITS = 7, COORD_MASK = (1 << COORD_BITS) - 1;
constexpr int DST_Y_SHIFT = COORD_BITS, SRC_X_SHIFT = 2 * COORD_BITS;
constexpr int OP_SHIFT = 4 * COORD_BITS, OP_MASK = 3;
constexpr int PAIR_MASK = (1 << (2 * COORD_BITS)) - 1;
constexpr int OP_LOAD = 0, OP_STORE = 1, OP_CAS = 2;
constexpr int SCR = 1 + NF;                            // scratch: win + packet
constexpr int ARB_BLOCK = 64;                          // arbitrate threads a block
constexpr int ADV_BLOCK = 32;                          // advance threads a block
constexpr int MAX_PACKED = 6;                          // leaves pack_kernel moves

}  // namespace

extern "C" {

// Field order is the wrapper's _Args (STATE_LEAVES, then the rest).  The
// leaves marked "packed" point at the wrapper's working copies in the
// packed variant and at the public leaves otherwise.
struct RouterArgs {
  int32_t* net_buf;      // packed (B, F, 2, 5, cap, T)
  int32_t* net_head;     // packed (B, 2, 5, T)
  int32_t* net_count;    // packed (B, 2, 5, T)
  int32_t* ep_buf;       // (B, F, T, ep_fifo)
  int32_t* ep_head;      // (B, T)
  int32_t* ep_count;     // (B, T)
  uint8_t* resp_valid;   // (B, L, T) bool
  int32_t* resp_buf;     // (B, F, L, T)
  int32_t* mem;          // (B, T, mem_words)
  int32_t* credits;      // (B, T)
  int32_t* rr;           // packed (B, 2, 5, T)
  int32_t* prog_ptr;     // (B, T)
  uint8_t* reg_valid;    // (B, T) bool
  int32_t* reg_buf;      // (B, F, T)
  int32_t* completed;    // (B, T)
  int32_t* lat_sum;      // (B, T)
  int32_t* out_of_credit_cycles;  // (B, T)
  int32_t* cycle;        // (B,)
  int32_t* fifo_depth;   // (B,)
  int32_t* max_credits;  // (B,)
  int32_t* link_util;    // packed (B, 2, 5, T)
  int32_t* fifo_hwm;     // packed (B, 2, 5, T)
  int32_t* ep_hwm;       // (B, T)
  int32_t* lat_hist;     // (B, LAT_BINS)
  int32_t* measure_start;  // (B,)
  int32_t* measure_stop;   // (B,)
  const int32_t* prog_buf;  // (B, 5, T, Lp)
  const int32_t* prog_len;  // (B, T)
  int32_t* scratch;      // (B, 2, 5, SCR, T)
  int32_t* cyc_snap;     // (B,)
  int32_t* done;         // (B, C) completions per cycle
  int32_t* busy;         // (B, C) tiles not drained after each cycle
};

// Field order is the wrapper's _Dims.
struct RouterDims {
  int B, ny, nx, cap, ep_fifo, mem_words, L, Lp;
  int wrap_x, wrap_y;
  int chip_w;            // multi-chip boundary: chip width, 0 = no gate
  int period;            // boundary link accepts a flit when cycle % period == 0
  int variant;           // 0 = direct (the public leaves), 1 = packed
};

}  // extern "C"

namespace {

// ---- the layouts ------------------------------------------------------------
// offset of (lane b, network n, port p) of tile t in a port leaf: packed
// (B, 2, 5, T), or public (B, 2, T, 5)
template <bool PACKED>
__device__ __forceinline__ int port_idx(int b, int n, int p, int t, int T) {
  if constexpr (PACKED) return ((b * 2 + n) * NP + p) * T + t;
  else return ((b * 2 + n) * T + t) * NP + p;
}

// offset of word f of slot s of (lane b, network n, port p) at tile t in
// net_buf: packed (B, F, 2, 5, cap, T), or public (B, F, 2, T, 5, cap)
template <bool PACKED>
__device__ __forceinline__ int buf_idx(const RouterDims& d, int b, int f,
                                       int n, int p, int s, int t) {
  if constexpr (PACKED)
    return ((((b * NF + f) * 2 + n) * NP + p) * d.cap + s) * (d.ny * d.nx) + t;
  else return ((((b * NF + f) * 2 + n) * (d.ny * d.nx) + t) * NP + p) * d.cap + s;
}

// offset of word k of the scratch record of output o of (lane b, network
// n) at tile t
__device__ __forceinline__ int scr_idx(const RouterDims& d, int b, int n,
                                       int o, int k, int t) {
  return (((b * 2 + n) * NP + o) * SCR + k) * (d.ny * d.nx) + t;
}

// ---- helpers ----------------------------------------------------------------
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// a % n for a in [0, 2 n): a FIFO pointer plus at most one lap
__device__ __forceinline__ int lap(int a, int n) { return a >= n ? a - n : a; }

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Add v to *addr, one atomicAdd per distinct address among the warp's
// threads that reach this point together.
__device__ __forceinline__ void warp_add(int32_t* addr, int v) {
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(
      active, static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(addr)));
  const int sum = __reduce_add_sync(peers, v);
  if ((threadIdx.x & 31) == __ffs(peers) - 1 && sum != 0) atomicAdd(addr, sum);
}

// Topology::route: dimension-ordered X then Y; wrapped dimensions take the
// minimal ring direction, the half-way tie broken by coordinate parity.
__device__ int route(int dx, int dy, int x, int y, const RouterDims& d) {
  if (!d.wrap_x && !d.wrap_y)
    return dx > x ? E_ : dx < x ? W_ : dy > y ? S_ : dy < y ? N_ : P_;
  const bool tie = floor_mod(x + y + dx + dy, 2) == 0;
  int xstep, ystep;
  bool xneed, yneed;
  if (d.wrap_x) {
    const int r = floor_mod(dx - x, d.nx);
    xstep = (2 * r < d.nx || (2 * r == d.nx && tie)) ? E_ : W_;
    xneed = r != 0;
  } else {
    xstep = dx > x ? E_ : W_;
    xneed = dx != x;
  }
  if (d.wrap_y) {
    const int r = floor_mod(dy - y, d.ny);
    ystep = (2 * r < d.ny || (2 * r == d.ny && tie)) ? S_ : N_;
    yneed = r != 0;
  } else {
    ystep = dy > y ? S_ : N_;
    yneed = dy != y;
  }
  return xneed ? xstep : (yneed ? ystep : P_);
}

struct Tile {
  int x, y;
  int nb[NP];            // neighbour feeding input port i (W, E, N, S); -1
                         // across a non-wrapped edge; nb[P_] is the tile
};

// the output port of the neighbour that feeds input port i
__device__ __forceinline__ int facing(int i) {
  return i == W_ ? E_ : i == E_ ? W_ : i == N_ ? S_ : N_;
}

__device__ __forceinline__ Tile tile_at(const RouterDims& d, int t) {
  Tile k;
  k.y = t / d.nx;
  k.x = t - k.y * d.nx;
  k.nb[P_] = t;
  k.nb[W_] = k.x > 0 ? t - 1 : (d.wrap_x ? t + d.nx - 1 : -1);
  k.nb[E_] = k.x < d.nx - 1 ? t + 1 : (d.wrap_x ? t - (d.nx - 1) : -1);
  k.nb[N_] = k.y > 0 ? t - d.nx : (d.wrap_y ? t + (d.ny - 1) * d.nx : -1);
  k.nb[S_] = k.y < d.ny - 1 ? t + d.nx : (d.wrap_y ? t - (d.ny - 1) * d.nx : -1);
  return k;
}

// The phases below are written gather-first: every load a thread needs is
// issued before its first store, in at most three rounds of independent
// loads (the second and third use addresses the first returned).  Loads
// and stores through the same pointers cannot be reordered by the
// compiler, so a load written after a store would start a new round trip
// to L2.

// ---- arbitrate: one (lane b, network n, tile t) -----------------------------
template <bool PACKED>
__device__ void arbitrate(const RouterArgs& a, const RouterDims& d, int b,
                          int n, int t) {
  const int T = d.ny * d.nx;
  const Tile k = tile_at(d, t);
  // round 1: the lane's cycle and depth, the neighbours' facing counts,
  // this tile's counts, heads and round-robin pointers
  const int cyc = *(a.cycle + b);
  const int depth = a.fifo_depth[b];
  int nbc[NP], cnt[NP], slot[NP], rr[NP];
  nbc[P_] = 0;
#pragma unroll
  for (int i = 1; i < NP; ++i)
    nbc[i] = k.nb[i] >= 0 ? *(a.net_count + port_idx<PACKED>(b, n, facing(i), k.nb[i], T)) : 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int pi = port_idx<PACKED>(b, n, i, t, T);
    cnt[i] = *(a.net_count + pi);
    slot[i] = *(a.net_head + pi);
    rr[i] = *(a.rr + pi);
  }
  // round 2: the head packet of every non-empty FIFO
  int pkt[NP][NF];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      pkt[i][f] = cnt[i] > 0 ? *(a.net_buf + buf_idx<PACKED>(d, b, f, n, i, slot[i], t)) : 0;

  bool e_gated = false, w_gated = false, open_now = true;
  if (d.chip_w > 0) {
    open_now = floor_mod(cyc, d.period) == 0;
    e_gated = (k.x + 1) % d.chip_w == 0 && k.x + 1 < d.nx;
    w_gated = k.x % d.chip_w == 0 && k.x > 0;
  }
  // space at the neighbour's facing input: one free slot (sp), two free
  // slots (sp2, the ring-entry rule; only wrapped dimensions use it)
  bool sp[NP], sp2[NP];
  sp[P_] = sp2[P_] = true;
#pragma unroll
  for (int i = 1; i < NP; ++i) {
    sp[i] = k.nb[i] >= 0 && nbc[i] < depth;
    sp2[i] = !((i == W_ || i == E_) ? d.wrap_x : d.wrap_y) || nbc[i] < depth - 1;
  }
  if (e_gated) sp[E_] = sp[E_] && open_now;
  if (w_gated) sp[W_] = sp[W_] && open_now;

  int want[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int h = pkt[i][HDR];
    want[i] = cnt[i] > 0
        ? route(h & COORD_MASK, (h >> DST_Y_SHIFT) & COORD_MASK, k.x, k.y, d) : -1;
  }

  if (n == 0 && t == 0) a.cyc_snap[b] = cyc;
#pragma unroll
  for (int o = 0; o < NP; ++o) {
    const bool bubble = (d.wrap_x && (o == E_ || o == W_)) ||
                        (d.wrap_y && (o == N_ || o == S_));
    int best = NP + 1, win = -1;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bool need2 = bubble && i != (((o - 1) ^ 1) + 1);
      const bool cand = want[i] == o && sp[o] && (sp2[o] || !need2);
      const int prio = floor_mod(i - rr[o], NP);
      // strict < over ascending i: the lowest input wins a tie
      if (cand && prio < best) {
        best = prio;
        win = i;
      }
    }
    a.scratch[scr_idx(d, b, n, o, 0, t)] = win;
    // a record without a winner is never read past its first word; the P
    // column keeps the ungated winner's packet, which advance masks
    if (win >= 0)
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        int v = pkt[0][f];
#pragma unroll
        for (int i = 1; i < NP; ++i) v = win == i ? pkt[i][f] : v;
        a.scratch[scr_idx(d, b, n, o, 1 + f, t)] = v;
      }
  }
}

// ---- advance: one (lane b, tile t), cycle j of C -----------------------------
template <bool PACKED>
__device__ void advance(const RouterArgs& a, const RouterDims& d, int b,
                        int t, int j, int C) {
  const int T = d.ny * d.nx;
  const Tile k = tile_at(d, t);
  const int bt = b * T + t;
  const int L = d.L, EP = d.ep_fifo;

  // ---- round 1: the tile's own state and the winners feeding it ----
  const int c = *(a.cyc_snap + b);
  const int depth = a.fifo_depth[b];
  const bool rv = (*(a.reg_valid + bt) != 0);
  const int tag = *(a.reg_buf + (b * NF + TAG) * T + t);
  const int completed = *(a.completed + bt);
  const int lat_sum = *(a.lat_sum + bt);
  // win[n][o]: this tile's winner records; feed[n][i]: the record of the
  // neighbour output feeding input i (i != P)
  int head[2][NP], count[2][NP], util[2][NP], hwm[2][NP], win[2][NP];
  int feed[2][NP];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pi = port_idx<PACKED>(b, n, i, t, T);
      head[n][i] = *(a.net_head + pi);
      count[n][i] = *(a.net_count + pi);
      util[n][i] = *(a.link_util + pi);
      hwm[n][i] = *(a.fifo_hwm + pi);
      win[n][i] = *(a.scratch + scr_idx(d, b, n, i, 0, t));
      feed[n][i] = i != P_ && k.nb[i] >= 0
          ? *(a.scratch + scr_idx(d, b, n, facing(i), 0, k.nb[i])) : -1;
    }
  const int credits0 = *(a.credits + bt);
  const int slot = floor_mod(c, L);
  int inflight = 0;                      // the slot itself is emptied below
  bool inj = false;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const bool v = (*(a.resp_valid + (b * L + l) * T + t) != 0);
    inj = l == slot ? v : inj;
    inflight += (l != slot && v) ? 1 : 0;
  }
  const int ehead = *(a.ep_head + bt), ecount0 = *(a.ep_count + bt);
  const int ep_hwm0 = *(a.ep_hwm + bt);
  const int len = a.prog_len[bt];
  const int ptr0 = *(a.prog_ptr + bt);
  const int ooc = *(a.out_of_credit_cycles + bt);

  // ---- round 2: packets at the addresses round 1 gave ----
  int own[2][NF];                        // this tile's P-column packets
  int in_pkt[2][NP][NF];                 // packets arriving at inputs W..S
  int inj_pkt[NF], req[NF], entry[NF];
  const bool pending = ptr0 < len;
  const int pidx = min(max(ptr0, 0), max(d.Lp - 1, 0));
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      own[n][f] = win[n][P_] >= 0 ? *(a.scratch + scr_idx(d, b, n, P_, 1 + f, t)) : 0;
      in_pkt[n][P_][f] = 0;
#pragma unroll
      for (int i = 1; i < NP; ++i)
        in_pkt[n][i][f] = feed[n][i] >= 0
            ? *(a.scratch + scr_idx(d, b, n, facing(i), 1 + f, k.nb[i])) : 0;
    }
    inj_pkt[f] = inj ? *(a.resp_buf + ((b * NF + f) * L + slot) * T + t) : 0;
    req[f] = ecount0 > 0 ? *(a.ep_buf + ((b * NF + f) * T + t) * EP + ehead) : 0;
    entry[f] = pending ? a.prog_buf[((b * NF + f) * T + t) * d.Lp + pidx] : 0;
  }

  // finalize network n: apply the P deliver gate, pop; has[n][o] says
  // output o moved a packet
  bool has[2][NP];
  auto finalize = [&](int n, bool deliver) {
#pragma unroll
    for (int o = 0; o < NP; ++o) has[n][o] = win[n][o] >= 0 && (o != P_ || deliver);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      bool pop = false;
#pragma unroll
      for (int o = 0; o < NP; ++o) pop = pop || (has[n][o] && win[n][o] == i);
      head[n][i] = lap(head[n][i] + (pop ? 1 : 0), depth);
      count[n][i] -= pop ? 1 : 0;
    }
  };
  // the tail slot each input of network n pushes into (-1: no push), the
  // local port-P packet valid or not
  int tail[2][NP];
  auto push = [&](int n, bool local_valid) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bool m = i == P_ ? local_valid : feed[n][i] >= 0;
      tail[n][i] = m ? lap(head[n][i] + count[n][i], depth) : -1;
      count[n][i] += m ? 1 : 0;
    }
  };

  // ---- reverse network: P deliveries are ALWAYS absorbed ----
  finalize(REV, true);
  const bool absorbed = has[REV][P_];
  int credits = wrap_add(credits0, absorbed ? 1 : 0);
  // ---- endpoint: inject the pending response of slot c % L ----
  push(REV, inj);
  // ---- endpoint: service one request per cycle (line rate) ----
  const bool can = ecount0 > 0 && count[REV][P_] + inflight < depth;
  const int op = (req[HDR] >> OP_SHIFT) & OP_MASK;
  const int addr = min(max(req[ADDR], 0), d.mem_words - 1);
  int32_t* mem = a.mem + bt * d.mem_words;
  const int cur = can ? *(mem + addr) : 0;          // round 3
  const bool is_store = can && op == OP_STORE;
  const bool is_load = can && op == OP_LOAD;
  const bool is_cas = can && op == OP_CAS;
  const int ep_head = lap(ehead + (can ? 1 : 0), EP);
  int ep_count = ecount0 - (can ? 1 : 0);
  // the response routes home (src <-> dst) and carries the UNCLAMPED addr
  const int src_pair = (k.x & COORD_MASK) | ((k.y & COORD_MASK) << COORD_BITS);
  const int resp[NF] = {((req[HDR] >> SRC_X_SHIFT) & PAIR_MASK) |
                            (src_pair << SRC_X_SHIFT) |
                            (req[HDR] & (OP_MASK << OP_SHIFT)),
                        req[ADDR], (is_load || is_cas) ? cur : 0, req[CMP], req[TAG]};
  // ---- forward network: P deliveries go to the endpoint FIFO ----
  finalize(FWD, ep_count < EP);
  const int ep_tail = lap(ep_head + ep_count, EP);
  ep_count += has[FWD][P_] ? 1 : 0;
  // ---- master injection from the per-lane, per-tile program ----
  const bool can_inj = pending && credits > 0 && entry[NOT_BEFORE] <= c &&
                       count[FWD][P_] < depth;
  const int pkt[NF] = {entry[HDR] | (src_pair << SRC_X_SHIFT), entry[ADDR],
                       entry[DATA], entry[CMP], c};
  push(FWD, can_inj);
  credits = wrap_sub(credits, can_inj ? 1 : 0);
  const int ptr = wrap_add(ptr0, can_inj ? 1 : 0);

  // ---- stores ----
  const int lat = wrap_sub(c, tag);      // the registered response's stats
  if (rv) {
    a.completed[bt] = wrap_add(completed, 1);
    a.lat_sum[bt] = wrap_add(lat_sum, lat);
    if (tag >= a.measure_start[b] && tag < a.measure_stop[b]) {
      const int bin = lat < 0 ? 0 : (lat > LAT_BINS - 1 ? LAT_BINS - 1 : lat);
      atomicAdd(&a.lat_hist[b * LAT_BINS + bin], 1);
    }
  }
  a.reg_valid[bt] = absorbed ? 1 : 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) a.reg_buf[(b * NF + f) * T + t] = absorbed ? own[REV][f] : 0;
  if (is_store || (is_cas && cur == req[CMP])) mem[addr] = req[DATA];
  a.resp_valid[(b * L + slot) * T + t] = can ? 1 : 0;
  if (can)
#pragma unroll
    for (int f = 0; f < NF; ++f) a.resp_buf[((b * NF + f) * L + slot) * T + t] = resp[f];
  if (has[FWD][P_])
#pragma unroll
    for (int f = 0; f < NF; ++f) a.ep_buf[((b * NF + f) * T + t) * EP + ep_tail] = own[FWD][f];
  if (pending && credits0 + (absorbed ? 1 : 0) <= 0)
    a.out_of_credit_cycles[bt] = wrap_add(ooc, 1);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pi = port_idx<PACKED>(b, n, i, t, T);
      if (has[n][i]) a.rr[pi] = (win[n][i] + 1) % NP;
      if (tail[n][i] >= 0)
#pragma unroll
        for (int f = 0; f < NF; ++f)
          a.net_buf[buf_idx<PACKED>(d, b, f, n, i, tail[n][i], t)] =
              i != P_ ? in_pkt[n][i][f] : (n == REV ? inj_pkt[f] : pkt[f]);
      a.net_head[pi] = head[n][i];
      a.net_count[pi] = count[n][i];
      a.link_util[pi] = wrap_add(util[n][i], has[n][i] ? 1 : 0);
      a.fifo_hwm[pi] = max(hwm[n][i], count[n][i]);
    }
  a.ep_head[bt] = ep_head;
  a.ep_count[bt] = ep_count;
  a.ep_hwm[bt] = max(ep_hwm0, ep_count);
  a.credits[bt] = credits;
  a.prog_ptr[bt] = ptr;
  if (t == 0) a.cycle[b] = wrap_add(c, 1);

  // completions of this cycle; post-cycle drain fence: the tiles that
  // still hold it open
  warp_add(&a.done[b * C + j], rv ? 1 : 0);
  warp_add(&a.busy[b * C + j],
           (ptr < len || credits != a.max_credits[b] || absorbed) ? 1 : 0);
}

// ---- two kernels a cycle -----------------------------------------------------
template <bool PACKED>
__global__ void __launch_bounds__(ARB_BLOCK)
arbitrate_kernel(RouterArgs a, RouterDims d) {
  const int T = d.ny * d.nx;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;   // (b, n, t)
  if (gid >= 2 * d.B * T) return;
  const int bn = gid / T;
  arbitrate<PACKED>(a, d, bn / 2, bn % 2, gid - bn * T);
}

template <bool PACKED>
__global__ void __launch_bounds__(ADV_BLOCK)
advance_kernel(RouterArgs a, RouterDims d, int j, int C) {
  const int T = d.ny * d.nx;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;   // (b, t)
  if (gid >= d.B * T) return;
  advance<PACKED>(a, d, gid / T, gid % T, j, C);
}

template <bool PACKED>
int launch_cycles(const RouterArgs& a, const RouterDims& d, int C,
                  cudaStream_t s) {
  const int n = d.B * d.ny * d.nx;
  const int g_arb = (2 * n + ARB_BLOCK - 1) / ARB_BLOCK;
  const int g_adv = (n + ADV_BLOCK - 1) / ADV_BLOCK;
  for (int j = 0; j < C; ++j) {
    arbitrate_kernel<PACKED><<<g_arb, ARB_BLOCK, 0, s>>>(a, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    advance_kernel<PACKED><<<g_adv, ADV_BLOCK, 0, s>>>(a, d, j, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ---- packing: the wrapper's working layout ----------------------------------
// A leaf is `batch` matrices of T rows (tiles) by K columns (ports, or
// ports x slots) in the reference's layout; packed, each is K rows by T.
struct PackLeaf {
  int32_t* pub;
  int32_t* packed;
  int batch, K;
};

struct PackArgs {
  PackLeaf leaf[MAX_PACKED];
  int T;
};

// One 32 x 32 tile of one leaf's transpose (blockIdx.z the leaf), through
// shared memory so that the read and the write are both coalesced.
__global__ void __launch_bounds__(256)
pack_kernel(PackArgs p, int unpack) {
  __shared__ int32_t tile[32][33];
  const PackLeaf lf = p.leaf[blockIdx.z];
  const int kt = (lf.K + 31) / 32;
  if (static_cast<int>(blockIdx.y) >= lf.batch * kt) return;
  const int T = p.T, K = lf.K;
  const int m = blockIdx.y / kt, k0 = (blockIdx.y % kt) * 32, t0 = blockIdx.x * 32;
  int32_t* pub = lf.pub + static_cast<size_t>(m) * T * K;
  int32_t* pk = lf.packed + static_cast<size_t>(m) * T * K;
  const int tx = threadIdx.x, ty = threadIdx.y;        // 32 x 8 threads
  if (!unpack) {
    for (int r = ty; r < 32; r += 8) {                 // rows t, columns k
      const int t = t0 + r, k = k0 + tx;
      if (t < T && k < K) tile[r][tx] = pub[static_cast<size_t>(t) * K + k];
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {                 // rows k, columns t
      const int k = k0 + r, t = t0 + tx;
      if (k < K && t < T) pk[static_cast<size_t>(k) * T + t] = tile[tx][r];
    }
  } else {
    for (int r = ty; r < 32; r += 8) {
      const int k = k0 + r, t = t0 + tx;
      if (k < K && t < T) tile[tx][r] = pk[static_cast<size_t>(k) * T + t];
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      const int t = t0 + r, k = k0 + tx;
      if (t < T && k < K) pub[static_cast<size_t>(t) * K + k] = tile[r][tx];
    }
  }
}

}  // namespace

extern "C" {

// Pack (unpack = 0) or unpack (1) n <= MAX_PACKED leaves on `stream`:
// leaf i is batch[i] matrices of T x K[i] words at pub[i], K[i] x T at
// packed[i].  Returns cudaGetLastError() after the launch, 0 on success.
int router_pack_launch(int32_t* const* pub, int32_t* const* packed,
                       const int* batch, const int* K, int n, int T,
                       int unpack, void* stream) {
  if (n < 1 || n > MAX_PACKED || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  PackArgs p{};
  p.T = T;
  int rows = 0;
  for (int i = 0; i < n; ++i) {
    p.leaf[i] = PackLeaf{pub[i], packed[i], batch[i], K[i]};
    const int r = batch[i] * ((K[i] + 31) / 32);
    rows = r > rows ? r : rows;
  }
  if (rows < 1 || rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<dim3((T + 31) / 32, rows, n), dim3(32, 8), 0,
                static_cast<cudaStream_t>(stream)>>>(p, unpack);
  return static_cast<int>(cudaGetLastError());
}

// Run C mesh cycles on `stream` in the layout dims->variant names; no
// host sync.  Returns the first launch error (cudaGetLastError), 0 on
// success.
int router_step_launch(const RouterArgs* args, const RouterDims* dims, int C,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dims->variant == 0) return launch_cycles<false>(*args, *dims, C, s);
  if (dims->variant == 1) return launch_cycles<true>(*args, *dims, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// sizeof of the two argument structs, so the wrapper can check its ctypes
// mirror against the compiled layout.
void router_step_abi(int* sizes) {
  sizes[0] = static_cast<int>(sizeof(RouterArgs));
  sizes[1] = static_cast<int>(sizeof(RouterDims));
}

const char* router_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
