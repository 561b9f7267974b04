// One mesh cycle of the cycle-level network simulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/router_step.py::router_step_call
// (its body _router_kernel traces repro/netsim_jax/sim.py::_step_core).
// It computes what repro_torch/netsim/sim.py::step_core computes, bit for
// bit, over a batch of independent lanes.  The Python wrapper is
// repro_torch/kernels/router_step.py; it owns the layout (the leaf order of
// RouterArgs, the dimensions in RouterDims) and checks every operand.
//
// Design.  The state stays in device memory (12 lanes of a 16x32 mesh with
// 16-deep FIFOs are ~23 MB, which lives in the 50 MB L2).  One thread per
// (lane, tile); a cycle is two launches:
//   arbitrate  routes the head packet of every input FIFO and runs the
//              round-robin arbitration of both networks.  It reads the
//              neighbours' FIFO counts only, all from start-of-cycle state,
//              and writes the winner and its packet per (network, output)
//              into a scratch array, plus the lane's start-of-cycle cycle.
//   advance    finalizes the port-P deliver gates, pops, services the
//              endpoint, pulls the neighbours' winners from the scratch
//              into its own input FIFOs, injects, and updates telemetry.
//              It writes only its own tile's state, so the update is in
//              place and race-free.
// Per-lane reductions (completions per cycle, the latency histogram, the
// count of tiles not drained after the cycle) use integer atomicAdd, which
// is exact in any order.  Signed overflow is undefined in C++, so the
// counters that may wrap (as int32 does in the reference) add unsigned.
// Remainders of possibly negative numbers use floor_mod, never bare %.
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
constexpr int BLOCK = 128;

}  // namespace

extern "C" {

// Field order is the wrapper's _Args (STATE_LEAVES, then the rest).
struct RouterArgs {
  int32_t* net_buf;      // (B, F, 2, ny, nx, 5, cap)
  int32_t* net_head;     // (B, 2, ny, nx, 5)
  int32_t* net_count;    // (B, 2, ny, nx, 5)
  int32_t* ep_buf;       // (B, F, ny, nx, 1, ep_fifo)
  int32_t* ep_head;      // (B, ny, nx, 1)
  int32_t* ep_count;     // (B, ny, nx, 1)
  uint8_t* resp_valid;   // (B, L, ny, nx) bool
  int32_t* resp_buf;     // (B, F, L, ny, nx)
  int32_t* mem;          // (B, ny, nx, mem_words)
  int32_t* credits;      // (B, ny, nx)
  int32_t* rr;           // (B, 2, ny, nx, 5)
  int32_t* prog_ptr;     // (B, ny, nx)
  uint8_t* reg_valid;    // (B, ny, nx) bool
  int32_t* reg_buf;      // (B, F, ny, nx)
  int32_t* completed;    // (B, ny, nx)
  int32_t* lat_sum;      // (B, ny, nx)
  int32_t* out_of_credit_cycles;  // (B, ny, nx)
  int32_t* cycle;        // (B,)
  int32_t* fifo_depth;   // (B,)
  int32_t* max_credits;  // (B,)
  int32_t* link_util;    // (B, 2, ny, nx, 5)
  int32_t* fifo_hwm;     // (B, 2, ny, nx, 5)
  int32_t* ep_hwm;       // (B, ny, nx)
  int32_t* lat_hist;     // (B, LAT_BINS)
  int32_t* measure_start;  // (B,)
  int32_t* measure_stop;   // (B,)
  const int32_t* prog_buf;  // (B, 5, ny, nx, Lp)
  const int32_t* prog_len;  // (B, ny, nx)
  int32_t* scratch;      // (B, ny, nx, 2, 5, SCR)
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
};

}  // extern "C"

namespace {

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
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
  int b, t, x, y;
  int tw, te, tn, ts;    // neighbour tiles, -1 across a non-wrapped edge
};

__device__ __forceinline__ bool tile_of(const RouterDims& d, Tile& k) {
  const int T = d.ny * d.nx;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= d.B * T) return false;
  k.b = gid / T;
  k.t = gid - k.b * T;
  k.y = k.t / d.nx;
  k.x = k.t - k.y * d.nx;
  k.tw = k.x > 0 ? k.t - 1 : (d.wrap_x ? k.t + d.nx - 1 : -1);
  k.te = k.x < d.nx - 1 ? k.t + 1 : (d.wrap_x ? k.t - (d.nx - 1) : -1);
  k.tn = k.y > 0 ? k.t - d.nx : (d.wrap_y ? k.t + (d.ny - 1) * d.nx : -1);
  k.ts = k.y < d.ny - 1 ? k.t + d.nx : (d.wrap_y ? k.t - (d.ny - 1) * d.nx : -1);
  return true;
}

// offset of (b, n, tile, port) in the (B, 2, ny, nx, 5) leaves
__device__ __forceinline__ int port_idx(int b, int n, int T, int tile, int p) {
  return ((b * 2 + n) * T + tile) * NP + p;
}

// offset of slot s of (b, lane f, n, tile, port) in net_buf
__device__ __forceinline__ size_t buf_idx(const RouterDims& d, int b, int f,
                                          int n, int tile, int p, int s) {
  const int T = d.ny * d.nx;
  return ((((static_cast<size_t>(b) * NF + f) * 2 + n) * T + tile) * NP + p)
         * d.cap + s;
}

// offset of word k of the scratch record of (b, tile, n, out)
__device__ __forceinline__ size_t scr_idx(const RouterDims& d, int b, int tile,
                                          int n, int o, int k) {
  const int T = d.ny * d.nx;
  return (((static_cast<size_t>(b) * T + tile) * 2 + n) * NP + o) * SCR + k;
}

__global__ void __launch_bounds__(BLOCK)
arbitrate_kernel(RouterArgs a, RouterDims d) {
  Tile k;
  if (!tile_of(d, k)) return;
  const int T = d.ny * d.nx;
  const int b = k.b, t = k.t;
  const int cyc = a.cycle[b];
  if (t == 0) a.cyc_snap[b] = cyc;
  const int depth = a.fifo_depth[b];

  bool e_gated = false, w_gated = false, open_now = true;
  if (d.chip_w > 0) {
    open_now = floor_mod(cyc, d.period) == 0;
    e_gated = (k.x + 1) % d.chip_w == 0 && k.x + 1 < d.nx;
    w_gated = k.x % d.chip_w == 0 && k.x > 0;
  }

  for (int n = 0; n < 2; ++n) {
    const int* cnt = a.net_count;
    // space at the neighbour's facing input: one free slot (sp), two free
    // slots (sp2, the ring-entry rule; only wrapped dimensions use it)
    bool sp[NP], sp2[NP];
    sp[P_] = sp2[P_] = true;
    sp[W_] = k.tw >= 0 && cnt[port_idx(b, n, T, k.tw, E_)] < depth;
    sp[E_] = k.te >= 0 && cnt[port_idx(b, n, T, k.te, W_)] < depth;
    sp[N_] = k.tn >= 0 && cnt[port_idx(b, n, T, k.tn, S_)] < depth;
    sp[S_] = k.ts >= 0 && cnt[port_idx(b, n, T, k.ts, N_)] < depth;
    sp2[W_] = !d.wrap_x || cnt[port_idx(b, n, T, k.tw, E_)] < depth - 1;
    sp2[E_] = !d.wrap_x || cnt[port_idx(b, n, T, k.te, W_)] < depth - 1;
    sp2[N_] = !d.wrap_y || cnt[port_idx(b, n, T, k.tn, S_)] < depth - 1;
    sp2[S_] = !d.wrap_y || cnt[port_idx(b, n, T, k.ts, N_)] < depth - 1;
    if (e_gated) sp[E_] = sp[E_] && open_now;
    if (w_gated) sp[W_] = sp[W_] && open_now;

    bool valid[NP];
    int want[NP];
    int pkt[NP][NF];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pi = port_idx(b, n, T, t, i);
      valid[i] = cnt[pi] > 0;
      const int slot = a.net_head[pi];
#pragma unroll
      for (int f = 0; f < NF; ++f) pkt[i][f] = a.net_buf[buf_idx(d, b, f, n, t, i, slot)];
      const int h = pkt[i][HDR];
      want[i] = route(h & COORD_MASK, (h >> DST_Y_SHIFT) & COORD_MASK, k.x, k.y, d);
    }

#pragma unroll
    for (int o = 0; o < NP; ++o) {
      const bool bubble = (d.wrap_x && (o == E_ || o == W_)) ||
                          (d.wrap_y && (o == N_ || o == S_));
      const int rr = a.rr[port_idx(b, n, T, t, o)];
      int best = NP + 1, win = -1;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const bool need2 = bubble && i != (((o - 1) ^ 1) + 1);
        const bool cand = valid[i] && want[i] == o && sp[o] && (sp2[o] || !need2);
        const int prio = floor_mod(i - rr, NP);
        // strict < over ascending i: the lowest input wins a tie
        if (cand && prio < best) {
          best = prio;
          win = i;
        }
      }
      int* out = a.scratch + scr_idx(d, b, t, n, o, 0);
      out[0] = win;
      // the P column keeps the ungated winner's packet; advance masks it
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        int v = pkt[0][f];
#pragma unroll
        for (int i = 1; i < NP; ++i) v = (win == i) ? pkt[i][f] : v;
        out[1 + f] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
advance_kernel(RouterArgs a, RouterDims d, int j, int C) {
  Tile k;
  if (!tile_of(d, k)) return;
  const int T = d.ny * d.nx;
  const int b = k.b, t = k.t, bt = b * T + t;
  const int c = a.cyc_snap[b];
  const int depth = a.fifo_depth[b];
  const int L = d.L, EP = d.ep_fifo;

  // ---- registered response port becomes visible (stats record) ----
  const bool rv = a.reg_valid[bt] != 0;
  const int tag = a.reg_buf[(b * NF + TAG) * T + t];
  const int lat = wrap_sub(c, tag);
  if (rv) {
    a.completed[bt] = wrap_add(a.completed[bt], 1);
    a.lat_sum[bt] = wrap_add(a.lat_sum[bt], lat);
    atomicAdd(&a.done[b * C + j], 1);
    if (tag >= a.measure_start[b] && tag < a.measure_stop[b]) {
      const int bin = lat < 0 ? 0 : (lat > LAT_BINS - 1 ? LAT_BINS - 1 : lat);
      atomicAdd(&a.lat_hist[b * LAT_BINS + bin], 1);
    }
  }

  int head[2][NP], count[2][NP];
  bool has[2][NP];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      head[n][i] = a.net_head[port_idx(b, n, T, t, i)];
      count[n][i] = a.net_count[port_idx(b, n, T, t, i)];
    }

  // finalize network n: apply the P deliver gate, update rr, pop
  auto finalize = [&](int n, bool deliver) {
    bool pop[NP] = {false, false, false, false, false};
#pragma unroll
    for (int o = 0; o < NP; ++o) {
      int win = a.scratch[scr_idx(d, b, t, n, o, 0)];
      if (o == P_ && !deliver) win = -1;
      has[n][o] = win >= 0;
      if (win >= 0) {
        a.rr[port_idx(b, n, T, t, o)] = (win + 1) % NP;
#pragma unroll
        for (int i = 0; i < NP; ++i) pop[i] = pop[i] || (i == win);
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      head[n][i] = floor_mod(head[n][i] + (pop[i] ? 1 : 0), depth);
      count[n][i] -= pop[i] ? 1 : 0;
    }
  };

  // enqueue into input port i of network n; the neighbour's winner comes
  // from the scratch, the local port-P packet from `local`
  auto push = [&](int n, int i, bool local_valid, const int* local) {
    bool m;
    int src_tile = t, src_port = P_;
    if (i == P_) {
      m = local_valid;
    } else {
      src_tile = i == W_ ? k.tw : i == E_ ? k.te : i == N_ ? k.tn : k.ts;
      src_port = i == W_ ? E_ : i == E_ ? W_ : i == N_ ? S_ : N_;
      m = src_tile >= 0 && a.scratch[scr_idx(d, b, src_tile, n, src_port, 0)] >= 0;
    }
    if (!m) return;
    const int tail = floor_mod(head[n][i] + count[n][i], depth);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int v = i == P_ ? local[f]
                            : a.scratch[scr_idx(d, b, src_tile, n, src_port, 1 + f)];
      a.net_buf[buf_idx(d, b, f, n, t, i, tail)] = v;
    }
    count[n][i] += 1;
  };

  // ---- reverse network: P deliveries are ALWAYS absorbed ----
  finalize(REV, true);
  const bool absorbed = has[REV][P_];
  int credits = wrap_add(a.credits[bt], absorbed ? 1 : 0);
  a.reg_valid[bt] = absorbed ? 1 : 0;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    a.reg_buf[(b * NF + f) * T + t] =
        absorbed ? a.scratch[scr_idx(d, b, t, REV, P_, 1 + f)] : 0;

  // ---- endpoint: inject the pending response of slot c % L ----
  const int slot = floor_mod(c, L);
  const bool inj = a.resp_valid[(b * L + slot) * T + t] != 0;
  int inj_pkt[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) inj_pkt[f] = a.resp_buf[((b * NF + f) * L + slot) * T + t];
#pragma unroll
  for (int i = 0; i < NP; ++i) push(REV, i, inj, inj_pkt);
  int inflight = 0;                      // the slot itself was just emptied
  for (int l = 0; l < L; ++l)
    inflight += (l != slot && a.resp_valid[(b * L + l) * T + t] != 0) ? 1 : 0;

  // ---- endpoint: service one request per cycle (line rate) ----
  const int ehead = a.ep_head[bt], ecount0 = a.ep_count[bt];
  const bool can = ecount0 > 0 && count[REV][P_] + inflight < depth;
  int req[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) req[f] = a.ep_buf[((b * NF + f) * T + t) * EP + ehead];
  const int op = (req[HDR] >> OP_SHIFT) & OP_MASK;
  const int addr = min(max(req[ADDR], 0), d.mem_words - 1);
  int32_t* mem = a.mem + static_cast<size_t>(bt) * d.mem_words;
  const int cur = mem[addr];
  const bool is_store = can && op == OP_STORE;
  const bool is_load = can && op == OP_LOAD;
  const bool is_cas = can && op == OP_CAS;
  if (is_store || (is_cas && cur == req[CMP])) mem[addr] = req[DATA];
  int ep_head = floor_mod(ehead + (can ? 1 : 0), EP);
  int ep_count = ecount0 - (can ? 1 : 0);
  // the response routes home (src <-> dst) and carries the UNCLAMPED addr
  const int src_pair = (k.x & COORD_MASK) | ((k.y & COORD_MASK) << COORD_BITS);
  const int resp[NF] = {((req[HDR] >> SRC_X_SHIFT) & PAIR_MASK) |
                            (src_pair << SRC_X_SHIFT) |
                            (req[HDR] & (OP_MASK << OP_SHIFT)),
                        req[ADDR], (is_load || is_cas) ? cur : 0, req[CMP], req[TAG]};
  a.resp_valid[(b * L + slot) * T + t] = can ? 1 : 0;
  if (can)
#pragma unroll
    for (int f = 0; f < NF; ++f) a.resp_buf[((b * NF + f) * L + slot) * T + t] = resp[f];

  // ---- forward network: P deliveries go to the endpoint FIFO ----
  finalize(FWD, ep_count < EP);
  if (has[FWD][P_]) {
    const int tail = floor_mod(ep_head + ep_count, EP);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      a.ep_buf[((b * NF + f) * T + t) * EP + tail] =
          a.scratch[scr_idx(d, b, t, FWD, P_, 1 + f)];
    ep_count += 1;
  }

  // ---- master injection from the per-lane, per-tile program ----
  const int len = a.prog_len[bt];
  int ptr = a.prog_ptr[bt];
  const bool pending = ptr < len;
  if (pending && credits <= 0)
    a.out_of_credit_cycles[bt] = wrap_add(a.out_of_credit_cycles[bt], 1);
  const int pidx = min(max(ptr, 0), max(d.Lp - 1, 0));
  int entry[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f)
    entry[f] = a.prog_buf[(static_cast<size_t>(b * NF + f) * T + t) * d.Lp + pidx];
  const bool can_inj = pending && credits > 0 && entry[NOT_BEFORE] <= c &&
                       count[FWD][P_] < depth;
  const int pkt[NF] = {entry[HDR] | (src_pair << SRC_X_SHIFT), entry[ADDR],
                       entry[DATA], entry[CMP], c};
#pragma unroll
  for (int i = 0; i < NP; ++i) push(FWD, i, can_inj, pkt);
  credits = wrap_sub(credits, can_inj ? 1 : 0);
  ptr = wrap_add(ptr, can_inj ? 1 : 0);

  // ---- write back the tile's pointers and telemetry ----
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pi = port_idx(b, n, T, t, i);
      a.net_head[pi] = head[n][i];
      a.net_count[pi] = count[n][i];
      a.link_util[pi] = wrap_add(a.link_util[pi], has[n][i] ? 1 : 0);
      a.fifo_hwm[pi] = max(a.fifo_hwm[pi], count[n][i]);
    }
  a.ep_head[bt] = ep_head;
  a.ep_count[bt] = ep_count;
  a.ep_hwm[bt] = max(a.ep_hwm[bt], ep_count);
  a.credits[bt] = credits;
  a.prog_ptr[bt] = ptr;
  if (t == 0) a.cycle[b] = wrap_add(c, 1);

  // post-cycle drain fence: count the tiles that still hold it open
  if (ptr < len || credits != a.max_credits[b] || absorbed)
    atomicAdd(&a.busy[b * C + j], 1);
}

}  // namespace

extern "C" {

// Run C mesh cycles on `stream`: 2 launches per cycle, no host sync.
// Returns the first launch error (cudaGetLastError), 0 on success.
int router_step_launch(const RouterArgs* args, const RouterDims* dims, int C,
                       void* stream) {
  const int n = dims->B * dims->ny * dims->nx;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int j = 0; j < C; ++j) {
    arbitrate_kernel<<<grid, BLOCK, 0, s>>>(*args, *dims);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    advance_kernel<<<grid, BLOCK, 0, s>>>(*args, *dims, j, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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
