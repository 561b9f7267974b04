// Mamba-2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  Per (batch, head), with state h (N, P):
//     h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T,   y_t = C_t^T h_t.
// x (b, h, S, P), dt (b, h, S), B/C (b, g, S, N) in one dtype (fp32 or
// bf16), A (h,) fp32; y like x.  Head hh reads group hh / (h / g).  The
// Python wrapper is repro_torch/kernels/ssd_scan.py; it checks every
// operand and chooses the variant from the shapes.
//
// Bound on an H100.  At Jamba's widths (128 heads of P = 64, N = 16, 4096
// tokens, bf16) a call reads x, dt, B, C and writes y, ~135 MB, against
// ~11 GFLOP of chunked work: bound by bytes, ~40 us.  On the CUDA cores
// alone the work takes >= 0.16 ms at 67 TFLOP/s, so the bf16 path runs
// its products on the tensor cores.
//
// Design.  The Pallas grid walked a head's chunks in order, carrying the
// state in VMEM.  Here the chunks run in parallel (Mamba-2's chunked
// algorithm, 2048 blocks at Jamba's widths), in three launches:
//   1. state: per (batch, head, chunk c) of Q steps, the prefix cum_i of
//      dt A inside the chunk, the chunk's own state
//          S_c = sum_i exp(cum_Q - cum_i) dt_i B_i x_i^T     (N x P)
//      and its decay exp(cum_Q);
//   2. pass: per (batch, head), the state entering each chunk,
//          h_0 = 0,  h_c = exp(cum_Q,c-1) h_{c-1} + S_{c-1},
//      1024-element fp32 FMAs over the 16 chunks, in place of S_c;
//   3. out: per (batch, head, chunk)
//          y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//                + exp(cum_i) C_i^T h_c.
// Decay is only ever taken of cum_i - cum_j with j <= i and of cum_Q -
// cum_i, never of a masked, positive exponent.  Steps past S are dt = 0
// (exact: they decay nothing and add nothing) and are not written, so the
// wrapper pads nothing.  The state is fp32 throughout.
//
// Two variants, chosen by the wrapper from the shapes.
//  * tensor_core (bf16, Q a multiple of 64 up to 256, N a multiple of 16
//    up to 128, P a multiple of 8 up to 64).  Pass 3 is flash attention's
//    shape: S = C B^T (64 x 64 tiles, K = N) is a wgmma from shared memory
//    with C and B K-major in the 128-byte swizzle, a row of N > 64 values
//    in two 128-byte column blocks (Mamba-2 370M's N = 128: a K = 128
//    chain of eight k-slices); W = S o exp(cum_i -
//    cum_j) o dt_j is formed on the accumulator fragment in fp32 (dt is
//    folded into W, so x stays exact); y += W x is a wgmma with W from
//    registers as bf16 hi + lo (bf16 alone misses the tolerance, as P
//    does in flash) and the x tile, loaded by TMA, as the transposed
//    (MN-major) B operand.  Off the diagonal tile the decay factors into
//    a row part and a column part (both non-positive exponents), so W
//    costs two multiplies an entry; the diagonal tile takes one exp an
//    entry.  The inter-chunk term C h (K = N) is a wgmma too, with the
//    fp32 state as bf16 hi + lo, scaled by exp(cum_i) before the intra
//    products accumulate on it.  Two warpgroups share a chunk's row
//    blocks, heaviest and lightest together.  Pass 1 is S_c^T = x^T (B o
//    w), M = P = 64, N up to 128, K = Q, one warpgroup: x^T is the
//    transposed A operand from the same TMA tile, B o w the K-major B
//    operand as hi + lo.
//  * cuda_core (fp32, and bf16 shapes the tensor-core tiles do not
//    take): the same three passes in fp32 on the CUDA cores; in pass 3
//    thread i computes row i.  Its pass 3 holds the whole chunk's x, B
//    and C in shared memory, so the wrapper runs it at the largest of
//    Q, Q/2, Q/4, ... whose out_simt_floats fit (Q/2 at N = 128, P = 64);
//    the chunked algorithm is exact at any chunk.
// What bounds the bf16 call now (PERF.md, measured on an H100): pass 3,
// about four fifths of it, on forming W on the CUDA cores and on the
// hi + lo products, which double the tensor work; x is read twice (passes
// 1 and 3), so the bytes alone are ~1.5x the bound above.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;          // cuda_core: one thread per step
constexpr int MAX_CHUNK = 256;
constexpr int MAX_P = 64;             // one 128-byte row of bf16
constexpr int MAX_N = 128;            // tensor_core: two 128-byte rows of bf16
constexpr int TC_ROWS = 64;           // wgmma rows; chunks are a multiple
constexpr int OUT_THREADS = 256;      // tensor_core pass 3: 2 warpgroups
constexpr int STATE_THREADS = 128;    // tensor_core pass 1: 1 warpgroup
constexpr int PASS_THREADS = 1024;     // pass 2: one thread per state element
constexpr int PASS_GROUP = 8;         // pass 2: chunks loaded per round trip
constexpr unsigned FULL = 0xffffffffu;

// tensor_core shared memory (bytes) of pass 3 at chunk q and state size
// n: a 128-byte row per step for x, and one per 64 state values for each of
// C and B, per state row for the state as hi and lo, cum, the column
// factors and dt, the scan's 32 partials, the mbarrier and the 1024-byte
// alignment slack
constexpr int out_tc_smem(int q, int n) { return q * 128 + 2 * q * 128 * ((n + 63) / 64) + 2 * n * 128 + 3 * q * 4 + 128 + 8 + 1024; }
// pass 1 at chunk q and wgmma width nw: x, B o w as hi and lo (nw rows of
// q columns), cum, partials, mbarrier, slack
constexpr int state_tc_smem(int q, int nw) { return q * 128 + 2 * nw * q * 2 + q * 4 + 128 + 8 + 1024; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// cuda_core shared memory (floats) of passes 1 and 3
size_t state_simt_floats(int Q, int P, int N) {
  return (size_t)Q * P + (size_t)Q * N + Q + 32;
}
size_t out_simt_floats(int Q, int P, int N) {
  return (size_t)Q * P + (size_t)Q * N + (size_t)Q * (N + 1) + Q +
         (size_t)N * P + 32;
}

// Inclusive prefix sum of cum[0..Q) in place, any blockDim (a multiple of
// 32) and Q <= 8 blockDim; wsum holds 32 floats.
__device__ void block_scan(float* cum, int Q, float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int nw = blockDim.x / 32, per = (Q + blockDim.x - 1) / blockDim.x;
  float run = 0.f;                     // the thread's run of `per` steps
  for (int r = 0; r < per; ++r) {
    const int i = tid * per + r;
    if (i < Q) {
      run += cum[i];
      cum[i] = run;
    }
  }
  float v = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < nw ? wsum[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += u;
    }
    if (lane < nw) wsum[lane] = t;
  }
  __syncthreads();
  const float before = (w > 0 ? wsum[w - 1] : 0.f) + (v - run);
  for (int r = 0; r < per; ++r) {
    const int i = tid * per + r;
    if (i < Q) cum[i] += before;
  }
  __syncthreads();
}

// cum[i] = dt_i A over the chunk (0 past S), then its prefix sum.
template <typename T>
__device__ void chunk_cum(float* cum, float* wsum, const T* dtp, float a,
                          int c0, int S, int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    cum[i] = (c0 + i < S ? to_f(dtp[c0 + i]) : 0.f) * a;
  __syncthreads();
  block_scan(cum, Q, wsum);
}

// ---- pass 2 (both variants): the state entering each chunk ------------------
// One thread per state element; the chunks' values are loaded PASS_GROUP
// at a time before any is written, so a group costs one round trip.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                int H, int nc, int NPs) {
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  float* st = states + bh * nc * NPs;
  const float* dc = decay + bh * nc;
  for (int e = threadIdx.x; e < NPs; e += blockDim.x) {
    float h = 0.f;
    for (int c0 = 0; c0 < nc; c0 += PASS_GROUP) {
      float s[PASS_GROUP], g[PASS_GROUP];
#pragma unroll
      for (int u = 0; u < PASS_GROUP; ++u) {
        const bool in = c0 + u < nc;
        s[u] = in ? st[(size_t)(c0 + u) * NPs + e] : 0.f;
        g[u] = in ? dc[c0 + u] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PASS_GROUP; ++u)
        if (c0 + u < nc) {
          st[(size_t)(c0 + u) * NPs + e] = h;
          h = fmaf(g[u], h, s[u]);
        }
    }
  }
}

// ---- cuda_core pass 1: S_c = sum_i B_i (w_i x_i)^T ----------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_simt_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ Bm, const float* __restrict__ A,
                      float* __restrict__ states, float* __restrict__ decay,
                      int H, int G, int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                  // Q x P
  float* Bs = xs + Q * P;            // Q x N: B_i w_i
  float* cum = Bs + Q * N;           // Q
  float* wsum = cum + Q;             // 32
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, c0 = c * Q, gg = hh / (H / G);
  const size_t bh = (size_t)bb * H + hh;
  const T* xp = x + bh * S * P;
  const T* dtp = dt + bh * S;
  const T* Bp = Bm + ((size_t)bb * G + gg) * S * N;
  chunk_cum(cum, wsum, dtp, A[hh], c0, S, Q);
  const float total = cum[Q - 1];
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int i = e / P, t = c0 + i;
    xs[e] = t < S ? to_f(xp[(size_t)t * P + e % P]) : 0.f;
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int i = e / N, t = c0 + i;
    Bs[e] = t < S ? to_f(Bp[(size_t)t * N + e % N]) * to_f(dtp[t]) *
                        expf(total - cum[i])
                  : 0.f;
  }
  __syncthreads();
  float* out = states + (bh * nc + c) * N * P;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) {
    const int n = e / P, p = e % P;
    float s = 0.f;
    for (int i = 0; i < Q; ++i) s = fmaf(Bs[i * N + n], xs[i * P + p], s);
    out[e] = s;
  }
  if (threadIdx.x == 0) decay[bh * nc + c] = expf(total);
}

// ---- cuda_core pass 3: thread i computes row i of the chunk ------------------
// PM >= P: output columns a thread keeps in registers.
template <typename T, int PM>
__global__ void __launch_bounds__(THREADS)
ssd_out_simt_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ A,
                    const float* __restrict__ states, T* __restrict__ y,
                    int H, int G, int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                  // Q x P: dt_i * x_i
  float* Bs = xs + Q * P;            // Q x N
  float* Cs = Bs + Q * N;            // Q x (N + 1): thread i reads row i
  float* cum = Cs + Q * (N + 1);     // Q
  float* hs = cum + Q;               // N x P: the state entering the chunk
  float* wsum = hs + N * P;          // 32
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, c0 = c * Q, gg = hh / (H / G);
  const size_t bh = (size_t)bb * H + hh;
  const T* xp = x + bh * S * P;
  const T* dtp = dt + bh * S;
  const T* Bp = Bm + ((size_t)bb * G + gg) * S * N;
  const T* Cp = Cm + ((size_t)bb * G + gg) * S * N;
  const float* hp = states + (bh * nc + c) * N * P;
  chunk_cum(cum, wsum, dtp, A[hh], c0, S, Q);
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int i = e / P, t = c0 + i;
    xs[e] = t < S ? to_f(xp[(size_t)t * P + e % P]) * to_f(dtp[t]) : 0.f;
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int i = e / N, n = e % N, t = c0 + i;
    const bool in = t < S;
    Bs[e] = in ? to_f(Bp[(size_t)t * N + n]) : 0.f;
    Cs[i * (N + 1) + n] = in ? to_f(Cp[(size_t)t * N + n]) : 0.f;
  }
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) hs[e] = hp[e];
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= Q || c0 + i >= S) return;
  float acc[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) acc[p] = 0.f;
  const float ci = cum[i];
  const float* crow = Cs + i * (N + 1);
  for (int j = 0; j <= i; ++j) {                        // intra-chunk
    const float* brow = Bs + j * N;
    float cb = 0.f;
    for (int n = 0; n < N; ++n) cb = fmaf(crow[n], brow[n], cb);
    const float w = cb * expf(ci - cum[j]);
    const float* xr = xs + j * P;
#pragma unroll
    for (int p = 0; p < PM; ++p)
      if (p < P) acc[p] = fmaf(w, xr[p], acc[p]);
  }
  const float ei = expf(ci);                            // inter-chunk
  for (int n = 0; n < N; ++n) {
    const float cn = crow[n] * ei;
    const float* sr = hs + n * P;
#pragma unroll
    for (int p = 0; p < PM; ++p)
      if (p < P) acc[p] = fmaf(cn, sr[p], acc[p]);
  }
  T* yr = y + (bh * S + c0 + i) * P;
#pragma unroll
  for (int p = 0; p < PM; ++p)
    if (p < P) yr[p] = from_f<T>(acc[p]);
}

// ---- tensor_core helpers ----------------------------------------------------
// byte offset of element (r, k) of a tile of 128-byte rows in the 128-byte
// swizzle (8-row atoms of 1024 bytes)
__device__ __forceinline__ int sw128(int r, int k) {
  return r * 128 + (((k / 8) ^ (r % 8)) * 16) + (k % 8) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows c0 .. c0 + Q of a (S, N) bf16 matrix into swizzled tiles of
// 128-byte rows, one tile of Q rows per 64 columns, zeros past S: 16-byte
// chunks (N is a multiple of 16 and the matrix 16-byte aligned), all of a
// thread's loads issued together.
__device__ __forceinline__ void load_bc(uint8_t* dst, const bf16* src, int c0,
                                        int S, int N, int Q) {
  const int per_row = N / 8;
  for (int e = threadIdx.x; e < Q * per_row; e += blockDim.x) {
    const int i = e / per_row, c = e % per_row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c0 + i < S) v = *reinterpret_cast<const uint4*>(src + (size_t)(c0 + i) * N + 8 * c);
    *reinterpret_cast<uint4*>(dst + (c / 8) * Q * 128 + i * 128 +
                              (((c % 8) ^ (i % 8)) * 16)) = v;
  }
}

// Descriptor address of k-slice kk (16 values) of row r0 of a tile that
// load_bc wrote: column block kk / 4, 32 bytes per slice within it.
__device__ __forceinline__ const uint8_t* bc_slice(const uint8_t* tile, int r0,
                                                   int kk, int Q) {
  return tile + (kk / 4) * Q * 128 + r0 * 128 + 32 * (kk % 4);
}

// ---- tensor_core pass 1: S_c^T = x^T (B o w), one warpgroup ------------------
// NW: the wgmma width that holds N (16, 32, 64 or 128; rows of B o w past
// N are zeros).
template <int NW>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_state_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                    const bf16* __restrict__ dt, const bf16* __restrict__ Bm,
                    const float* __restrict__ A, float* __restrict__ states,
                    float* __restrict__ decay, int H, int G, int S, int P,
                    int N, int Q) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Xs = hopper::align1024(smem_raw);             // Q rows x 128 B
  uint8_t* Bhi = Xs + Q * 128;                           // Q/64 blocks x NW x 128 B
  uint8_t* Blo = Bhi + NW * Q * 2;
  float* cum = reinterpret_cast<float*>(Blo + NW * Q * 2);
  float* wsum = cum + Q;                                 // 32
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsum + 32);
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, c0 = c * Q, gg = hh / (H / G);
  const size_t bh = (size_t)bb * H + hh;
  const bf16* dtp = dt + bh * S;
  const bf16* Bp = Bm + ((size_t)bb * G + gg) * S * N;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, Q * 128);
    hopper::tma_load_3d(Xs, &map_x, bar, 0, c0, static_cast<int>(bh));
  }
  chunk_cum(cum, wsum, dtp, A[hh], c0, S, Q);
  const float total = cum[Q - 1];
  // B o w, K-major: row n, column i, in Q/64 column blocks of NW rows
  // (rows past N zeros).  A thread takes whole steps i: B_i in 16-byte
  // chunks, w_i = dt_i exp(cum_Q - cum_i).
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const int t = c0 + i;
    const float w = t < S ? __bfloat162float(dtp[t]) * expf(total - cum[i]) : 0.f;
#pragma unroll
    for (int c = 0; c < NW / 8; ++c) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t < S && 8 * c < N)
        raw = *reinterpret_cast<const uint4*>(Bp + (size_t)t * N + 8 * c);
      const bf16* bv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = 8 * c + u;
        const float v = __bfloat162float(bv[u]) * w;
        const bf16 hi = __float2bfloat16(v);
        const int off = (i / 64) * NW * 128 + sw128(n, i % 64);
        *reinterpret_cast<bf16*>(Bhi + off) = hi;
        *reinterpret_cast<bf16*>(Blo + off) = __float2bfloat16(v - __bfloat162float(hi));
      }
    }
  }
  hopper::fence_proxy_async();
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  float acc[NW / 2];
#pragma unroll
  for (int r = 0; r < NW / 2; ++r) acc[r] = 0.f;
  hopper::fence_regs<NW / 2>(acc);
  hopper::wgmma_fence();
  for (int kk = 0; kk < Q / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(Xs + 2048 * kk, Q * 128, 1024);
    const int boff = (kk / 4) * NW * 128 + 32 * (kk % 4);
    hopper::WgmmaSS<NW, 1, 0>::run(acc, da, hopper::desc_sw128(Bhi + boff, 16, 1024), 1);
    hopper::WgmmaSS<NW, 1, 0>::run(acc, da, hopper::desc_sw128(Blo + boff, 16, 1024), 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs<NW / 2>(acc);

  // thread (warp w, lane 4 g + t4) holds rows (p) 16 w + g and + 8, and in
  // each 8-column block j the columns (n) 8 j + 2 t4 and + 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* out = states + (bh * nc + c) * N * P;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 16 * warp + g + 8 * r, n = 8 * j + 2 * t4 + e;
        if (p < P && n < N) out[n * P + p] = acc[4 * j + 2 * r + e];
      }
  if (threadIdx.x == 0) decay[bh * nc + c] = expf(total);
}

// ---- tensor_core pass 3: y = diag(exp(cum)) C h + (C B^T o L o dt) x -------
// NK = N / 16: the k-slices of C B^T and of C h (4 to a 64-column block).
template <int NK>
__global__ void __launch_bounds__(OUT_THREADS, 2)
ssd_out_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                  const bf16* __restrict__ dt, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ A,
                  const float* __restrict__ states, bf16* __restrict__ y,
                  int H, int G, int S, int P, int N, int Q) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int NB = (NK + 3) / 4;                       // 64-column blocks of C, B
  uint8_t* Xs = hopper::align1024(smem_raw);             // Q rows x 128 B each
  uint8_t* Cs = Xs + Q * 128;                            // NB x Q rows x 128 B
  uint8_t* Bs = Cs + NB * Q * 128;
  uint8_t* Hhi = Bs + NB * Q * 128;                      // N rows x 128 B each
  uint8_t* Hlo = Hhi + N * 128;
  float* cum = reinterpret_cast<float*>(Hlo + N * 128);  // Q
  float* qcol = cum + Q;                                 // Q
  float* dts = qcol + Q;                                 // Q
  float* wsum = dts + Q;                                 // 32
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsum + 32);
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int nc = gridDim.x, c0 = c * Q, gg = hh / (H / G);
  const size_t bh = (size_t)bb * H + hh;
  const bf16* dtp = dt + bh * S;
  const size_t bg = ((size_t)bb * G + gg) * S * N;
  const float* hp = states + (bh * nc + c) * N * P;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, Q * 128);
    hopper::tma_load_3d(Xs, &map_x, bar, 0, c0, static_cast<int>(bh));
  }
  load_bc(Cs, Cm + bg, c0, S, N, Q);
  load_bc(Bs, Bm + bg, c0, S, N, Q);
  // the state entering the chunk as bf16 hi + lo, MN-major (rows n)
  for (int e = threadIdx.x; e < N * 64; e += blockDim.x) {
    const int n = e / 64, p = e % 64;
    const float v = p < P ? hp[n * P + p] : 0.f;
    const bf16 hi = __float2bfloat16(v);
    *reinterpret_cast<bf16*>(Hhi + sw128(n, p)) = hi;
    *reinterpret_cast<bf16*>(Hlo + sw128(n, p)) = __float2bfloat16(v - __bfloat162float(hi));
  }
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    dts[i] = c0 + i < S ? __bfloat162float(dtp[c0 + i]) : 0.f;
  hopper::fence_proxy_async();
  chunk_cum(cum, wsum, dtp, A[hh], c0, S, Q);           // syncs the block
  // the column factor of an off-diagonal tile: exp(cum_end - cum_j) dt_j,
  // cum_end the tile's last step (a non-positive exponent)
  for (int j = threadIdx.x; j < Q; j += blockDim.x)
    qcol[j] = expf(cum[j / TC_ROWS * TC_ROWS + TC_ROWS - 1] - cum[j]) * dts[j];
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t4 = lane % 4;
  const int nb = Q / TC_ROWS;
  // row blocks heaviest first, dealt 0, 1, 1, 0, 0, 1, ... so the two
  // warpgroups get equal shares of the causal tiles
  for (int k = 0; k < nb; ++k) {
    if (((k + 1) / 2) % 2 != wg) continue;
    const int rb = nb - 1 - k;
    const int row0 = rb * TC_ROWS + 16 * w4 + g, row1 = row0 + 8;
    const float cr0 = cum[row0], cr1 = cum[row1];

    // inter-chunk term first: acc = diag(exp(cum_i)) C h, C h by wgmma
    // with h as hi + lo
    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    hopper::fence_regs<32>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint64_t dc = hopper::desc_sw128(bc_slice(Cs, rb * TC_ROWS, kk, Q), 16, 1024);
      hopper::WgmmaSS<64, 0, 1>::run(
          acc, dc, hopper::desc_sw128(Hhi + 2048 * kk, N * 128, 1024), 1);
      hopper::WgmmaSS<64, 0, 1>::run(
          acc, dc, hopper::desc_sw128(Hlo + 2048 * kk, N * 128, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(acc);
    const float e0 = expf(cr0), e1 = expf(cr1);
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] *= (r % 4) < 2 ? e0 : e1;

    for (int jt = 0; jt <= rb; ++jt) {
      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.f;
      hopper::fence_regs<32>(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        hopper::WgmmaSS<64, 0, 0>::run(
            sc, hopper::desc_sw128(bc_slice(Cs, rb * TC_ROWS, kk, Q), 16, 1024),
            hopper::desc_sw128(bc_slice(Bs, jt * TC_ROWS, kk, Q), 16, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(sc);

      // W = S o exp(cum_i - cum_j) o dt_j below the diagonal.  Off the
      // diagonal every row lies past the tile, so the decay factors into
      // a row part exp(cum_i - cum_end) and the column part qcol, both of
      // non-positive exponents; on it, each entry takes its own.
      const bool diag = jt == rb;
      const float cend = cum[jt * TC_ROWS + TC_ROWS - 1];
      const float f0 = diag ? 0.f : expf(cr0 - cend);
      const float f1 = diag ? 0.f : expf(cr1 - cend);
      // as bf16 hi + lo A fragments (k-slice kk is registers 8 kk .. 8 kk + 7)
      uint32_t whi[4][4], wlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * r + e;
            const int col = jt * TC_ROWS + 8 * (i / 4) + 2 * t4 + (i % 2);
            const bool r1 = (i % 4) >= 2;
            if (!diag)
              v[e] = sc[i] * (r1 ? f1 : f0) * qcol[col];
            else
              v[e] = col <= (r1 ? row1 : row0)
                         ? sc[i] * expf((r1 ? cr1 : cr0) - cum[col]) * dts[col]
                         : 0.f;
          }
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
          const float2 hf = __bfloat1622float2(hi);
          whi[kk][r] = *reinterpret_cast<uint32_t*>(&hi);
          wlo[kk][r] = pack_bf16(v[0] - hf.x, v[1] - hf.y);
        }
      hopper::fence_regs<32>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = hopper::desc_sw128(
            Xs + jt * TC_ROWS * 128 + 2048 * kk, Q * 128, 1024);
        hopper::WgmmaRS<64, 1>::run(acc, whi[kk], dx, 1);
        hopper::WgmmaRS<64, 1>::run(acc, wlo[kk], dx, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(acc);
    }

    bf16* yp = y + (bh * S + c0) * P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * t4;
      if (p >= P) continue;              // P is a multiple of 8: p + 1 < P too
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row1 : row0;
        if (c0 + row >= S) continue;
        *reinterpret_cast<__nv_bfloat162*>(yp + (size_t)row * P + p) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---- launches ---------------------------------------------------------------
template <typename T, int PM>
int launch_simt(const void* x, const void* dt, const void* B, const void* C,
                const float* A, void* y, float* states, float* decay, int b,
                int H, int G, int S, int P, int N, int Q, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q;
  const dim3 grid(nc, H, b);
  const size_t sm1 = sizeof(float) * state_simt_floats(Q, P, N);
  const size_t sm3 = sizeof(float) * out_simt_floats(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out_simt_kernel<T, PM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sm3));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_simt_kernel<T><<<grid, THREADS, sm1, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(B), A, states, decay, H, G, S, P, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3(H, b), PASS_THREADS, 0, s>>>(states, decay, H, nc, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_simt_kernel<T, PM><<<grid, THREADS, sm3, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C), A, states,
      static_cast<T*>(y), H, G, S, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simt(const void* x, const void* dt, const void* B, const void* C,
                  const float* A, void* y, float* states, float* decay, int b,
                  int H, int G, int S, int P, int N, int Q, cudaStream_t s) {
  if (P <= 16)
    return launch_simt<T, 16>(x, dt, B, C, A, y, states, decay, b, H, G, S, P, N, Q, s);
  if (P <= 32)
    return launch_simt<T, 32>(x, dt, B, C, A, y, states, decay, b, H, G, S, P, N, Q, s);
  return launch_simt<T, 64>(x, dt, B, C, A, y, states, decay, b, H, G, S, P, N, Q, s);
}

template <int NW>
int launch_state_tc(const CUtensorMap& mx, const bf16* dt, const bf16* B,
                    const float* A, float* states, float* decay, int b, int H,
                    int G, int S, int P, int N, int Q, cudaStream_t s) {
  const int smem = state_tc_smem(Q, NW);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_tc_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_tc_kernel<NW><<<dim3((S + Q - 1) / Q, H, b), STATE_THREADS, smem, s>>>(
      mx, dt, B, A, states, decay, H, G, S, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_out_tc(const CUtensorMap& mx, const bf16* dt, const bf16* B,
                  const bf16* C, const float* A, const float* states, bf16* y,
                  int b, int H, int G, int S, int P, int N, int Q,
                  cudaStream_t s) {
  const int smem = out_tc_smem(Q, N);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_out_tc_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_out_tc_kernel<NK><<<dim3((S + Q - 1) / Q, H, b), OUT_THREADS, smem, s>>>(
      mx, dt, B, C, A, states, y, H, G, S, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const bf16* x, const bf16* dt, const bf16* B, const bf16* C,
              const float* A, bf16* y, float* states, float* decay, int b,
              int H, int G, int S, int P, int N, int Q, cudaStream_t s) {
  CUtensorMap mx{};
  if (!hopper_host::make_map_3d(&mx, x, P, S, (uint64_t)b * H, 64, Q))
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  int err = N <= 16 ? launch_state_tc<16>(mx, dt, B, A, states, decay, b, H, G, S, P, N, Q, s)
          : N <= 32 ? launch_state_tc<32>(mx, dt, B, A, states, decay, b, H, G, S, P, N, Q, s)
          : N <= 64 ? launch_state_tc<64>(mx, dt, B, A, states, decay, b, H, G, S, P, N, Q, s)
                    : launch_state_tc<128>(mx, dt, B, A, states, decay, b, H, G, S, P, N, Q, s);
  if (err != 0) return err;
  ssd_pass_kernel<<<dim3(H, b), PASS_THREADS, 0, s>>>(states, decay, H, nc, N * P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (N / 16) {
    case 1: return launch_out_tc<1>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    case 2: return launch_out_tc<2>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    case 3: return launch_out_tc<3>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    case 4: return launch_out_tc<4>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    case 5: return launch_out_tc<5>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    case 6: return launch_out_tc<6>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    case 7: return launch_out_tc<7>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
    default: return launch_out_tc<8>(mx, dt, B, C, A, states, y, b, H, G, S, P, N, Q, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y alike; A is fp32).
// variant: 0 = cuda_core (P <= 64, Q <= 256, shared memory of
// out_simt_floats(Q, P, N) floats <= 227 KB), 1 = tensor_core (bf16, Q a
// multiple of 64 up to 256, N a multiple of 16 up to 128, P a multiple of
// 8 up to 64, x, B and C 16-byte aligned).  states (b, h, nc, N, P) and decay (b,
// h, nc) fp32 are the wrapper's scratch, nc = ceil(S / Q).  The caller
// chooses the variant; nothing here falls back.  Three launches on
// `stream`, no host sync.  Returns the first error, 0 on success.
int ssd_scan_launch(const void* x, const void* dt, const void* B,
                    const void* C, const float* A, void* y, float* states,
                    float* decay, int b, int H, int G, int S, int P, int N,
                    int Q, int dtype, int variant, void* stream) {
  if (b <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || P <= 0 ||
      N <= 0 || Q <= 0 || Q > MAX_CHUNK || P > MAX_P || b > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || Q % TC_ROWS != 0 || N % 16 != 0 || N > MAX_N ||
        P % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(C) % 16 != 0)
      return cudaErrorInvalidValue;
    return launch_tc(static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
                     static_cast<const bf16*>(B), static_cast<const bf16*>(C), A,
                     static_cast<bf16*>(y), states, decay, b, H, G, S, P, N, Q, s);
  }
  if (variant != 0 || sizeof(float) * out_simt_floats(Q, P, N) > 232448)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_simt<float>(x, dt, B, C, A, y, states, decay, b, H, G, S, P, N, Q, s);
  if (dtype == 1)
    return dispatch_simt<bf16>(x, dt, B, C, A, y, states, decay, b, H, G, S, P, N, Q, s);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
