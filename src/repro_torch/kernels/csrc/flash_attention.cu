// Flash attention forward (online softmax), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  q (B, H, Sq, hd), k/v (B, KH, Sk, hd), out like q,
// in q's dtype (fp32 or bf16); query head h reads KV head h / (H / KH), as
// the Pallas index map does, so KV is never repeated in memory.  Masks:
// causal (key <= query), sliding window (key > query - window), and the
// kv_len tail (key < kv_len).  Any Sq, Sk and hd <= 128: ragged tails are
// masked here, the wrapper pads nothing.  The Python wrapper is
// repro_torch/kernels/flash_attention.py; it checks every operand.
//
// Bound on an H100.  Jamba's prefill (1 x 4096 tokens, 32 query heads of
// 128, causal) is ~137 GFLOP against ~50 MB of q, k, v and out: bound by
// operations, ~0.14 ms at the bf16 tensor-core peak.
//
// Design, bf16 (flash_wgmma_kernel).  The Pallas grid ran the KV blocks of
// a query block in order and carried m, l and acc in VMEM.  Blocks here run
// in parallel, so a block owns 128 query rows of one (batch, head) (the
// heaviest causal tiles first) and loops over 64-key tiles itself.  One
// producer warp fills a 3-stage ring of K and V tiles (mbarrier full/empty
// pairs) by TMA from 3-D tensor maps over (batch x head, seq, hd), which
// zero-fill past Sq, Sk and hd; where TMA cannot describe the rows (hd not
// a multiple of 8, or an operand not 16-byte aligned) its 32 threads load
// the same swizzled tiles themselves.  Q (64 rows per warpgroup) stays in
// shared memory for the whole loop.  Two consumer warpgroups each own 64
// query rows:
//   S = Q K^T by wgmma.m64n64k16 from shared memory (Q and K both K-major,
//     128-byte swizzle), fp32 accumulators; the scale is applied to S in
//     fp32, as the plain version does;
//   the online softmax runs on the accumulator fragment in fp32 registers:
//     a thread holds 2 rows x 16 keys, the row max and sum reduce over the
//     4 lanes of a quad;
//   O += P V by wgmma with P from registers (the S fragment's layout is
//     the A operand's) and V from shared memory as the transposed
//     (MN-major) B.  P is split into bf16 hi = bf16(P) and lo = bf16(P -
//     hi), two products into the one fp32 accumulator: P rounded to bf16
//     alone misses the 1-ulp tolerance against the fp32 plain version (at
//     Jamba's shape, 68,388 of 2.1 M outputs on the CPU), hi + lo meets it,
//     for 1.5x the tensor-core work of a plain bf16 kernel.
// Tiles wholly masked for the whole block are never loaded; a warpgroup
// skips the products of a tile wholly masked for its own rows.  Masked
// scores are -1e30, not -inf, so exp(m_prev - m_cur) stays finite; l is
// floored at 1e-30.
//
// fp32 (flash_fwd_kernel<float>) keeps every sum in full fp32 on the CUDA
// cores (the reduced Jamba on the card): 8 warps x 4 query rows, 32-key
// tiles, lane j scores key j, hd / 32 output columns per lane.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int ROWS = 4;               // query rows per warp
constexpr int BQ = WARPS * ROWS;      // query rows per block
constexpr int BKV = 32;               // keys per tile (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)BQ * hd + (size_t)BKV * (hd + 1) +
                          (size_t)BKV * hd);
}

// DW = ceil(hd / 32): output columns per lane.
template <typename T, int DW>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int Sq, int Sk, int hd, int kv_len, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // BQ x hd (scaled)
  float* Ks = Qs + BQ * hd;               // BKV x (hd + 1): lane j reads row j
  float* Vs = Ks + BKV * (hd + 1);        // BKV x hd
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const T* qp = q + (size_t)(b * H + h) * Sq * hd;
  const T* kp = k + (size_t)(b * KH + kh) * Sk * hd;
  const T* vp = v + (size_t)(b * KH + kh) * Sk * hd;
  T* op = o + (size_t)(b * H + h) * Sq * hd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < BQ * hd; i += WARPS * 32) {
    const int r = i / hd, d = i % hd;
    Qs[i] = (q0 + r < Sq) ? to_f(qp[(size_t)(q0 + r) * hd + d]) * scale : 0.f;
  }

  // keys any row of this block may see: [kv_begin, kv_end)
  const int q_last = min(Sq, q0 + BQ) - 1;
  int kv_end = min(Sk, kv_len);
  if (causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = ((q0 - window + 1) / BKV) * BKV;

  float m[ROWS], l[ROWS], acc[ROWS][DW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DW; ++dd) acc[r][dd] = 0.f;
  }
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    for (int i = tid; i < BKV * hd; i += WARPS * 32) {
      const int j = i / hd, d = i % hd;
      const bool in = k0 + j < Sk;
      Ks[j * (hd + 1) + d] = in ? to_f(kp[(size_t)(k0 + j) * hd + d]) : 0.f;
      Vs[i] = in ? to_f(vp[(size_t)(k0 + j) * hd + d]) : 0.f;
    }
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * (hd + 1);
    const float* qrow = Qs + warp * ROWS * hd;
    for (int d = 0; d < hd; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qrow[r * hd + d], kv, s[r]);
    }
    const int key = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + warp * ROWS + r;
      bool ok = key < kv_len && key < Sk;
      if (causal) ok = ok && key <= qi;
      if (window > 0) ok = ok && key > qi - window;
      const float sv = ok ? s[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < DW; ++dd) acc[r][dd] *= alpha;
    }
    for (int j = 0; j < BKV; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(FULL, p[r], j);
#pragma unroll
      for (int dd = 0; dd < DW; ++dd) {
        const int d = lane + 32 * dd;
        const float vv = d < hd ? Vs[j * hd + d] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][dd] = fmaf(pj[r], vv, acc[r][dd]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DW; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd) op[(size_t)qi * hd + d] = from_f<T>(acc[r][dd] * inv);
    }
  }
}

template <typename T, int DW>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, int hd, int kv_len, int causal, int window,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DW><<<grid, WARPS * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, hd, kv_len,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KH, int Sq, int Sk, int hd, int kv_len, int causal,
             int window, float scale, cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal, window, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---- bf16: tensor cores -----------------------------------------------------
constexpr int W_BQ = 64;                  // query rows per consumer warpgroup
constexpr int W_WG = 2;                   // consumer warpgroups per block
constexpr int W_BM = W_BQ * W_WG;         // query rows per block
constexpr int W_BKV = 64;                 // keys per tile
constexpr int W_STAGES = 3;
constexpr int W_THREADS = 128 * W_WG + 32;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int w_smem(int hb) {
  return hb * W_BM * 128 + W_STAGES * 2 * hb * W_BKV * 128 + 1024 + 256;
}

// Store rows [r0, r0 + rows) of a (n, hd) bf16 matrix into a swizzled tile
// of `hb` 64-column blocks, zeros past n and hd: the thread-load path, one
// warp.
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* src,
                                          int r0, int rows, int n, int hd,
                                          int hb, int lane) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = lane; i < rows * hb * 64; i += 32) {
    const int r = i / (hb * 64), c = i % (hb * 64);
    const bf16 x = (r0 + r < n && c < hd) ? src[(size_t)(r0 + r) * hd + c]
                                          : zero;
    const int blk = c / 64, cc = c % 64;
    *reinterpret_cast<bf16*>(dst + blk * rows * 128 + r * 128 +
                             (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2) = x;
  }
  hopper::fence_proxy_async();
  __syncwarp();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&v);
}

// HB = ceil(hd / 64) column blocks of 64 (1 or 2).
template <int HB>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                   int KH, int Sq, int Sk, int hd, int kv_len, int causal,
                   int window, float scale, int use_tma) {
  constexpr int Q_BYTES = HB * W_BM * 128;               // [hb][128][64]
  constexpr int KV_BYTES = HB * W_BKV * 128;             // [hb][64][64]
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + Q_BYTES;                            // [stage] KV_BYTES
  uint8_t* Vs = Ks + W_STAGES * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + W_STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + W_STAGES;
  uint64_t* empty = v_full + W_STAGES;

  const int nq = (Sq + W_BM - 1) / W_BM;
  const int q0 = (nq - 1 - blockIdx.x) * W_BM;           // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, bkh = b * KH + h / (H / KH);
  const int kv_lim = min(Sk, kv_len);
  // keys any row of this block may see: [kv_begin, kv_end)
  int kv_end = kv_lim;
  if (causal) kv_end = min(kv_end, min(Sq, q0 + W_BM));
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / W_BKV) * W_BKV;
  const int ntiles =
      kv_end > kv_begin ? (kv_end - kv_begin + W_BKV - 1) / W_BKV : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 4 * W_WG);           // one per warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * W_WG) {                               // producer
    const bf16* qp = q + (size_t)bh * Sq * hd;
    const bf16* kp = k + (size_t)bkh * Sk * hd;
    const bf16* vp = v + (size_t)bkh * Sk * hd;
    if (use_tma && lane == 0) {
      hopper::tma_prefetch_desc(&map_q);
      hopper::tma_prefetch_desc(&map_k);
      hopper::tma_prefetch_desc(&map_v);
      hopper::mbar_expect_tx(q_full, Q_BYTES);
      for (int j = 0; j < HB; ++j)
        hopper::tma_load_3d(Qs + j * W_BM * 128, &map_q, q_full, 64 * j, q0,
                            bh);
    } else if (!use_tma) {
      load_rows(Qs, qp, q0, W_BM, Sq, hd, HB, lane);
      if (lane == 0) hopper::mbar_arrive(q_full);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % W_STAGES, k0 = kv_begin + it * W_BKV;
      if (use_tma) {
        if (lane != 0) continue;
        hopper::mbar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&k_full[s], KV_BYTES);
        for (int j = 0; j < HB; ++j)
          hopper::tma_load_3d(Ks + s * KV_BYTES + j * W_BKV * 128, &map_k,
                              &k_full[s], 64 * j, k0, bkh);
        hopper::mbar_expect_tx(&v_full[s], KV_BYTES);
        for (int j = 0; j < HB; ++j)
          hopper::tma_load_3d(Vs + s * KV_BYTES + j * W_BKV * 128, &map_v,
                              &v_full[s], 64 * j, k0, bkh);
      } else {
        hopper::mbar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
        load_rows(Ks + s * KV_BYTES, kp, k0, W_BKV, Sk, hd, HB, lane);
        if (lane == 0) hopper::mbar_arrive(&k_full[s]);
        load_rows(Vs + s * KV_BYTES, vp, k0, W_BKV, Sk, hd, HB, lane);
        if (lane == 0) hopper::mbar_arrive(&v_full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows qw0 .. qw0 + 63.  Thread (warp w,
  // lane 4 g + t) holds rows qw0 + 16 w + g and + 8 of each fragment, and
  // in each 8-column block j the columns 8 j + 2 t and + 1.
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t4 = lane % 4;
  const int qw0 = q0 + wg * W_BQ;
  const int row0 = qw0 + 16 * w4 + g, row1 = row0 + 8;
  const int qw_last = min(Sq, qw0 + W_BQ) - 1;
  int kw_end = kv_lim;                                  // this warpgroup's keys
  if (causal) kw_end = min(kw_end, qw_last + 1);
  const int kw_begin = window > 0 ? qw0 - window + 1 : 0;
  const bool rows_here = qw0 < Sq;
  const uint8_t* qs = Qs + wg * W_BQ * 128;

  float acc[HB * 32];                                   // O, 64 x 64 HB
#pragma unroll
  for (int i = 0; i < HB * 32; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  hopper::mbar_wait(q_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % W_STAGES;
    const uint32_t parity = (it / W_STAGES) & 1;
    const int k0 = kv_begin + it * W_BKV;
    const bool active = rows_here && k0 < kw_end && k0 + W_BKV > kw_begin;
    hopper::mbar_wait(&k_full[s], parity);
    if (active) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      const uint8_t* ks = Ks + s * KV_BYTES;
      hopper::fence_regs<32>(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < HB; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::WgmmaSS<64, 0, 0>::run(
              sc, hopper::desc_sw128(qs + j * W_BM * 128 + 32 * kk, 16, 1024),
              hopper::desc_sw128(ks + j * W_BKV * 128 + 32 * kk, 16, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(sc);

      // scale in fp32, then mask where the tile is not wholly visible
      const bool whole = k0 + W_BKV <= kv_lim &&
                         (!causal || k0 + W_BKV - 1 <= qw0) &&
                         (window <= 0 || k0 > qw_last - window);
      uint32_t ok = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= scale;
        if (!whole) {
          const int key = k0 + 8 * (i / 4) + 2 * t4 + (i % 2);
          const int row = (i % 4) < 2 ? row0 : row1;
          bool keep = key < kv_lim;
          if (causal) keep = keep && key <= row;
          if (window > 0) keep = keep && key > row - window;
          if (!keep) {
            ok &= ~(1u << i);
            sc[i] = NEG_INF;
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if ((i % 4) < 2) mx0 = fmaxf(mx0, sc[i]);
        else mx1 = fmaxf(mx1, sc[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float a0 = exp2f((m0 - mx0) * LOG2E);
      const float a1 = exp2f((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool r1 = (i % 4) >= 2;
        const float p = ((ok >> i) & 1u)
                            ? exp2f((sc[i] - (r1 ? m1 : m0)) * LOG2E)
                            : 0.f;
        sc[i] = p;
        if (r1) sum1 += p;
        else sum0 += p;
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int i = 0; i < HB * 32; ++i) acc[i] *= (i % 4) < 2 ? a0 : a1;

      // P as bf16 hi + lo A fragments: k-slice kk (keys 16 kk ..) is
      // registers 8 kk .. 8 kk + 7 of the S fragment
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          phi[kk][r] = *reinterpret_cast<uint32_t*>(&hi);
          plo[kk][r] = pack_bf16(x - hf.x, y - hf.y);
        }

      hopper::mbar_wait(&v_full[s], parity);
      const uint8_t* vs = Vs + s * KV_BYTES;
      hopper::fence_regs<HB * 32>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = hopper::desc_sw128(vs + 2048 * kk, W_BKV * 128,
                                               1024);
        hopper::WgmmaRS<64 * HB, 1>::run(acc, phi[kk], dv, 1);
        hopper::WgmmaRS<64 * HB, 1>::run(acc, plo[kk], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HB * 32>(acc);
    } else {
      hopper::mbar_wait(&v_full[s], parity);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // l over the quad, then out = acc / l in q's dtype
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* op = o + (size_t)bh * Sq * hd;
#pragma unroll
  for (int j = 0; j < HB * 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (c >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (row >= Sq) continue;
      const float inv = r ? inv1 : inv0;
      const float x = acc[4 * j + 2 * r] * inv, y = acc[4 * j + 2 * r + 1] * inv;
      bf16* dst = op + (size_t)row * hd + c;
      if (c + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
      } else {
        dst[0] = __float2bfloat16(x);
        if (c + 1 < hd) dst[1] = __float2bfloat16(y);
      }
    }
  }
}

template <int HB>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                 int H, int KH, int Sq, int Sk, int hd, int kv_len, int causal,
                 int window, float scale, int use_tma, cudaStream_t s) {
  CUtensorMap mq{}, mk{}, mv{};
  if (use_tma &&
      (!hopper_host::make_map_3d(&mq, q, hd, Sq, (uint64_t)B * H, 64, W_BM) ||
       !hopper_host::make_map_3d(&mk, k, hd, Sk, (uint64_t)B * KH, 64, W_BKV) ||
       !hopper_host::make_map_3d(&mv, v, hd, Sk, (uint64_t)B * KH, 64, W_BKV)))
    return cudaErrorInvalidValue;
  constexpr int smem = w_smem(HB);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + W_BM - 1) / W_BM, H, B);
  flash_wgmma_kernel<HB><<<grid, W_THREADS, smem, s>>>(
      mq, mk, mv, q, k, v, o, H, KH, Sq, Sk, hd, kv_len, causal, window, scale,
      use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; use_tma
// = 1 loads by TMA and needs hd a multiple of 8 and 16-byte aligned q, k
// and v, 0 loads with the producer warp's threads); q, k, v and out of one
// dtype; hd <= 128; window <= 0 means no window.  The caller chooses;
// nothing here falls back.  Launches on `stream`, no host sync.  Returns
// cudaGetLastError() after the launch, 0 on success.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KH, int Sq, int Sk,
                           int hd, int kv_len, int causal, int window,
                           float scale, int dtype, int use_tma,
                           void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      hd <= 0 || hd > 128 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal,
                           window, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (use_tma && (hd % 8 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(v) % 16 != 0))
    return cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  if (hd <= 64)
    return launch_wgmma<1>(qb, kb, vb, ob, B, H, KH, Sq, Sk, hd, kv_len,
                           causal, window, scale, use_tma, s);
  return launch_wgmma<2>(qb, kb, vb, ob, B, H, KH, Sq, Sk, hd, kv_len, causal,
                         window, scale, use_tma, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
