// Flash attention forward (online softmax), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  q (B, H, Sq, hd), k/v (B, KH, Sk, hd), out like q,
// in q's dtype (fp32 or bf16); query head h reads KV head h / (H / KH), as
// the Pallas index map does, so KV is never repeated in memory.  Masks:
// causal (key <= query), sliding window (key > query - window), and the
// kv_len tail (key < kv_len).  The Python wrapper is
// repro_torch/kernels/flash_attention.py; it checks every operand.
//
// Bound on an H100.  Jamba's prefill (1 x 4096 tokens, 32 query heads of
// 128, causal) is ~137 GFLOP against ~50 MB of q, k, v and out: bound by
// operations, ~0.14 ms at the bf16 tensor-core peak.
//
// Design.  The Pallas grid ran the KV blocks of a query block in order and
// carried m, l and acc in VMEM.  Blocks here run in parallel, so one block
// owns one (batch, head, 32-row query tile) and loops over the KV tiles
// itself, with m, l and acc in registers: 8 warps, 4 query rows each; in a
// tile of 32 keys lane j scores key j, the warp reduces the row max and
// sum with shuffles, and each lane accumulates hd / 32 output columns.
// Tiles wholly above the diagonal (and, with a window, wholly before it)
// are never loaded.  Masked scores are -1e30, not -inf, so exp(m_prev -
// m_cur) stays finite; l is floored at 1e-30.  The scale is the caller's
// (the unpadded head_dim's).  All arithmetic is fp32 on the CUDA cores,
// whatever the input type: right first.  Tensor cores (mma.sync, then
// wgmma with TMA) are the next step and the reason this kernel is ~40x
// above its bound.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int ROWS = 4;               // query rows per warp
constexpr int BQ = WARPS * ROWS;      // query rows per block
constexpr int BKV = 32;               // keys per tile (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike); hd <= 128;
// window <= 0 means no window.  Launches on `stream`, no host sync.
// Returns cudaGetLastError() after the launch, 0 on success.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KH, int Sq, int Sk,
                           int hd, int kv_len, int causal, int window,
                           float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0 ||
      hd <= 0 || hd > 128 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, o, B, H, KH, Sq, Sk, hd, kv_len, causal,
                          window, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
