// Mamba-2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  Per (batch, head), with state h (N, P):
//     h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T,   y_t = C_t^T h_t.
// x (b, h, S, P), dt (b, h, S), B/C (b, g, S, N) in one dtype (fp32 or
// bf16), A (h,) fp32; y like x.  Head hh reads group hh / (h / g).  The
// Python wrapper is repro_torch/kernels/ssd_scan.py; it checks every
// operand.
//
// Bound on an H100.  At Jamba's widths (128 heads of P = 64, N = 16, 4096
// tokens, bf16) a call reads x, dt, B, C and writes y, ~135 MB, against
// ~11 GFLOP of chunked work: bound by bytes, ~40 us.
//
// Design.  The chunk recurrence is sequential, as the Pallas grid's
// innermost chunk dimension was.  So one block owns one (batch, head) and
// loops over the chunks itself, with the fp32 (N, P) state in shared
// memory; 128 blocks at Jamba's widths.  A chunk of Q <= 256 steps is
// staged in shared memory (dt * x, B, C, the log-decay prefix sum) and
// thread i computes output row i:
//     y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) (dt_j x_j)     (intra)
//         + exp(cum_i) C_i^T h                                         (inter)
// then the block updates the state:
//     h = exp(cum_Q) h + sum_i exp(cum_Q - cum_i) B_i (dt_i x_i)^T.
// The decay is only ever taken of cum_i - cum_j with j <= i (never of a
// masked, positive exponent).  Steps past S are dt = 0 (exact: they decay
// nothing and add nothing) and are not written, so the wrapper pads
// nothing.  All arithmetic is fp32 on the CUDA cores; one block per head
// leaves 4 SMs idle and runs the intra-chunk sum at ~1/Q of the block's
// threads' peak when rows are short: right first, fast later.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;          // = the largest chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_floats(int Q, int P, int N) {
  return (size_t)Q * P + (size_t)Q * N + (size_t)Q * (N + 1) + 2 * (size_t)Q +
         (size_t)N * P + 32;
}

// Inclusive prefix sum of cum[0..Q) in place (Q <= blockDim.x = THREADS).
__device__ void block_scan(float* cum, int Q, float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  float v = tid < Q ? cum[tid] : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    float t = lane < THREADS / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += u;
    }
    if (lane < THREADS / 32) wsum[lane] = t;
  }
  __syncthreads();
  if (w > 0) v += wsum[w - 1];
  if (tid < Q) cum[tid] = v;
  __syncthreads();
}

// PM >= P: output columns a thread keeps in registers.
template <typename T, int PM>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ A, T* __restrict__ y, int H, int G,
                int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* xs = smem;                  // Q x P: dt_i * x_i
  float* Bs = xs + Q * P;            // Q x N
  float* Cs = Bs + Q * N;            // Q x (N + 1): thread i reads row i
  float* cum = Cs + Q * (N + 1);     // Q: inclusive prefix of dt * A
  float* dout = cum + Q;             // Q: exp(cum_Q - cum_i)
  float* st = dout + Q;              // N x P: the carried state
  float* wsum = st + N * P;          // 32: scan partials
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int gg = hh / (H / G);
  const float a = A[hh];
  const T* xp = x + (size_t)(bb * H + hh) * S * P;
  const T* dtp = dt + (size_t)(bb * H + hh) * S;
  const T* Bp = Bm + (size_t)(bb * G + gg) * S * N;
  const T* Cp = Cm + (size_t)(bb * G + gg) * S * N;
  T* yp = y + (size_t)(bb * H + hh) * S * P;
  const int tid = threadIdx.x;

  for (int e = tid; e < N * P; e += THREADS) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                 // the previous chunk is fully read
    for (int i = tid; i < Q; i += THREADS)
      cum[i] = (c0 + i < S ? to_f(dtp[c0 + i]) : 0.f) * a;
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P, t = c0 + i;
      xs[e] = t < S ? to_f(xp[(size_t)t * P + p]) * to_f(dtp[t]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N, t = c0 + i;
      const bool in = t < S;
      Bs[e] = in ? to_f(Bp[(size_t)t * N + n]) : 0.f;
      Cs[i * (N + 1) + n] = in ? to_f(Cp[(size_t)t * N + n]) : 0.f;
    }
    __syncthreads();
    block_scan(cum, Q, wsum);

    const int i = tid;
    if (i < Q && c0 + i < S) {
      float acc[PM];
#pragma unroll
      for (int p = 0; p < PM; ++p) acc[p] = 0.f;
      const float ci = cum[i];
      const float* crow = Cs + i * (N + 1);
      for (int j = 0; j <= i; ++j) {                      // intra-chunk
        const float* brow = Bs + j * N;
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(crow[n], brow[n], cb);
        const float w = cb * expf(ci - cum[j]);
        const float* xr = xs + j * P;
#pragma unroll
        for (int p = 0; p < PM; ++p)
          if (p < P) acc[p] = fmaf(w, xr[p], acc[p]);
      }
      const float ei = expf(ci);                          // inter-chunk
      for (int n = 0; n < N; ++n) {
        const float cn = crow[n] * ei;
        const float* sr = st + n * P;
#pragma unroll
        for (int p = 0; p < PM; ++p)
          if (p < P) acc[p] = fmaf(cn, sr[p], acc[p]);
      }
      T* yr = yp + (size_t)(c0 + i) * P;
#pragma unroll
      for (int p = 0; p < PM; ++p)
        if (p < P) yr[p] = from_f<T>(acc[p]);
    }
    const float total = cum[Q - 1];
    for (int j = tid; j < Q; j += THREADS) dout[j] = expf(total - cum[j]);
    __syncthreads();                 // every row has read the old state
    const float decay = expf(total);
    for (int e = tid; e < N * P; e += THREADS) {
      const int n = e / P, p = e % P;
      float s = 0.f;
      for (int j = 0; j < Q; ++j)
        s = fmaf(Bs[j * N + n] * dout[j], xs[j * P + p], s);
      st[e] = decay * st[e] + s;
    }
  }
}

template <typename T, int PM>
int launch(const void* x, const void* dt, const void* B, const void* C,
           const float* A, void* y, int b, int H, int G, int S, int P, int N,
           int Q, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, b);
  ssd_scan_kernel<T, PM><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C), A,
      static_cast<T*>(y), H, G, S, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* B, const void* C,
             const float* A, void* y, int b, int H, int G, int S, int P,
             int N, int Q, cudaStream_t s) {
  if (P <= 16) return launch<T, 16>(x, dt, B, C, A, y, b, H, G, S, P, N, Q, s);
  if (P <= 32) return launch<T, 32>(x, dt, B, C, A, y, b, H, G, S, P, N, Q, s);
  if (P <= 64) return launch<T, 64>(x, dt, B, C, A, y, b, H, G, S, P, N, Q, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y alike; A is fp32).
// P <= 64, chunk Q <= 256, shared memory (Q (P + 2N + 3) + N P + 32 floats)
// <= 227 KB.  Launches on `stream`, no host sync.  Returns
// cudaGetLastError() after the launch, 0 on success.
int ssd_scan_launch(const void* x, const void* dt, const void* B,
                    const void* C, const float* A, void* y, int b, int H,
                    int G, int S, int P, int N, int Q, int dtype,
                    void* stream) {
  if (b <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || P <= 0 ||
      N <= 0 || Q <= 0 || Q > THREADS || b > 65535 ||
      sizeof(float) * smem_floats(Q, P, N) > 232448)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, B, C, A, y, b, H, G, S, P, N, Q, s);
  if (dtype == 1)
    return dispatch<bf16>(x, dt, B, C, A, y, b, H, G, S, P, N, Q, s);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
