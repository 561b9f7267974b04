// Grouped (expert) matmul out[e] = lhs[e] @ rhs[e], for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::grouped_matmul_pallas
// (body _gmm_kernel): E experts, lhs (E, M, K), rhs (E, K, N), out (E, M, N)
// in lhs's dtype, fp32 accumulation.  The Python wrapper is
// repro_torch/kernels/moe_gmm.py; it checks every operand.
//
// Bound on an H100.  At the MoE prefill shapes of Jamba (16 experts, 648
// capacity rows, 4096 x 14336) a call is 1.22 TFLOP, above the card's
// ridge (~295 FLOP per byte in bf16): bound by the tensor cores.  In
// decode (8 capacity rows) it reads 1.88 GB of expert weights for a few
// GFLOP: bound by bytes.
//
// Design.  The Pallas grid (expert, row block, column block, k block) ran
// in order and carried the fp32 sum in VMEM across the k blocks.  Here one
// block owns a 128 x 128 output tile of one expert and loops over K itself,
// so no sum crosses blocks.  bf16 goes through the tensor cores with WMMA
// (16x16x16 fragments, fp32 accumulators): 8 warps, each a 64 x 32 tile.
// fp32 is a plain CUDA-core tile (64 x 64, 4 x 4 per thread), so its sums
// stay in full fp32.  Ragged M, N and K edges are masked while the tiles
// are staged in shared memory (zeros), so the wrapper pads nothing; the
// padding rows of capacity buffers multiply zeros as in the reference.
// Single-stage staging, no cp.async, wgmma or TMA yet: later work.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ---- bf16: WMMA on the tensor cores ----------------------------------------
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 per warp
constexpr int FM = WM / 16, FN = WN / 16;            // 4 x 2 fragments
constexpr int LDA = BK + 8;                          // ldm: multiple of 8
constexpr int LDB = BN + 8;

__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
                bf16* __restrict__ out, int M, int K, int N, int a_vec,
                int b_vec) {
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[THREADS / 32][16 * 16];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* A = lhs + (size_t)e * M * K;
  const bf16* B = rhs + (size_t)e * K * N;
  bf16* O = out + (size_t)e * M * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {     // lhs tile
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + col;
      bf16* dst = &As[r * LDA + col];
      if (a_vec && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&A[(size_t)gm * K + gk]);
      } else {
        for (int i = 0; i < 8; ++i)
          dst[i] = (gm < M && gk + i < K) ? A[(size_t)gm * K + gk + i] : zero;
      }
    }
    for (int c = tid; c < BK * BN / 8; c += THREADS) {     // rhs tile
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + col;
      bf16* dst = &Bs[r * LDB + col];
      if (b_vec && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&B[(size_t)gk * N + gn]);
      } else {
        for (int i = 0; i < 8; ++i)
          dst[i] = (gk < K && gn + i < N) ? B[(size_t)gk * N + gn + i] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * WM + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[kk * LDB + wn * WN + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: each fragment through the warp's 16 x 16 scratch, masked
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 256; t += 32) {
        const int gm = m0 + wm * WM + i * 16 + t / 16;
        const int gn = n0 + wn * WN + j * 16 + t % 16;
        if (gm < M && gn < N)
          O[(size_t)gm * N + gn] = __float2bfloat16(Cs[warp][t]);
      }
      __syncwarp();
    }
}

// ---- fp32: CUDA cores, full fp32 sums --------------------------------------
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               float* __restrict__ out, int M, int K, int N) {
  __shared__ float As[FBK][FBM + 4];     // transposed: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const float* A = lhs + (size_t)e * M * K;
  const float* B = rhs + (size_t)e * K * N;
  float* O = out + (size_t)e * M * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int c = tid; c < FBM * FBK; c += FTHREADS) {
      const int m = c / FBK, k = c % FBK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int c = tid; c < FBK * FBN; c += FTHREADS) {
      const int k = c / FBN, n = c % FBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) O[(size_t)gm * N + gn] = acc[i][j];
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out alike).  Launches on
// `stream`, no host sync.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype or size it does not take), 0 on
// success.
int moe_gmm_launch(const void* lhs, const void* rhs, void* out, int E, int M,
                   int K, int N, int dtype, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if ((M + BM - 1) / BM > 65535 || E > 65535) return cudaErrorInvalidValue;
    const int a_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(lhs) % 16 == 0);
    const int b_vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(rhs) % 16 == 0);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
    gmm_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
        static_cast<bf16*>(out), M, K, N, a_vec, b_vec);
  } else if (dtype == 0) {
    if ((M + FBM - 1) / FBM > 65535 || E > 65535) return cudaErrorInvalidValue;
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, E);
    gmm_f32_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        static_cast<float*>(out), M, K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
