// Grouped (expert) matmul out[e] = lhs[e] @ rhs[e], for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::grouped_matmul_pallas
// (body _gmm_kernel): E experts, lhs (E, M, K), rhs (E, K, N), out (E, M, N)
// in lhs's dtype, fp32 accumulation.  The Python wrapper is
// repro_torch/kernels/moe_gmm.py; it checks every operand and chooses the
// variant from the shape and the alignment alone (gmm_variant).
//
// Bound on an H100.  At the MoE prefill shapes of Jamba (16 experts, 648
// capacity rows, 4096 x 14336 and back) a call is 1.22 TFLOP, above the
// card's ridge (~295 FLOP per byte in bf16): bound by the tensor cores,
// 1.23 ms at 989 TFLOP/s.  In decode (8 capacity rows) it reads 1.88 GB of
// expert weights for a few GFLOP: bound by bytes, 0.56 ms at 3.35 TB/s.
//
// Design.  The Pallas grid (expert, row block, column block, k block) ran
// in order and carried the fp32 sum in VMEM across the k blocks.  Here a
// block owns one output tile of one expert and loops over K itself, so no
// sum crosses blocks.  Four variants:
//
//  * tma (bf16, M > 64): the prefill.  A 128 x 256 output tile per block:
//    one producer warp keeps a ring of 4 stages full by TMA (a 128 x 64
//    lhs tile, K-major, and four 64 x 64 rhs tiles, N-major, 48 KB a
//    stage, mbarrier full/empty pairs), and two consumer warpgroups each
//    issue wgmma.m64n256k16 on their 64 rows (A K-major, B transposed since
//    rhs is N-contiguous) into 128 fp32 registers a thread, one stage's
//    products in flight while the last one's finish.  Two blocks of
//    neighbouring row tiles form a cluster and share the rhs tile: each
//    loads half of it for both (TMA multicast), which halves the rhs
//    traffic from L2.  The epilogue writes the registers straight to
//    global memory, masked on ragged M and N.  The grid runs the row tiles
//    of one column tile next to each other, so the rhs column block they
//    share is read from DRAM about once.
//  * tma_swiglu (bf16, M > 64, no autograd): the expert SwiGLU's first
//    half, h = silu(lhs @ w_gate) * (lhs @ w_up), in one launch of the
//    same kernel (gmm_tma_kernel<true>).  The ring, the wgmma and the
//    multicast are tma's; only the mapping of the 256 columns changes.  A
//    block's output tile is 128 rows x 128 columns of h: each stage's
//    64 x 256 rhs tile holds w_gate columns n0 .. n0 + 127 (boxes 0, 1)
//    and w_up columns n0 .. n0 + 127 (boxes 2, 3), and block c of the
//    cluster loads operand c (its two boxes) for both blocks.  After the
//    K loop a thread's 8-column block j < 16 holds g and block j + 16 the
//    u of the same (row, column).  The epilogue rounds each to bf16, as
//    the two separate products' outputs were rounded, computes silu(g) u
//    in fp32 with torch's formula g / (1 + exp(-g)) (no fast math), and
//    rounds once to bf16: the function of the unfused chain (two tma
//    calls, F.silu(g.float()) * u.float(), back to bf16).  g and u never
//    reach device memory, where the chain wrote them, read them back and
//    moved three fp32 tensors of the same size.  The grid's y is N / 128.
//    Bound of a call: 2 x 2 E M K N FLOPs; lhs and both weights read
//    once, h written once (E M N bf16).  Above the ridge at the prefill
//    shapes, as tma: the tensor cores bound it.
//  * decode (bf16, M <= 64): "swap AB", out^T[e] = rhs[e]^T lhs[e]^T.
//    The N axis of the weights (4096 or 14336) fills wgmma's 64-row side
//    and M, rounded up to MP in {8, 16, 32, 64}, is its N.  A block streams
//    a 128-row slab of one expert's weights through a 6-stage TMA ring of
//    16 KB (+ MP x 64 of lhs) stages, so every weight byte is read once;
//    one warpgroup issues wgmma.m64nMPk16 with A transposed (the weights
//    are N-contiguous) and B K-major.
//  * ragged (bf16, rows of K or N not a multiple of 16 bytes, or an
//    operand not 16-byte aligned: TMA cannot describe it): WMMA 16x16x16
//    fragments, a 128 x 128 tile per block, single-stage staging with the
//    edges zero-filled.
//  * fp32: a plain CUDA-core tile (64 x 64, 4 x 4 per thread), so its sums
//    stay in full fp32 (the reduced Jamba on the card).
//
// TMA uses 3-D tensor maps over (E, rows, cols), so each expert's own M, K
// and N are the bounds: boxes past them are zero-filled and never read the
// next expert's rows.  The maps are encoded on the host per call with
// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint
// (hopper.cuh; no -lcuda), and passed as __grid_constant__ parameters.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// ---- bf16, tma: the prefill (warp-specialised TMA + wgmma) -----------------
constexpr int T_BM = 128, T_BN = 256, T_BK = 64, T_STAGES = 4;
constexpr int T_CONSUMERS = 2;                          // warpgroups
constexpr int T_CLUSTER = 2;                            // row tiles, one rhs
constexpr int T_THREADS = 128 * T_CONSUMERS + 32;       // + a producer warp
constexpr int T_A_BYTES = T_BM * T_BK * 2;              // 16 KB
constexpr int T_B_BYTES = T_BK * T_BN * 2;              // 32 KB, 4 blocks
constexpr int T_SMEM = T_STAGES * (T_A_BYTES + T_B_BYTES) + 1024 + 256;

// The output columns a block covers: all 256 of the product, or (SWIGLU)
// 128 of h, from 128 of w_gate and the same 128 of w_up.
template <bool SWIGLU>
__host__ __device__ constexpr int t_cols() {
  return SWIGLU ? T_BN / 2 : T_BN;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// map_c (w_up) is read only by SWIGLU.
template <bool SWIGLU>
__global__ void __cluster_dims__(T_CLUSTER, 1, 1)
__launch_bounds__(T_THREADS, 1)
gmm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c,
               bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::align1024(smem_raw);
  uint8_t* a_tiles = base;                                // [stage][128][64]
  uint8_t* b_tiles = base + T_STAGES * T_A_BYTES;         // [stage][4][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      b_tiles + T_STAGES * T_B_BYTES);
  uint64_t* empty = full + T_STAGES;
  const int m0 = blockIdx.x * T_BM, n0 = blockIdx.y * t_cols<SWIGLU>();
  const int e = blockIdx.z;
  const int ktiles = (K + T_BK - 1) / T_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = hopper::cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      // every consumer warpgroup of every block of the cluster frees a
      // stage: the rhs tile in it came from both blocks' producers
      hopper::mbar_init(&empty[s], T_CONSUMERS * T_CLUSTER);
    }
    hopper::mbar_fence_init();
  }
  hopper::cluster_sync();

  if (warp == 4 * T_CONSUMERS) {                        // producer
    if (lane == 0) {
      hopper::tma_prefetch_desc(&map_a);
      hopper::tma_prefetch_desc(&map_b);
      if constexpr (SWIGLU) hopper::tma_prefetch_desc(&map_c);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % T_STAGES;
        hopper::mbar_wait(&empty[s], ((kt / T_STAGES) & 1) ^ 1);
        // its own lhs tile, and its half of the rhs tile for both blocks
        hopper::mbar_expect_tx(&full[s], T_A_BYTES + T_B_BYTES);
        hopper::tma_load_3d(a_tiles + s * T_A_BYTES, &map_a, &full[s],
                            kt * T_BK, m0, e);
        // (SWIGLU: boxes 0, 1 of w_gate and 2, 3 of w_up at the same
        // columns; HALF == PER, so block c loads operand c)
        constexpr int HALF = T_BN / 64 / T_CLUSTER;
        constexpr int PER = t_cols<SWIGLU>() / 64;       // boxes an operand
#pragma unroll
        for (int j = rank * HALF; j < (rank + 1) * HALF; ++j)
          hopper::tma_load_3d_multicast(
              b_tiles + s * T_B_BYTES + j * (T_BK * 128),
              j < PER ? &map_b : &map_c, &full[s], n0 + 64 * (j % PER),
              kt * T_BK, e, (1u << T_CLUSTER) - 1);
      }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg .. + 63, all 256 columns.
    // It issues its products whatever M is (rows past M are zeros): a
    // branch around wgmma makes ptxas serialise them (C7518).
    const int wg = warp / 4;
    float acc[T_BN / 2];
#pragma unroll
    for (int i = 0; i < T_BN / 2; ++i) acc[i] = 0.f;
    // the products of stage kt are in flight while those of kt - 1 finish;
    // a stage is freed once its products are done (wgmma.wait_group covers
    // the whole warpgroup's product), in block c of the cluster by the
    // warpgroup's thread c
    const uint32_t signal = threadIdx.x % 128;
    hopper::fence_regs<T_BN / 2>(acc);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % T_STAGES;
      hopper::mbar_wait(&full[s], (kt / T_STAGES) & 1);
      const uint8_t* a = a_tiles + s * T_A_BYTES + wg * 64 * 128;
      const uint8_t* b = b_tiles + s * T_B_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T_BK / 16; ++kk)
        hopper::WgmmaSS<T_BN, 0, 1>::run(
            acc, hopper::desc_sw128(a + 32 * kk, 16, 1024),
            hopper::desc_sw128(b + 2048 * kk, T_BK * 128, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (signal < T_CLUSTER && kt > 0)
        hopper::mbar_arrive_cluster(&empty[(kt + T_STAGES - 1) % T_STAGES],
                                    signal);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<T_BN / 2>(acc);
    // epilogue: accumulator registers straight to global memory.  Thread
    // (warp w, lane g * 4 + t) holds, for each 8-column block j, rows
    // 16 w + g and + 8, columns 8 j + 2 t and + 1 (SWIGLU: block j < 16
    // of g, block j + 16 of u at the same row and column).
    const int w4 = warp % 4, g = lane / 4, t = lane % 4;
    const int r0 = m0 + wg * 64 + w4 * 16 + g;
    bf16* O = out + (size_t)e * M * N;
    constexpr int UP = t_cols<SWIGLU>() / 2;        // u's offset in acc
#pragma unroll
    for (int j = 0; j < t_cols<SWIGLU>() / 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;           // N % 8 == 0: c + 1 < N
      if (c >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        float v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[i] = acc[4 * j + 2 * h + i];
          if constexpr (SWIGLU) {
            const float gi = round_bf16(v[i]);
            const float ui = round_bf16(acc[UP + 4 * j + 2 * h + i]);
            v[i] = gi / (1.0f + expf(-gi)) * ui;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(&O[(size_t)r * N + c]) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
  // no block leaves while the other may still write its tiles or signal
  // its barriers
  hopper::cluster_sync();
}

// ---- bf16, decode: swap AB, the weights streamed once ----------------------
constexpr int D_BN = 128, D_BK = 64, D_STAGES = 6;
constexpr int D_THREADS = 128 + 32;
constexpr int D_W_BYTES = D_BK * D_BN * 2;              // 16 KB, 2 blocks

constexpr int d_smem(int mp) {
  return D_STAGES * (D_W_BYTES + mp * D_BK * 2) + 1024 + 256;
}

template <int MP>
__global__ void __launch_bounds__(D_THREADS)
gmm_decode_kernel(const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_x,
                  bf16* __restrict__ out, int M, int K, int N) {
  constexpr int X_BYTES = MP * D_BK * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::align1024(smem_raw);
  uint8_t* w_tiles = base;                               // [stage][2][64][64]
  uint8_t* x_tiles = base + D_STAGES * D_W_BYTES;        // [stage][MP][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_tiles + D_STAGES * X_BYTES);
  uint64_t* empty = full + D_STAGES;
  const int n0 = blockIdx.x * D_BN, e = blockIdx.y;
  const int ktiles = (K + D_BK - 1) / D_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                                      // producer
    if (lane == 0) {
      hopper::tma_prefetch_desc(&map_w);
      hopper::tma_prefetch_desc(&map_x);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % D_STAGES;
        hopper::mbar_wait(&empty[s], ((kt / D_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], D_W_BYTES + X_BYTES);
#pragma unroll
        for (int j = 0; j < D_BN / 64; ++j)
          hopper::tma_load_3d(w_tiles + s * D_W_BYTES + j * (D_BK * 128),
                              &map_w, &full[s], n0 + 64 * j, kt * D_BK, e);
        hopper::tma_load_3d(x_tiles + s * X_BYTES, &map_x, &full[s],
                            kt * D_BK, 0, e);
      }
    }
    return;
  }

  // one consumer warpgroup: out^T rows n0 .. n0 + 127 as two m64 halves
  float acc[2][MP / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < MP / 2; ++i) acc[h][i] = 0.f;
  hopper::fence_regs<MP / 2>(acc[0]);
  hopper::fence_regs<MP / 2>(acc[1]);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % D_STAGES;
    hopper::mbar_wait(&full[s], (kt / D_STAGES) & 1);
    const uint8_t* w = w_tiles + s * D_W_BYTES;
    const uint8_t* x = x_tiles + s * X_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D_BK / 16; ++kk) {
      const uint64_t bx = hopper::desc_sw128(x + 32 * kk, 16, 1024);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hopper::WgmmaSS<MP, 1, 0>::run(
            acc[h],
            hopper::desc_sw128(w + h * (D_BK * 128) + 2048 * kk, D_BK * 128,
                               1024),
            bx, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                 // stage kt - 1's products done
    if (threadIdx.x == 0 && kt > 0)
      hopper::mbar_arrive(&empty[(kt + D_STAGES - 1) % D_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<MP / 2>(acc[0]);
  hopper::fence_regs<MP / 2>(acc[1]);
  // epilogue: acc[h] is out^T rows (weight columns) n0 + 64 h + 16 w + g
  // and + 8, columns (lhs rows) 8 j + 2 t and + 1.
  const int g = lane / 4, t = lane % 4;
  bf16* O = out + (size_t)e * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + 64 * h + 16 * warp + g + 8 * (i / 2);
        const int m = 8 * j + 2 * t + (i % 2);
        if (n < N && m < M)
          O[(size_t)m * N + n] = __float2bfloat16(acc[h][4 * j + i]);
      }
}

// ---- bf16, ragged: WMMA on the tensor cores ---------------------------------
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

template <int MP>
int launch_decode(const bf16* lhs, const bf16* rhs, bf16* out, int E, int M,
                  int K, int N, cudaStream_t s) {
  CUtensorMap map_w, map_x;
  if (!hopper_host::make_map_3d(&map_w, rhs, N, K, E, 64, D_BK) ||
      !hopper_host::make_map_3d(&map_x, lhs, K, M, E, D_BK, MP))
    return cudaErrorInvalidValue;
  constexpr int smem = d_smem(MP);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_decode_kernel<MP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + D_BN - 1) / D_BN, E);
  gmm_decode_kernel<MP><<<grid, D_THREADS, smem, s>>>(map_w, map_x, out, M, K,
                                                      N);
  return static_cast<int>(cudaGetLastError());
}

// SWIGLU: rhs is w_gate and rhs_up w_up (else rhs_up is not read).
template <bool SWIGLU>
int launch_tma(const bf16* lhs, const bf16* rhs, const bf16* rhs_up,
               bf16* out, int E, int M, int K, int N, cudaStream_t s) {
  constexpr int cols = t_cols<SWIGLU>();
  if ((N + cols - 1) / cols > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!hopper_host::make_map_3d(&map_a, lhs, K, M, E, T_BK, T_BM) ||
      !hopper_host::make_map_3d(&map_b, rhs, N, K, E, 64, T_BK))
    return cudaErrorInvalidValue;
  CUtensorMap map_c = map_b;                  // read only by SWIGLU
  if (SWIGLU && !hopper_host::make_map_3d(&map_c, rhs_up, N, K, E, 64, T_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tma_kernel<SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles in whole clusters: a tile past M computes nothing but loads
  // its share of the rhs tile for the other block
  const int mtiles = (M + T_BM - 1) / T_BM;
  dim3 grid((mtiles + T_CLUSTER - 1) / T_CLUSTER * T_CLUSTER,
            (N + cols - 1) / cols, E);
  gmm_tma_kernel<SWIGLU><<<grid, T_THREADS, T_SMEM, s>>>(map_a, map_b, map_c,
                                                         out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs, rhs_up and out alike).  For
// bf16, variant: 0 = ragged (WMMA), 1 = tma (M > 64), 2 = decode with
// MP = mp (8, 16, 32 or 64, at least M), 3 = tma_swiglu: out =
// silu(lhs @ rhs) * (lhs @ rhs_up), rhs_up of rhs's shape (no other
// variant reads rhs_up); tma, decode and tma_swiglu need K and N
// multiples of 8 and 16-byte aligned operands.  The caller chooses;
// nothing here falls back to another variant.  Launches on `stream`, no
// host sync.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype, variant or size it does not take),
// 0 on success.
int moe_gmm_launch(const void* lhs, const void* rhs, const void* rhs_up,
                   void* out, int E, int M, int K, int N, int dtype,
                   int variant, int mp, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((M + FBM - 1) / FBM > 65535 || E > 65535) return cudaErrorInvalidValue;
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM, E);
    gmm_f32_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bf16* a = static_cast<const bf16*>(lhs);
  const bf16* b = static_cast<const bf16*>(rhs);
  bf16* o = static_cast<bf16*>(out);
  if (variant == 0) {
    if ((M + BM - 1) / BM > 65535 || E > 65535) return cudaErrorInvalidValue;
    const int a_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(lhs) % 16 == 0);
    const int b_vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(rhs) % 16 == 0);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
    gmm_bf16_kernel<<<grid, THREADS, 0, s>>>(a, b, o, M, K, N, a_vec, b_vec);
    return static_cast<int>(cudaGetLastError());
  }
  const bool tma_ok = K % 8 == 0 && N % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(lhs) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(rhs) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      E <= 65535;
  if (!tma_ok) return cudaErrorInvalidValue;
  if (variant == 1) return launch_tma<false>(a, b, nullptr, o, E, M, K, N, s);
  if (variant == 3) {
    if (rhs_up == nullptr || reinterpret_cast<uintptr_t>(rhs_up) % 16 != 0)
      return cudaErrorInvalidValue;
    return launch_tma<true>(a, b, static_cast<const bf16*>(rhs_up), o, E, M,
                            K, N, s);
  }
  if (variant == 2 && M <= mp) {
    switch (mp) {
      case 8: return launch_decode<8>(a, b, o, E, M, K, N, s);
      case 16: return launch_decode<16>(a, b, o, E, M, K, N, s);
      case 32: return launch_decode<32>(a, b, o, E, M, K, N, s);
      case 64: return launch_decode<64>(a, b, o, E, M, K, N, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
