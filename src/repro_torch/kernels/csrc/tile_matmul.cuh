// One 64x64 output tile of a masked matrix product: the tile loop of K3
// (expert_matmul.cu) and of K1's tile variant (elastic_matmul.cu), which
// takes the K1 calls that neither small_m nor the TMA GEMM takes -- fp32
// at M > 16 and bf16 whose bases or row strides TMA cannot read.
//
//     y[m, n] = sum_{k < k_len} x[m, k] * w[k, n]  for m < m_valid, n < n_valid
//     y[m, n] = 0                                  for m_valid <= m < m_out or
//                                                      n_valid <= n < n_out
//
// x and w are row-major with unit inner stride and row strides ldx / ldw;
// y is written for rows < m_out and columns < n_out with row stride ldy.
// Rows past m_valid and columns past n_valid are never read; their
// outputs are exact zeros.  Accumulation is fp32.  bf16 runs on the tensor
// cores through WMMA (mma.sync) with fp32 accumulators: 128 threads, each
// warp one 32x32 quadrant, K in steps of 32 staged through shared memory.
// fp32 runs on FMAs: 256 threads, each a 4x4 micro-tile, K in steps of 16.
// No pipelining: a wgmma/TMA loop for K3 is the next redesign.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace repro_tile {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;        // bf16: 4 warps, 2x2 over the tile
constexpr int A_LD = BK + 8;        // bf16 elements (wmma: multiple of 8)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;        // floats (wmma: multiple of 4)
constexpr int F_THREADS = 256;      // fp32: 16x16 threads, 4x4 each
constexpr int F_BK = 16;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A tile with nothing live: exact zeros in bounds, no loads, no math.
template <typename T>
__device__ __forceinline__ void store_zero_tile(T* y, int m0, int n0,
                                                int m_out, int ldy,
                                                int n_out) {
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = m0 + i / BN, c = n0 + i % BN;
    if (r < m_out && c < n_out) y[(size_t)r * ldy + c] = from_float<T>(0.f);
  }
}

__device__ __forceinline__ void tile_bf16(
    const __nv_bfloat16* __restrict__ x, int ldx,
    const __nv_bfloat16* __restrict__ w, int ldw,
    __nv_bfloat16* __restrict__ y, int ldy, int m0, int n0, int m_valid,
    int m_out, int k_len, int n_valid, int n_out) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;   // this warp's 32x32 quadrant
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int n_k = (k_len + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * A_LD + c] =
          (gm < m_valid && gk < k_len) ? x[(size_t)gm * ldx + gk] : zero;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * B_LD + c] =
          (gk < k_len && gn < n_valid) ? w[(size_t)gk * ldw + gn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < m_out && gn < n_out)
      y[(size_t)gm * ldy + gn] = __float2bfloat16(
          (gm < m_valid && gn < n_valid) ? Cs[r * C_LD + c] : 0.f);
  }
}

__device__ __forceinline__ void tile_f32(
    const float* __restrict__ x, int ldx, const float* __restrict__ w,
    int ldw, float* __restrict__ y, int ldy, int m0, int n0, int m_valid,
    int m_out, int k_len, int n_valid, int n_out) {
  __shared__ float As[F_BK][BM + 4];   // transposed: As[k][m]
  __shared__ float Bs[F_BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k = (k_len + F_BK - 1) / F_BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * F_BK;
    for (int i = tid; i < BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < m_valid && gk < k_len) ? x[(size_t)gm * ldx + gk]
                                              : 0.f;
    }
    for (int i = tid; i < F_BK * BN; i += F_THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < k_len && gn < n_valid) ? w[(size_t)gk * ldw + gn]
                                              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < m_out && gn < n_out)
        y[(size_t)gm * ldy + gn] =
            (gm < m_valid && gn < n_valid) ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace repro_tile
