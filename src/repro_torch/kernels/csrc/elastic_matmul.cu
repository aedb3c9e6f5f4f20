// Width-elastic matmul for Hopper (sm_90a): the paper's hot spot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/elastic_matmul.py:
// elastic_matmul (body _kernel).  Computes
//     y[m, n] = sum_{k < k_act} x[m, k] * w[k, n]   for n < n_act,
//     y[m, n] = 0                                   for n_act <= n < n_out,
// accumulating in fp32, for bf16 or fp32 x and w (y in x's dtype).
//
// (k_act, n_act) are read from a device int32[2] -- the counterpart of the
// TPU kernel's scalar prefetch -- so one launch configuration serves every
// sub-network width.  The weight is the FULL resident parameter: the
// kernel reads its active block through the row stride ldw, so no call
// copies w[:k_act, :n_act] (resident weights are the Dynamic-OFA point).
// In sliced mode the caller passes n_out == n_act and x of width k_act; in
// the TPU op's shape it passes n_out == N and gets exact zeros past n_act.
//
// What bounds it on the H100: at the serving shapes (M = bucket x 197 rows,
// K, N <= 1536) a bf16 product does 2*M*K*N operations on 2*(M*K + K*N +
// M*N) bytes, which stays below the card's bf16 ridge point (data-sheet
// peak FLOP/s over HBM bytes/s) even at the largest bucket: the bound is
// bytes, and at small buckets the launch itself dominates.  This
// first version stages 64x64 output tiles through shared memory and runs
// the bf16 product on the tensor cores with WMMA (mma.sync, fp32
// accumulators); fp32 inputs use an FMA micro-tile.  Dead tiles (n0 >=
// n_act) write zeros and exit without loading; the K loop stops at
// cdiv(k_act, BK) and masks its last tile.  wgmma/TMA pipelining is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;        // 4 warps, 2x2 over the 64x64 tile
constexpr int A_LD = BK + 8;        // bf16 elements (wmma: multiple of 8)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;        // floats (wmma: multiple of 4)

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A tile past n_act: exact zeros, no loads, no math.
template <typename T>
__device__ __forceinline__ void store_zero_tile(T* y, int m0, int n0, int M,
                                                int ldy, int n_out) {
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = m0 + i / BN, c = n0 + i % BN;
    if (r < M && c < n_out) y[(size_t)r * ldy + c] = from_float<T>(0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
elastic_matmul_bf16(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y,
                    const int* __restrict__ widths, int M, int ldx, int ldw,
                    int ldy, int n_out) {
  using namespace nvcuda;
  const int k_act = widths[0];
  const int n_act = widths[1];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (n0 >= n_act) {
    store_zero_tile(y, m0, n0, M, ldy, n_out);
    return;
  }
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
  const int n_k = (k_act + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * A_LD + c] =
          (gm < M && gk < k_act) ? x[(size_t)gm * ldx + gk] : zero;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * B_LD + c] =
          (gk < k_act && gn < n_act) ? w[(size_t)gk * ldw + gn] : zero;
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
    if (gm < M && gn < n_out)
      y[(size_t)gm * ldy + gn] =
          __float2bfloat16(gn < n_act ? Cs[r * C_LD + c] : 0.f);
  }
}

// fp32: 256 threads, each owns a 4x4 micro-tile of the 64x64 output tile.
constexpr int F_THREADS = 256;
constexpr int F_BK = 16;

__global__ void __launch_bounds__(F_THREADS)
elastic_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, const int* __restrict__ widths,
                   int M, int ldx, int ldw, int ldy, int n_out) {
  const int k_act = widths[0];
  const int n_act = widths[1];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (n0 >= n_act) {
    store_zero_tile(y, m0, n0, M, ldy, n_out);
    return;
  }
  __shared__ float As[F_BK][BM + 4];   // transposed: As[k][m]
  __shared__ float Bs[F_BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k = (k_act + F_BK - 1) / F_BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * F_BK;
    for (int i = tid; i < BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_act) ? x[(size_t)gm * ldx + gk] : 0.f;
    }
    for (int i = tid; i < F_BK * BN; i += F_THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < k_act && gn < n_act) ? w[(size_t)gk * ldw + gn] : 0.f;
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
      if (gm < M && gn < n_out)
        y[(size_t)gm * ldy + gn] = gn < n_act ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); -1 for an unsupported dtype.
extern "C" int repro_elastic_matmul(const void* x, const void* w, void* y,
                                    const void* widths, int M, int ldx,
                                    int ldw, int ldy, int n_out, int dtype,
                                    void* stream) {
  const dim3 grid((n_out + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wd = static_cast<const int*>(widths);
  if (dtype == 1) {
    elastic_matmul_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), wd, M, ldx, ldw, ldy, n_out);
  } else if (dtype == 0) {
    elastic_matmul_f32<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), wd, M, ldx, ldw, ldy, n_out);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
