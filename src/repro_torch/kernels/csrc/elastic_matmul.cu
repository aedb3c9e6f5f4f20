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
// accumulators); fp32 inputs use an FMA micro-tile (the tile loop lives in
// tile_matmul.cuh, shared with K3).  Dead tiles (n0 >= n_act) write zeros
// and exit without loading; the K loop stops at cdiv(k_act, BK) and masks
// its last tile.  wgmma/TMA pipelining is later work.
#include "tile_matmul.cuh"

using namespace repro_tile;

namespace {

__global__ void __launch_bounds__(THREADS)
elastic_matmul_bf16(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y,
                    const int* __restrict__ widths, int M, int ldx, int ldw,
                    int ldy, int n_out) {
  const int k_act = widths[0];
  const int n_act = widths[1];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  if (n0 >= n_act) {
    store_zero_tile(y, m0, n0, M, ldy, n_out);
    return;
  }
  tile_bf16(x, ldx, w, ldw, y, ldy, m0, n0, M, M, k_act, n_act, n_out);
}

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
  tile_f32(x, ldx, w, ldw, y, ldy, m0, n0, M, M, k_act, n_act, n_out);
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
