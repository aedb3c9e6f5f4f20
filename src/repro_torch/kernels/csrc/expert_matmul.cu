// Expert-gated grouped matmul for Hopper (sm_90a): the MoE FFN hot path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/expert_matmul.py:
// expert_matmul (body _kernel).  For every expert e
//     out[e, c] = x[e, c] @ w[e]   for c < counts[e],
//     out[e, c] = 0                for counts[e] <= c < C,
// accumulating in fp32, for bf16 or fp32 x and w (out in x's dtype).
// x is (E, C, K) and w (E, K, F), each read through its expert and row
// strides with a unit inner stride, so the elastic expert width (w[..., :a_ff]
// of the up/gate weights, wo[:, :a_ff] of the down weight) and the elastic
// expert count (the first a_experts experts) are read in place from the
// full resident weights.  counts is a device int32[E], the counterpart of
// the TPU kernel's scalar prefetch: one launch configuration serves every
// load and every elastic setting, with no host sync.
//
// Grid (F tiles, C tiles, E).  A block whose first row is at or past
// counts[e] writes its zero tile and returns: it reads neither x nor w.
// The TPU docstring promises that skip for the weights, but its w_map is
// a no-op (fault F2 in ROADMAP.md); here an expert with no tokens costs no
// weight bytes at all.  A live block runs the shared 64x64 tile loop of
// tile_matmul.cuh over K in steps (the TPU kernel takes all of d as one
// block, which cannot fit a Hopper SM at d = 2048), zeroes its rows past
// counts[e] and masks F edges that are not a multiple of 64 (a_ff = 1056
// or 704 of 1408).
//
// What bounds it on the H100: at decode (4 sequences x top-6 = at most 24
// live slots over 64 experts, C = 4) it is the bytes of the live experts'
// weights, 2*K*F bytes each, against 2*count*K*F operations: intensity of
// about one operation per byte, far below the ridge, so the design's job
// is to read no dead expert's weights.  At prefill of 4 x 512 tokens the
// slab has C = 240 rows per expert (8 groups x 30 capacity slots); a
// balanced router fills 192 of them (2048 tokens x top-6 / 64 experts),
// a skewed one fewer on most experts, since capacity drops the slots an
// expert cannot seat (PERF.md gives the drop rate of the random-weight
// model).  So a weight byte carries at most ~190 operations, below the
// bf16 ridge of ~295: the bound is again the weights' bytes, and
// operations take over only from ~300 live rows per expert (larger
// batches).  Each C tile of a live expert reads its weights once more.  This first version
// runs bf16 on WMMA (mma.sync, fp32 accumulators) without a load pipeline
// and fp32 on FMAs; wgmma/TMA is later work.
#include "tile_matmul.cuh"

using namespace repro_tile;

namespace {

__global__ void __launch_bounds__(THREADS)
expert_matmul_bf16(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ y,
                   const int* __restrict__ counts, int C, int K, int F,
                   long long x_se, int x_sc, long long w_se, int w_sk) {
  const int e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), C);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  __nv_bfloat16* ye = y + (size_t)e * C * F;
  if (m0 >= cnt) {
    store_zero_tile(ye, m0, n0, C, F, F);
    return;
  }
  tile_bf16(x + e * x_se, x_sc, w + e * w_se, w_sk, ye, F, m0, n0, cnt, C, K,
            F, F);
}

__global__ void __launch_bounds__(F_THREADS)
expert_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, const int* __restrict__ counts,
                  int C, int K, int F, long long x_se, int x_sc,
                  long long w_se, int w_sk) {
  const int e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), C);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float* ye = y + (size_t)e * C * F;
  if (m0 >= cnt) {
    store_zero_tile(ye, m0, n0, C, F, F);
    return;
  }
  tile_f32(x + e * x_se, x_sc, w + e * w_se, w_sk, ye, F, m0, n0, cnt, C, K,
           F, F);
}

}  // namespace

// x (E, C, K) with strides (x_se, x_sc, 1); w (E, K, F) with strides
// (w_se, w_sk, 1); y (E, C, F) contiguous; counts int32[E] on the device.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); -1 for an unsupported dtype.
extern "C" int repro_expert_matmul(const void* x, const void* w, void* y,
                                   const void* counts, int E, int C, int K,
                                   int F, long long x_se, int x_sc,
                                   long long w_se, int w_sk, int dtype,
                                   void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  if (dtype == 1) {
    expert_matmul_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), cn, C, K, F, x_se, x_sc, w_se, w_sk);
  } else if (dtype == 0) {
    expert_matmul_f32<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), cn, C, K, F, x_se, x_sc, w_se, w_sk);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
