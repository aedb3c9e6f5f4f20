// Width-elastic matmul for Hopper (sm_90a): the paper's hot spot.
//
// Replaces the Pallas TPU kernel src/repro/kernels/elastic_matmul.py:
// elastic_matmul (body _kernel).  Computes
//     y[m, n] = sum_{k < k_act} x[m, k] * w[k, n]   for n < n_act,
//     y[m, n] = 0                                   for n_act <= n < n_out,
// accumulating in fp32, for bf16 or fp32 x and w (y in x's dtype).
//
// (k_act, n_act) are read from a device int32[2] -- the counterpart of the
// TPU kernel's scalar prefetch.  The weight is the FULL resident parameter:
// every variant reads its active block through the row stride ldw, so no
// call copies w[:k_act, :n_act] (resident weights are the Dynamic-OFA
// point).  In sliced mode the caller passes n_out == n_act and x of width
// k_act; in the TPU op's shape it passes n_out == N, x wider than k_act,
// and gets exact zeros past n_act.
//
// Three variants, chosen on the host by kernels/elastic_matmul.py:
// choose_variant from (M, k_act, n_act, dtype, strides):
//
// * small_m (M <= 16, bf16 and fp32: LM decode at M = 4, the ViT head at
//   M = bucket, the fp32 MoE router at decode).  Bound: the bytes of w --
//   2*M operations per weight element, far below the ridge point of ~295
//   operations a byte.  The old 64x64 tile gave a 2048-wide output 32
//   blocks on 132 SMs, 60 dead rows each, and read w one scalar at a time.
//   This kernel stages x[:, k-chunk] in shared memory (fp32), streams w
//   with 16-byte loads (8 threads on a 128-byte row segment, 32 rows a
//   block at once, 8 loads in flight per thread, the first 8 issued before
//   x is staged) and does fp32 FMAs.  The grid splits N into 64-column
//   tiles and K into chunks of 256 to 512 rows, planned on the host
//   (small_m_plan) for ~4 blocks per SM; fewer, longer splits measured
//   faster than more, shorter ones (PERF.md); split-K partials go to an
//   fp32 workspace and a second
//   kernel adds them in split order (deterministic, no atomics), casts and
//   stores, zeros past n_act included.  With one split the first kernel
//   stores y itself.
// * tma (M > 16, bf16, 16-byte-aligned bases and row strides: the ViT at
//   M = 197 x bucket, LM prefill at M = 2048).  Bound: operations at the
//   LM's prefill shapes, bytes at the ViT's small K and N.  BK = 64, a
//   ring of 4-8 stages (192 KB) in shared memory fed by TMA
//   (cp.async.bulk.tensor with the 128-byte swizzle) and guarded by full /
//   empty mbarriers; one producer warp (one thread of it) issues the
//   loads, one or two consumer warpgroups each run wgmma.mma_async
//   m64nBNk16 on 64 of the rows with fp32 accumulators in registers,
//   keeping one wgmma group in flight.  The tile is 128 x 256, 128 x 128
//   or 64 x 128, chosen by tma_tile on the host: the largest that gives
//   about one block per SM without a mostly idle last wave -- 128 x 256
//   at most of the LM's prefill shapes, 64 x 128 for the ViT's N = 384
//   layers, which would leave most SMs idle.
//   The weight is K x N row-major, i.e. MN-major B: wgmma reads it with
//   its transpose bit set, from TMA boxes of 64 columns (128 bytes, the
//   swizzle width) by 64 rows.  Both tensor maps are encoded per call on
//   the host over the ACTIVE extents -- x as k_act x M, w as n_act x k_act
//   with their real row strides -- so TMA's out-of-bounds zero fill clears
//   the K tail, the M edge and columns past n_act.  In the TPU op's shape
//   (x wider than k_act, live data past k_act) that zero fill is what keeps
//   x's columns >= k_act out of the product: nothing is masked in shared
//   memory.  Tiles at or past n_act store zeros and exit before any load;
//   the K loop runs to cdiv(k_act, BK).  The grid walks M tiles fastest so
//   that the blocks in flight share each weight tile through L2.
// * tile (everything else: fp32 at M > 16 -- parity paths and the fp32
//   router at prefill -- and bf16 whose bases or row strides TMA cannot
//   take).  The unpipelined 64x64 tile loop of tile_matmul.cuh (WMMA for
//   bf16, FMAs for fp32), shared with K3.  The main path never takes it in
//   bf16 (chip_smoke.py asserts the per-variant counters).
//
// The TMA / wgmma machinery of tma and the streaming core of small_m live
// in hopper_gemm.cuh, shared with K3 (expert_matmul.cu).
//
// Later work: a persistent, cluster-multicast schedule for the tma variant
// (one block per SM walking the output tiles, the epilogue of one tile
// overlapping the loads of the next, TMA multicast of the x tile).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_gemm.cuh"
#include "tile_matmul.cuh"

using namespace repro_hopper;
using namespace repro_tile;

namespace {

// ---------------------------------------------------------------- tile ----

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

// ------------------------------------------------------------- small_m ----

// x[:, k0:k0+kc] is staged in smem[MT][S_KC_MAX]; after the product the
// same buffer holds the per-warp partial sums (stream_rows in
// hopper_gemm.cuh).
template <typename T, int MT>
__global__ void __launch_bounds__(S_THREADS, MT <= 4 ? 3 : 1)
small_m_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, float* __restrict__ ws,
               const int* __restrict__ widths, int M, int ldx, int ldw,
               int ldy, int n_out, int kc, int vec_ok) {
  __shared__ float buf[MT * S_KC_MAX];

  const int k_act = widths[0];
  const int n_act = widths[1];
  const bool direct = gridDim.y == 1;     // one split: store y here
  const int n0 = blockIdx.x * S_BN;
  const int tid = threadIdx.x;
  if (n0 >= n_act) {       // only with one split: the grid covers n_out
    for (int i = tid; i < M * S_BN; i += S_THREADS) {
      const int m = i / S_BN, n = n0 + i % S_BN;
      if (n < n_out) y[(size_t)m * ldy + n] = T(0.f);
    }
    return;
  }
  stream_rows<T, MT>(x, ldx, w, ldw, M, blockIdx.y * kc, kc, k_act, n0,
                     n_act, vec_ok, buf);
  for (int i = tid; i < M * S_BN; i += S_THREADS) {
    const int m = i / S_BN, col = i % S_BN, n = n0 + col;
    const float s = stream_sum<MT>(buf, m, col);
    if (direct) {
      if (n < n_out) y[(size_t)m * ldy + n] = T(n < n_act ? s : 0.f);
    } else if (n < n_act) {
      ws[((size_t)blockIdx.y * M + m) * n_act + n] = s;
    }
  }
}

// y[m, n] = sum over splits of ws[split, m, n] in split order; 0 past n_act
template <typename T>
__global__ void small_m_reduce(const float* __restrict__ ws,
                               T* __restrict__ y,
                               const int* __restrict__ widths, int M,
                               int ldy, int n_out, int splits) {
  const int n_act = widths[1];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * n_out) return;
  const int m = (int)(i / n_out), n = (int)(i % n_out);
  float s = 0.f;
  if (n < n_act) {
    // unrolled so that the partials' loads are in flight together
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      s += ws[((size_t)sp * M + m) * n_act + n];
  }
  y[(size_t)m * ldy + n] = T(s);
}

template <typename T>
int launch_small_m(const void* x, const void* w, void* y, void* ws,
                   const int* widths, int M, int ldx, int ldw, int ldy,
                   int n_out, int n_act, int splits, int kc, int vec_ok,
                   cudaStream_t s) {
  const int cols = splits == 1 ? n_out : n_act;   // one split: zeros too
  const dim3 grid((cols + S_BN - 1) / S_BN, splits);
#define REPRO_SMALL_M(MT)                                                   \
  small_m_kernel<T, MT><<<grid, S_THREADS, 0, s>>>(                         \
      static_cast<const T*>(x), static_cast<const T*>(w),                   \
      static_cast<T*>(y), static_cast<float*>(ws), widths, M, ldx, ldw,     \
      ldy, n_out, kc, vec_ok)
  if (M <= 1) REPRO_SMALL_M(1);
  else if (M <= 2) REPRO_SMALL_M(2);
  else if (M <= 4) REPRO_SMALL_M(4);
  else if (M <= 8) REPRO_SMALL_M(8);
  else if (M <= 16) REPRO_SMALL_M(16);
  else return -1;
#undef REPRO_SMALL_M
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)M * n_out;
  small_m_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<T*>(y), widths, M, ldy,
      n_out, splits);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- tma ----

template <int CWG, int BN>
__global__ void __launch_bounds__(GemmTile<CWG, BN>::THREADS, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                __nv_bfloat16* __restrict__ y,
                const int* __restrict__ widths, int M, int ldy, int n_out) {
  using G = GemmTile<CWG, BN>;
  const int k_act = widths[0];
  const int n_act = widths[1];
  const int m0 = blockIdx.x * G::BM;    // M tiles fastest: see the note
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  if (n0 >= n_act) {        // dead tile: zeros, no loads
    for (int i = tid; i < G::BM * BN; i += G::THREADS) {
      const int r = m0 + i / BN, c = n0 + i % BN;
      if (r < M && c < n_out)
        y[(size_t)r * ldy + c] = __float2bfloat16(0.f);
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES *
                                               G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  const int n_k = (k_act + G_BK - 1) / G_BK;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CWG);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;               // CWG: the producer warp
  if (wg == CWG) {                        // producer: one thread
    if (tid == 128 * CWG) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % G::STAGES;
        mbar_wait(&empty[s], ((kt / G::STAGES) & 1) ^ 1);
        unsigned char* a = smem + s * G::STAGE_BYTES;
        unsigned char* b = a + G::A_BYTES;
        mbar_expect_tx(&full[s], G::STAGE_BYTES);
        tma_load_2d(a, &map_x, &full[s], kt * G_BK, m0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          tma_load_2d(b + h * 8192, &map_w, &full[s], n0 + 64 * h,
                      kt * G_BK);
      }
    }
    return;
  }

  // consumer warpgroup wg computes rows m0 + 64wg .. m0 + 64wg + 63
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % G::STAGES;
    mbar_wait(&full[s], (kt / G::STAGES) & 1);
    const uint32_t a = smem_u32(smem + s * G::STAGE_BYTES) + wg * 64 * 128;
    const uint32_t b = smem_u32(smem + s * G::STAGE_BYTES + G::A_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks) {
      // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, a
      //    16-wide K step is 32 bytes along the swizzled row;
      // B: MN-major, 64-column boxes 8192 bytes apart (LBO), 8-row groups
      //    1024 bytes apart (SBO), a 16-row K step is 2048 bytes
      const uint64_t da = gmma_desc(a + ks * 32, 16, 1024);
      const uint64_t db = gmma_desc(b + ks * 2048, 8192, 1024);
      wgmma_step<BN>(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % G::STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);

  store_acc<BN>(d, y, ldy, tid % 128, m0 + wg * 64, n0, M, M, n_act, n_out);
}

template <int CWG, int BN>
int launch_tma(const void* x, const void* w, void* y, const int* widths,
               int M, int ldx, int ldw, int ldy, int n_out, int k_act,
               int n_act, cudaStream_t s) {
  using G = GemmTile<CWG, BN>;
  CUtensorMap map_x, map_w;
  if (!encode_map(&map_x, x, k_act, M, ldx, G::BM) ||
      !encode_map(&map_w, w, n_act, k_act, ldw, G_BK))
    return -2;
  // once per instantiation and process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tma_kernel<CWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + G::BM - 1) / G::BM, (n_out + BN - 1) / BN);
  gemm_tma_kernel<CWG, BN><<<grid, G::THREADS, G::SMEM, s>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(y), widths, M, ldy, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile variant.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); -1 for an
// unsupported dtype.
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

// The small_m variant: M <= 16, K split into `splits` chunks of `kc` rows
// (kc <= 512); `ws` an fp32 workspace of splits x M x n_act when splits
// > 1 (unused otherwise); vec_ok when w's base and row stride allow
// 16-byte loads.  Returns as above; -1 for an unsupported dtype or M.
extern "C" int repro_elastic_matmul_small_m(
    const void* x, const void* w, void* y, void* ws, const void* widths,
    int M, int ldx, int ldw, int ldy, int n_out, int n_act, int splits,
    int kc, int vec_ok, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wd = static_cast<const int*>(widths);
  if (kc > S_KC_MAX || splits < 1) return -1;
  if (dtype == 1)
    return launch_small_m<__nv_bfloat16>(x, w, y, ws, wd, M, ldx, ldw, ldy,
                                         n_out, n_act, splits, kc, vec_ok,
                                         s);
  if (dtype == 0)
    return launch_small_m<float>(x, w, y, ws, wd, M, ldx, ldw, ldy, n_out,
                                 n_act, splits, kc, vec_ok, s);
  return -1;
}

// The tma variant (bf16): x (M rows, ldx apart) and w (k_act rows, ldw
// apart) with 16-byte-aligned bases and row strides; k_act, n_act >= 1 are
// the host's copy of the widths, used for the tensor maps' extents; the
// tile is 128 x 256 (cwg 2, bn 256), 128 x 128 (2, 128) or 64 x 128
// (1, 128).  Returns as above; -1 for another tile, -2 when the tensor
// maps cannot be encoded.
extern "C" int repro_elastic_matmul_tma(const void* x, const void* w, void* y,
                                        const void* widths, int M, int ldx,
                                        int ldw, int ldy, int n_out,
                                        int k_act, int n_act, int cwg,
                                        int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wd = static_cast<const int*>(widths);
  if (cwg == 2 && bn == 256)
    return launch_tma<2, 256>(x, w, y, wd, M, ldx, ldw, ldy, n_out, k_act,
                              n_act, s);
  if (cwg == 2 && bn == 128)
    return launch_tma<2, 128>(x, w, y, wd, M, ldx, ldw, ldy, n_out, k_act,
                              n_act, s);
  if (cwg == 1 && bn == 128)
    return launch_tma<1, 128>(x, w, y, wd, M, ldx, ldw, ldy, n_out, k_act,
                              n_act, s);
  return -1;
}
