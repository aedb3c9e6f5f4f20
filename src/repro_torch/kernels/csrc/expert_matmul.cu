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
// load and every elastic setting, with no host sync.  No variant reads a
// weight byte of an expert with no rows, or of a tile past an expert's
// count.  The TPU docstring promises that skip, but its w_map is a no-op
// (fault F2 in ROADMAP.md).
//
// What bounds it on the H100 is the bytes of the live experts' weights,
// 2*K*F bytes each, at both of the LM's shapes.  At decode (4 sequences x
// top-6 = at most 24 live slots over 64 experts, C = 4) an expert has at
// most 4 rows: ~1 operation per weight byte.  At prefill of 4 x 512 tokens
// the slab has C = 240 rows per expert (8 groups x 30 capacity slots); a
// random-weight router keeps ~48% of its routed slots, ~92 rows per expert
// on average, and even 240 rows are 240 operations a weight byte, under
// the bf16 ridge of ~295.  So the design's job is to read each live
// expert's weights once, and fast.  Three variants, chosen on the host by
// kernels/expert_matmul.py:choose_variant from (C, dtype, strides):
//
// * stream (C <= 16, bf16 and fp32: decode).  K1 small_m's weight
//   streaming (hopper_gemm.cuh: stream_rows) once per live expert.  Grid
//   (F / 64, K splits, E); a block reads counts[e] first and, for an
//   expert with no rows, touches no weight byte.  Otherwise it stages
//   x[e, :counts[e], k-chunk] in shared memory (fp32), streams w[e] with
//   16-byte loads, 8 in flight per thread, the first issued before x is
//   staged, and runs fp32 FMAs over the live rows only.  The K split is
//   planned on the host from shapes alone (stream_plan; chunks of at most
//   512 rows).  Split-K partials go to an fp32 workspace and a second
//   kernel adds them in split order (deterministic, no atomics), casts,
//   and writes exact zeros past each count and for dead experts.
// * tma (C > 16, bf16, bases and strides TMA can take: prefill).  A
//   grouped wgmma GEMM fed by TMA, on K1's tma pattern: a ring of BK = 64
//   stages guarded by full / empty mbarriers, one producer thread issuing
//   the loads, two consumer warpgroups running wgmma.mma_async m64n128k16
//   with fp32 accumulators, the weight read as MN-major B (transpose bit)
//   in 64-column boxes with the 128-byte swizzle.  Two 3-D tensor maps a
//   call, encoded on the host over the call's extents -- x as (K, C, E)
//   and w as (F, K, E) with their row and expert strides -- are passed by
//   value (__grid_constant__), so there is no device array of maps and no
//   host-to-device copy; a box's outer extent is 1, so it lands in shared
//   memory exactly as K1's 2-D box does.  TMA's zero fill clears rows past
//   C, the K tail and columns past F (a_ff = 1056 and 704 are not
//   multiples of 128).  A block covers 128 rows of one expert and 128
//   columns; each consumer warpgroup owns one 64-row sub-tile (an
//   accumulator).  The block takes its live sub-tiles from counts[e] on
//   the device: the producer loads x only for those, a warpgroup computes
//   only a live one, and a block with none stores zeros and exits before
//   any load.  Rows counts[e] <= c inside a live sub-tile are computed and
//   stored as exact zeros by the epilogue (rows are independent, so
//   whatever x holds there cannot leak).  The grid walks C tiles fastest,
//   then F tiles, within an expert, so an expert's second C tile finds the
//   weight tile in L2.  One block per (F tile, expert) looping over all
//   its live rows, 128 x 256 tiles and two blocks per SM were slower at
//   both of the LM's shapes (PERF.md has the sweep's readings; git
//   history has those variants).
// * tile (everything else: fp32 at C > 16 -- the parity paths -- and bf16
//   whose base, row stride or expert stride TMA cannot take, such as the
//   dense oracle's stride-0 expert axis).  The unpipelined 64x64 tile loop
//   of tile_matmul.cuh (WMMA for bf16, FMAs for fp32), shared with K1: a
//   block past counts[e] writes its zero tile without reading x or w.
//   The main path never takes it in bf16 (chip_smoke.py asserts it).
//
// The backward (the reference has none: JAX differentiates through XLA),
// read from the same device counts, never from the host:
//   dgrad  dx[e, c] = dy[e, c] w[e]^T for c < counts[e], exact zeros past;
//   wgrad  dw[e] = x[e, :counts[e]]^T dy[e, :counts[e]] (a dead expert's
//          dw is exactly 0; it reads no byte of x or dy).
// What bounds them at the LM's train_4k microbatch (C = 1920 slab rows,
// ~64% of the routed slots kept, d 2048, expert width 1408) is operations:
// ~2 * 1230 * 2048 * 1408 flops an expert against its 5.8 MB of weights,
// ~1230 flops a weight byte, over the bf16 ridge.  dgrad runs on the
// persistent variant (expert_dgrad_persistent, below): one block an SM
// walks a list of the live (expert, 128-row tile, 256-column tile) items
// that every block scans from the device counts in its prologue (no host
// sync), the producer keeping the ring full across items, the consumers
// staging each tile as bf16 in shared memory for a TMA store, and the
// producer warp writing the dead rows' zeros once its loads are issued.
// Its predecessor, expert_tma_kernel<X_DGRAD> (the forward's grouped GEMM
// with dy as A and w read along its rows as a K-major B; a 128 x 128 tile
// a block, half the blocks past the counts), takes what the persistent
// kernel does not (dx rows TMA cannot store, more than 512 experts).  Both
// read a strided a_ff or slice_e view of w in place through the same 3-D
// map.  The persistent kernel's 2-block clusters multicasting the w tile
// measured slower (PERF.md); so did 128-column items.  wgrad runs on the
// persistent variant too (expert_wgrad_persistent, below): one block an
// SM walks the (live expert, 128-row K tile, 256-column F tile) items,
// the experts by descending count so that the longest reductions start
// first and the last wave is short, each tile reduced over its expert's
// live rows by one block (x and dy both MN-major, K1's wgrad layout; no
// split, so no reduce: the same bits every run, graph-safe), staged as
// bf16 and stored by TMA while the producer loads the next item; a
// producer warpgroup gives its registers to the consumers (setmaxnreg)
// and writes the dead experts' zeros.  Its predecessor
// expert_wgrad_tma_kernel (a block per 128 x 128 tile, cold ring each)
// takes more than 512 experts.  The last 64-row box of a ragged count
// holds rows past it (TMA loads whole boxes); the consumers zero them in
// shared memory before the product, since a NaN there would reach the
// sum.  fp32 and strides TMA cannot take (the dense oracle's stride-0
// expert axis) go to a 64x64 FMA tile loop over any strides.
//
// Later work: the forward's tma on the persistent schedule (ragged experts
// of 0 to 240 rows at prefill, one tile's epilogue overlapping the next
// tile's loads).
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

// -------------------------------------------------------------- stream ----

// The block's product over MR >= cnt staged rows of its K chunk, stored:
// y itself with one split (zeros past cnt), else the live rows' partials
// at ws_e.
template <typename T, int MR>
__device__ __forceinline__ void stream_block(
    const T* __restrict__ x, int x_sc, const T* __restrict__ w, int w_sk,
    T* __restrict__ ye, float* __restrict__ ws_e, int cnt, int C, int K,
    int F, int n0, int k0, int kc, int vec_ok, bool direct, float* buf) {
  stream_rows<T, MR>(x, x_sc, w, w_sk, cnt, k0, kc, K, n0, F, vec_ok, buf);
  for (int i = threadIdx.x; i < C * S_BN; i += S_THREADS) {
    const int m = i / S_BN, col = i % S_BN, n = n0 + col;
    if (n >= F) continue;
    if (direct)
      ye[(size_t)m * F + n] = T(m < cnt ? stream_sum<MR>(buf, m, col) : 0.f);
    else if (m < cnt)
      ws_e[(size_t)m * F + n] = stream_sum<MR>(buf, m, col);
  }
}

// stream_block over the fewest rows, a power of two up to MT, that cover
// cnt: the FMAs run over the live rows (most live experts at decode have
// one), one code path per row count
template <typename T, int MR, int MT, typename... A>
__device__ __forceinline__ void stream_live(int cnt, A... args) {
  if constexpr (MR < MT) {
    if (cnt > MR) {
      stream_live<T, 2 * MR, MT>(cnt, args...);
      return;
    }
  }
  stream_block<T, MR>(args...);
}

template <typename T, int MT>
__global__ void __launch_bounds__(S_THREADS, MT <= 4 ? 3 : 1)
expert_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ ws,
                     const int* __restrict__ counts, int C, int K, int F,
                     long long x_se, int x_sc, long long w_se, int w_sk,
                     int kc, int vec_ok) {
  __shared__ float buf[MT * S_KC_MAX];
  const int e = blockIdx.z;
  const int E = gridDim.z;
  const int cnt = min(max(counts[e], 0), C);
  const bool direct = gridDim.y == 1;     // one split: store y here
  const int n0 = blockIdx.x * S_BN;
  T* ye = y + (size_t)e * C * F;
  if (cnt == 0) {           // no rows: no weight byte; the zeros of y come
    if (direct) {           // from here or from the reduce
      for (int i = threadIdx.x; i < C * S_BN; i += S_THREADS) {
        const int m = i / S_BN, n = n0 + i % S_BN;
        if (n < F) ye[(size_t)m * F + n] = T(0.f);
      }
    }
    return;
  }
  stream_live<T, 1, MT>(cnt, x + e * x_se, x_sc, w + e * w_se, w_sk, ye,
                        ws + ((size_t)blockIdx.y * E + e) * C * F, cnt, C, K,
                        F, n0, (int)blockIdx.y * kc, kc, vec_ok, direct, buf);
}

// y[e, c, n] = sum over splits of ws[split, e, c, n] in split order for
// c < counts[e]; exact zeros past the count (dead experts included)
template <typename T>
__global__ void expert_stream_reduce(const float* __restrict__ ws,
                                     T* __restrict__ y,
                                     const int* __restrict__ counts, int E,
                                     int C, int F, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_split = (long long)E * C * F;
  if (i >= per_split) return;
  const int e = (int)(i / ((long long)C * F));
  const int m = (int)((i / F) % C);
  const int cnt = min(max(counts[e], 0), C);
  float s = 0.f;
  if (m < cnt) {
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * per_split + i];
  }
  y[i] = T(s);
}

template <typename T>
int launch_stream(const void* x, const void* w, void* y, void* ws,
                  const int* counts, int E, int C, int K, int F,
                  long long x_se, int x_sc, long long w_se, int w_sk,
                  int splits, int kc, int vec_ok, cudaStream_t s) {
  const dim3 grid((F + S_BN - 1) / S_BN, splits, E);
#define REPRO_STREAM(MT)                                                    \
  expert_stream_kernel<T, MT><<<grid, S_THREADS, 0, s>>>(                   \
      static_cast<const T*>(x), static_cast<const T*>(w),                   \
      static_cast<T*>(y), static_cast<float*>(ws), counts, C, K, F, x_se,   \
      x_sc, w_se, w_sk, kc, vec_ok)
  if (C <= 1) REPRO_STREAM(1);
  else if (C <= 2) REPRO_STREAM(2);
  else if (C <= 4) REPRO_STREAM(4);
  else if (C <= 8) REPRO_STREAM(8);
  else if (C <= 16) REPRO_STREAM(16);
  else return -1;
#undef REPRO_STREAM
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)E * C * F;
  expert_stream_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<T*>(y), counts, E, C, F,
      splits);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- tma ----

constexpr int X_CWG = 2;     // consumer warpgroups of the tma variant
constexpr int X_BN = 128;    // its columns per block
using XTile = GemmTile<X_CWG, X_BN>;    // 128 rows: 64 per warpgroup

// The two row-gated products on this ring (the rows are x's or dy's c):
//   X_FWD    y  = x w     A = x (K, C, E), K-major; B = w (F, K, E) read
//                         MN-major in 64-column boxes; reduction K;
//   X_DGRAD  dx = dy w^T  A = dy (F, C, E), K-major; B = the same map of
//                         w read along its rows, K-major (64-row boxes
//                         of 64 reduction columns); reduction F.
// Output rows c < counts[e] are live in both; wgrad (below) reduces over
// them instead.
enum : int { X_FWD = 0, X_DGRAD = 1 };

// out[e, c, n] = sum_{r < n_red} A[e, c, r] B[e, r, n] for c < counts[e],
// exact zeros past it; n < N (out's row stride N)
template <int OP>
__global__ void __launch_bounds__(XTile::THREADS, 1)
expert_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  __nv_bfloat16* __restrict__ y,
                  const int* __restrict__ counts, int C, int n_red, int F) {
  using G = XTile;
  const int e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), C);
  const int m0 = blockIdx.x * G::BM;      // C tiles fastest, then F tiles
  const int n0 = blockIdx.y * X_BN;
  const int tid = threadIdx.x;
  __nv_bfloat16* ye = y + (size_t)e * C * F;
  // live 64-row sub-tiles of the block, one per consumer warpgroup
  const int n_sub = cnt > m0 ? min((cnt - m0 + 63) / 64, X_CWG) : 0;
  if (n_sub == 0) {         // dead tile: zeros, no loads
    for (int i = tid; i < G::BM * X_BN; i += G::THREADS) {
      const int r = m0 + i / X_BN, c = n0 + i % X_BN;
      if (r < C && c < F) ye[(size_t)r * F + c] = __float2bfloat16(0.f);
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES *
                                               G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  const int n_k = (n_red + G_BK - 1) / G_BK;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_sub);    // one arrival per live warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;               // X_CWG: the producer warp
  if (wg == X_CWG) {                      // producer: one thread
    if (tid == 128 * X_CWG) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % G::STAGES;
        mbar_wait(&empty[s], ((kt / G::STAGES) & 1) ^ 1);
        unsigned char* a = smem + s * G::STAGE_BYTES;
        unsigned char* b = a + G::A_BYTES;
        mbar_expect_tx(&full[s], n_sub * 8192 + G::B_BYTES);
        for (int sub = 0; sub < n_sub; ++sub)
          tma_load_3d(a + sub * 8192, &map_x, &full[s], kt * G_BK,
                      m0 + 64 * sub, e);
#pragma unroll
        for (int h = 0; h < X_BN / 64; ++h) {
          if constexpr (OP == X_DGRAD)      // 64 output columns' rows of w
            tma_load_3d(b + h * 8192, &map_w, &full[s], kt * G_BK,
                        n0 + 64 * h, e);
          else
            tma_load_3d(b + h * 8192, &map_w, &full[s], n0 + 64 * h,
                        kt * G_BK, e);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: sub-tile wg, computed when live, else zeros
  float d[X_BN / 2];
#pragma unroll
  for (int i = 0; i < X_BN / 2; ++i) d[i] = 0.f;
  if (wg < n_sub) {
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % G::STAGES;
      mbar_wait(&full[s], (kt / G::STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * G::STAGE_BYTES) + wg * 8192;
      const uint32_t b = smem_u32(smem + s * G::STAGE_BYTES + G::A_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < G_BK / 16; ++ks) {
        // as K1's tma kernels: A K-major (a 16-wide K step is 32 bytes
        // along the swizzled row); B MN-major in the forward (LBO 8 KB
        // between 64-column boxes, SBO 1 KB between 8-row groups, a
        // 16-row K step is 2 KB), K-major in dgrad (as A: its 128 rows
        // are the two boxes back to back)
        if constexpr (OP == X_DGRAD)
          wgmma_m64n128k16<0, 0>(d, gmma_desc(a + ks * 32, 16, 1024),
                                 gmma_desc(b + ks * 32, 16, 1024));
        else
          wgmma_m64n128k16(d, gmma_desc(a + ks * 32, 16, 1024),
                           gmma_desc(b + ks * 2048, 8192, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % G::STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
  }
  store_acc<X_BN>(d, ye, F, tid % 128, m0 + 64 * wg, n0,
                  wg < n_sub ? cnt : 0, C, F, F);
}

// dw[e, i, j] = sum_{c < counts[e]} x[e, c, i] dy[e, c, j]: one block a
// 128 x 128 tile of one expert's (K, F) gradient, its reduction the
// expert's live rows, read as 64-row boxes of x (K, C, E) and dy (F, C,
// E), both MN-major (as K1's wgrad reads x).  A dead expert's blocks store
// zeros and load nothing.  The last box of a ragged count holds rows past
// it, which may hold anything (a NaN times 0 is NaN): the consumers zero
// those rows of the four boxes in shared memory before their product.
__global__ void __launch_bounds__(XTile::THREADS, 1)
expert_wgrad_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dy,
                        __nv_bfloat16* __restrict__ dw,
                        const int* __restrict__ counts, int C, int K,
                        int F) {
  using G = XTile;
  const int e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), C);
  const int i0 = blockIdx.x * G::BM;      // K tiles fastest, then F tiles
  const int j0 = blockIdx.y * X_BN;
  const int tid = threadIdx.x;
  __nv_bfloat16* dwe = dw + (size_t)e * K * F;
  if (cnt == 0) {           // dead expert: zeros, no loads
    for (int i = tid; i < G::BM * X_BN; i += G::THREADS) {
      const int r = i0 + i / X_BN, c = j0 + i % X_BN;
      if (r < K && c < F) dwe[(size_t)r * F + c] = __float2bfloat16(0.f);
    }
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES *
                                               G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  const int n_k = (cnt + G_BK - 1) / G_BK;
  const int tail = cnt - (n_k - 1) * G_BK;    // live rows of the last box
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * X_CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == X_CWG) {                      // producer: one thread
    if (tid == 128 * X_CWG) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % G::STAGES;
        mbar_wait(&empty[s], ((kt / G::STAGES) & 1) ^ 1);
        unsigned char* a = smem + s * G::STAGE_BYTES;
        unsigned char* b = a + G::A_BYTES;
        mbar_expect_tx(&full[s], G::STAGE_BYTES);
#pragma unroll
        for (int h = 0; h < X_CWG; ++h)
          tma_load_3d(a + h * 8192, &map_x, &full[s], i0 + 64 * h,
                      kt * G_BK, e);
#pragma unroll
        for (int h = 0; h < X_BN / 64; ++h)
          tma_load_3d(b + h * 8192, &map_dy, &full[s], j0 + 64 * h,
                      kt * G_BK, e);
      }
    }
    return;
  }

  float d[X_BN / 2];
#pragma unroll
  for (int i = 0; i < X_BN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % G::STAGES;
    mbar_wait(&full[s], (kt / G::STAGES) & 1);
    if (kt == n_k - 1 && tail < G_BK) {
      // rows tail .. 63 of each 64-row box (whole 128-byte rows: the
      // swizzle moves 16-byte chunks within a row), by both consumer
      // warpgroups, made visible to wgmma's async proxy
      constexpr int BOXES = X_CWG + X_BN / 64;
      const int per_box = (G_BK - tail) * 8;          // 16-byte chunks
      unsigned char* st = smem + s * G::STAGE_BYTES;
      for (int i = tid; i < BOXES * per_box; i += 128 * X_CWG) {
        const int box = i / per_box, r = tail + (i % per_box) / 8;
        reinterpret_cast<uint4*>(st + box * 8192 + r * 128)[i % 8] =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_async_smem();
      asm volatile("bar.sync 1, %0;" ::"n"(128 * X_CWG) : "memory");
    }
    const uint32_t a = smem_u32(smem + s * G::STAGE_BYTES) + wg * 8192;
    const uint32_t b = smem_u32(smem + s * G::STAGE_BYTES + G::A_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks)
      // both MN-major: a 16-row step of the reduction is 2 KB
      wgmma_m64n128k16<1, 1>(d, gmma_desc(a + ks * 2048, 8192, 1024),
                             gmma_desc(b + ks * 2048, 8192, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % G::STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);
  store_acc<X_BN>(d, dwe, F, tid % 128, i0 + 64 * wg, j0, K, K, F, F);
}

// ------------------------------------------------- dgrad: persistent ----

constexpr int P_BM = 128;        // rows an item: 64 a consumer warpgroup
constexpr int P_BN = 256;        // columns an item (128 measured slower)
constexpr int P_E_MAX = 512;     // experts the prologue's scan takes

// The persistent dgrad's and wgrad's shared memory at BN output columns
// an item: the ring (as many BK = 64 stages of A (128 rows) and B (BN
// columns) as fit: dy and w for dgrad, x and dy for wgrad), each
// warpgroup's 64 x BN output tile for the TMA store, the mbarriers, and
// three int arrays of P_E_MAX + 1 (dgrad's scan: live items and dead rows
// before each expert, the clamped counts; wgrad's clamped counts and
// order of the experts).
template <int BN>
struct PersistTile {
  static constexpr int A_BYTES = P_BM * G_BK * 2;
  static constexpr int B_BYTES = BN * G_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = P_BM * BN * 2;
  static constexpr int SCAN_BYTES = 3 * 4 * (P_E_MAX + 1);
  static constexpr int FREE =
      232448 - 1024 - OUT_BYTES - SCAN_BYTES - 2 * 8 * 8;
  static constexpr int STAGES =
      FREE / STAGE_BYTES < 8 ? FREE / STAGE_BYTES : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 OUT_BYTES + 2 * 8 * STAGES + SCAN_BYTES;
};

// the last e in [0, E] with pre[e] <= i (pre non-decreasing, pre[0] = 0)
__device__ __forceinline__ int scan_find(const int* pre, int E, int i) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pre[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// dx[e, c, k] = sum_f dy[e, c, f] w[e, k, f] for c < counts[e], exact
// zeros past it, as a persistent kernel: gridDim.x blocks (at most one an
// SM) walk one list of live items -- (expert, 128-row tile, BN-column
// tile), the row tiles of an expert's column tile consecutive, so blocks
// that run together share its w tile in L2 -- block b taking items b,
// b + gridDim.x, ...  The list is the counts' scan, made by every block in
// its prologue (no host sync: graph-safe).  The producer thread keeps the
// ring full across items; each consumer warpgroup runs its 64 rows on
// wgmma m64nBNk16 (both operands K-major), then stages its tile in shared
// memory as bf16 (rows past the count as zeros) and stores it by TMA,
// while the producer already loads the next item's stages.  Once
// its loads are issued, the producer warp writes the dead rows -- from
// the count rounded up to 128 to C -- of the block's share, so every row
// of dx is written.
template <int BN>
__global__ void __launch_bounds__(XTile::THREADS, 1)
expert_dgrad_persistent(const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_dx,
                        __nv_bfloat16* __restrict__ dx,
                        const int* __restrict__ counts, int E, int C, int K,
                        int F) {
  using P = PersistTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out = smem + P::STAGES * P::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + P::OUT_BYTES);
  uint64_t* empty = full + P::STAGES;
  int* items = reinterpret_cast<int*>(empty + P::STAGES);   // [E + 1]
  int* dead = items + (P_E_MAX + 1);                         // [E + 1]
  int* cnts = dead + (P_E_MAX + 1);                          // [E]
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_nt = (K + BN - 1) / BN;
  const int n_k = (F + G_BK - 1) / G_BK;

  if (tid < 32) {           // the scan, 32 experts a round
    int carry_i = 0, carry_d = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int cnt = e < E ? min(max(counts[e], 0), C) : 0;
      const int mt = (cnt + P_BM - 1) / P_BM;
      int vi = mt * n_nt, vd = e < E ? C - min(mt * P_BM, C) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ti = __shfl_up_sync(0xffffffffu, vi, o);
        const int td = __shfl_up_sync(0xffffffffu, vd, o);
        if (lane >= o) {
          vi += ti;
          vd += td;
        }
      }
      if (e < E) {
        cnts[e] = cnt;
        items[e + 1] = carry_i + vi;
        dead[e + 1] = carry_d + vd;
      }
      carry_i += __shfl_sync(0xffffffffu, vi, 31);
      carry_d += __shfl_sync(0xffffffffu, vd, 31);
    }
    if (lane == 0) items[0] = dead[0] = 0;
  }
  if (tid == 32) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();
  const int n_items = items[E], n_dead = dead[E];

  // item i: its expert, first row and column, and the expert's count
  auto item = [&](int i, int& e, int& m0, int& n0, int& cnt) {
    e = scan_find(items, E, i);
    cnt = cnts[e];
    const int n_mt = (cnt + P_BM - 1) / P_BM;
    const int l = i - items[e];
    m0 = (l % n_mt) * P_BM;
    n0 = (l / n_mt) * BN;
  };

  const int wg = tid / 128;
  if (wg == X_CWG) {                      // the producer warp
    if (lane == 0) {
      int g = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        int e, m0, n0, cnt;
        item(i, e, m0, n0, cnt);
        const int n_sub = min((cnt - m0 + 63) / 64, X_CWG);
        for (int kt = 0; kt < n_k; ++kt, ++g) {
          const int s = g % P::STAGES;
          mbar_wait(&empty[s], ((g / P::STAGES) & 1) ^ 1);
          unsigned char* a = smem + s * P::STAGE_BYTES;
          unsigned char* b = a + P::A_BYTES;
          mbar_expect_tx(&full[s], n_sub * 8192 + P::B_BYTES);
          for (int sub = 0; sub < n_sub; ++sub)
            tma_load_3d(a + sub * 8192, &map_dy, &full[s], kt * G_BK,
                        m0 + 64 * sub, e);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)    // 64 output columns' rows
            tma_load_3d(b + h * 8192, &map_w, &full[s], kt * G_BK,
                        n0 + 64 * h, e);
        }
      }
    }
    __syncwarp();
    // the dead rows of this block's share, 16 bytes a lane (K % 8 == 0)
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int r = blockIdx.x; r < n_dead; r += gridDim.x) {
      const int e = scan_find(dead, E, r);
      const int row = min((cnts[e] + P_BM - 1) / P_BM * P_BM, C) +
                      (r - dead[e]);
      uint4* p = reinterpret_cast<uint4*>(dx + ((size_t)e * C + row) * K);
      for (int c = lane; c < K / 8; c += 32) p[c] = z;
    }
    return;
  }

  const int t = tid % 128;
  unsigned char* o_wg = out + wg * (64 * BN * 2);     // BN / 64 boxes
  const int r_base = 16 * (t / 32) + (t % 32) / 4;
  float d[BN / 2];
  int g = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    int e, m0, n0, cnt;
    item(i, e, m0, n0, cnt);
    // a warpgroup whose rows are all past the count runs the products too
    // (on whatever its A slot holds: the epilogue stores zeros there), so
    // no branch divides the warpgroups around wgmma
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) d[x] = 0.f;
    for (int kt = 0; kt < n_k; ++kt, ++g) {
      const int s = g % P::STAGES;
      mbar_wait(&full[s], (g / P::STAGES) & 1);
      const uint32_t a = smem_u32(smem + s * P::STAGE_BYTES) + wg * 8192;
      const uint32_t b = smem_u32(smem + s * P::STAGE_BYTES + P::A_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < G_BK / 16; ++ks)       // both K-major
        wgmma_step<BN, 0, 0>(d, gmma_desc(a + ks * 32, 16, 1024),
                             gmma_desc(b + ks * 32, 16, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % P::STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(&empty[(g - 1) % P::STAGES]);
    // the epilogue: once the last item's store has read the tile, this
    // warpgroup's rows as bf16 (zeros past the count) into its swizzled
    // boxes, then one TMA store per box (rows past C are not written)
    if (t == 0) bulk_wait_read();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = r_base + 8 * ii;
        const bool ok = m0 + 64 * wg + r < cnt;
        const int ch = j % 8;
        *reinterpret_cast<__nv_bfloat162*>(
            o_wg + (j / 8) * 8192 + r * 128 + ((ch ^ (r & 7)) << 4) +
            4 * (t % 4)) =
            __floats2bfloat162_rn(ok ? d[4 * j + 2 * ii] : 0.f,
                                  ok ? d[4 * j + 2 * ii + 1] : 0.f);
      }
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (t == 0 && m0 + 64 * wg < C) {
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        if (n0 + 64 * h < K)
          tma_store_3d(&map_dx, o_wg + h * 8192, n0 + 64 * h, m0 + 64 * wg,
                       e);
      bulk_commit();
    }
    __syncwarp();
  }
  if (t == 0) bulk_wait();
}

// ------------------------------------------------- wgrad: persistent ----

// dw[e, i, j] = sum_{c < counts[e]} x[e, c, i] dy[e, c, j] as a persistent
// kernel: gridDim.x blocks (at most one an SM) walk one list of items --
// (live expert, 128-row K tile, 256-column F tile) -- block b taking
// items b, b + gridDim.x, ...  Every live expert has the same items, so
// the list is an order of the live experts, made by every block in its
// prologue from the device counts (no host sync: graph-safe): by
// descending count (ties by index), so the longest reductions start first
// and the last wave is short.  An F past the last tile's columns is
// zero-filled by the loads and clipped by the stores.
// Within an expert, an F tile's K tiles are consecutive: blocks that run
// together share its dy boxes in L2.  The producer thread keeps the ring
// full across items with 64-row boxes of x (K, C, E) and dy (F, C, E),
// both MN-major; each consumer warpgroup owns 64 of the 128 K rows and
// runs wgmma m64n256k16 over the expert's live rows, zeroing the rows of
// the last box past the count in shared memory first (a NaN there would
// reach the sum), then stages its tile as bf16 for a TMA store while the
// producer loads the next item.  Each tile is summed by one block in row
// order: the same bits on every run, no workspace, no atomics.  The
// producer is a whole warpgroup, so that setmaxnreg can give its
// registers to the consumers' 128 accumulators (at 288 threads ptxas caps
// a thread at 168 registers, and BN = 256 spilled); its other three warps
// write the dead experts' zeros of the block's share, so every element of
// dw is written.
constexpr int W_THREADS = 128 * X_CWG + 128;

__global__ void __launch_bounds__(W_THREADS, 1)
expert_wgrad_persistent(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_dw,
                        __nv_bfloat16* __restrict__ dw,
                        const int* __restrict__ counts, int E, int C, int K,
                        int F) {
  constexpr int BN = P_BN;
  using P = PersistTile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out = smem + P::STAGES * P::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + P::OUT_BYTES);
  uint64_t* empty = full + P::STAGES;
  int* cnts = reinterpret_cast<int*>(empty + P::STAGES);   // [E]
  int* order = cnts + (P_E_MAX + 1);      // [E]: live experts, then dead
  int* n_live_s = order + P_E_MAX;
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_it = (K + P_BM - 1) / P_BM;           // K tiles of an expert
  const int per = n_it * ((F + BN - 1) / BN);       // items of a live one

  if (tid == 0) {
    *n_live_s = 0;
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_async_smem();
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    cnts[e] = min(max(counts[e], 0), C);
    if (cnts[e] > 0) atomicAdd(n_live_s, 1);
  }
  __syncthreads();
  // each expert's place: live ones first, by descending count; dead ones
  // after them; ties by index
  for (int e = tid; e < E; e += blockDim.x) {
    const int ce = cnts[e];
    int r = 0;
    for (int o = 0; o < E; ++o) {
      const int co = cnts[o];
      r += co != ce ? co > ce : o < e;
    }
    order[r] = e;
  }
  __syncthreads();
  const int n_live = *n_live_s, n_items = n_live * per;

  // item i: its expert, first K row and first F column
  auto item = [&](int i, int& e, int& i0, int& j0) {
    e = order[i / per];
    const int l = i % per;
    i0 = (l % n_it) * P_BM;
    j0 = (l / n_it) * BN;
  };

  const int wg = tid / 128;
  if (wg == X_CWG) {                      // the producer warpgroup
    // 2 x 128 x 232 + 128 x 40 registers <= 64 K
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int warp = (tid % 128) / 32;
    if (warp > 0) {
      // the dead experts' rows of this block's share, a row a warp, 16
      // bytes a lane (F % 8 == 0)
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const int n_dead = (E - n_live) * K;
      for (int r = blockIdx.x + gridDim.x * (warp - 1); r < n_dead;
           r += 3 * gridDim.x) {
        const int e = order[n_live + r / K];
        uint4* p =
            reinterpret_cast<uint4*>(dw + ((size_t)e * K + r % K) * F);
        for (int c = lane; c < F / 8; c += 32) p[c] = z;
      }
    } else if (lane == 0) {
      int g = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        int e, i0, j0;
        item(i, e, i0, j0);
        const int n_k = (cnts[e] + G_BK - 1) / G_BK;
        for (int kt = 0; kt < n_k; ++kt, ++g) {
          const int s = g % P::STAGES;
          mbar_wait(&empty[s], ((g / P::STAGES) & 1) ^ 1);
          unsigned char* a = smem + s * P::STAGE_BYTES;
          unsigned char* b = a + P::A_BYTES;
          mbar_expect_tx(&full[s], P::STAGE_BYTES);
#pragma unroll
          for (int h = 0; h < X_CWG; ++h)
            tma_load_3d(a + h * 8192, &map_x, &full[s], i0 + 64 * h,
                        kt * G_BK, e);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_3d(b + h * 8192, &map_dy, &full[s], j0 + 64 * h,
                        kt * G_BK, e);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int t = tid % 128;
  unsigned char* o_wg = out + wg * (64 * BN * 2);     // BN / 64 boxes
  const int r_base = 16 * (t / 32) + (t % 32) / 4;
  float d[BN / 2];
  int g = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    int e, i0, j0;
    item(i, e, i0, j0);
    const int cnt = cnts[e];
    const int n_k = (cnt + G_BK - 1) / G_BK;
    const int tail = cnt - (n_k - 1) * G_BK;    // live rows of the last box
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) d[x] = 0.f;
    for (int kt = 0; kt < n_k; ++kt, ++g) {
      const int s = g % P::STAGES;
      mbar_wait(&full[s], (g / P::STAGES) & 1);
      unsigned char* st = smem + s * P::STAGE_BYTES;
      if (kt == n_k - 1 && tail < G_BK) {
        // rows tail .. 63 of each 64-row box (whole 128-byte rows: the
        // swizzle moves 16-byte chunks within a row), by both consumer
        // warpgroups, made visible to wgmma's async proxy
        constexpr int BOXES = X_CWG + BN / 64;
        const int per_box = (G_BK - tail) * 8;          // 16-byte chunks
        for (int z = tid; z < BOXES * per_box; z += 128 * X_CWG) {
          const int box = z / per_box, r = tail + (z % per_box) / 8;
          reinterpret_cast<uint4*>(st + box * 8192 + r * 128)[z % 8] =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_async_smem();
        asm volatile("bar.sync 3, %0;" ::"n"(128 * X_CWG) : "memory");
      }
      const uint32_t a = smem_u32(st) + wg * 8192;
      const uint32_t b = smem_u32(st + P::A_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < G_BK / 16; ++ks)
        // both MN-major: a 16-row step of the reduction is 2 KB
        wgmma_step<BN, 1, 1>(d, gmma_desc(a + ks * 2048, 8192, 1024),
                             gmma_desc(b + ks * 2048, 8192, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(d);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % P::STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);
    if (lane == 0) mbar_arrive(&empty[(g - 1) % P::STAGES]);
    // the epilogue: once the last item's store has read the tile, this
    // warpgroup's 64 K rows as bf16 into its swizzled boxes, then one TMA
    // store per box (rows past K and columns past F are not written)
    if (t == 0) bulk_wait_read();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = r_base + 8 * ii;
        const int ch = j % 8;
        *reinterpret_cast<__nv_bfloat162*>(
            o_wg + (j / 8) * 8192 + r * 128 + ((ch ^ (r & 7)) << 4) +
            4 * (t % 4)) =
            __floats2bfloat162_rn(d[4 * j + 2 * ii], d[4 * j + 2 * ii + 1]);
      }
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (t == 0 && i0 + 64 * wg < K) {
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        if (j0 + 64 * h < F)
          tma_store_3d(&map_dw, o_wg + h * 8192, j0 + 64 * h, i0 + 64 * wg,
                       e);
      bulk_commit();
    }
    __syncwarp();
  }
  if (t == 0) bulk_wait();
}

// once per kernel and process (the port drives one card)
template <typename Kern>
cudaError_t smem_attr(Kern kern) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)XTile::SMEM);
}

int launch_tma(const void* x, const void* w, void* y, const int* counts,
               int E, int C, int K, int F, long long x_se, int x_sc,
               long long w_se, int w_sk, cudaStream_t s) {
  using G = XTile;
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[3] = {(cuuint64_t)K, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)x_sc * 2,
                                   (cuuint64_t)x_se * 2};
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)w_sk * 2,
                                   (cuuint64_t)w_se * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!encode_bf16_map(&map_x, x, 3, x_dims, x_strides, box) ||
      !encode_bf16_map(&map_w, w, 3, w_dims, w_strides, box))
    return -2;
  static const cudaError_t attr = smem_attr(expert_tma_kernel<X_FWD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((C + G::BM - 1) / G::BM, (F + X_BN - 1) / X_BN, E);
  expert_tma_kernel<X_FWD><<<grid, G::THREADS, G::SMEM, s>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(y), counts, C, K, F);
  return static_cast<int>(cudaGetLastError());
}

// a contiguous (E, C, N) bf16 tensor as the 3-D map (N, C, E)
bool encode_slab_map(CUtensorMap* map, const void* p, int E, int C, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)C * N * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_bf16_map(map, p, 3, dims, strides, box);
}

int launch_dgrad_tma(const void* dy, const void* w, void* dx,
                     const int* counts, int E, int C, int K, int F,
                     long long w_se, int w_sk, cudaStream_t s) {
  using G = XTile;
  CUtensorMap map_dy, map_w;
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)w_sk * 2,
                                   (cuuint64_t)w_se * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!encode_slab_map(&map_dy, dy, E, C, F) ||
      !encode_bf16_map(&map_w, w, 3, w_dims, w_strides, box))
    return -2;
  static const cudaError_t attr = smem_attr(expert_tma_kernel<X_DGRAD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((C + G::BM - 1) / G::BM, (K + X_BN - 1) / X_BN, E);
  expert_tma_kernel<X_DGRAD><<<grid, G::THREADS, G::SMEM, s>>>(
      map_dy, map_w, static_cast<__nv_bfloat16*>(dx), counts, C, F, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_dgrad_persistent(const CUtensorMap& map_dy,
                            const CUtensorMap& map_w,
                            const CUtensorMap& map_dx, void* dx,
                            const int* counts, int E, int C, int K, int F,
                            int grid, cudaStream_t s) {
  constexpr size_t bytes = PersistTile<BN>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      expert_dgrad_persistent<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  expert_dgrad_persistent<BN><<<grid, XTile::THREADS, bytes, s>>>(
      map_dy, map_w, map_dx, static_cast<__nv_bfloat16*>(dx), counts, E, C,
      K, F);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgrad_tma(const void* x, const void* dy, void* dw,
                     const int* counts, int E, int C, int K, int F,
                     long long x_se, int x_sc, cudaStream_t s) {
  using G = XTile;
  CUtensorMap map_x, map_dy;
  const cuuint64_t x_dims[3] = {(cuuint64_t)K, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)x_sc * 2,
                                   (cuuint64_t)x_se * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!encode_bf16_map(&map_x, x, 3, x_dims, x_strides, box) ||
      !encode_slab_map(&map_dy, dy, E, C, F))
    return -2;
  static const cudaError_t attr = smem_attr(expert_wgrad_tma_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((K + G::BM - 1) / G::BM, (F + X_BN - 1) / X_BN, E);
  expert_wgrad_tma_kernel<<<grid, G::THREADS, G::SMEM, s>>>(
      map_x, map_dy, static_cast<__nv_bfloat16*>(dw), counts, C, K, F);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- backward tile ----

// One 64 x 64 tile of C[i, j] = sum_{r < r_len} A(i, r) B(r, j) with
// A(i, r) = a[i * sai + r * sar] and B(r, j) = b[r * sbr + j * sbj] (any
// strides: the transposed reads of both gradients), on FMAs in fp32 for
// bf16 and fp32 alike: 256 threads, each 4 x 4 outputs, the reduction in
// steps of 16.  Rows i >= m_valid and columns j >= n_valid are neither
// read nor computed, and stored as exact zeros below m_out / n_out.
template <typename T>
__device__ __forceinline__ void tile_strided(
    const T* __restrict__ a, long long sai, long long sar,
    const T* __restrict__ b, long long sbr, long long sbj,
    T* __restrict__ y, int ldy, int m0, int n0, int m_valid, int m_out,
    int r_len, int n_valid, int n_out) {
  __shared__ float As[F_BK][BM + 4];   // As[r][i]
  __shared__ float Bs[F_BK][BN + 4];   // Bs[r][j]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // a thread's loads walk the operand's unit-stride side where it has one
  const bool a_i_fast = sai == 1, b_j_fast = sbj == 1;
  const int n_k = (r_len + F_BK - 1) / F_BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int r0 = kt * F_BK;
    for (int t = tid; t < BM * F_BK; t += F_THREADS) {
      const int i = a_i_fast ? t % BM : t / F_BK;
      const int r = a_i_fast ? t / BM : t % F_BK;
      const int gi = m0 + i, gr = r0 + r;
      As[r][i] = (gi < m_valid && gr < r_len)
                     ? to_f(a[gi * sai + gr * sar]) : 0.f;
    }
    for (int t = tid; t < F_BK * BN; t += F_THREADS) {
      const int j = b_j_fast ? t % BN : t / F_BK;
      const int r = b_j_fast ? t / BN : t % F_BK;
      const int gj = n0 + j, gr = r0 + r;
      Bs[r][j] = (gj < n_valid && gr < r_len)
                     ? to_f(b[gr * sbr + gj * sbj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = n0 + tx * 4 + j;
      if (gi < m_out && gj < n_out)
        y[(size_t)gi * ldy + gj] = from_float<T>(
            gi < m_valid && gj < n_valid ? acc[i][j] : 0.f);
    }
  }
}

// dx[e, c, k] = sum_f dy[e, c, f] w[e, k, f] for c < counts[e], zeros past
// it (no byte of dy read there); dy and dx contiguous
template <typename T>
__global__ void __launch_bounds__(F_THREADS)
expert_dgrad_tile(const T* __restrict__ dy, const T* __restrict__ w,
                  T* __restrict__ dx, const int* __restrict__ counts, int C,
                  int K, int F, long long w_se, int w_sk) {
  const int e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), C);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  T* dxe = dx + (size_t)e * C * K;
  if (m0 >= cnt) {
    store_zero_tile(dxe, m0, n0, C, K, K);
    return;
  }
  tile_strided<T>(dy + (size_t)e * C * F, F, 1, w + e * w_se, 1, w_sk, dxe,
                  K, m0, n0, cnt, C, F, K, K);
}

// dw[e, k, f] = sum_{c < counts[e]} x[e, c, k] dy[e, c, f]; dy and dw
// contiguous; a dead expert's tile is zeros, nothing read
template <typename T>
__global__ void __launch_bounds__(F_THREADS)
expert_wgrad_tile(const T* __restrict__ x, const T* __restrict__ dy,
                  T* __restrict__ dw, const int* __restrict__ counts, int C,
                  int K, int F, long long x_se, int x_sc) {
  const int e = blockIdx.z;
  const int cnt = min(max(counts[e], 0), C);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  T* dwe = dw + (size_t)e * K * F;
  if (cnt == 0) {
    store_zero_tile(dwe, m0, n0, K, F, F);
    return;
  }
  tile_strided<T>(x + e * x_se, 1, x_sc, dy + (size_t)e * C * F, F, 1, dwe,
                  F, m0, n0, K, K, cnt, F, F);
}

}  // namespace

// The tile variant.  x (E, C, K) with strides (x_se, x_sc, 1); w (E, K, F)
// with strides (w_se, w_sk, 1); y (E, C, F) contiguous; counts int32[E] on
// the device.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); -1 for an
// unsupported dtype.
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

// The stream variant: C <= 16, K split into `splits` chunks of `kc` rows
// (kc <= 512); `ws` an fp32 workspace of splits x E x C x F when splits > 1
// (unused otherwise); vec_ok when w's base and its row and expert strides
// allow 16-byte loads.  Strides and returns as above; -1 for an
// unsupported dtype, C or kc.
extern "C" int repro_expert_matmul_stream(
    const void* x, const void* w, void* y, void* ws, const void* counts,
    int E, int C, int K, int F, long long x_se, int x_sc, long long w_se,
    int w_sk, int splits, int kc, int vec_ok, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  if (kc > S_KC_MAX || kc < 1 || splits < 1) return -1;
  if (dtype == 1)
    return launch_stream<__nv_bfloat16>(x, w, y, ws, cn, E, C, K, F, x_se,
                                        x_sc, w_se, w_sk, splits, kc, vec_ok,
                                        s);
  if (dtype == 0)
    return launch_stream<float>(x, w, y, ws, cn, E, C, K, F, x_se, x_sc,
                                w_se, w_sk, splits, kc, vec_ok, s);
  return -1;
}

// The tma variant (bf16): bases 16-byte aligned, row and expert strides
// non-zero multiples of 8 elements, K, F >= 1; 128 x 128 tiles.  Strides
// and returns as above; -2 when the tensor maps cannot be encoded.
extern "C" int repro_expert_matmul_tma(const void* x, const void* w, void* y,
                                       const void* counts, int E, int C,
                                       int K, int F, long long x_se,
                                       int x_sc, long long w_se, int w_sk,
                                       void* stream) {
  return launch_tma(x, w, y, static_cast<const int*>(counts), E, C, K, F,
                    x_se, x_sc, w_se, w_sk, static_cast<cudaStream_t>(stream));
}

// The backward's tma kernels (bf16; bases 16-byte aligned, w's or x's row
// and expert strides non-zero multiples of 8 elements, F a multiple of 8;
// dy (E, C, F), dx (E, C, K) and dw (E, K, F) contiguous; K, F >= 1):
// dgrad dx = dy w^T over the rows c < counts[e] (exact zeros past them),
// wgrad dw[e] = x[e, :counts[e]]^T dy[e, :counts[e]] (a dead expert's dw
// exactly 0).  Returns cudaGetLastError() after the launch; -2 when the
// tensor maps cannot be encoded.
extern "C" int repro_expert_matmul_dgrad_tma(const void* dy, const void* w,
                                             void* dx, const void* counts,
                                             int E, int C, int K, int F,
                                             long long w_se, int w_sk,
                                             void* stream) {
  return launch_dgrad_tma(dy, w, dx, static_cast<const int*>(counts), E, C,
                          K, F, w_se, w_sk, static_cast<cudaStream_t>(stream));
}

// The persistent dgrad (bf16; as the tma dgrad, and K a multiple of 8
// (dx is stored by TMA), E <= 512): `grid` blocks, at most one an SM,
// over items of 128 rows x 256 columns.  Returns as above; -1 for an
// unsupported shape or grid.
extern "C" int repro_expert_matmul_dgrad_persistent(
    const void* dy, const void* w, void* dx, const void* counts, int E,
    int C, int K, int F, long long w_se, int w_sk, int grid, void* stream) {
  if (E < 1 || E > P_E_MAX || C < 1 || K < 1 || F < 1 || K % 8 || grid < 1)
    return -1;
  CUtensorMap map_dy, map_w, map_dx;
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)w_sk * 2,
                                   (cuuint64_t)w_se * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!encode_slab_map(&map_dy, dy, E, C, F) ||
      !encode_bf16_map(&map_w, w, 3, w_dims, w_strides, box) ||
      !encode_slab_map(&map_dx, dx, E, C, K))
    return -2;
  const int* cn = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_dgrad_persistent<P_BN>(map_dy, map_w, map_dx, dx, cn, E, C,
                                       K, F, grid, s);
}

extern "C" int repro_expert_matmul_wgrad_tma(const void* x, const void* dy,
                                             void* dw, const void* counts,
                                             int E, int C, int K, int F,
                                             long long x_se, int x_sc,
                                             void* stream) {
  return launch_wgrad_tma(x, dy, dw, static_cast<const int*>(counts), E, C,
                          K, F, x_se, x_sc, static_cast<cudaStream_t>(stream));
}

// The persistent wgrad (bf16; as the tma wgrad, and E <= 512): `grid`
// blocks, at most one an SM, over items of 128 K rows x 256 F columns, the
// experts by descending count.  Returns as above; -1 for an unsupported
// shape or grid.
extern "C" int repro_expert_matmul_wgrad_persistent(
    const void* x, const void* dy, void* dw, const void* counts, int E,
    int C, int K, int F, long long x_se, int x_sc, int grid, void* stream) {
  if (E < 1 || E > P_E_MAX || C < 1 || K < 1 || F < 1 || F % 8 || grid < 1)
    return -1;
  CUtensorMap map_x, map_dy, map_dw;
  const cuuint64_t x_dims[3] = {(cuuint64_t)K, (cuuint64_t)C, (cuuint64_t)E};
  const cuuint64_t x_strides[2] = {(cuuint64_t)x_sc * 2,
                                   (cuuint64_t)x_se * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!encode_bf16_map(&map_x, x, 3, x_dims, x_strides, box) ||
      !encode_slab_map(&map_dy, dy, E, C, F) ||
      !encode_slab_map(&map_dw, dw, E, K, F))
    return -2;
  constexpr size_t bytes = PersistTile<P_BN>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      expert_wgrad_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  expert_wgrad_persistent<<<grid, W_THREADS, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      map_x, map_dy, map_dw, static_cast<__nv_bfloat16*>(dw),
      static_cast<const int*>(counts), E, C, K, F);
  return static_cast<int>(cudaGetLastError());
}

// The backward's tile kernels (any strides of w or x, fp32 or bf16 on FMAs
// with fp32 sums): dgrad (op 0) and wgrad (op 1) as above; dy, dx and dw
// contiguous.  a is w for dgrad and x for wgrad, with its expert and row
// strides (a_se, a_sr).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch; -1 for an unsupported op or dtype.
extern "C" int repro_expert_matmul_bwd_tile(int op, const void* a,
                                            const void* dy, void* out,
                                            const void* counts, int E, int C,
                                            int K, int F, long long a_se,
                                            int a_sr, int dtype,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  if (op != 0 && op != 1) return -1;
  const dim3 grid = op == 0 ? dim3((K + BN - 1) / BN, (C + BM - 1) / BM, E)
                            : dim3((F + BN - 1) / BN, (K + BM - 1) / BM, E);
#define REPRO_BWD_TILE(T)                                                   \
  if (op == 0)                                                              \
    expert_dgrad_tile<T><<<grid, F_THREADS, 0, s>>>(                        \
        static_cast<const T*>(dy), static_cast<const T*>(a),                \
        static_cast<T*>(out), cn, C, K, F, a_se, a_sr);                     \
  else                                                                      \
    expert_wgrad_tile<T><<<grid, F_THREADS, 0, s>>>(                        \
        static_cast<const T*>(a), static_cast<const T*>(dy),                \
        static_cast<T*>(out), cn, C, K, F, a_se, a_sr)
  if (dtype == 1) {
    REPRO_BWD_TILE(__nv_bfloat16);
  } else if (dtype == 0) {
    REPRO_BWD_TILE(float);
  } else {
    return -1;
  }
#undef REPRO_BWD_TILE
  return static_cast<int>(cudaGetLastError());
}
