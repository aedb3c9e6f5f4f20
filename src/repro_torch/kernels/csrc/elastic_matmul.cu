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
// Four variants, chosen on the host by kernels/elastic_matmul.py:
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
// * f32_splitk (fp32 at M > 16 with 16-byte-aligned bases and row
//   strides: the MoE router at prefill, M = 2048 tokens x K = 2048 ->
//   E = 64 experts, 27 calls a prefill).  Bound: operations -- 2 M K N
//   = 0.54 GFLOP a call against 67 TFLOP/s fp32 outside the tensor cores,
//   8 us (its bytes take 5 us).  The products stay exact fp32 FMAs: TF32
//   would flip near-ties in the top-6 routing.  The tile loop gave this
//   shape 32 blocks of 64 x 64 on 132 SMs, each walking K = 2048 with no
//   load in flight behind its FMAs.  Here a block computes a 64 x 64
//   tile over one split of K: 128 threads, each a 4 x 8 register
//   micro-tile (12 16-byte shared loads, free of bank conflicts, feed
//   128 FMAs), x and w staged
//   16 rows of K at a time through a 4-stage cp.async ring whose zero
//   fill masks the K tail, the M edge and the columns past n_act.  K is
//   split so that the (tile, split) blocks fill the card at two blocks an
//   SM (f32_splitk_plan on the host: 8 splits of 256 rows over the 32
//   tiles at the router's shape, 256 blocks; sweep_splits.py times the
//   alternatives), and the
//   reduce is fused as in the tma wgrad below: each split writes its fp32
//   partial and draws a ticket from the tile's counter, the last block
//   adds the partials in split order (bit-for-bit repeatable), stores y
//   with zeros past n_act and resets the counter (graph-replayable).
//   Column tiles past n_act store zeros without loads.
// * tile (everything else: fp32 whose bases or row strides forbid
//   16-byte loads, and bf16 whose bases or row strides TMA cannot take).
//   The unpipelined 64x64 tile loop of tile_matmul.cuh (WMMA for bf16,
//   FMAs for fp32), shared with K3.  The main path never takes it
//   (chip_smoke.py asserts the per-variant counters).
//
// The TMA / wgmma machinery of tma and the streaming core of small_m live
// in hopper_gemm.cuh, shared with K3 (expert_matmul.cu).
//
// Backward (training; the TPU kernel has none, JAX differentiates through
// XLA).  Both read the same device widths as the forward:
//
// * dgrad: dx[m, k] = sum_{n < n_act} dy[m, n] w[k, n] for k < k_act,
//   exact zeros for k_act <= k < kx (x's width).  wgrad: dw[k, n] =
//   sum_m x[m, k] dy[m, n] on the active block, exact zeros elsewhere in
//   the full weight's shape, fp32 accumulation.
// * Bound: at the training step's shapes (M = 50,432 token rows against
//   weights of 192 x 192 to 1536 x 384) each product does about
//   k n / (k + n) operations a byte: 96 at 192 x 192, 192 at 384 x 384,
//   307 at 1536 x 384, against the H100's ridge of ~295.  So the large
//   layers sit at the ridge (operations and bytes both bound them) and
//   the narrow ones are bound by the bytes of dy and x (dx): what counts
//   is to stream M's rows at full bandwidth into the tensor cores and to
//   read each row of dy and x from device memory once.
// * tma (bf16, TMA-readable bases and strides: every call of the step).
//   Both products run on the forward's ring (tma_produce / tma_consume:
//   one producer thread's TMA loads, full / empty mbarriers, consumer
//   warpgroups on wgmma m64n128k16, fp32 accumulators in registers), in
//   128 x 128 tiles.
//   dgrad is the forward with a K-major B: both its operands are read
//   along the reduction (dy along its rows exactly as the forward reads
//   x, w along its rows as one {64, 128} box) and the widths swap roles.
//   Its reduction is short (384 or 1536) against M = 50,432 rows, so a
//   block's fixed costs weigh: the kernel is persistent (one block an SM
//   walks the tiles, its producer loading the next tile while the
//   consumers finish the last), the tiles go column-fastest (the blocks
//   in flight share their rows of dy in L2: M-fastest read dy once per
//   column tile from memory), and the epilogue stages the bf16 tile in
//   shared memory (128-byte swizzle, no bank conflicts) for one TMA store
//   that runs behind the next tile's products, where 4-byte stores from
//   registers left the tensor cores idle.  Tiles past k_act store zeros
//   without loads; w's map covers all its rows, so a tile that straddles
//   k_act reads whole boxes (TMA's partial boxes cost ~35% at k_act =
//   288) and stores zeros past it.
//   wgrad reads both operands down their columns (MN-major: x as the
//   forward reads w, in {64, 64} boxes, A's transpose bit set).  Its 9 to
//   36 output tiles cannot fill 132 SMs, so M is split: each block takes
//   one (tile, split) pair, the tiles of a split side by side (they share
//   its rows in L2), as many splits as fill one wave (wgrad_tma_plan: a
//   block over a whole wave costs a wave).  Chunks are whole 64-row boxes
//   (TMA cannot clip a box to a chunk's end, so only the last chunk may
//   meet M's edge).  The reduce is fused: each split writes its fp32
//   partial, takes a ticket from the tile's counter, and the last block
//   adds the partials in split order (deterministic; each thread keeps
//   16 loads in flight), stores dw and resets the counter (a CUDA graph
//   replays it); further blocks zero the tiles outside the active block.
//   The tiles and plans come from the sweep in sweep_splits.py (PERF.md).
// * wmma_bf16 (bf16 that TMA cannot read) and fma_f32 (fp32, the parity
//   path): the first backward, one 128 x 128 tile GEMM (64 x 64 in fp32)
//   whose operands are read in place in whichever orientation the
//   product needs, staged 32 deep by 16-byte cp.async into a double
//   buffer whose zero fill masks everything past the widths, on WMMA
//   (bf16 in, fp32 accumulate) or FMAs; wgrad splits M (wgrad_plan) into
//   an fp32 workspace and a second kernel adds the splits in order.
//
// Later work: a persistent, cluster-multicast schedule for the tma variant
// (one block per SM walking the output tiles, the epilogue of one tile
// overlapping the loads of the next, TMA multicast of the x tile).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include <mma.h>

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

// The three products on the tma ring, and what each reads (A is the
// tile's rows, B its columns, both over the reduction):
//   FWD    y  = x w      A = x, K-major: one box {64, BM};
//                        B = w, MN-major: BN / 64 boxes {64, 64};
//   DGRAD  dx = dy w^T   A = dy, K-major, as FWD;
//                        B = w along its rows, K-major: one box {64, BN};
//   WGRAD  dw = x^T dy   A = x down its columns, MN-major: CWG boxes
//                        {64, 64}; B = dy, MN-major, as FWD.
enum : int { FWD = 0, DGRAD = 1, WGRAD = 2 };

// zeros at rows r0 .. r0 + R - 1 below r_out and columns c0 .. c0 + C - 1
// below c_out of y (row stride ld), by all THREADS threads of the block
template <int R, int C, int THREADS>
__device__ __forceinline__ void zero_tile(__nv_bfloat16* __restrict__ y,
                                          int ld, int r0, int c0, int r_out,
                                          int c_out) {
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = r0 + i / C, c = c0 + i % C;
    if (r < r_out && c < c_out) y[(size_t)r * ld + c] = __float2bfloat16(0.f);
  }
}

// the ring of a tma block: dynamic shared memory from a 1024-byte boundary
// (the 128-byte swizzle's atom)
__device__ __forceinline__ unsigned char* ring_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// A tma block's ring: G::STAGES stages of A and B tiles from ring_base(),
// then the full and empty mbarriers, initialised by thread 0
template <class G>
struct Ring {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
};

template <class G, int CWG>
__device__ __forceinline__ Ring<G> ring_init() {
  Ring<G> r;
  r.smem = ring_base();
  r.full = reinterpret_cast<uint64_t*>(r.smem + G::STAGES * G::STAGE_BYTES);
  r.empty = r.full + G::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4 * CWG);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer thread's loads of one tile: n_k steps of G_BK along the
// reduction from k0 for the output tile at (m0, n0), into ring steps it0
// .. it0 + n_k - 1 (a stage is refilled once the consumers release it)
template <class G, int CWG, int BN, int OP>
__device__ __forceinline__ void tma_produce(const Ring<G>& ring,
                                            const CUtensorMap* map_a,
                                            const CUtensorMap* map_b,
                                            int m0, int n0, int k0, int n_k,
                                            int it0) {
  for (int kt = 0; kt < n_k; ++kt) {
    const int it = it0 + kt;
    const int s = it % G::STAGES;
    const int k = k0 + kt * G_BK;
    mbar_wait(&ring.empty[s], ((it / G::STAGES) & 1) ^ 1);
    unsigned char* a = ring.smem + s * G::STAGE_BYTES;
    unsigned char* b = a + G::A_BYTES;
    mbar_expect_tx(&ring.full[s], G::STAGE_BYTES);
    if constexpr (OP == WGRAD) {
#pragma unroll
      for (int h = 0; h < CWG; ++h)
        tma_load_2d(a + h * 8192, map_a, &ring.full[s], m0 + 64 * h, k);
    } else {
      tma_load_2d(a, map_a, &ring.full[s], k, m0);
    }
    if constexpr (OP == DGRAD) {
      tma_load_2d(b, map_b, &ring.full[s], k, n0);
    } else {
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        tma_load_2d(b + h * 8192, map_b, &ring.full[s], n0 + 64 * h, k);
    }
  }
}

// A consumer warpgroup's product over ring steps it0 .. it0 + n_k - 1:
// wgmma on each stage as it arrives, one group in flight, each stage
// released once its group is done (the last one too when RELEASE_LAST:
// a persistent block refills it for its next tile).  d then holds the
// warpgroup's 64 x BN rows of the tile (fp32).
template <class G, int CWG, int BN, int OP, bool RELEASE_LAST>
__device__ __forceinline__ void tma_consume(const Ring<G>& ring, int n_k,
                                            int it0, float (&d)[BN / 2]) {
  const int tid = threadIdx.x, wg = tid / 128;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int it = it0 + kt;
    const int s = it % G::STAGES;
    mbar_wait(&ring.full[s], (it / G::STAGES) & 1);
    const uint32_t a = smem_u32(ring.smem + s * G::STAGE_BYTES) +
                       wg * 64 * 128;
    const uint32_t b = smem_u32(ring.smem + s * G::STAGE_BYTES + G::A_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks) {
      // K-major (A of FWD and DGRAD, B of DGRAD): rows of 128 bytes,
      //   8-row groups 1024 bytes apart, a 16-wide K step is 32 bytes
      //   along the swizzled row;
      // MN-major (B of FWD and WGRAD, A of WGRAD): 64-column boxes 8192
      //   bytes apart (LBO), 8-row groups 1024 bytes apart (SBO), a
      //   16-row K step is 2048 bytes
      const uint64_t da = OP == WGRAD ? gmma_desc(a + ks * 2048, 8192, 1024)
                                      : gmma_desc(a + ks * 32, 16, 1024);
      const uint64_t db = OP == DGRAD ? gmma_desc(b + ks * 32, 16, 1024)
                                      : gmma_desc(b + ks * 2048, 8192, 1024);
      wgmma_step<BN, OP == WGRAD, OP != DGRAD>(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (kt > 0 && tid % 32 == 0)
      mbar_arrive(&ring.empty[(it - 1) % G::STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);
  if constexpr (RELEASE_LAST) {
    if (n_k > 0 && tid % 32 == 0)
      mbar_arrive(&ring.empty[(it0 + n_k - 1) % G::STAGES]);
  }
}

// The producer / consumer loop of one tma block over one tile: n_k steps
// of G_BK along the reduction from k0, for the output tile at (m0, n0).
// A ring of G::STAGES stages in dynamic shared memory, fed by one
// producer thread's TMA loads and guarded by full / empty mbarriers; CWG
// consumer warpgroups run wgmma on it, one group in flight.  Returns
// false on the producer warp, which has nothing left to do, and true on
// the consumers, whose d then holds rows m0 + 64 wg .. + 63 of the tile
// (fp32).
template <int CWG, int BN, int OP>
__device__ __forceinline__ bool tma_mainloop(const CUtensorMap* map_a,
                                             const CUtensorMap* map_b,
                                             int m0, int n0, int k0, int n_k,
                                             float (&d)[BN / 2]) {
  using G = GemmTile<CWG, BN>;
  const Ring<G> ring = ring_init<G, CWG>();
  const int tid = threadIdx.x;
  if (tid / 128 == CWG) {                 // producer: one thread
    if (tid == 128 * CWG)
      tma_produce<G, CWG, BN, OP>(ring, map_a, map_b, m0, n0, k0, n_k, 0);
    return false;
  }
  // consumer warpgroup tid / 128 computes rows m0 + 64 wg .. + 63
  tma_consume<G, CWG, BN, OP, false>(ring, n_k, 0, d);
  return true;
}

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
  if (n0 >= n_act) {        // dead tile: zeros, no loads
    zero_tile<G::BM, BN, G::THREADS>(y, ldy, m0, n0, M, n_out);
    return;
  }
  float d[BN / 2];
  if (!tma_mainloop<CWG, BN, FWD>(&map_x, &map_w, m0, n0, 0,
                                  (k_act + G_BK - 1) / G_BK, d))
    return;
  const int tid = threadIdx.x;
  store_acc<BN>(d, y, ldy, tid % 128, m0 + (tid / 128) * 64, n0, M, M,
                n_act, n_out);
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

// dgrad's tiles: CWG consumer warpgroups, BN columns, a ring in what is
// left of DG_SMEM after a staging area for the tile's bf16 store (BN / 64
// boxes of 64 columns, each 64 CWG rows of 128 bytes in the 128-byte
// swizzle) and one such box of zeros
constexpr int DG_SMEM = 220 * 1024;
template <int CWG, int BN>
struct DgradTile {
  static constexpr int BOX = 64 * CWG * 128;
  static constexpr int STAGING = BOX * (BN / 64);
  using G = GemmTile<CWG, BN, DG_SMEM - STAGING - BOX - 1024>;
  static constexpr int STAGING_AT =      // past the ring and its barriers
      (G::STAGES * G::STAGE_BYTES + 2 * G::STAGES * 8 + 1023) / 1024 * 1024;
  static constexpr int ZEROS_AT = STAGING_AT + STAGING;
  static constexpr size_t SMEM = ZEROS_AT + BOX + 1024;     // + align
};

// dx[m, k] = sum_{n < n_act} dy[m, n] w[k, n] for k < k_act, 0 for
// k_act <= k < kx: the forward's ring with a K-major B and the widths'
// roles swapped (the reduction runs to n_act, the live columns to k_act).
// Persistent: one block an SM walks the live tiles, column tiles fastest
// (the blocks in flight share their rows of dy in L2, and w stays there);
// its producer loads the next tile's stages while the consumers store the
// last one.  The consumers write the tile as bf16 into the staging area
// and one thread stores it with TMA (which clips at M and kx), in the
// background of the next tile's products; after each live tile it stores
// the block's share of the tiles past k_act from the box of zeros.  Live
// and dead tiles are dealt to the blocks apart: in one sequence, blocks
// whose stride hits only dead columns would leave the products to the
// others.
template <int CWG, int BN>
__global__ void __launch_bounds__(DgradTile<CWG, BN>::G::THREADS, 1)
dgrad_tma_kernel(const __grid_constant__ CUtensorMap map_dy,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_dx,
                 const int* __restrict__ widths, int mt, int nt) {
  using D = DgradTile<CWG, BN>;
  using G = typename D::G;
  const int k_act = widths[0];
  const int n_act = widths[1];
  const int n_k = (n_act + G_BK - 1) / G_BK;
  const int tid = threadIdx.x;
  unsigned char* zeros = ring_base() + D::ZEROS_AT;
  for (int i = tid; i < D::BOX / 16; i += G::THREADS)
    reinterpret_cast<uint4*>(zeros)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  const Ring<G> ring = ring_init<G, CWG>();     // (its barrier orders both)
  unsigned char* staging = ring.smem + D::STAGING_AT;
  const int lt = min((k_act + BN - 1) / BN, nt);   // live column tiles
  const int b = blockIdx.x, grid = gridDim.x;
  const int live = mt * lt, dead = mt * (nt - lt);
  const int my_live = live > b ? (live - b + grid - 1) / grid : 0;
  const int my_dead = dead > b ? (dead - b + grid - 1) / grid : 0;
  if (tid / 128 == CWG) {                 // producer: one thread
    if (tid == 128 * CWG) {
      for (int i = 0; i < my_live; ++i) {
        const int t = b + i * grid;
        tma_produce<G, CWG, BN, DGRAD>(ring, &map_dy, &map_w,
                                       (t / lt) * G::BM, (t % lt) * BN, 0,
                                       n_k, i * n_k);
      }
    }
    return;
  }
  const int t32 = tid % 128, wg = tid / 128;
  // this thread's accumulator rows (+ 8 i) and column pair (+ 8 j)
  const int row = wg * 64 + (t32 / 32) * 16 + (t32 % 32) / 4;
  const int col = 2 * (t32 % 4);
  // thread 0 stores dead tiles j0 .. j1 - 1 of this block's share
  auto store_dead = [&](int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      const int t = b + j * grid;
      const int m0 = (t / (nt - lt)) * G::BM;
      const int n0 = (lt + t % (nt - lt)) * BN;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        tma_store_2d(&map_dx, zeros, n0 + 64 * h, m0);
    }
    bulk_commit();
  };
  for (int i = 0; i < my_live; ++i) {
    const int t = b + i * grid;
    const int m0 = (t / lt) * G::BM, n0 = (t % lt) * BN;
    float d[BN / 2];
    tma_consume<G, CWG, BN, DGRAD, true>(ring, n_k, i * n_k, d);
    // the last tile's store has read the staging area
    if (tid == 0) bulk_wait_read();
    asm volatile("bar.sync 1, %0;" ::"n"(128 * CWG) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h, c = col + 8 * j;   // c % 64 = col + 8 (j % 8)
        const float v0 = n0 + c < k_act ? d[4 * j + 2 * h] : 0.f;
        const float v1 = n0 + c + 1 < k_act ? d[4 * j + 2 * h + 1] : 0.f;
        // box j / 8, row r, 16-byte chunk j % 8 swizzled by r % 8
        unsigned char* p = staging + (j / 8) * D::BOX + r * 128 +
                           (((j % 8) ^ (r % 8)) * 16) + 2 * col;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;" ::"n"(128 * CWG) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        tma_store_2d(&map_dx, staging + h * D::BOX, n0 + 64 * h, m0);
      bulk_commit();
      store_dead(i * my_dead / my_live, (i + 1) * my_dead / my_live);
    }
  }
  if (tid == 0) {
    if (my_live == 0) store_dead(0, my_dead);
    bulk_wait_read();                     // before the block's smem goes
  }
}

template <int CWG, int BN>
int launch_dgrad_tma(const void* dy, const void* w, void* dx,
                     const int* widths, int M, int ldy, int ldw, int ldx,
                     int kx, int w_rows, int n_act, cudaStream_t s) {
  using D = DgradTile<CWG, BN>;
  using G = typename D::G;
  CUtensorMap map_dy, map_w, map_dx;
  if (!encode_map(&map_dy, dy, n_act, M, ldy, G::BM) ||
      !encode_map(&map_w, w, n_act, w_rows, ldw, BN) ||
      !encode_map(&map_dx, dx, kx, M, ldx, G::BM))
    return -2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dgrad_tma_kernel<CWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)D::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int mt = (M + G::BM - 1) / G::BM, nt = (kx + BN - 1) / BN;
  const int grid = mt * nt < sms ? mt * nt : sms;
  dgrad_tma_kernel<CWG, BN><<<grid, G::THREADS, D::SMEM, s>>>(
      map_dy, map_w, map_dx, widths, mt, nt);
  return static_cast<int>(cudaGetLastError());
}

// one warpgroup's 64 x BN fp32 accumulator (t = thread in the warpgroup)
// at rows r0 .. r0 + 63 of a tile p with BN columns, row-major
template <int BN>
__device__ __forceinline__ void store_partial(const float (&d)[BN / 2],
                                              float* __restrict__ p, int t,
                                              int r0) {
  const int r = r0 + (t / 32) * 16 + (t % 32) / 4;
  const int c = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(p + (size_t)(r + 8 * i) * BN + c + 8 * j) =
          make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
}

// dw[k, n] = sum_m x[m, k] dy[m, n] for k < k_act and n < n_act, 0
// elsewhere in the full Kw x Nw weight.  The active block is cut into
// tiles_i x tiles_j tiles of BM x BN and M into `splits` chunks of
// `chunk` rows (whole 64-row TMA boxes: only the last chunk meets M's
// edge).  Blocks 0 .. live * splits - 1 each compute one (tile, split),
// the tiles of a split side by side (they share its rows of x and dy in
// L2); with one split a block stores its tile itself, else it writes its
// fp32 partial to ws[split][tile] and takes a ticket from the tile's
// counter, and the block that draws the last one adds the partials in
// split order (deterministic), stores dw and resets the counter for the
// next call (a CUDA graph replays it).  No block waits on another.  The
// blocks after those write the zeros of the tiles outside the active
// block.
template <int CWG, int BN>
__global__ void __launch_bounds__(GemmTile<CWG, BN>::THREADS, 1)
wgrad_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_dy,
                 float* __restrict__ ws, __nv_bfloat16* __restrict__ dw,
                 int* __restrict__ counters, const int* __restrict__ widths,
                 int M, int Kw, int Nw, int tiles_i, int tiles_j, int splits,
                 int chunk) {
  using G = GemmTile<CWG, BN>;
  constexpr int TILE = G::BM * BN;
  const int k_act = widths[0];
  const int n_act = widths[1];
  const int live = tiles_i * tiles_j;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b >= live * splits) {     // a tile outside the active block: zeros
    int dead = b - live * splits;
    const int all_j = (Nw + BN - 1) / BN;
    const int right = tiles_i * (all_j - tiles_j);   // beside the block
    int ti, tj;
    if (dead < right) {
      ti = dead / (all_j - tiles_j);
      tj = tiles_j + dead % (all_j - tiles_j);
    } else {                                          // below it
      dead -= right;
      ti = tiles_i + dead / all_j;
      tj = dead % all_j;
    }
    zero_tile<G::BM, BN, G::THREADS>(dw, Nw, ti * G::BM, tj * BN, Kw, Nw);
    return;
  }
  const int tile = b % live, split = b / live;
  const int i0 = (tile / tiles_j) * G::BM, j0 = (tile % tiles_j) * BN;
  const int r0 = split * chunk;
  const int rows = min(chunk, M - r0);
  float d[BN / 2];
  if (!tma_mainloop<CWG, BN, WGRAD>(&map_x, &map_dy, i0, j0, r0,
                                    (rows + G_BK - 1) / G_BK, d))
    return;
  const int t = tid % 128, wg = tid / 128;
  if (splits == 1) {
    store_acc<BN>(d, dw, Nw, t, i0 + 64 * wg, j0, k_act, Kw, n_act, Nw);
    return;
  }
  store_partial<BN>(d, ws + ((size_t)split * live + tile) * TILE, t,
                    64 * wg);
  __shared__ int last;
  __threadfence();          // the partial is visible before the ticket
  asm volatile("bar.sync 1, %0;" ::"n"(128 * CWG) : "memory");
  if (tid == 0) last = atomicAdd(&counters[tile], 1) == splits - 1;
  asm volatile("bar.sync 1, %0;" ::"n"(128 * CWG) : "memory");
  if (!last) return;
  __threadfence();
  // each thread sums PER runs of 4 columns over the splits, in split
  // order, with all PER loads of a split in flight at once
  constexpr int PER = TILE / (128 * CWG * 4);
  static_assert(PER * 128 * CWG * 4 == TILE, "whole float4 runs a thread");
  float4 acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4* part = reinterpret_cast<const float4*>(
        ws + ((size_t)sp * live + tile) * TILE);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const float4 v = __ldcg(part + tid + u * 128 * CWG);
      acc[u].x += v.x; acc[u].y += v.y; acc[u].z += v.z; acc[u].w += v.w;
    }
  }
  const bool vec = Nw % 4 == 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = 4 * (tid + u * 128 * CWG);
    const int r = i0 + e / BN, c = j0 + e % BN;
    if (r >= Kw) continue;
    const bool row = r < k_act;
    const float v[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
    __nv_bfloat16 o[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      o[h] = __float2bfloat16(row && c + h < n_act ? v[h] : 0.f);
    __nv_bfloat16* q = dw + (size_t)r * Nw + c;
    if (vec && c + 3 < Nw) {
      uint2 packed;
      memcpy(&packed, o, sizeof(packed));
      *reinterpret_cast<uint2*>(q) = packed;
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (c + h < Nw) q[h] = o[h];
    }
  }
  if (tid == 0) counters[tile] = 0;
}

template <int CWG, int BN>
int launch_wgrad_tma(const void* x, const void* dy, void* ws, void* dw,
                     int* counters, const int* widths, int M, int ldx,
                     int ldy, int Kw, int Nw, int k_act, int n_act,
                     int x_cols, int dy_cols, int splits, int chunk,
                     cudaStream_t s) {
  using G = GemmTile<CWG, BN>;
  if (chunk % G_BK || splits < 1 || (long long)(splits - 1) * chunk >= M ||
      (long long)splits * chunk < M || (splits > 1 && ws == nullptr))
    return -1;
  CUtensorMap map_x, map_dy;
  if (!encode_map(&map_x, x, x_cols, M, ldx, 64) ||
      !encode_map(&map_dy, dy, dy_cols, M, ldy, 64))
    return -2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_tma_kernel<CWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ti = (k_act + G::BM - 1) / G::BM, tj = (n_act + BN - 1) / BN;
  const long long all = (long long)((Kw + G::BM - 1) / G::BM) *
                        ((Nw + BN - 1) / BN);
  const long long blocks = (long long)ti * tj * splits + all - ti * tj;
  wgrad_tma_kernel<CWG, BN><<<(unsigned)blocks, G::THREADS, G::SMEM, s>>>(
      map_x, map_dy, static_cast<float*>(ws),
      static_cast<__nv_bfloat16*>(dw), counters, widths, M, Kw, Nw, ti, tj,
      splits, chunk);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward ----
//
// Both backward products are one tiled GEMM
//     C[i, j] = sum_{r_begin <= r < r_end} A(i, r) * B(r, j)
// whose operands are read in place from row-major tensors: A(i, r) is
// a[i * lda + r] (A_ROW) or a[r * lda + i]; B(r, j) is b[r * ldb + j]
// (B_ROW) or b[j * ldb + r].  dgrad is A = dy (A_ROW), B = w read along
// its rows (col); wgrad is A = x read down its columns (col), B = dy
// (B_ROW).  Elements at i >= I_lim, j >= J_lim or r >= r_end are staged
// as zeros, so nothing past the active widths is read.

constexpr int W_BM = 128;         // output tile (bf16)
constexpr int W_BN = 128;
constexpr int W_BK = 32;          // reduction step
constexpr int W_THREADS = 256;    // 8 warps, 2 x 4 over the tile, 64 x 32 each
constexpr int W_PAD = 8;          // bf16 elements of row padding
constexpr int W_TILE_ELEMS = W_BM * (W_BK + W_PAD);   // >= W_BK * (W_BM + W_PAD)
constexpr int W_STAGE_ELEMS = 2 * W_TILE_ELEMS;       // A and B
constexpr int W_SMEM = 2 * W_STAGE_ELEMS * 2;         // two stages, bytes
constexpr int WF_BM = 64;         // output tile (fp32, FMA)
constexpr int WF_BK = 16;
constexpr int WF_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (nothing is read at bytes == 0)
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage ROWS x COLS of a row-major view (element (u, c) at g[u * ld + c])
// into dst with row stride LD; (u, c) with u >= u_lim or c >= c_lim are
// zeros.  VEC: 16-byte cp.async (g 16-byte aligned, ld and c0 multiples of
// 8); else element by element.
template <int ROWS, int COLS, int LD, bool VEC>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* g,
                                           long long ld, int u0, int c0,
                                           int u_lim, int c_lim) {
  if constexpr (VEC) {
    constexpr int CH = COLS / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += W_THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const int u = u0 + r, cc = c0 + c;
      const int n = (u < u_lim && cc < c_lim) ? min(8, c_lim - cc) : 0;
      cp_async_n(dst + r * LD + c, n ? g + (long long)u * ld + cc : g, 2 * n);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += W_THREADS) {
      const int r = i / COLS, c = i % COLS;
      const int u = u0 + r, cc = c0 + c;
      dst[r * LD + c] = (u < u_lim && cc < c_lim)
                            ? g[(long long)u * ld + cc]
                            : __float2bfloat16(0.f);
    }
  }
}

using WFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

// One 128 x 128 tile of C on the tensor cores (WMMA, bf16 in, fp32
// accumulate), the reduction in steps of 32 double-buffered with cp.async.
// Warp w owns rows 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31.
template <bool A_ROW, bool B_ROW, bool VEC>
__device__ __forceinline__ void wmma_tile(
    const __nv_bfloat16* __restrict__ a, long long lda,
    const __nv_bfloat16* __restrict__ b, long long ldb, int i0, int j0,
    int r_begin, int r_end, int I_lim, int J_lim, __nv_bfloat16* sm,
    WFrag (&acc)[4][2]) {
  using namespace nvcuda;
  constexpr int LD_R = W_BK + W_PAD;    // tile stored along r
  constexpr int LD_T = W_BM + W_PAD;    // tile stored along i or j
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int fi = 0; fi < 4; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj) wmma::fill_fragment(acc[fi][fj], 0.f);
  const int n_t = r_end > r_begin ? (r_end - r_begin + W_BK - 1) / W_BK : 0;
  auto stage = [&](int t, int buf) {
    __nv_bfloat16* As = sm + buf * W_STAGE_ELEMS;
    __nv_bfloat16* Bs = As + W_TILE_ELEMS;
    const int r0 = r_begin + t * W_BK;
    if constexpr (A_ROW)
      stage_tile<W_BM, W_BK, LD_R, VEC>(As, a, lda, i0, r0, I_lim, r_end);
    else
      stage_tile<W_BK, W_BM, LD_T, VEC>(As, a, lda, r0, i0, r_end, I_lim);
    if constexpr (B_ROW)
      stage_tile<W_BK, W_BN, LD_T, VEC>(Bs, b, ldb, r0, j0, r_end, J_lim);
    else
      stage_tile<W_BN, W_BK, LD_R, VEC>(Bs, b, ldb, j0, r0, J_lim, r_end);
  };
  if (n_t > 0) stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) {
      stage(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* As = sm + (t & 1) * W_STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + W_TILE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < W_BK; kk += 16) {
      using LA = typename std::conditional<A_ROW, wmma::row_major,
                                           wmma::col_major>::type;
      using LB = typename std::conditional<B_ROW, wmma::row_major,
                                           wmma::col_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb[2];
#pragma unroll
      for (int fi = 0; fi < 4; ++fi) {
        const int i = wm * 64 + fi * 16;
        if constexpr (A_ROW)
          wmma::load_matrix_sync(fa[fi], As + i * LD_R + kk, LD_R);
        else
          wmma::load_matrix_sync(fa[fi], As + kk * LD_T + i, LD_T);
      }
#pragma unroll
      for (int fj = 0; fj < 2; ++fj) {
        const int j = wn * 32 + fj * 16;
        if constexpr (B_ROW)
          wmma::load_matrix_sync(fb[fj], Bs + kk * LD_T + j, LD_T);
        else
          wmma::load_matrix_sync(fb[fj], Bs + j * LD_R + kk, LD_R);
      }
#pragma unroll
      for (int fi = 0; fi < 4; ++fi)
#pragma unroll
        for (int fj = 0; fj < 2; ++fj)
          wmma::mma_sync(acc[fi][fj], fa[fi], fb[fj], acc[fi][fj]);
    }
    __syncthreads();   // this stage is refilled two steps on
  }
}

// dx[m, k] = sum_{n < n_act} dy[m, n] w[k, n] for k < k_act, 0 for
// k_act <= k < kx; grid (cdiv(kx, 128), cdiv(M, 128)).
template <bool VEC>
__global__ void __launch_bounds__(W_THREADS)
dgrad_wmma(const __nv_bfloat16* __restrict__ dy,
           const __nv_bfloat16* __restrict__ w,
           __nv_bfloat16* __restrict__ dx, const int* __restrict__ widths,
           int M, int ldy, int ldw, int ldx, int kx) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 sm[2 * W_STAGE_ELEMS];
  const int k_act = widths[0], n_act = widths[1];
  const int i0 = blockIdx.y * W_BM, j0 = blockIdx.x * W_BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (j0 >= k_act) {       // columns past k_act: zeros, no loads
    for (int i = tid; i < W_BM * W_BN; i += W_THREADS) {
      const int r = i0 + i / W_BN, c = j0 + i % W_BN;
      if (r < M && c < kx) dx[(size_t)r * ldx + c] = __float2bfloat16(0.f);
    }
    return;
  }
  WFrag acc[4][2];
  wmma_tile<true, false, VEC>(dy, ldy, w, ldw, i0, j0, 0, n_act, M, k_act,
                              sm, acc);
  __syncthreads();         // the stages become per-warp staging
  float* stg = reinterpret_cast<float*>(sm) + warp * 16 * 20;
  const int wm = warp / 4, wn = warp % 4;
  const int rr = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int fi = 0; fi < 4; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj) {
      wmma::store_matrix_sync(stg, acc[fi][fj], 20, wmma::mem_row_major);
      __syncwarp();
      const int gi = i0 + wm * 64 + fi * 16 + rr;
      const int gj = j0 + wn * 32 + fj * 16 + c0;
      if (gi < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gj + e < kx)
            dx[(size_t)gi * ldx + gj + e] = __float2bfloat16(
                gj + e < k_act ? stg[rr * 20 + c0 + e] : 0.f);
      }
      __syncwarp();
    }
}

// Partial dw over rows [split * chunk, (split + 1) * chunk) of x and dy
// into ws[split] (fp32, ipad x jpad); grid (jpad / 128, ipad / 128,
// splits), tiles past the active block return at once.
template <bool VEC>
__global__ void __launch_bounds__(W_THREADS)
wgrad_wmma(const __nv_bfloat16* __restrict__ x,
           const __nv_bfloat16* __restrict__ dy, float* __restrict__ ws,
           const int* __restrict__ widths, int M, int ldx, int ldy,
           int chunk, int ipad, int jpad) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 sm[2 * W_STAGE_ELEMS];
  const int k_act = widths[0], n_act = widths[1];
  const int i0 = blockIdx.y * W_BM, j0 = blockIdx.x * W_BN;
  if (i0 >= k_act || j0 >= n_act) return;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(M, r_begin + chunk);
  WFrag acc[4][2];
  wmma_tile<false, true, VEC>(x, ldx, dy, ldy, i0, j0, r_begin, r_end,
                              k_act, n_act, sm, acc);
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  float* out = ws + (size_t)blockIdx.z * ipad * jpad;
#pragma unroll
  for (int fi = 0; fi < 4; ++fi)
#pragma unroll
    for (int fj = 0; fj < 2; ++fj)
      wmma::store_matrix_sync(
          out + (size_t)(i0 + wm * 64 + fi * 16) * jpad + j0 + wn * 32 +
              fj * 16,
          acc[fi][fj], jpad, wmma::mem_row_major);
}

// The fp32 counterpart of wmma_tile on FMAs: one 64 x 64 tile, each
// thread 4 x 4 outputs, the reduction in steps of 16 staged as As[r][i],
// Bs[r][j] (the loads walk the operand's contiguous index fastest).
template <bool A_ROW, bool B_ROW>
__device__ __forceinline__ void fma_tile(const float* __restrict__ a,
                                         long long lda,
                                         const float* __restrict__ b,
                                         long long ldb, int i0, int j0,
                                         int r_begin, int r_end, int I_lim,
                                         int J_lim, float (&acc)[4][4]) {
  __shared__ float As[WF_BK][WF_BM + 4];
  __shared__ float Bs[WF_BK][WF_BM + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += WF_BK) {
    for (int idx = tid; idx < WF_BM * WF_BK; idx += WF_THREADS) {
      const int il = A_ROW ? idx / WF_BK : idx % WF_BM;
      const int rl = A_ROW ? idx % WF_BK : idx / WF_BM;
      const int gi = i0 + il, gr = r0 + rl;
      As[rl][il] = (gi < I_lim && gr < r_end)
                       ? (A_ROW ? a[(long long)gi * lda + gr]
                                : a[(long long)gr * lda + gi])
                       : 0.f;
    }
    for (int idx = tid; idx < WF_BM * WF_BK; idx += WF_THREADS) {
      const int jl = B_ROW ? idx % WF_BM : idx / WF_BK;
      const int rl = B_ROW ? idx / WF_BM : idx % WF_BK;
      const int gj = j0 + jl, gr = r0 + rl;
      Bs[rl][jl] = (gj < J_lim && gr < r_end)
                       ? (B_ROW ? b[(long long)gr * ldb + gj]
                                : b[(long long)gj * ldb + gr])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WF_BK; ++kk) {
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
}

__global__ void __launch_bounds__(WF_THREADS)
dgrad_fma(const float* __restrict__ dy, const float* __restrict__ w,
          float* __restrict__ dx, const int* __restrict__ widths, int M,
          int ldy, int ldw, int ldx, int kx) {
  const int k_act = widths[0], n_act = widths[1];
  const int i0 = blockIdx.y * WF_BM, j0 = blockIdx.x * WF_BM;
  float acc[4][4];
  fma_tile<true, false>(dy, ldy, w, ldw, i0, j0, 0, j0 < k_act ? n_act : 0,
                        M, k_act, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gi < M && gj < kx)
        dx[(size_t)gi * ldx + gj] = gj < k_act ? acc[i][j] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(WF_THREADS)
wgrad_fma(const float* __restrict__ x, const float* __restrict__ dy,
          float* __restrict__ ws, const int* __restrict__ widths, int M,
          int ldx, int ldy, int chunk, int ipad, int jpad) {
  const int k_act = widths[0], n_act = widths[1];
  const int i0 = blockIdx.y * WF_BM, j0 = blockIdx.x * WF_BM;
  if (i0 >= k_act || j0 >= n_act) return;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(M, r_begin + chunk);
  float acc[4][4];
  fma_tile<false, true>(x, ldx, dy, ldy, i0, j0, r_begin, r_end, k_act,
                        n_act, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = ws + (size_t)blockIdx.z * ipad * jpad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(i0 + ty * 4 + i) * jpad + j0 + tx * 4 + j] = acc[i][j];
}

// dw[k, n] = sum over splits of ws[split, k, n] in split order for
// k < k_act and n < n_act, 0 elsewhere in the full (Kw, Nw) weight
template <typename T>
__global__ void wgrad_reduce(const float* __restrict__ ws, T* __restrict__ dw,
                             const int* __restrict__ widths, int Kw, int Nw,
                             int splits, int ipad, int jpad) {
  const int k_act = widths[0], n_act = widths[1];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Kw * Nw) return;
  const int k = (int)(i / Nw), n = (int)(i % Nw);
  float s = 0.f;
  if (k < k_act && n < n_act) {
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      s += ws[((size_t)sp * ipad + k) * jpad + n];
  }
  dw[i] = from_float<T>(s);
}

// ---------------------------------------------------------- f32_splitk ----

constexpr int SK_BM = 64;            // output tile rows
constexpr int SK_BN = 64;            // output tile columns
constexpr int SK_BK = 16;            // rows of K a stage
constexpr int SK_STAGES = 4;         // the cp.async ring
constexpr int SK_THREADS = 128;      // 16 x 8 threads, 4 x 8 outputs each
constexpr int SK_TM = SK_BM / 16;    // rows a thread
constexpr int SK_LDA = SK_BK + 4;    // x tile row stride (floats)
constexpr int SK_STAGE = SK_BM * SK_LDA + SK_BK * SK_BN;  // floats
constexpr int SK_SMEM = SK_STAGES * SK_STAGE * 4;         // 36,864 bytes
constexpr int SK_TILE = SK_BM * SK_BN;

// y (M x n_out, ldy apart) = x[:, :k_act] w[:k_act, :n_act], zeros past
// n_act, in fp32 on FMAs.  The live tiles (tiles_m x tiles_n of 64 x 64)
// times `splits` chunks of `kc` rows of K: blocks 0 .. live * splits - 1
// each compute one (tile, split), the tiles of a split side by side (they
// share its rows of w in L2).  With one split a block stores its tile;
// else it writes its fp32 partial to ws[split][tile], takes a ticket from
// the tile's counter, and the block that draws the last one adds the
// partials in split order (deterministic), stores y and resets the
// counter for the next call (a CUDA graph replays it).  The blocks after
// those store the zeros of the column tiles past n_act.
__global__ void __launch_bounds__(SK_THREADS, 2)
f32_splitk_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, float* __restrict__ ws,
                  int* __restrict__ counters, const int* __restrict__ widths,
                  int M, int ldx, int ldw, int ldy, int n_out, int tiles_m,
                  int tiles_n, int splits, int kc) {
  extern __shared__ __align__(16) float sk_smem[];
  const int k_act = widths[0], n_act = widths[1];
  const int tid = threadIdx.x;
  const int live = tiles_m * tiles_n;
  const int b = blockIdx.x;
  if (b >= live * splits) {
    const int dead = b - live * splits;
    const int all_n = (n_out + SK_BN - 1) / SK_BN;
    const int tm = dead / (all_n - tiles_n);
    const int tn = tiles_n + dead % (all_n - tiles_n);
    for (int i = tid; i < SK_TILE; i += SK_THREADS) {
      const int r = tm * SK_BM + i / SK_BN, c = tn * SK_BN + i % SK_BN;
      if (r < M && c < n_out) y[(size_t)r * ldy + c] = 0.f;
    }
    return;
  }
  const int tile = b % live, split = b / live;
  const int m0 = (tile / tiles_n) * SK_BM, n0 = (tile % tiles_n) * SK_BN;
  const int kb = split * kc, ke = min(kb + kc, k_act);
  const int nk = ke > kb ? (ke - kb + SK_BK - 1) / SK_BK : 0;
  // thread (ty, tx) owns rows ty + 16 i and columns tx * 4 .. + 3 and
  // 32 + tx * 4 .. + 3: a warp's 16-byte shared loads of x rows hit 4
  // distinct bank groups and its loads of w rows 128 contiguous bytes
  const int tx = tid % 8, ty = tid / 8;

  // stage t of this split into ring slot `slot`: x as [64][SK_LDA]
  // (two 16-byte chunks a thread), w as [16][64] (two); zero fill past
  // M, past ke and past n_act, so nothing outside them is read
  auto load = [&](int t, int slot) {
    float* As = sk_smem + slot * SK_STAGE;
    float* Bs = As + SK_BM * SK_LDA;
    const int k0 = kb + t * SK_BK;
#pragma unroll
    for (int u = 0; u < SK_BM * SK_BK / 4 / SK_THREADS; ++u) {
      const int i = tid + u * SK_THREADS;
      const int r = i / 4, c = (i % 4) * 4;
      const int m = m0 + r, k = k0 + c;
      const int n = m < M ? max(0, min(4, ke - k)) : 0;
      cp_async_n(As + r * SK_LDA + c, n ? x + (size_t)m * ldx + k : x,
                 4 * n);
    }
#pragma unroll
    for (int u = 0; u < SK_BK * SK_BN / 4 / SK_THREADS; ++u) {
      const int i = tid + u * SK_THREADS;
      const int r = i / 16, c = (i % 16) * 4;
      const int k = k0 + r, col = n0 + c;
      const int n = k < ke ? max(0, min(4, n_act - col)) : 0;
      cp_async_n(Bs + r * SK_BN + c, n ? w + (size_t)k * ldw + col : w,
                 4 * n);
    }
  };

  float acc[SK_TM][8];
#pragma unroll
  for (int i = 0; i < SK_TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();        // stage t landed; slot (t - 1) % STAGES free
    const int pf = t + SK_STAGES - 1;
    if (pf < nk) load(pf, pf % SK_STAGES);
    cp_async_commit();
    const float* As = sk_smem + (t % SK_STAGES) * SK_STAGE;
    const float* Bs = As + SK_BM * SK_LDA;
#pragma unroll
    for (int k4 = 0; k4 < SK_BK; k4 += 4) {
      float4 a[SK_TM];
#pragma unroll
      for (int i = 0; i < SK_TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * SK_LDA
                                                + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* br = Bs + (k4 + kk) * SK_BN + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < SK_TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool vec = ldy % 4 == 0;
  // 4 consecutive outputs (r, c .. c + 3) of y, zeros past n_act
  auto store4 = [&](int r, int c, float4 v) {
    if (r >= M) return;
    const float o[4] = {c < n_act ? v.x : 0.f, c + 1 < n_act ? v.y : 0.f,
                        c + 2 < n_act ? v.z : 0.f, c + 3 < n_act ? v.w : 0.f};
    float* p = y + (size_t)r * ldy + c;
    if (vec && c + 3 < n_out) {
      *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (c + h < n_out) p[h] = o[h];
    }
  };
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < SK_TM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store4(m0 + ty + 16 * i, n0 + tx * 4 + 32 * h,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]));
    return;
  }
  float* part = ws + ((size_t)split * live + tile) * SK_TILE;
#pragma unroll
  for (int i = 0; i < SK_TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + (ty + 16 * i) * SK_BN + tx * 4 +
                                 32 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  __shared__ int last;
  __threadfence();          // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread sums PER runs of 4 outputs over the splits, in split
  // order, with all PER loads of a split in flight at once
  constexpr int PER = SK_TILE / (4 * SK_THREADS);
  float4 s[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4* p = reinterpret_cast<const float4*>(
        ws + ((size_t)sp * live + tile) * SK_TILE);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const float4 v = __ldcg(p + tid + u * SK_THREADS);
      s[u].x += v.x; s[u].y += v.y; s[u].z += v.z; s[u].w += v.w;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = 4 * (tid + u * SK_THREADS);
    store4(m0 + e / SK_BN, n0 + e % SK_BN, s[u]);
  }
  if (tid == 0) counters[tile] = 0;
}

int launch_f32_splitk(const float* x, const float* w, float* y, float* ws,
                      int* counters, const int* widths, int M, int ldx,
                      int ldw, int ldy, int n_out, int k_act, int n_act,
                      int splits, int kc, cudaStream_t s) {
  if (kc % SK_BK || splits < 1 || (long long)splits * kc < k_act ||
      n_act > n_out || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return -1;
  static const cudaError_t attr = cudaFuncSetAttribute(
      f32_splitk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SK_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles_m = (M + SK_BM - 1) / SK_BM;
  const int tiles_n = (n_act + SK_BN - 1) / SK_BN;
  const int all_n = (n_out + SK_BN - 1) / SK_BN;
  const long long blocks = (long long)tiles_m * tiles_n * splits +
                           (long long)tiles_m * (all_n - tiles_n);
  if (blocks == 0) return 0;
  f32_splitk_kernel<<<(unsigned)blocks, SK_THREADS, SK_SMEM, s>>>(
      x, w, y, ws, counters, widths, M, ldx, ldw, ldy, n_out, tiles_m,
      tiles_n, splits, kc);
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

// K1's data gradient: dx (M x kx, row stride ldx) from dy (M rows, ldy
// apart) and w (rows ldw apart), at the widths in `widths`.  dtype 1
// (bf16) runs on the tensor cores (WMMA), `vec` when dy's and w's bases
// are 16-byte aligned and ldy, ldw multiples of 8; dtype 0 (fp32) on
// FMAs.  Returns cudaGetLastError() after the launch; -1 for a dtype.
extern "C" int repro_elastic_matmul_dgrad(const void* dy, const void* w,
                                          void* dx, const void* widths,
                                          int M, int ldy, int ldw, int ldx,
                                          int kx, int vec, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wd = static_cast<const int*>(widths);
  if (dtype == 1) {
    const dim3 grid((kx + W_BN - 1) / W_BN, (M + W_BM - 1) / W_BM);
    const auto* a = static_cast<const __nv_bfloat16*>(dy);
    const auto* b = static_cast<const __nv_bfloat16*>(w);
    auto* o = static_cast<__nv_bfloat16*>(dx);
    if (vec)
      dgrad_wmma<true><<<grid, W_THREADS, 0, s>>>(a, b, o, wd, M, ldy, ldw,
                                                   ldx, kx);
    else
      dgrad_wmma<false><<<grid, W_THREADS, 0, s>>>(a, b, o, wd, M, ldy, ldw,
                                                    ldx, kx);
  } else if (dtype == 0) {
    const dim3 grid((kx + WF_BM - 1) / WF_BM, (M + WF_BM - 1) / WF_BM);
    dgrad_fma<<<grid, WF_THREADS, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w),
        static_cast<float*>(dx), wd, M, ldy, ldw, ldx, kx);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's weight gradient: dw (Kw x Nw, contiguous) from x (M rows, ldx
// apart) and dy (M rows, ldy apart), zeros outside the active block.  M is
// split into `splits` chunks of `chunk` rows (a multiple of 32); `ws` an
// fp32 workspace of splits x ipad x jpad, ipad and jpad the host's
// k_act and n_act rounded up to 128.  vec and dtype as for dgrad.
// Returns as above.
extern "C" int repro_elastic_matmul_wgrad(
    const void* x, const void* dy, void* ws, void* dw, const void* widths,
    int M, int ldx, int ldy, int Kw, int Nw, int ipad, int jpad, int splits,
    int chunk, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wd = static_cast<const int*>(widths);
  float* w32 = static_cast<float*>(ws);
  if (ipad % W_BM || jpad % W_BN || chunk % W_BK || splits < 1) return -1;
  if (dtype == 1) {
    const dim3 grid(jpad / W_BN, ipad / W_BM, splits);
    const auto* a = static_cast<const __nv_bfloat16*>(x);
    const auto* b = static_cast<const __nv_bfloat16*>(dy);
    if (vec)
      wgrad_wmma<true><<<grid, W_THREADS, 0, s>>>(a, b, w32, wd, M, ldx, ldy,
                                                   chunk, ipad, jpad);
    else
      wgrad_wmma<false><<<grid, W_THREADS, 0, s>>>(a, b, w32, wd, M, ldx,
                                                    ldy, chunk, ipad, jpad);
  } else if (dtype == 0) {
    const dim3 grid(jpad / WF_BM, ipad / WF_BM, splits);
    wgrad_fma<<<grid, WF_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), w32, wd,
        M, ldx, ldy, chunk, ipad, jpad);
  } else {
    return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)Kw * Nw;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (dtype == 1)
    wgrad_reduce<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        w32, static_cast<__nv_bfloat16*>(dw), wd, Kw, Nw, splits, ipad, jpad);
  else
    wgrad_reduce<float><<<blocks, 256, 0, s>>>(
        w32, static_cast<float*>(dw), wd, Kw, Nw, splits, ipad, jpad);
  return static_cast<int>(cudaGetLastError());
}

// K1's data gradient on the tma ring (bf16): dy (M rows, ldy apart) and w
// (w_rows rows, ldw apart) with 16-byte-aligned bases and row strides, dx
// M x kx (ldx apart, 16-byte-aligned base and row stride).  The tensor
// maps cover dy's first n_act columns (the host's copy of the width: the
// reduction's zero fill) and w's first n_act columns of all its w_rows >=
// k_act rows: a tile that straddles k_act reads whole rows, and its
// columns past k_act are stored as zeros.  Tiles of 128 x 128.  Returns
// as above; -2 when the tensor maps cannot be encoded.
extern "C" int repro_elastic_matmul_dgrad_tma(const void* dy, const void* w,
                                              void* dx, const void* widths,
                                              int M, int ldy, int ldw,
                                              int ldx, int kx, int w_rows,
                                              int n_act, void* stream) {
  return launch_dgrad_tma<2, 128>(
      dy, w, dx, static_cast<const int*>(widths), M, ldy, ldw, ldx, kx,
      w_rows, n_act, static_cast<cudaStream_t>(stream));
}

// K1's weight gradient on the tma ring (bf16): dw (Kw x Nw, contiguous)
// from x (M rows of x_cols, ldx apart) and dy (M rows of dy_cols, ldy
// apart) with 16-byte-aligned bases and row strides; k_act <= x_cols and
// n_act <= dy_cols >= 1 are the host's copy of the widths, which set the
// active block's tiles (a tile that straddles a width reads whole rows
// and stores zeros past it).  M is
// split into `splits` chunks of `chunk` rows, a multiple of 64, that
// cover it exactly once; `ws` an fp32 workspace of splits x tiles x 128
// x 128 when splits > 1 (tiles: the active block's 128 x 128 tiles);
// `counters` an int32 per tile, 0 before the call and left 0 after it.
// Returns as above; -1 for a plan that does not cover M, -2 when the
// tensor maps cannot be encoded.
extern "C" int repro_elastic_matmul_wgrad_tma(
    const void* x, const void* dy, void* ws, void* dw, void* counters,
    const void* widths, int M, int ldx, int ldy, int Kw, int Nw, int k_act,
    int n_act, int x_cols, int dy_cols, int splits, int chunk,
    void* stream) {
  return launch_wgrad_tma<2, 128>(
      x, dy, ws, dw, static_cast<int*>(counters),
      static_cast<const int*>(widths), M, ldx, ldy, Kw, Nw, k_act, n_act,
      x_cols, dy_cols, splits, chunk, static_cast<cudaStream_t>(stream));
}

// The f32_splitk variant (fp32, M > 16): x (M rows, ldx apart) and w (rows
// ldw apart) with 16-byte-aligned bases and row strides (ldx, ldw
// multiples of 4), y M x n_out (ldy apart).  k_act and n_act <= n_out are
// the host's copy of the widths, which set the tiles and the plan; tiles
// of 64 x 64; K is split into `splits` chunks of `kc` rows (a multiple of
// 16) that cover k_act; `ws` an fp32 workspace of splits x live tiles x
// 64 x 64 and `counters` an int32 per live tile (0 before the call, left
// 0 after it) when splits > 1.  Returns cudaGetLastError() after the
// launch; -1 for a plan that does not cover k_act.
extern "C" int repro_elastic_matmul_f32_splitk(
    const void* x, const void* w, void* y, void* ws, void* counters,
    const void* widths, int M, int ldx, int ldw, int ldy, int n_out,
    int k_act, int n_act, int splits, int kc, void* stream) {
  return launch_f32_splitk(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), static_cast<float*>(ws),
      static_cast<int*>(counters), static_cast<const int*>(widths), M, ldx,
      ldw, ldy, n_out, k_act, n_act, splits, kc,
      static_cast<cudaStream_t>(stream));
}
