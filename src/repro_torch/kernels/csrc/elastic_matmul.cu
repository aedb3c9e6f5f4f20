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
// Later work: a persistent, cluster-multicast schedule for the tma variant
// (one block per SM walking the output tiles, the epilogue of one tile
// overlapping the loads of the next, TMA multicast of the x tile).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tile_matmul.cuh"

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

constexpr int S_THREADS = 256;
constexpr int S_BN = 64;          // output columns per block
constexpr int S_KC_MAX = 512;     // rows of x staged per block
constexpr int S_UNROLL = 8;       // weight loads in flight per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of w (VEC = 16 / sizeof(T) columns), kept packed until used:
// a streamed 16-byte load where the row segment is whole and aligned,
// else masked scalar loads (columns >= n_valid read as 0)
template <typename T>
__device__ __forceinline__ uint4 load_w(const T* p, bool whole, int n_valid) {
  if (whole) return __ldcs(reinterpret_cast<const uint4*>(p));
  constexpr int VEC = 16 / sizeof(T);
  T t[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) t[j] = j < n_valid ? p[j] : T(0.f);
  uint4 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

__device__ __forceinline__ void unpack(uint4 t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x); v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z); v[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack(uint4 t, float (&v)[8]) {
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);            // bf16 -> fp32
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// x[:, k0:k0+kc] is staged in smem[MT][S_KC_MAX]; after the product the
// same buffer holds the per-warp partial sums [8 warps][MT][S_BN] (the
// same size: 8 * 64 == 512).
template <typename T, int MT>
__global__ void __launch_bounds__(S_THREADS, MT <= 4 ? 3 : 1)
small_m_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, float* __restrict__ ws,
               const int* __restrict__ widths, int M, int ldx, int ldw,
               int ldy, int n_out, int kc, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);          // columns per 16-byte load
  constexpr int TPR = S_BN / VEC;              // threads per row segment
  constexpr int RG = S_THREADS / TPR;          // rows in flight per block
  constexpr int WARPS = S_THREADS / 32;
  static_assert(WARPS * S_BN == S_KC_MAX, "shared buffer reuse");
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
  const int k0 = blockIdx.y * kc;
  const int k1 = min(k_act, k0 + kc);
  const int rows = k1 - k0;
  const int tr = tid % TPR, g = tid / TPR;
  const int c = n0 + tr * VEC;
  const bool whole = vec_ok && c + VEC <= n_act;
  const int n_valid = n_act - c;
  // S_UNROLL rows of w in flight per thread: RG * S_UNROLL rows a round
  uint4 raw[S_UNROLL];
  auto load_round = [&](int r0) {
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u) {
      const int r = r0 + u * RG;
      raw[u] = r < rows ? load_w(w + (size_t)(k0 + r) * ldw + c, whole,
                                 n_valid)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_round(g);            // the first round does not wait for x
  for (int i = tid; i < MT * kc; i += S_THREADS) {
    const int m = i / kc, kk = i % kc;
    buf[m * S_KC_MAX + kk] =
        (m < M && kk < rows) ? to_f(x[(size_t)m * ldx + k0 + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;
  for (int r0 = g; r0 < rows; r0 += RG * S_UNROLL) {
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u) {
      const int r = r0 + u * RG;
      if (r < rows) {
        float wv[VEC];
        unpack(raw[u], wv);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = buf[m * S_KC_MAX + r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    }
    if (r0 + RG * S_UNROLL < rows) load_round(r0 + RG * S_UNROLL);
  }
  // rows of one warp that share columns: lanes tr, tr + TPR, ...
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  __syncthreads();                         // x is no longer read
  const int warp = tid / 32, lane = tid % 32;
  if (lane < TPR) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        buf[(warp * MT + m) * S_BN + tr * VEC + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < M * S_BN; i += S_THREADS) {
    const int m = i / S_BN, col = i % S_BN, n = n0 + col;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) s += buf[(wp * MT + m) * S_BN + col];
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

constexpr int G_BK = 64;
constexpr int G_SMEM_RING = 192 * 1024;   // shared memory for the ring

// Tile shapes: CWG consumer warpgroups of 64 rows each, BN columns (128
// or 256: one wgmma m64nBNk16 per 16-wide K step), and one producer warp.
template <int CWG, int BN>
struct GemmTile {
  static constexpr int BM = 64 * CWG;
  static constexpr int THREADS = 128 * CWG + 32;
  static constexpr int A_BYTES = BM * G_BK * 2;
  static constexpr int B_BYTES = G_BK * BN * 2;      // BN / 64 TMA boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      G_SMEM_RING / STAGE_BYTES < 8 ? G_SMEM_RING / STAGE_BYTES : 8;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024  // align
                                 + 2 * STAGES * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16, K-major) * B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, K-major) * B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up in libcuda at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// 2-D bf16 map: inner extent `inner` (unit stride), `outer` rows `ld`
// elements apart, box {64, box_outer}, 128-byte swizzle, zero fill
bool encode_map(CUtensorMap* map, const void* base, int inner, int outer,
                int ld, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
      if constexpr (BN == 256) wgmma_m64n256k16(d, da, db);
      else wgmma_m64n128k16(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % G::STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);

  // accumulator layout: register 4j + 2i + e holds row 16*warp + lane/4 +
  // 8i and column 8j + 2*(lane%4) + e of the warpgroup's 64 x BN tile
  const int t = tid % 128;
  const int r_base = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int c_base = n0 + 2 * (t % 4);
  const bool pair = (ldy % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c_base + 8 * j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_base + 8 * i;
      if (r >= M) continue;
      const float v0 = col < n_act ? d[4 * j + 2 * i] : 0.f;
      const float v1 = col + 1 < n_act ? d[4 * j + 2 * i + 1] : 0.f;
      __nv_bfloat16* p = y + (size_t)r * ldy + col;
      if (pair && col + 1 < n_out) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < n_out) p[0] = __float2bfloat16(v0);
        if (col + 1 < n_out) p[1] = __float2bfloat16(v1);
      }
    }
  }
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
