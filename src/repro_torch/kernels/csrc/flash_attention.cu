// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel).  For every (batch, head) and query row
//     o[s] = sum_t softmax_t(q[s] . k[t] / sqrt(D)) v[t]
// over keys t < T (and t <= s when causal), with the running max,
// denominator and accumulator in fp32, p cast to v's dtype before the PV
// product and the denominator summed from the fp32 p, as the TPU kernel
// does.
//
// Differences from the TPU kernel, by design (all variants):
//  * keys at positions >= T are MASKED (probability 0).  The reference
//    wrapper pads keys with zeros and lets them into the softmax (fault F1
//    in ROADMAP.md); these kernels never see padding;
//  * GQA picks the kv head as h / (H / KH) inside the kernel -- no
//    repeated copy of k and v;
//  * q, k, v and o are read and written through (batch, seq, head)
//    strides, so the (B, S, H*D) activations of the ViT go in and come out
//    without a transpose.
//
// Four variants, chosen on the host by kernels/flash_attention.py:
// choose_variant from the shapes alone:
//
// * wgmma (bf16, D = 64, 112 or 128, S >= 65, T >= 1, rows TMA can read:
//   every prefill, training and serving call of the port -- the ViT at
//   S = T = 197, the LMs' causal prefill at 512, train_4k's at 4096,
//   DiT-L/2 at 256, the UNet's 16 x 16 latent and its cross-attention over
//   77 keys -- but the UNet's 8 x 8 latent).  Bound: operations (4 S T D a
//   head, half that causal) at the long rows (train_4k: 2.2 ms of bf16
//   tensor work a microbatch), bytes at DiT-L/2's.  What the mma.sync
//   kernel below cost there (3.1x SDPA at train_4k, 19% of its bound):
//   mma.sync at a fraction of the tensor cores' wgmma rate; four warps
//   that both loaded and computed, so a load waited on the math and the
//   math on a load; K and V staged from L2 once for every 64 queries; the
//   softmax alone between the two products.  This is FlashAttention-3's
//   forward.  A persistent block an SM walks the 128-row query tiles
//   (causal: the longest first; at train_4k in groups of heads whose K
//   and V fit in L2 together, which cut the K/V re-reads from device
//   memory, taken from a counter so the blocks that finish first take
//   more; where all of K and V fit, dealt in rounds that alternate
//   direction, so the blocks' work comes out even).  A producer thread (its
//   warpgroup gives the consumers its registers by setmaxnreg: 232 / 40)
//   loads each tile's Q once and streams 128-key K and V tiles by TMA (4-D
//   maps over the (batch, seq, head) strides, 128-byte swizzle, rows past
//   T zero-filled and masked) into rings behind mbarriers, running ahead
//   across tiles; no consumer thread issues a copy.  Two consumer
//   warpgroups own 64 query rows each, so a K/V tile serves 128 queries:
//   S = Q K^T on wgmma from shared memory (m64n128k16), the online softmax
//   in fp32 registers (exp2 with the scale folded in, masks as selects on
//   the edge tiles only), P rounded to bf16 in registers as the A operand
//   of O += P V (m64nDk16, V MN-major; N = 112 at kimi-k2's D, whose
//   second box holds 48 columns).  Tile j + 1's S product is issued before
//   tile j's softmax, then tile j's PV, so the softmax runs under both;
//   at D > 64 the two warpgroups also take turns issuing (named barriers),
//   one's softmax under the other's products.  O is scaled by 1 / l and
//   stored through o's strides, the logsumexp beside it.  D = 128 and 112
//   take 193 KB of shared memory (two Q slots, two K and two V stages), D
//   = 64 161 KB (four stages).
// * mma (bf16, D = 64, 112 or 128, S <= 64 or T = 0, 16-byte-aligned
//   rows: the UNet's 8 x 8 latent, S = 64, where half or more of wgmma's
//   128-row tile would be padding and mma measured faster).  This is the
//   FlashAttention-2 layout on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate): 4 warps, each owning 16 rows of a 64-row q tile; q
//   fragments held in registers (ldmatrix); K and V tiles of 64 keys kept
//   in bf16 shared memory (rows padded by 16 bytes, so ldmatrix is free of
//   bank conflicts), double-buffered with 16-byte cp.async whose source
//   size zero-fills keys past T; S = QK^T and the online softmax in fp32
//   registers; P rounded to bf16 in registers and used directly as the A
//   operand of PV (ldmatrix.trans reads V as the B operand).  Causally
//   dead KV tiles are skipped and the diagonal tile masked; the grid runs
//   (batch*head) fastest and, when causal, the q tiles that see the most
//   keys first.  D = 128 takes 87 KB of dynamic shared memory, D = 112 77
//   KB (the attribute is set once).
// * decode (bf16, D = 64, 112 or 128, S = 1, any H / KH: every LM decode
//   step).  Bound: the bytes of the K/V cache (4*T*D bytes a kv head
//   against 4*T*D*R operations).  The old kernel gave each (batch, head)
//   one block with one live query row of 64 reading the whole cache
//   serially.  Here the grid is (B*KH*groups, n_splits): each block takes
//   a group of up to 8 of the R = H/KH query rows that share a kv head
//   (granite-20b's MQA has R = 48: 6 groups, each reading the same K/V
//   chunk, the later ones from L2) over one chunk of T (planned on the
//   host by decode_plan for ~2 blocks per SM, which measured faster than
//   4), reads K and V rows with 16-byte loads (D/8 threads a row, rounded
//   up to a power of two so that the row's shuffles stay in its lanes: 16
//   at D = 112 with 2 idle; 4 rows in flight per thread), keeps the
//   chunk's scores in shared memory, and writes an fp32 partial (max,
//   denominator, accumulator) to a workspace; a second kernel merges the
//   partials in split order (deterministic, no atomics) and stores o.
//   The count of valid keys is read from a device int32 (the cache's
//   fill, which a CUDA graph of the decode step advances in place, as
//   the reference's traced `len` scalar); the grid is planned from the
//   cache's capacity, and a block whose chunk starts at or past the fill
//   writes an empty partial (max -inf, denominator 0) and exits, so the
//   device time follows the fill.  The merge skips empty partials.
// Backward (training; the TPU kernel has none): see "backward" below.
// The wgmma, mma and fma variants write each row's fp32 logsumexp when
// asked, which is all the backward keeps of the forward's softmax.
//
// * fma (fp32 inputs, the smoke configs' head dims 8 and 16, and rows
//   that are not 16-byte aligned; D = 8, 16, 64, 112 and 128): the first
//   port's kernel, kept as the parity and smoke path.  128 threads, two per query row; each thread
//   scores half of each 64-key tile and accumulates half of the output
//   dims, with K and V staged in shared memory as fp32.  At D = 128 the q
//   tile is staged in shared memory beside K and V (99 KB, dynamic), and
//   the q . k loop is unrolled by 8, not fully, or the compiler hoists the
//   q row back into registers (255 registers and spills).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_gemm.cuh"

namespace {

constexpr int BQ = 64;
constexpr int THREADS = 2 * BQ;
constexpr int BKV = 64;   // keys per tile

// q staged in shared memory (not registers) above this head dim
constexpr int Q_REG_MAX_D = 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (D + 1) * (2 * BKV + (D > Q_REG_MAX_D ? BQ : 0));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// p.astype(v.dtype): round to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KH, int S, int T_len, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, long long o_sb,
                       long long o_ss, long long o_sh, float scale,
                       int causal, float* __restrict__ lse) {
  constexpr int HALF = BKV / 2;
  constexpr int DH = D / 2;
  constexpr int LD = D + 1;
  constexpr bool Q_SMEM = D > Q_REG_MAX_D;
  const float NEG_INF = -__int_as_float(0x7f800000);
  extern __shared__ float smem[];
  float* Ks = smem;              // [BKV][LD]
  float* Vs = Ks + BKV * LD;     // [BKV][LD]
  float* Qs = Vs + BKV * LD;     // [BQ][LD], only when Q_SMEM

  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;   // partner lane = tid ^ 1
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + row;
  const bool valid_q = qi < S;

  float qr[Q_SMEM ? 1 : D];
  if constexpr (Q_SMEM) {
    // read by every thread only after the first tile's __syncthreads
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int qr_i = q0 + r;
      Qs[r * LD + d] =
          qr_i < S ? to_float(q[b * q_sb + (long long)qr_i * q_ss + h * q_sh + d])
                   : 0.f;
    }
  } else {
    const T* qp = q + b * q_sb + (long long)qi * q_ss + h * q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = valid_q ? to_float(qp[d]) : 0.f;
  }

  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m_i = NEG_INF, l_i = 0.f;

  int n_kv = (T_len + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (q0 + BQ + BKV - 1) / BKV);  // dead tiles
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BKV;
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      const bool ok = kj < T_len;
      Ks[j * LD + d] = ok ? to_float(kb[(long long)kj * k_ss + d]) : 0.f;
      Vs[j * LD + d] = ok ? to_float(vb[(long long)kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[HALF];
    float m_loc = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const int j = 2 * jj + half;
      const int kj = k0 + j;
      const float* kr = Ks + j * LD;
      float dot = 0.f;
      if constexpr (Q_SMEM) {
        // not fully unrolled: the compiler would hoist the whole q row out
        // of the key loop into registers again (255 registers and spills)
        const float* qs = Qs + row * LD;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[d], kr[d], dot);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      }
      const bool ok = kj < T_len && (!causal || kj <= qi);
      s[jj] = ok ? dot * scale : NEG_INF;
      m_loc = fmaxf(m_loc, s[jj]);
    }
    m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 1));
    const float m_new = fmaxf(m_i, m_loc);
    // m_new == -inf: nothing valid seen yet for this row -> keep zeros
    const float corr = (m_new == NEG_INF) ? 1.f : __expf(m_i - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const float p = (s[jj] == NEG_INF) ? 0.f : __expf(s[jj] - m_new);
      s[jj] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l_i = l_i * corr + p_sum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= corr;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const float pa = round_to<T>(s[jj]);                 // key 2jj+half
      const float pb = __shfl_xor_sync(0xffffffffu, pa, 1);  // key 2jj+1-half
      const int ja = 2 * jj + half, jb = 2 * jj + 1 - half;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const int d = 2 * i + half;
        acc[i] = fmaf(pa, Vs[ja * LD + d], fmaf(pb, Vs[jb * LD + d], acc[i]));
      }
    }
    __syncthreads();
  }

  if (valid_q) {
    T* op = o + b * o_sb + (long long)qi * o_ss + h * o_sh;
    const float l = fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int i = 0; i < DH; ++i) op[2 * i + half] = from_float<T>(acc[i] / l);
    if (lse != nullptr && half == 0)
      lse[(long long)bh * S + qi] = l_i > 0.f ? m_i + logf(l_i) : NEG_INF;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int S, int T_len, int D, const long long* st, float scale,
           int causal, float* lse, cudaStream_t s) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
#define REPRO_FA_LAUNCH(DIM)                                                 \
  do {                                                                       \
    constexpr size_t bytes = smem_bytes<DIM>();                              \
    if (bytes > 48 * 1024) {                                                 \
      /* once per instantiation and process (the port drives one card) */    \
      static const cudaError_t err = cudaFuncSetAttribute(                   \
          flash_attention_kernel<T, DIM>,                                    \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);          \
      if (err != cudaSuccess) return static_cast<int>(err);                  \
    }                                                                        \
    flash_attention_kernel<T, DIM><<<grid, THREADS, bytes, s>>>(             \
        static_cast<const T*>(q), static_cast<const T*>(k),                  \
        static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, T_len,       \
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],       \
        st[9], st[10], st[11], scale, causal, lse);                          \
  } while (0)
  switch (D) {
    case 8: REPRO_FA_LAUNCH(8); break;
    case 16: REPRO_FA_LAUNCH(16); break;
    case 64: REPRO_FA_LAUNCH(64); break;
    case 112: REPRO_FA_LAUNCH(112); break;
    case 128: REPRO_FA_LAUNCH(128); break;
    default: return -1;
  }
#undef REPRO_FA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ mma ----

constexpr int M_BQ = 64;          // query rows per block (16 per warp)
constexpr int M_BKV = 64;         // keys per tile
constexpr int M_THREADS = 128;

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (D + 8) * (M_BQ + 4 * M_BKV);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts (mma.sync m16n8k16): lane = 4g + t4; accumulator c[e]
// sits at row g + 8*(e/2), column 2*t4 + e%2 of its 16 x 8 block.
template <int D>
__global__ void __launch_bounds__(M_THREADS)
flash_attention_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int H, int KH, int S,
                    int T_len, long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh,
                    float scale, int causal, float* __restrict__ lse) {
  constexpr int LDS = D + 8;      // padded row: ldmatrix without conflicts
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int KD = D / 16;      // k16 steps of QK^T
  constexpr int ND = D / 8;       // n8 blocks of the output
  const float NEG_INF = -__int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + M_BQ * LDS;          // [2][M_BKV][LDS]
  __nv_bfloat16* Vs = Ks + 2 * M_BKV * LDS;     // [2][M_BKV][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  // causal: the last q tiles, which see the most keys, are started first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * M_BQ;
  int n_kv = (T_len + M_BKV - 1) / M_BKV;
  if (causal) n_kv = min(n_kv, (q0 + M_BQ + M_BKV - 1) / M_BKV);

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  for (int i = tid; i < M_BQ * CH; i += M_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < S;
    cp_async16(Qs + r * LDS + c,
               qb + (ok ? (long long)(q0 + r) * q_ss : 0LL) + c, ok);
  }
  auto load_kv = [&](int tile, int buf) {
    __nv_bfloat16* kd = Ks + buf * M_BKV * LDS;
    __nv_bfloat16* vd = Vs + buf * M_BKV * LDS;
    for (int i = tid; i < M_BKV * CH; i += M_THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const int j = tile * M_BKV + r;
      const bool ok = j < T_len;
      const long long jj = ok ? j : 0;
      cp_async16(kd + r * LDS + c, kb + jj * k_ss + c, ok);
      cp_async16(vd + r * LDS + c, vb + jj * v_ss + c, ok);
    }
  };
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;          // rows row0 and row0 + 8

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd],
                    Qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS
                        + kd * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (t & 1) * M_BKV * LDS;
    const __nv_bfloat16* Vt = Vs + (t & 1) * M_BKV * LDS;

    // S = Q K^T: 16 x 64 for this warp, 8 blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {    // keys 16np .. 16np + 15
        uint32_t bf[4];
        ldmatrix_x4(bf, Kt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LDS
                            + kd * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kd], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kd], bf[2], bf[3]);
      }
    }

    // online softmax over this tile, rows row0 (e < 2) and row0 + 8
    const int k0 = t * M_BKV;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nb * 8 + 2 * t4 + (e & 1);
        const int qi = row0 + 8 * (e >> 1);
        const bool ok = j < T_len && (!causal || j <= qi);
        s[nb][e] = ok ? s[nb][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);
      // m_new == -inf: nothing valid seen yet for this row -> keep zeros
      corr[i] = (m_new == NEG_INF) ? 1.f : __expf(m_i[i] - m_new);
      m_i[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (s[nb][e] == NEG_INF)
                            ? 0.f : __expf(s[nb][e] - m_i[e >> 1]);
        s[nb][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_i[i] = l_i[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];

    // O += P V: P (bf16) from registers as the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {   // output dims 16dp .. + 15
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, Vt + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS
                    + dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this buffer is refilled at the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    if (lse != nullptr && t4 == 0)
      lse[(long long)bh * S + qi] =
          l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : NEG_INF;
    __nv_bfloat16* op = o + b * o_sb + (long long)qi * o_ss + h * o_sh;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(op + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nd][2 * i] * inv,
                                acc[nd][2 * i + 1] * inv);
  }
}

// --------------------------------------------------------------- decode ----

constexpr int D_THREADS = 128;
constexpr int D_WARPS = D_THREADS / 32;
constexpr int D_R_MAX = 8;        // query heads a block (a kv head's group)
constexpr int D_CHUNK_MAX = 256;  // keys per block

constexpr int D_U = 4;            // K or V rows in flight per thread

// 8 bf16 (16 bytes) as floats
__device__ __forceinline__ void unpack8(uint4 t, float (&v)[8]) {
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// threads a row of D / 8 active ones (8 dims each): the next power of two,
// so that the xor shuffles over a row stay inside it; the lanes past D / 8
// (2 of 16 at D = 112) load zeros and store nothing
__host__ __device__ constexpr int row_lanes(int active) {
  return active <= 1 ? 1 : 2 * row_lanes((active + 1) / 2);
}

// One block: kv head (b, kvh), keys [split*chunk, min(T, (split+1)*chunk))
// with T = min(*len, T_cap), and the group of query heads r0 .. r0 + Rg - 1
// of the R = H / KH that share the kv head (Rg <= D_R_MAX; the groups of
// one kv head read the same K/V chunk, which L2 serves to the later ones).
// Writes ws_ml[bh][split] = (max, denominator) and ws_acc[bh][split][D]
// (unnormalised; p rounded to bf16 before PV); a chunk past T writes
// (-inf, 0) and zeros.
template <int D>
__global__ void __launch_bounds__(D_THREADS)
flash_attention_decode(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       const int* __restrict__ len, int H, int KH, int T_cap,
                       long long q_sb,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, float scale, int chunk) {
  constexpr int GA = D / 8;            // active threads a row
  constexpr int G = row_lanes(GA);     // threads a row (a power of two)
  constexpr int SLOTS = 32 / G;        // rows a warp reads at once
  constexpr int STEP = D_WARPS * SLOTS;
  const float NEG_INF = -__int_as_float(0x7f800000);
  __shared__ float sc[D_R_MAX][D_CHUNK_MAX];
  __shared__ float red[D_WARPS][D_R_MAX][D];
  __shared__ float ml[D_R_MAX][2];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gi = lane % G, slot = lane / G;
  const bool on = gi < GA;             // holds 8 dims of the row
  const int R = H / KH;
  const int n_groups = (R + D_R_MAX - 1) / D_R_MAX;
  const int bkh = blockIdx.x / n_groups, r0 = (blockIdx.x % n_groups)
                                              * D_R_MAX;
  const int Rg = min(D_R_MAX, R - r0);
  const int b = bkh / KH, kvh = bkh % KH;
  const int h0 = kvh * R + r0;         // this group's first query head
  const int split = blockIdx.y, splits = gridDim.y;
  const int T_len = min(__ldg(len), T_cap);
  const int t0 = split * chunk, t1 = min(T_len, t0 + chunk);
  const int n = t1 - t0;
  if (n <= 0) {     // past the fill: an empty partial (uniform per block)
    for (int i = tid; i < Rg * D; i += D_THREADS) {
      const long long bh = (long long)b * H + h0 + i / D;
      ws_acc[(bh * splits + split) * D + i % D] = 0.f;
    }
    if (tid < Rg) {
      const long long bh = (long long)b * H + h0 + tid;
      ws_ml[(bh * splits + split) * 2] = NEG_INF;
      ws_ml[(bh * splits + split) * 2 + 1] = 0.f;
    }
    return;
  }
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh + gi * 8;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh + gi * 8;

  float qv[D_R_MAX][8];
#pragma unroll
  for (int r = 0; r < D_R_MAX; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[r][e] = 0.f;
    if (r < Rg && on) {
      unpack8(*reinterpret_cast<const uint4*>(
                  q + b * q_sb + (long long)(h0 + r) * q_sh + gi * 8),
              qv[r]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[r][e] *= scale;
    }
  }
  // scores: one row per slot, G lanes a row, reduced across those lanes;
  // D_U rows per thread in flight (the loop runs alike on every lane of a
  // warp: it shuffles)
  for (int jb = warp * SLOTS; jb < n; jb += D_U * STEP) {
    uint4 kr[D_U];
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int j = jb + u * STEP + slot;
      kr[u] = j < n && on ? *reinterpret_cast<const uint4*>(
                                kb + (long long)(t0 + j) * k_ss)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int j = jb + u * STEP + slot;
      float kv[8];
      unpack8(kr[u], kv);
#pragma unroll
      for (int r = 0; r < D_R_MAX; ++r) {
        if (r < Rg) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qv[r][e], kv[e], d);
#pragma unroll
          for (int off = 1; off < G; off <<= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          if (gi == 0 && j < n) sc[r][j] = d;
        }
      }
    }
  }
  __syncthreads();
  // per row: max, p = exp(s - max) summed in fp32 into the denominator,
  // then kept rounded to bf16 for PV
  for (int r = warp; r < Rg; r += D_WARPS) {
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[r][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = __expf(sc[r][j] - mx);
      l += p;
      sc[r][j] = __bfloat162float(__float2bfloat16(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ml[r][0] = mx;
      ml[r][1] = l;
    }
  }
  __syncthreads();
  float acc[D_R_MAX][8];
#pragma unroll
  for (int r = 0; r < D_R_MAX; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  for (int jb = warp * SLOTS; jb < n; jb += D_U * STEP) {
    uint4 vr[D_U];
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int j = jb + u * STEP + slot;
      vr[u] = j < n && on ? *reinterpret_cast<const uint4*>(
                                vb + (long long)(t0 + j) * v_ss)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int j = jb + u * STEP + slot;
      if (j < n) {
        float vv[8];
        unpack8(vr[u], vv);
#pragma unroll
        for (int r = 0; r < D_R_MAX; ++r) {
          if (r < Rg) {
            const float p = sc[r][j];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < D_R_MAX; ++r) {
    if (r < Rg) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        if (slot == 0 && on) red[warp][r][gi * 8 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Rg * D; i += D_THREADS) {
    const int r = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < D_WARPS; ++w) s += red[w][r][d];
    const long long bh = (long long)b * H + h0 + r;
    ws_acc[(bh * splits + split) * D + d] = s;
  }
  if (tid < Rg) {
    const long long bh = (long long)b * H + h0 + tid;
    ws_ml[(bh * splits + split) * 2] = ml[tid][0];
    ws_ml[(bh * splits + split) * 2 + 1] = ml[tid][1];
  }
}

// o[b, 0, h] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, in split
// order, over the splits with a denominator (an empty one adds nothing,
// and no NaN: its max is -inf); one block of D threads per (batch, head).
// With `lse` (fp32 (B, H), may be null) also the row's logsumexp of the
// scaled scores, M + log(l), or -inf where no key is valid (then o = 0):
// what a sequence-sharded decode merges across shards.
template <int D>
__global__ void __launch_bounds__(D)
flash_attention_merge(const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int splits, long long o_sb, long long o_sh) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* ml = ws_ml + (size_t)bh * splits * 2;
  // unrolled so that the partials' loads are in flight together
  float mx = ml[0];
#pragma unroll 8
  for (int s = 1; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float f = ml[2 * s + 1] > 0.f ? __expf(ml[2 * s] - mx) : 0.f;
    l = fmaf(ml[2 * s + 1], f, l);
    a = fmaf(ws_acc[((size_t)bh * splits + s) * D + d], f, a);
  }
  o[(bh / H) * o_sb + (bh % H) * o_sh + d] =
      __float2bfloat16(a / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0)
    lse[bh] = l > 0.f ? mx + logf(l) : -__int_as_float(0x7f800000);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KH, int S, int T_len, const long long* st,
               float scale, int causal, float* lse, cudaStream_t s) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  if (bytes > 48 * 1024) {
    // once per instantiation and process (the port drives one card)
    static const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (S + M_BQ - 1) / M_BQ);
  flash_attention_mma<D><<<grid, M_THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, KH, S, T_len, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* ws, const int* len, float* lse, int B, int H, int KH,
                  int T_cap, const long long* st, float scale, int splits,
                  int chunk, cudaStream_t s) {
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)B * H * splits * D;
  // a block per (batch, kv head, group of <= D_R_MAX query heads)
  const int groups = (H / KH + D_R_MAX - 1) / D_R_MAX;
  flash_attention_decode<D><<<dim3(B * KH * groups, splits), D_THREADS, 0,
                              s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ws_acc, ws_ml, len, H, KH, T_cap,
      st[0], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_merge<D><<<B * H, D, 0, s>>>(
      ws_acc, ws_ml, static_cast<__nv_bfloat16*>(o), lse, H, splits, st[9],
      st[11]);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward ----
//
// FlashAttention's backward, causal or not, D = 64 and (wgmma) 112 and
// 128.  With
// P = exp(s * scale - lse) from the forward's logsumexp (fp32) and delta =
// rowsum(dO o O):
//     dV = P^T dO,  dS = P o (dO V^T - delta),  dK = scale dS^T Q,
//     dQ = scale dS K,
// with keys at positions >= T masked as in the forward, and causal keys
// j > query i (both from 0).  Bound: bytes at
// the ViT's S = T = 197, D = 64 (five products of 2 S T D a head, 3.8
// GFLOP a sandwich-step call, against q, k, v, o, dO read and dq, dk, dv
// written, 310 MB: 93 us at 3.35 TB/s against 4 us of bf16 operations).
// Two bf16 variants, chosen on the host by kernels/flash_attention.py:
// choose_bwd_variant from shapes and strides only:
//
// * resident (bf16, D = 64, S and T <= 256, 16-byte-aligned rows: every
//   call of the sandwich step, S = T = 197).  What the two-pass mma.sync
//   backward it replaced (FlashAttention-2's: a delta launch, then dK/dV
//   and dQ in separate kernels, each recomputing S and dP) cost at these
//   shapes: 7 products where 5 do (S and dP twice), q, dO, k and v read
//   twice, a delta launch reading o and dO again.  Here one
//   block per (batch, kv head) holds all its keys: K and V stay in shared
//   memory for the whole pass, and warpgroup wg (of 1 to 4, 64 keys each)
//   keeps dK and dV of its keys in registers across the R query heads
//   (GQA's sum in a fixed order, no atomics).  The queries stream through
//   in chunks of 64: Q, dO and o by cp.async into two slots laid out as
//   TMA's 128-byte swizzle, behind the current chunk, the logsumexp
//   through a register.  A chunk: delta = rowsum(dO o) from the staged o
//   and dO (no delta launch); then per 32 queries S^T = K Q^T and dP^T =
//   V dO^T once on wgmma (m64n32k16, both operands from shared memory),
//   P = exp(S scale - lse) and dS = P (dP - delta) in registers, dV +=
//   P^T dO and dK += dS^T Q on wgmma (m64n64k16) with P and dS as register
//   A operands; the warpgroup's rows of dS^T go to shared memory (bf16,
//   swizzled), and after one barrier the first warpgroup computes dQ = dS
//   K of the chunk over all keys (wgmma, dS^T and K read MN-major) and
//   stores it once, while the others issue the next chunk's loads.  Each
//   input is read once and each output written once; 5 products.
//   What bounds it at S = T = 197 is neither the bytes (93 us a call at
//   3.35 TB/s) nor the products: one block an SM (the dK and dV
//   registers of 256 keys fill the register file), the products run in
//   ~40% of a chunk and the scalar work between them (the softmax
//   gradient, the delta, the loads' issue) in the rest, so the P and dS
//   step is branch-free (masks as selects, ex2.approx.ftz, the chunk's
//   logsumexp and delta read once) and the 32-query loop is not unrolled
//   (an unrolled copy cost instruction-cache misses: 12%).  197 keys pad
//   to 256 (wgmma's 64-row M).  An mma.sync version of the same pass
//   (warps of 16 keys, chunks of 32) measured the same before that step
//   was rewritten (PERF.md).
// * wgmma (every other bf16 call: causal, D = 112 or 128, or S or T >
//   256; the LMs' training at S = T = 4096, D = 128 and kimi-k2's 112,
//   causal, among them).  What the
//   two-pass mma.sync backward cost there (4.9 ms a call against a 0.70 ms
//   bound):
//   mma.sync at 4 warps, 7 products where 5 do, Q, dO, K and V re-read by
//   cp.async for every 64-row tile, at D = 128 A fragments re-read from
//   shared memory each step, and a delta launch.  This is
//   FlashAttention-3's backward: a block per (128-key tile, batch, kv
//   head), two consumer warpgroups of 64 keys keeping dK and dV in fp32
//   registers, a producer warpgroup (setmaxnreg gives the consumers 232
//   registers a thread; without it ptxas capped the 288- and 384-thread
//   blocks at 168 and spilled the accumulators) whose warps load Q, dO
//   and o by TMA into two stages (the logsumexp by plain loads), compute
//   each chunk's delta from the staged o and dO, and add dQ into an fp32
//   workspace.  Per chunk of 64 queries: 5 products on wgmma (S^T, dP^T
//   from shared memory; dV, dK with P and dS as register A operands; dQ =
//   dS K from dS^T staged in shared memory).  dQ stays deterministic and
//   graph-safe: the consumers put their share in shared memory, and the
//   writer warp adds it with one bulk reduction (cp.reduce.async.bulk) in
//   key-tile order, each (batch, head, chunk) behind an int32 ticket that
//   key tile n waits to read n; a second kernel casts the workspace into
//   dq.  First built with the consumers adding dQ themselves from
//   registers, slower than the two-pass mma.sync backward: that
//   read-modify-write's loads waited on the stores before them.  Causal:
//   a key tile starts at the chunk holding its first key (the dead chunks
//   are never visited) and the blocks of key tile 0 launch first; the
//   diagonal is masked by selects.  Ragged S and T: TMA's zero fill and
//   the masks, no copy.  No branch separates a warpgroup's threads around
//   a wgmma (ptxas then serializes them).  D = 112 (kimi-k2) takes D =
//   128's shared layout, as the forward does: a row is two 64-column
//   boxes, the second 48 columns wide and zero-filled by TMA past them, so
//   S^T and dP^T run 7 k-steps of 16 and dV and dK N = 112 (m64n112k16);
//   dQ's product runs 64 columns a warpgroup and the second stores its
//   first 48, into 448-byte fp32 rows that the bulk reductions add as
//   they are (their 16-byte pieces swizzled within groups of 4: 28 a row);
//   dK, dV and dq are stored at exactly 112 columns.
//
// fp32 (fma_f32) runs on FMAs in three passes: delta (one warp a row),
// dK/dV (a thread a key, GQA's R heads summed in its registers) and dQ
// (a thread a query), causal by skipping the dead 32-row blocks.

struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dO[3], dq[3], dk[3], dv[3];
};

constexpr int BF_ROWS = 32;       // fp32 kernels: rows a block (one a thread)

// delta[b, h, s] = sum_d dO[b, s, h, d] o[b, s, h, d] in fp32
template <typename T>
__global__ void __launch_bounds__(128)
flash_attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
                          float* __restrict__ delta, int H, int S, int D,
                          long long rows, BwdStrides st) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s_ = (int)(row % S);
  const long long bh = row / S;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const T* op = o + b * st.o[0] + (long long)s_ * st.o[1] + h * st.o[2];
  const T* gp = dO + b * st.dO[0] + (long long)s_ * st.dO[1] + h * st.dO[2];
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_float(op[d]) * to_float(gp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ----------------------------------------------- backward: resident ----

constexpr int R_QC = 64;          // queries a chunk (wgmma's M in dQ)
constexpr int R_T_MAX = 256;      // keys a block holds, 64 a warpgroup

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 32, fp32) += A (64 x 16, shared, K-major) * B (16 x 32,
// shared, K-major); descriptors as repro_hopper::gmma_desc builds them
__device__ __forceinline__ void wgmma_ss32_kk(float (&d)[16], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers: each warp's 16 rows
// as the mma.sync m16k16 A fragment) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs64_mn(float (&d)[32],
                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, shared, MN-major) * B (16 x 64,
// shared, MN-major); descriptors as repro_hopper::gmma_desc builds them
__device__ __forceinline__ void wgmma_ss64_mnmn(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// 2^x on the special-function unit, denormals flushed (no fix-up path)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows under
// the 128-byte swizzle (what TMA's SWIZZLE_128B writes and wgmma's layout
// type 1 reads; tiles 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Shared memory of the resident kernel with NWG warpgroups (64 keys
// each): K and V whole, two slots of Q, dO and o chunks, the chunk's dS^T
// (all swizzled tiles of 128-byte rows), then the chunk's logsumexp and
// delta.
template <int NWG>
struct ResidentSmem {
  static constexpr int KV = NWG * 64 * 128;
  static constexpr int CHUNK = R_QC * 128;
  static constexpr int K_OFF = 0, V_OFF = KV, Q_OFF = 2 * KV;
  static constexpr int G_OFF = Q_OFF + 2 * CHUNK;
  static constexpr int O_OFF = G_OFF + 2 * CHUNK;
  static constexpr int DS_OFF = O_OFF + 2 * CHUNK;
  static constexpr int L_OFF = DS_OFF + KV;
  static constexpr int BYTES = L_OFF + 2 * R_QC * 4 + 1024;  // + alignment
};

// One block per (batch, kv head): all of its keys in one pass.
// Warpgroup wg owns keys 64 wg .. + 63 and keeps their dK and dV (64 x 64
// each, fp32) in registers over the R query heads and their chunks of 64
// queries.  A chunk: its delta from o and dO in shared memory; per half
// chunk (32 queries) S^T = K Q^T and dP^T = V dO^T once on wgmma (both
// operands K-major in shared memory), P = exp(S scale - lse) and dS = P
// (dP - delta) in registers, dV += P^T dO and dK += dS^T Q on wgmma with P
// and dS as register A operands (dO and Q MN-major), and the warpgroup's
// rows of dS^T to shared memory as bf16; then dQ = dS K of the chunk over
// all keys on wgmma (dS^T and K MN-major), by the first warpgroup alone
// (one accumulator, no partials to add).  The next chunk's Q, dO and o
// load (cp.async, into the swizzled layout) and its logsumexp (a
// register) behind the current one.
template <int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
flash_attention_bwd_resident(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dO,
                             const float* __restrict__ lse,
                             __nv_bfloat16* __restrict__ dq,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int KH,
                             int S, int T_len, BwdStrides st, float scale) {
  using L = ResidentSmem<NWG>;
  using bf = __nv_bfloat16;
  using repro_hopper::gmma_desc;
  constexpr int THREADS = NWG * 128;
  extern __shared__ unsigned char rs_raw[];
  unsigned char* sm = rs_raw + ((1024 - (smem_u32(rs_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  float* Ls = reinterpret_cast<float*>(sm + L::L_OFF);     // [R_QC]
  float* Dl = Ls + R_QC;                                   // [R_QC]

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.x / KH, kvh = blockIdx.x % KH;
  const int R = H / KH;
  const int nch = (S + R_QC - 1) / R_QC;
  const int n_it = R * nch;
  const int key0 = 64 * wg + 16 * warp + lane / 4;   // keys key0, key0 + 8
  const bool key_ok[2] = {key0 < T_len, key0 + 8 < T_len};
  // P = exp(S scale - lse) as 2^(S scale log2e - lse log2e)
  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;
  // this thread's dS^T stores: rows key0 + 8i (same swizzle, lane / 4),
  // 4 bytes at 4 (lane % 4) of the 16-byte chunk of each 8 queries
  const int xr = (lane / 4) & 7;
  const uint32_t ds_row = key0 * 128 + 4 * (lane % 4);

  // rows r0 .. r0 + rows - 1 of a (seq, 64) bf16 slab into a swizzled
  // tile, by threads t0 ..; rows at or past n zero-filled (nothing read)
  auto load_tile = [&](int off, const bf* base, long long ld, int r0,
                       int rows, int n, int t0 = 0) {
    for (int i = tid - t0; i < rows * 8; i += THREADS - t0) {
      const int r = i / 8, c = i % 8;
      const bool ok = r0 + r < n;
      cp_async16(sm + off + swz(r, c),
                 base + (ok ? (long long)(r0 + r) * ld : 0LL) + c * 8, ok);
    }
  };
  auto load_chunk = [&](int it, int slot, int t0) {
    const int h = kvh * R + it / nch, q0 = (it % nch) * R_QC;
    load_tile(L::Q_OFF + slot * L::CHUNK, q + b * st.q[0] + h * st.q[2],
              st.q[1], q0, R_QC, S, t0);
    load_tile(L::G_OFF + slot * L::CHUNK, dO + b * st.dO[0] + h * st.dO[2],
              st.dO[1], q0, R_QC, S, t0);
    load_tile(L::O_OFF + slot * L::CHUNK, o + b * st.o[0] + h * st.o[2],
              st.o[1], q0, R_QC, S, t0);
  };
  // thread tid < R_QC: the logsumexp of query tid of chunk `it`
  auto lse_of = [&](int it) {
    const int h = kvh * R + it / nch, q0 = (it % nch) * R_QC;
    return q0 + tid < S ? lse[((long long)b * H + h) * S + q0 + tid] : 0.f;
  };
  float lse_next = tid < R_QC && n_it > 0 ? lse_of(0) : 0.f;
  load_tile(L::K_OFF, k + b * st.k[0] + kvh * st.k[2], st.k[1], 0, NWG * 64,
            T_len);
  load_tile(L::V_OFF, v + b * st.v[0] + kvh * st.v[2], st.v[1], 0, NWG * 64,
            T_len);
  if (n_it > 0) load_chunk(0, 0, 0);
  cp_async_commit();
  if (n_it > 1) load_chunk(1, 1, 0);
  cp_async_commit();
  // the warps that issue a chunk's loads while the first warpgroup
  // computes the last chunk's dQ (all of them when there is one)
  constexpr int PF0 = NWG > 1 ? 128 : 0;

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int slot = it & 1;
    const int h = kvh * R + it / nch, q0 = (it % nch) * R_QC;
    cp_async_wait<1>();
    repro_hopper::fence_async_smem();   // cp.async writes -> wgmma reads
    __syncthreads();
    if (tid < R_QC) {
      Ls[tid] = lse_next;
      if (it + 1 < n_it) lse_next = lse_of(it + 1);
    }
    const uint32_t qa = sb + L::Q_OFF + slot * L::CHUNK;
    const uint32_t ga = sb + L::G_OFF + slot * L::CHUNK;

    // delta = rowsum(dO o) in fp32: 8 threads a row, a 16-byte chunk each
    // (dO and o share the swizzle, so their chunks pair up in place)
    {
      const unsigned char* gp = sm + L::G_OFF + slot * L::CHUNK;
      const unsigned char* op = sm + L::O_OFF + slot * L::CHUNK;
      for (int i = tid; i < R_QC * 8; i += THREADS) {
        const int r = i / 8, c = i % 8;
        float gf[8], of[8];
        unpack8(*reinterpret_cast<const uint4*>(gp + swz(r, c)), gf);
        unpack8(*reinterpret_cast<const uint4*>(op + swz(r, c)), of);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(gf[e], of[e], acc);
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (c == 0) Dl[r] = acc;
      }
    }
    __syncthreads();

    const uint32_t ka = sb + L::K_OFF + wg * 64 * 128;
    const uint32_t va = sb + L::V_OFF + wg * 64 * 128;
    unsigned char* dsp = sm + L::DS_OFF + ds_row;
    // one loop body for both halves: the scalar code between the products
    // is what the kernel's issue slots go to, and an unrolled copy costs
    // instruction-cache misses
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t qb = qa + half * 32 * 128 + ks * 32;
        const uint32_t gb = ga + half * 32 * 128 + ks * 32;
        wgmma_ss32_kk(s, gmma_desc(ka + ks * 32, 16, 1024),
                      gmma_desc(qb, 16, 1024));
        wgmma_ss32_kk(dp, gmma_desc(va + ks * 32, 16, 1024),
                      gmma_desc(gb, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      repro_hopper::fence_acc(s);
      repro_hopper::fence_acc(dp);
      // register 4j + 2i + e: key key0 + 8i, query c_j + e of the chunk
      // (c_j = 32 half + 8j + 2 (lane % 4)); the logsumexp and delta of
      // the thread's 8 queries read once, masks as selects, no branches
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = half * 32 + 8 * j + 2 * (lane % 4);
        const float2 lv = *reinterpret_cast<const float2*>(Ls + c);
        const float2 dl = *reinterpret_cast<const float2*>(Dl + c);
        const float lq[2] = {lv.x * LOG2E, lv.y * LOG2E};
        const float dq2[2] = {dl.x, dl.y};
        const bool q_ok[2] = {q0 + c < S, q0 + c + 1 < S};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const float ev = ex2_ftz(fmaf(s[x], sl2, -lq[e]));
            const float pv = key_ok[i] && q_ok[e] ? ev : 0.f;
            s[x] = pv;
            dp[x] = pv * (dp[x] - dq2[e]);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              dsp + i * 8 * 128 + (((half * 4 + j) ^ xr) << 4)) =
              __floats2bfloat162_rn(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]);
        }
      }
      // dV += P^T dO, dK += dS^T Q: 16 queries a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[8 * kk], s[8 * kk + 1]),
            pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
            pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
            pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
        const uint32_t sa[4] = {
            pack_bf16(dp[8 * kk], dp[8 * kk + 1]),
            pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]),
            pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]),
            pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7])};
        const uint32_t row = (half * 32 + kk * 16) * 128;
        wgmma_rs64_mn(dv_acc, pa, gmma_desc(ga + row, 8192, 1024));
        wgmma_rs64_mn(dk_acc, sa, gmma_desc(qa + row, 8192, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      repro_hopper::fence_acc(dv_acc);
      repro_hopper::fence_acc(dk_acc);
    }
    repro_hopper::fence_async_smem();   // dS^T writes -> wgmma reads
    __syncthreads();
    // the slot is free (its delta and products are done): chunk it + 2
    if (it + 2 < n_it && tid >= PF0) load_chunk(it + 2, slot, PF0);
    cp_async_commit();

    // dQ = dS K over all keys (dS^T and K MN-major), on the first
    // warpgroup; the others go on to the next chunk's barrier
    if (wg == 0) {
      float dqa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NWG; ++ks) {
        const uint32_t r = ks * 16 * 128;
        wgmma_ss64_mnmn(dqa, gmma_desc(sb + L::DS_OFF + r, 8192, 1024),
                        gmma_desc(sb + L::K_OFF + r, 8192, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      repro_hopper::fence_acc(dqa);
      // register 4j + 2i + e: query 16 warp + lane / 4 + 8i, dim 8j +
      // 2 (lane % 4) + e
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + 16 * warp + lane / 4 + 8 * i;
        if (row >= S) continue;
        bf* qp = dq + b * st.dq[0] + (long long)row * st.dq[1] +
                 h * st.dq[2] + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(qp + 8 * j) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * i] * scale,
                                    dqa[4 * j + 2 * i + 1] * scale);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + 8 * i;
    if (j >= T_len) continue;
    bf* kp = dk + b * st.dk[0] + (long long)j * st.dk[1] + kvh * st.dk[2];
    bf* vp = dv + b * st.dv[0] + (long long)j * st.dv[1] + kvh * st.dv[2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int x = 4 * n + 2 * i, d = 8 * n + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(kp + d) = __floats2bfloat162_rn(
          dk_acc[x] * scale, dk_acc[x + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vp + d) =
          __floats2bfloat162_rn(dv_acc[x], dv_acc[x + 1]);
    }
  }
}

template <int NWG>
int launch_bwd_resident(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const float* lse,
                        void* dq, void* dk, void* dv, int B, int H, int KH,
                        int S, int T_len, const BwdStrides& st, float scale,
                        cudaStream_t s) {
  using bf = __nv_bfloat16;
  constexpr int bytes = ResidentSmem<NWG>::BYTES;
  // once per instantiation and process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bwd_resident<NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_attention_bwd_resident<NWG><<<B * KH, 128 * NWG, bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(dO), lse, static_cast<bf*>(dq),
      static_cast<bf*>(dk), static_cast<bf*>(dv), H, KH, S, T_len, st,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- backward: wgmma ----

constexpr int W_KEYS = 128;       // keys a block: 64 a consumer warpgroup
constexpr int W_BQ = 64;          // queries a chunk (wgmma's M in dQ)
constexpr int W_STAGES = 2;       // chunks in flight (Q, dO, o, logsumexp)
constexpr int W_THREADS = 3 * 128;   // 2 consumer warpgroups, a producer's

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers, as wgmma_rs64_mn) *
// B (16 x 128, shared, MN-major: two 64-column boxes LBO bytes apart)
__device__ __forceinline__ void wgmma_rs128_mn(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 112, fp32) += A (64 x 16, bf16 in registers, as wgmma_rs64_mn)
// * B (16 x 112, shared, MN-major: a 64-column box and a 48-column share
// of the next, LBO bytes apart)
__device__ __forceinline__ void wgmma_rs112_mn(float (&d)[56],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %61, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n\t}"
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
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x D) += A (registers) * B (16 x D, shared, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (D == 64) wgmma_rs64_mn(d, a, db);
  else if constexpr (D == 112) wgmma_rs112_mn(d, a, db);
  else wgmma_rs128_mn(d, a, db);
}

// Shared memory of the wgmma backward at head dim D (all bf16 tiles
// swizzled, 128-byte rows, 1024-byte aligned; a row of D > 64 is two
// 64-column boxes, each box its own run of rows, the second of D = 112
// 48 columns wide and zero-filled by TMA past them, as the forward's):
// K and V of the block's 128 keys, two stages of a chunk's Q, dO and o
// (64 rows each), its logsumexp and delta, the chunk's dS^T (128 keys x
// 64 queries), its dQ share in fp32 (64 x D, exactly D columns a row: the
// workspace's rows; 16-byte pieces swizzled within a row, DQ_SWZ), and
// the mbarriers.
template <int D>
struct WgmmaSmem {
  static constexpr int NB = (D + 63) / 64;           // 64-column boxes
  static constexpr int KV = NB * W_KEYS * 128;
  static constexpr int CH = NB * W_BQ * 128;
  static constexpr int K_OFF = 0, V_OFF = KV, ST_OFF = 2 * KV;
  static constexpr int Q_IN = 0, G_IN = CH, O_IN = 2 * CH;
  static constexpr int L_IN = 3 * CH, DL_IN = 3 * CH + 4 * W_BQ;
  static constexpr int STAGE = 3 * CH + 1024;
  static constexpr int DS_OFF = ST_OFF + W_STAGES * STAGE;
  static constexpr int DQ_OFF = DS_OFF + W_KEYS * 128;
  static constexpr int BAR_OFF = DQ_OFF + W_BQ * D * 4;
  static constexpr int BARS = 3 * W_STAGES + 3;
  static constexpr int BYTES = BAR_OFF + 8 * BARS + 1024;
};

// The swizzle of a dQ row's 16-byte pieces: piece p of row r at p ^ (r &
// DQ_SWZ<D>), so that a warp's stores of 4 rows hit distinct banks.  Rows
// of D = 64 and 128 hold 16 and 32 pieces (a multiple of 8); a 448-byte
// row of D = 112 holds 28, so its pieces move within aligned groups of 4
// (28 / 4 = 7), which stays inside the row.
template <int D>
constexpr int DQ_SWZ = D == 112 ? 3 : 7;

__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// global[dst] += shared[src], fp32, as one bulk operation (in L2)
__device__ __forceinline__ void bulk_add_s2g(float* dst, const void* src,
                                             int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// raise a barrier's expected transaction bytes without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// One block per (key tile of 128, batch, kv head), the key tiles that see
// the most queries first (blockIdx runs over (batch, kv head) fastest).
// Consumer warpgroup wg owns keys 64 wg .. + 63 of the tile and keeps
// their dK and dV (64 x D each, fp32) in registers over every chunk of 64
// queries that sees them, for each of the R query heads in turn (GQA's
// sum in a fixed order).  The third warpgroup (setmaxnreg gives the
// consumers its registers) has three jobs: a warp, the producer,
// loads K and V once and each chunk's Q, dO and o by TMA (zero rows past
// S and T) and its logsumexp by plain loads, into two stages behind
// mbarriers; two warps compute the chunk's delta = rowsum(dO o) from the
// staged tiles (a row a thread; no delta launch); a warp, the dQ writer,
// adds the consumers' dQ share into the fp32 workspace.  A chunk, per consumer
// warpgroup: per 32 queries S^T = K Q^T and dP^T = V dO^T on wgmma, P =
// exp(S scale - lse) and dS = P (dP - delta) in registers (masks as
// selects: keys past T, queries past S, causal keys past the query), dS^T
// to shared memory (once both warpgroups' dQ products of the last chunk,
// which read all of it, are done), dV += P^T dO and dK += dS^T Q on wgmma with P and dS
// as register A operands; then dQ = dS K of the block's keys, warpgroup
// wg its columns 64 wg .. + 63 (at D = 64 the first alone stores its
// product), into shared memory.  The
// writer adds it to the workspace by one bulk reduction in L2, in
// key-tile order: key tile n waits until the chunk's ticket reads n (tile
// n - 1's addition is complete), tile 0 stores instead of adding, and
// each tile advances the ticket.  So dQ's sum runs over the key tiles in
// one order on every run; a second kernel casts the workspace into dq.
template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_attention_bwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          const __grid_constant__ CUtensorMap map_g,
                          const float* __restrict__ lse,
                          float* __restrict__ ws, int* __restrict__ tickets,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int B, int H,
                          int KH, int S, int T_len, BwdStrides st,
                          float scale, int causal) {
  using L = WgmmaSmem<D>;
  using bf = __nv_bfloat16;
  using repro_hopper::gmma_desc;
  extern __shared__ unsigned char wg_raw[];
  unsigned char* sm = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + W_STAGES;
  uint64_t* dl_ready = empty + W_STAGES;
  uint64_t* kv_bar = dl_ready + W_STAGES;
  uint64_t* dq_full = kv_bar + 1;
  uint64_t* dq_empty = dq_full + 1;
  constexpr int DQ_WARPS = D > 64 ? 8 : 4;   // consumer warps that write dQ

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int bkh = blockIdx.x % (B * KH);
  const int n = blockIdx.x / (B * KH);                 // key tile
  const int b = bkh / KH, kvh = bkh % KH;
  const int R = H / KH;
  const int nch = (S + W_BQ - 1) / W_BQ;
  const int j0 = n * W_KEYS;
  // causal: the chunks before 2n (their last query < j0) see none of the
  // tile's keys
  const int m_first = causal ? min(2 * n, nch) : 0;
  const int n_it = (nch - m_first) * R;     // chunk-major, heads inner

  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      repro_hopper::mbar_init(&full[s], 32);    // the producer warp's lanes
      repro_hopper::mbar_init(&empty[s], 8);    // one per consumer warp
      repro_hopper::mbar_init(&dl_ready[s], 2);   // the delta warps
    }
    repro_hopper::mbar_init(kv_bar, 1);
    repro_hopper::mbar_init(dq_full, DQ_WARPS);
    repro_hopper::mbar_init(dq_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    repro_hopper::fence_async_smem();
  }
  __syncthreads();

  if (wg == 2) {
    // give the consumers the registers: 2 x 128 x 232 + 128 x 40 <= 64 K
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const int warp = (tid - 256) / 32;
    if (warp == 0) {                        // the producer
      if (lane == 0) {
        repro_hopper::mbar_expect_tx(kv_bar, 2 * L::KV);
#pragma unroll
        for (int x = 0; x < L::NB; ++x) {
          repro_hopper::tma_load_4d(sm + L::K_OFF + x * W_KEYS * 128, &map_k,
                                    kv_bar, 64 * x, j0, kvh, b);
          repro_hopper::tma_load_4d(sm + L::V_OFF + x * W_KEYS * 128, &map_v,
                                    kv_bar, 64 * x, j0, kvh, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % W_STAGES;
        const int h = kvh * R + it % R, q0 = (m_first + it / R) * W_BQ;
        unsigned char* stg = sm + L::ST_OFF + s * L::STAGE;
        if (lane == 0) {
          repro_hopper::mbar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
          mbar_expect_tx_only(&full[s], 3 * L::CH);
#pragma unroll
          for (int x = 0; x < L::NB; ++x) {
            const int o = x * W_BQ * 128;
            repro_hopper::tma_load_4d(stg + L::Q_IN + o, &map_q, &full[s],
                                      64 * x, q0, h, b);
            repro_hopper::tma_load_4d(stg + L::G_IN + o, &map_g, &full[s],
                                      64 * x, q0, h, b);
            repro_hopper::tma_load_4d(stg + L::O_IN + o, &map_o, &full[s],
                                      64 * x, q0, h, b);
          }
        }
        __syncwarp();          // the stage is free: its logsumexp too
        float* ls = reinterpret_cast<float*>(stg + L::L_IN);
        const float* lp = lse + ((long long)b * H + h) * S + q0;
        for (int i = lane; i < W_BQ; i += 32)
          ls[i] = q0 + i < S ? lp[i] : 0.f;
        repro_hopper::mbar_arrive(&full[s]);      // after the TMA's bytes
      }
    } else if (warp == 1) {                 // the dQ writer
      if (lane == 0) {
        for (int it = 0; it < n_it; ++it) {
          const int m = m_first + it / R, h = kvh * R + it % R;
          const int q0 = m * W_BQ;
          repro_hopper::mbar_wait(dq_full, it & 1);
          const long long bh = (long long)b * H + h;
          float* dst = ws + (bh * S + q0) * D;
          const int bytes = min(W_BQ, S - q0) * D * 4;
          int* ticket = tickets + bh * nch + m;
          if (n == 0) {
            bulk_copy_s2g(dst, sm + L::DQ_OFF, bytes);
          } else {
            // tile n - 1 is an earlier block, so it runs or has run: a
            // wait this long is a fault, and the launch fails, not hangs
            for (long long spins = 0;
                 repro_hopper::ld_acquire_gpu(ticket) != n; ++spins) {
              if (spins > (1ll << 27)) __trap();
              __nanosleep(32);
            }
            fence_async_global();
            bulk_add_s2g(dst, sm + L::DQ_OFF, bytes);
          }
          repro_hopper::bulk_commit();
          repro_hopper::bulk_wait();             // read, added, visible
          repro_hopper::mbar_arrive(dq_empty);
          fence_async_global();
          __threadfence();
          repro_hopper::st_release_gpu(ticket, n + 1);
        }
      }
    } else {                                // delta: a row a thread
      const int r = tid - 256 - 64;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % W_STAGES;
        repro_hopper::mbar_wait(&full[s], (it / W_STAGES) & 1);
        unsigned char* stg = sm + L::ST_OFF + s * L::STAGE;
        float acc = 0.f;
#pragma unroll 2
        for (int c = 0; c < D / 8; ++c) {
          const int off = (c / 8) * W_BQ * 128 + swz(r, c % 8);
          float gf[8], of[8];
          unpack8(*reinterpret_cast<const uint4*>(stg + L::G_IN + off), gf);
          unpack8(*reinterpret_cast<const uint4*>(stg + L::O_IN + off), of);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(gf[e], of[e], acc);
        }
        reinterpret_cast<float*>(stg + L::DL_IN)[r] = acc;
        __syncwarp();
        if (lane == 0) repro_hopper::mbar_arrive(&dl_ready[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int warp = (tid % 128) / 32;
  const int kr = 64 * wg + 16 * warp + lane / 4;     // tile rows kr, kr + 8
  const int jk[2] = {j0 + kr, j0 + kr + 8};
  const bool key_ok[2] = {jk[0] < T_len, jk[1] < T_len};
  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;
  const int xr = (lane / 4) & 7;
  unsigned char* dsp = sm + L::DS_OFF + kr * 128 + 4 * (lane % 4);
  const uint32_t ka = sb + L::K_OFF + wg * 64 * 128;
  const uint32_t va = sb + L::V_OFF + wg * 64 * 128;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  repro_hopper::mbar_wait(kv_bar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % W_STAGES;
    const int q0 = (m_first + it / R) * W_BQ;
    repro_hopper::mbar_wait(&full[s], (it / W_STAGES) & 1);
    repro_hopper::mbar_wait(&dl_ready[s], (it / W_STAGES) & 1);
    const unsigned char* stg = sm + L::ST_OFF + s * L::STAGE;
    const uint32_t qa = smem_u32(stg + L::Q_IN), ga = smem_u32(stg + L::G_IN);
    const float* Ls = reinterpret_cast<const float*>(stg + L::L_IN);
    const float* Dl = reinterpret_cast<const float*>(stg + L::DL_IN);

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float s_[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s_[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t kx = (ks / 4) * W_KEYS * 128 + (ks % 4) * 32;
        const uint32_t qx = (ks / 4) * W_BQ * 128 + half * 32 * 128 +
                            (ks % 4) * 32;
        wgmma_ss32_kk(s_, gmma_desc(ka + kx, 16, 1024),
                      gmma_desc(qa + qx, 16, 1024));
        wgmma_ss32_kk(dp, gmma_desc(va + kx, 16, 1024),
                      gmma_desc(ga + qx, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      repro_hopper::fence_acc(s_);
      repro_hopper::fence_acc(dp);
      // the other warpgroup's dQ product of the last chunk reads every row
      // of dS^T: wait until it is done before the first write over ours
      if (half == 0) asm volatile("bar.sync 2, 256;" ::: "memory");
      // register 4j + 2i + e: key row kr + 8i, query c_j + e of the chunk
      // (c_j = 32 half + 8j + 2 (lane % 4))
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = half * 32 + 8 * j + 2 * (lane % 4);
        const float2 lv = *reinterpret_cast<const float2*>(Ls + c);
        const float2 dl = *reinterpret_cast<const float2*>(Dl + c);
        const float lq[2] = {lv.x * LOG2E, lv.y * LOG2E};
        const float dq2[2] = {dl.x, dl.y};
        const int qi[2] = {q0 + c, q0 + c + 1};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const float ev = ex2_ftz(fmaf(s_[x], sl2, -lq[e]));
            const bool ok = key_ok[i] && qi[e] < S &&
                            (!causal || jk[i] <= qi[e]);
            const float pv = ok ? ev : 0.f;
            s_[x] = pv;
            dp[x] = pv * (dp[x] - dq2[e]);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              dsp + i * 8 * 128 + (((half * 4 + j) ^ xr) << 4)) =
              __floats2bfloat162_rn(dp[4 * j + 2 * i], dp[4 * j + 2 * i + 1]);
        }
      }
      // dV += P^T dO, dK += dS^T Q: 16 queries a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s_[8 * kk], s_[8 * kk + 1]),
            pack_bf16(s_[8 * kk + 2], s_[8 * kk + 3]),
            pack_bf16(s_[8 * kk + 4], s_[8 * kk + 5]),
            pack_bf16(s_[8 * kk + 6], s_[8 * kk + 7])};
        const uint32_t sa[4] = {
            pack_bf16(dp[8 * kk], dp[8 * kk + 1]),
            pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]),
            pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]),
            pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7])};
        const uint32_t row = (half * 32 + kk * 16) * 128;
        wgmma_rs_mn<D>(dv_acc, pa, gmma_desc(ga + row, W_BQ * 128, 1024));
        wgmma_rs_mn<D>(dk_acc, sa, gmma_desc(qa + row, W_BQ * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait0();
      repro_hopper::fence_acc(dv_acc);
      repro_hopper::fence_acc(dk_acc);
    }
    // both warpgroups' dS^T written (generic -> async proxy) and the
    // stage read: release it to the producer
    repro_hopper::fence_async_smem();
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (lane == 0) repro_hopper::mbar_arrive(&empty[s]);

    // dQ = dS K over the tile's keys (dS^T and K MN-major) into shared
    // memory for the writer, once it has sent the last chunk's
    // (at D = 64 both warpgroups run the product, so that no branch
    // divides them around wgmma, and the first stores it)
    {
      const int cb = D > 64 ? wg : 0;            // the column block
      float dqa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < W_KEYS / 16; ++ks) {
        const uint32_t r = ks * 16 * 128;
        wgmma_ss64_mnmn(
            dqa, gmma_desc(sb + L::DS_OFF + r, 8192, 1024),
            gmma_desc(sb + L::K_OFF + cb * W_KEYS * 128 + r, 8192, 1024));
      }
      wgmma_commit();
      repro_hopper::mbar_wait(dq_empty, (it & 1) ^ 1);
      wgmma_wait0();
      repro_hopper::fence_acc(dqa);
      if (D == 64 && wg == 1) continue;
      // register 4j + 2i + e: query 16 warp + lane / 4 + 8i, column
      // 64 wg + 8j + 2 (lane % 4) + e; the 16-byte piece p of a row at
      // p ^ (row & DQ_SWZ) (no bank conflicts; the cast undoes it).  At
      // D = 112 the second warpgroup's last 16 columns (the zero-filled
      // keys' columns of its box) are not stored
      float* dqs = reinterpret_cast<float*>(sm + L::DQ_OFF);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + lane / 4 + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * wg + 8 * j + 2 * (lane % 4);
          if (D == 112 && wg == 1 && j >= 6) continue;
          const int p = (col / 4) ^ (row & DQ_SWZ<D>);
          *reinterpret_cast<float2*>(dqs + row * D + 4 * p + col % 4) =
              make_float2(dqa[4 * j + 2 * i], dqa[4 * j + 2 * i + 1]);
        }
      }
      repro_hopper::fence_async_smem();
      __syncwarp();
      if (lane == 0) repro_hopper::mbar_arrive(dq_full);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!key_ok[i]) continue;
    bf* kp = dk + b * st.dk[0] + (long long)jk[i] * st.dk[1] + kvh * st.dk[2];
    bf* vp = dv + b * st.dv[0] + (long long)jk[i] * st.dv[1] + kvh * st.dv[2];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int x = 4 * c + 2 * i, d = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(kp + d) = __floats2bfloat162_rn(
          dk_acc[x] * scale, dk_acc[x + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vp + d) =
          __floats2bfloat162_rn(dv_acc[x], dv_acc[x + 1]);
    }
  }
}

// dq[b, s, h, :] = scale ws[(b H + h) S + s, :] in bf16, undoing the
// writer's swizzle of 16-byte pieces (piece p of row s at p ^ (s &
// DQ_SWZ)); a thread 8 values
template <int D>
__global__ void __launch_bounds__(256)
flash_attention_bwd_dq_cast(const float* __restrict__ ws,
                            __nv_bfloat16* __restrict__ dq, int H, int S,
                            long long rows, BwdStrides st, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * (D / 8)) return;
  const long long row = i / (D / 8);
  const int c = (int)(i % (D / 8));              // 8 values: pieces 2c, 2c+1
  const int s_ = (int)(row % S);
  const long long bh = row / S;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const float* src = ws + row * D;
  const float4 a = __ldcs(reinterpret_cast<const float4*>(
      src + 4 * ((2 * c) ^ (s_ & DQ_SWZ<D>))));
  const float4 e = __ldcs(reinterpret_cast<const float4*>(
      src + 4 * ((2 * c + 1) ^ (s_ & DQ_SWZ<D>))));
  uint4 out;
  out.x = pack_bf16(a.x * scale, a.y * scale);
  out.y = pack_bf16(a.z * scale, a.w * scale);
  out.z = pack_bf16(e.x * scale, e.y * scale);
  out.w = pack_bf16(e.z * scale, e.w * scale);
  *reinterpret_cast<uint4*>(dq + b * st.dq[0] + (long long)s_ * st.dq[1] +
                            h * st.dq[2] + 8 * c) = out;
}

// the 4-D map (D, rows, heads, batch) of a (batch, seq, head) strided
// bf16 tensor (strides in elements), boxes of 64 columns x box_rows rows
inline bool encode_bshd(CUtensorMap* map, const void* p, int D, int rows,
                        int heads, int B, const long long (&s)[3],
                        int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[1] * 2, (cuuint64_t)s[2] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  return repro_hopper::encode_bf16_map4(map, p, dims, strides, box);
}

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dO, const float* lse,
                     float* ws, int* tickets, void* dq, void* dk, void* dv,
                     int B, int H, int KH, int S, int T_len,
                     const BwdStrides& st, float scale, int causal,
                     cudaStream_t s) {
  using bf = __nv_bfloat16;
  CUtensorMap mq, mk, mv, mo, mg;
  if (!encode_bshd(&mq, q, D, S, H, B, st.q, W_BQ) ||
      !encode_bshd(&mk, k, D, T_len, KH, B, st.k, W_KEYS) ||
      !encode_bshd(&mv, v, D, T_len, KH, B, st.v, W_KEYS) ||
      !encode_bshd(&mo, o, D, S, H, B, st.o, W_BQ) ||
      !encode_bshd(&mg, dO, D, S, H, B, st.dO, W_BQ))
    return -2;
  constexpr int bytes = WgmmaSmem<D>::BYTES;
  // once per instantiation and process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bwd_wgmma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int NT = (T_len + W_KEYS - 1) / W_KEYS;
  flash_attention_bwd_wgmma<D><<<B * KH * NT, W_THREADS, bytes, s>>>(
      mq, mk, mv, mo, mg, lse, ws, tickets, static_cast<bf*>(dk),
      static_cast<bf*>(dv), B, H, KH, S, T_len, st, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)B * H * S;
  flash_attention_bwd_dq_cast<D>
      <<<(unsigned)((rows * (D / 8) + 255) / 256), 256, 0, s>>>(
          ws, static_cast<bf*>(dq), H, S, rows, st, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 backward on FMAs (the parity path): one thread a row, 32 rows a
// block, the other side's rows staged in shared memory 32 at a time.
template <int D>
__global__ void __launch_bounds__(BF_ROWS)
flash_attention_bwd_dq_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dO,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int H, int KH, int S,
                           int T_len, BwdStrides st, float scale,
                           int causal) {
  __shared__ float Qs[BF_ROWS][D + 1], Gs[BF_ROWS][D + 1];
  __shared__ float Ks[BF_ROWS][D + 1], Vs[BF_ROWS][D + 1];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int row = blockIdx.y * BF_ROWS + tid;
  const bool ok = row < S;
  for (int d = 0; d < D; ++d) {
    Qs[tid][d] = ok ? q[b * st.q[0] + (long long)row * st.q[1] +
                        h * st.q[2] + d] : 0.f;
    Gs[tid][d] = ok ? dO[b * st.dO[0] + (long long)row * st.dO[1] +
                         h * st.dO[2] + d] : 0.f;
  }
  const float L = ok ? lse[(long long)bh * S + row] : 0.f;
  const float Dv = ok ? delta[(long long)bh * S + row] : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  // causal: keys past the block's last row are dead
  const int t_end = causal ? min(T_len, (int)blockIdx.y * BF_ROWS + BF_ROWS)
                           : T_len;
  for (int t0 = 0; t0 < t_end; t0 += BF_ROWS) {
    __syncthreads();
    for (int i = tid; i < BF_ROWS * D; i += BF_ROWS) {
      const int j = i / D, d = i % D;
      const bool kok = t0 + j < T_len;
      Ks[j][d] = kok ? k[b * st.k[0] + (long long)(t0 + j) * st.k[1] +
                         kvh * st.k[2] + d] : 0.f;
      Vs[j][d] = kok ? v[b * st.v[0] + (long long)(t0 + j) * st.v[1] +
                         kvh * st.v[2] + d] : 0.f;
    }
    __syncthreads();
    const int nj = min(BF_ROWS, (causal ? min(t_end, row + 1) : T_len) - t0);
    for (int j = 0; j < nj; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        sc = fmaf(Qs[tid][d], Ks[j][d], sc);
        dp = fmaf(Gs[tid][d], Vs[j][d], dp);
      }
      const float ds = expf(sc * scale - L) * (dp - Dv);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
    }
  }
  if (ok) {
    float* qp = dq + b * st.dq[0] + (long long)row * st.dq[1] + h * st.dq[2];
#pragma unroll
    for (int d = 0; d < D; ++d) qp[d] = acc[d] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(BF_ROWS)
flash_attention_bwd_dkdv_f32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int KH, int S, int T_len, BwdStrides st,
                             float scale, int causal) {
  __shared__ float Ks[BF_ROWS][D + 1], Vs[BF_ROWS][D + 1];
  __shared__ float Qs[BF_ROWS][D + 1], Gs[BF_ROWS][D + 1];
  __shared__ float Ls[BF_ROWS], Dl[BF_ROWS];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / KH, kvh = blockIdx.x % KH;
  const int R = H / KH;
  const int j = blockIdx.y * BF_ROWS + tid;
  const bool ok = j < T_len;
  for (int d = 0; d < D; ++d) {
    Ks[tid][d] = ok ? k[b * st.k[0] + (long long)j * st.k[1] +
                        kvh * st.k[2] + d] : 0.f;
    Vs[tid][d] = ok ? v[b * st.v[0] + (long long)j * st.v[1] +
                        kvh * st.v[2] + d] : 0.f;
  }
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  for (int r = 0; r < R; ++r) {
    const int h = kvh * R + r;
    const long long bh = (long long)b * H + h;
    // causal: queries before the block's first key see none of its keys
    for (int s0 = causal ? (int)blockIdx.y * BF_ROWS : 0; s0 < S;
         s0 += BF_ROWS) {
      __syncthreads();
      for (int i = tid; i < BF_ROWS * D; i += BF_ROWS) {
        const int si = i / D, d = i % D;
        const bool qok = s0 + si < S;
        Qs[si][d] = qok ? q[b * st.q[0] + (long long)(s0 + si) * st.q[1] +
                            h * st.q[2] + d] : 0.f;
        Gs[si][d] = qok ? dO[b * st.dO[0] + (long long)(s0 + si) * st.dO[1] +
                             h * st.dO[2] + d] : 0.f;
      }
      if (s0 + tid < S) {
        Ls[tid] = lse[bh * S + s0 + tid];
        Dl[tid] = delta[bh * S + s0 + tid];
      }
      __syncthreads();
      const int ns = min(BF_ROWS, S - s0);
      for (int i = 0; i < ns; ++i) {
        float sc = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          sc = fmaf(Ks[tid][d], Qs[i][d], sc);
          dp = fmaf(Vs[tid][d], Gs[i][d], dp);
        }
        const float p = ok && (!causal || s0 + i >= j)
                            ? expf(sc * scale - Ls[i]) : 0.f;
        const float ds = p * (dp - Dl[i]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, Gs[i][d], dva[d]);
          dka[d] = fmaf(ds, Qs[i][d], dka[d]);
        }
      }
    }
  }
  if (ok) {
    float* kp = dk + b * st.dk[0] + (long long)j * st.dk[1] + kvh * st.dk[2];
    float* vp = dv + b * st.dv[0] + (long long)j * st.dv[1] + kvh * st.dv[2];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kp[d] = dka[d] * scale;
      vp[d] = dva[d];
    }
  }
}

// The fp32 backward on FMAs: the delta pre-pass, then dK/dV and dQ.  Its
// arrays are D floats a thread (dK and dV 2 D), and its four staged tiles
// of 32 rows static shared memory, so it is instantiated at every head dim
// the fp32 forward takes but 112 and 128 (8 and 16: the smoke configs;
// 64): at 112 the tiles take 57.9 KB, past the 48 KB of static shared
// memory, and the 224 accumulators a thread of dK/dV would spill.
template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KH, int S, int T_len, const BwdStrides& st,
                   float scale, int causal, cudaStream_t s) {
  const long long rows = (long long)B * H * S;
  const unsigned dblocks = (unsigned)((rows + 3) / 4);
  flash_attention_bwd_delta<float><<<dblocks, 128, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dO), delta, H,
      S, D, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv_f32<D>
      <<<dim3(B * KH, (T_len + BF_ROWS - 1) / BF_ROWS), BF_ROWS, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dO), lse,
          delta, static_cast<float*>(dk), static_cast<float*>(dv), H, KH, S,
          T_len, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq_f32<D>
      <<<dim3(B * H, (S + BF_ROWS - 1) / BF_ROWS), BF_ROWS, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dO), lse,
          delta, static_cast<float*>(dq), H, KH, S, T_len, st, scale,
          causal);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------- forward: wgmma ----

constexpr int F_BQ = 128;         // query rows a tile: 64 a consumer warpgroup
constexpr int F_BKV = 128;        // keys a K or V tile
constexpr int F_THREADS = 3 * 128;   // 2 consumer warpgroups, a producer's

// Shared memory of the wgmma forward at head dim D (bf16 tiles swizzled,
// 128-byte rows, 1024-byte aligned; a row of D > 64 is two 64-column
// boxes, each box its own run of rows, the second of D = 112 48 columns
// wide and zero-filled past them): two slots of a 128-row Q tile, STAGES
// K tiles and STAGES V tiles of 128 keys, the mbarriers, and what the
// producer tells the consumers of the tile in each Q slot.
template <int D>
struct FwdSmem {
  static constexpr int NB = (D + 63) / 64;           // 64-column boxes
  static constexpr int STAGES = D == 64 ? 4 : 2;     // K (and V) tiles
  static constexpr int BOX_Q = F_BQ * 128, BOX_KV = F_BKV * 128;
  static constexpr int Q_TILE = NB * BOX_Q, KV_TILE = NB * BOX_KV;
  static constexpr int Q_OFF = 0, K_OFF = 2 * Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BARS = 4 + 4 * STAGES;
  static constexpr int TILE_OFF = BAR_OFF + 8 * BARS;  // 2 x {bh, qt, n_kv}
  static constexpr int BYTES = TILE_OFF + 32 + 1024;   // + alignment
};

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// mbar_wait on a barrier's shared address, but a wait past ~4 s is a
// fault: the launch fails (trap) rather than hangs
__device__ __forceinline__ void fwd_wait(uint32_t bar, int parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t0 == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void fwd_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// named barriers of the two consumer warpgroups (bar 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x 128, fp32) = (acc ? d : 0) + A (64 x 16, shared, K-major) * B
// (16 x 128, shared, K-major); descriptors as repro_hopper::gmma_desc
// builds them
__device__ __forceinline__ void wgmma_ss128_kk(float (&d)[64], uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n\t}"
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
      : "l"(da), "l"(db), "r"(acc));
}

// S = Q K^T of one K tile: the warpgroup's 64 query rows (qa) against the
// tile's 128 keys (ka), D / 16 steps (a box every 4), issued and committed
template <int D>
__device__ __forceinline__ void fwd_qk(float (&s)[64], uint32_t qa,
                                       uint32_t ka) {
  using repro_hopper::gmma_desc;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss128_kk(
        s, gmma_desc(qa + (ks / 4) * (F_BQ * 128) + (ks % 4) * 32, 16, 1024),
        gmma_desc(ka + (ks / 4) * (F_BKV * 128) + (ks % 4) * 32, 16, 1024),
        ks);
  wgmma_commit();
}

// O += P V of one V tile (va): P (bf16) from registers, 16 keys a step
template <int D>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2],
                                       uint32_t (&pa)[F_BKV / 16][4],
                                       uint32_t va) {
  using repro_hopper::gmma_desc;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < F_BKV / 16; ++kk) {
    const uint64_t db = gmma_desc(va + kk * 16 * 128, F_BKV * 128, 1024);
    if constexpr (D == 64) wgmma_rs64_mn(o, pa[kk], db);
    else if constexpr (D == 112) wgmma_rs112_mn(o, pa[kk], db);
    else wgmma_rs128_mn(o, pa[kk], db);
  }
  wgmma_commit();
}

// The online softmax over one tile's scores (register 4j + 2i + e: row
// r_lo + 8i, key k0 + 8j + 2 (lane % 4) + e), masked first (keys >= T,
// causal keys past the row: -inf, selects only) when the tile reaches
// either edge.  m: each row's running max of the raw scores; l: this
// thread's share of each row's denominator (summed from the fp32 p); corr:
// the factor that brings o to the new max.  p = 2^(s scale log2e - m scale
// log2e) stays in s.
__device__ __forceinline__ void fwd_softmax(float (&s)[64], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            bool mask, int k0, int r_lo,
                                            int T_len, int causal,
                                            float sl2) {
  const float NEG_INF = -__int_as_float(0x7f800000);
  if (mask) {
    const int kb = k0 + 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + 8 * j + e;
          const bool ok = key < T_len && (!causal || key <= r_lo + 8 * i);
          s[4 * j + 2 * i + e] = ok ? s[4 * j + 2 * i + e] : NEG_INF;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row that has seen no key keeps zeros (m = -inf: corr = 0, p = 0)
    const float ms = mx == NEG_INF ? 0.f : mx * sl2;
    corr[i] = ex2_ftz(m[i] * sl2 - ms);
    m[i] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2_ftz(fmaf(s[4 * j + 2 * i + e], sl2, -ms));
        s[4 * j + 2 * i + e] = p;
        rs += p;
      }
    l[i] = l[i] * corr[i] + rs;
  }
}

// P rounded to bf16 as the A fragments of PV, 16 keys each
__device__ __forceinline__ void fwd_pack(const float (&s)[64],
                                         uint32_t (&pa)[F_BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < F_BKV / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void fwd_rescale(float (&o)[N],
                                            const float (&corr)[2]) {
#pragma unroll
  for (int x = 0; x < N; ++x) o[x] *= corr[(x / 2) % 2];
}

// Tile t of the schedule, as kernels/flash_attention.py:wgmma_fwd_tile:
// causal, the (batch, head) pairs in groups of `group` whose K and V fit
// in L2 together, and within a group the query tiles that see the most
// keys first, its heads fastest; otherwise a head's query tiles one after
// another (they share its K and V in L2).
__device__ __forceinline__ void fwd_tile(int t, int BH, int nq, int causal,
                                         int group, int& bh, int& qt) {
  if (causal) {
    const int g = t / (group * nq), i = t % (group * nq);
    const int gh = min(group, BH - g * group);   // the last group's heads
    bh = g * group + i % gh;
    qt = nq - 1 - i / gh;
  } else {
    bh = t / nq;
    qt = t % nq;
  }
}

// K tiles a query tile reads: every tile of T, or causally up to the one
// holding its last row's diagonal key
__device__ __forceinline__ int fwd_n_kv(int qt, int nt, int causal) {
  return causal ? min(nt, (qt * F_BQ + F_BQ + F_BKV - 1) / F_BKV) : nt;
}

// Persistent: the B * H * ceil(S / 128) query tiles in fwd_tile's order,
// block x first tile x, then (`dynamic`) each the next tile not yet taken
// from an int32 counter, zero at launch, so the blocks that finish first
// take more; or (causal calls whose K and V fit in L2 at once) rounds of
// gridDim.x tiles taken left to right and right to left in turn, which
// evens the blocks' causal work without the counter's latency.  The
// producer (one thread
// of the third warpgroup, which setmaxnreg leaves 40 registers) loads each
// tile's Q by TMA into one of two slots, then its K and V tiles into rings
// of STAGES slots (K_0, then K_j+1 before V_j), each behind a full and an
// empty mbarrier; it runs ahead across tiles.  Consumer warpgroup wg owns
// the tile's rows 64 wg .. + 63: S = Q K^T on wgmma from shared memory
// (m64n128k16, both K-major), the online softmax in fp32 registers, P in
// bf16 registers as the A operand of O += P V (m64nDk16, V MN-major).
// Tile j + 1's S product is issued before tile j's softmax runs, then
// tile j's PV (intra-warpgroup overlap); and at D > 64 the two warpgroups
// take turns issuing (named barriers 1 and 2), so that one's softmax runs
// under the other's products; at D = 64 the second warpgroup starts one
// softmax behind the first.  No branch divides a warpgroup around a wgmma.
template <int D>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_attention_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse,
                          int* __restrict__ next_tile, int B, int H, int KH,
                          int S, int T_len, long long o_sb, long long o_ss,
                          long long o_sh, float scale, int causal,
                          int group, int dynamic) {
  using L = FwdSmem<D>;
  constexpr int ST = L::STAGES;
  extern __shared__ unsigned char fw_raw[];
  unsigned char* sm = fw_raw + ((1024 - (smem_u32(fw_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  volatile int* tile_info = reinterpret_cast<int*>(sm + L::TILE_OFF);
  // the consumers' barrier addresses (32-bit shared: fewer registers)
  const uint32_t bq_full = smem_u32(q_full), bq_empty = smem_u32(q_empty);
  const uint32_t bk_full = smem_u32(k_full), bk_empty = smem_u32(k_empty);
  const uint32_t bv_full = smem_u32(v_full), bv_empty = smem_u32(v_empty);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int BH = B * H, R = H / KH;
  const int nq = (S + F_BQ - 1) / F_BQ, nt = (T_len + F_BKV - 1) / F_BKV;
  const int n_tiles = BH * nq;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      repro_hopper::mbar_init(&q_full[i], 1);    // the producer's arrival
      repro_hopper::mbar_init(&q_empty[i], 8);   // one per consumer warp
    }
    for (int s = 0; s < ST; ++s) {
      repro_hopper::mbar_init(&k_full[s], 1);
      repro_hopper::mbar_init(&k_empty[s], 8);
      repro_hopper::mbar_init(&v_full[s], 1);
      repro_hopper::mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    repro_hopper::fence_async_smem();
  }
  __syncthreads();

  if (wg == 2) {
    // give the consumers the registers: 2 x 128 x 232 + 128 x 40 <= 64 K
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 256) {                  // the producer
      int qc = 0, kc = 0, vc = 0;
      // the next K or V tile j of (kv head kvh, batch b) into its ring
      auto load = [&](const CUtensorMap* map, int off, uint64_t* full,
                      uint64_t* empty, int& c, int j, int kvh, int b) {
        const int s = c % ST;
        fwd_wait(smem_u32(&empty[s]), ((c / ST) & 1) ^ 1);
        repro_hopper::mbar_expect_tx(&full[s], L::KV_TILE);
#pragma unroll
        for (int x = 0; x < L::NB; ++x)
          repro_hopper::tma_load_4d(sm + off + s * L::KV_TILE + x * L::BOX_KV,
                                    map, &full[s], 64 * x, j * F_BKV, kvh, b);
        ++c;
      };
      for (int t = blockIdx.x, r = 1;; ++r) {
        const int qs = qc & 1;
        fwd_wait(bq_empty + 8 * qs, ((qc >> 1) & 1) ^ 1);
        volatile int* info = tile_info + 4 * qs;   // published by the arrival
        if (t >= n_tiles) {              // the end: the consumers stop
          info[1] = -1;
          repro_hopper::mbar_arrive(&q_full[qs]);
          break;
        }
        int bh, qt;
        fwd_tile(t, BH, nq, causal, group, bh, qt);
        const int b = bh / H, h = bh % H, kvh = h / R;
        const int n_kv = fwd_n_kv(qt, nt, causal);
        info[0] = bh;
        info[1] = qt;
        info[2] = n_kv;
        repro_hopper::mbar_expect_tx(&q_full[qs], L::Q_TILE);
#pragma unroll
        for (int x = 0; x < L::NB; ++x)
          repro_hopper::tma_load_4d(sm + L::Q_OFF + qs * L::Q_TILE +
                                        x * L::BOX_Q,
                                    &map_q, &q_full[qs], 64 * x, qt * F_BQ, h,
                                    b);
        ++qc;
        if (n_kv > 0) load(&map_k, L::K_OFF, k_full, k_empty, kc, 0, kvh, b);
        for (int j = 0; j < n_kv; ++j) {
          if (j + 1 < n_kv)
            load(&map_k, L::K_OFF, k_full, k_empty, kc, j + 1, kvh, b);
          load(&map_v, L::V_OFF, v_full, v_empty, vc, j, kvh, b);
        }
        t = dynamic ? atomicAdd(next_tile, 1) + (int)gridDim.x
                    : r * gridDim.x + (r % 2 == 0 ? blockIdx.x
                                                  : gridDim.x - 1 - blockIdx.x);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int warp = (tid % 128) / 32;
  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;
  const float NEG_INF = -__int_as_float(0x7f800000);
  // turns (D > 64): warpgroup wg issues its products after bar.sync 1 + wg
  // and then lets the other go; the second warpgroup lets the first start.
  // At D = 64 the turns cost more than they hid (DiT-L/2's and the
  // sandwich step's short rows, PERF.md): the second warpgroup starts once
  // the first has run its first softmax (bar 3), and then runs free.
  constexpr bool TURNS = D > 64;
  if (TURNS && wg == 1) bar_arrive(1, 256);
  if (!TURNS && wg == 1) bar_sync(3, 256);
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  uint32_t pa[F_BKV / 16][4];
  int qc = 0, kc = 0, vc = 0;
  // the producer's word on the tile in Q slot qc % 2 (no index math here):
  // its query tile, or -1 at the end.  The loop tests it at the top: with
  // the wait and a `break` opening the body instead, ptxas kept these
  // warpgroups to the launch's 168 registers and spilled (PERF.md)
  auto next = [&]() {
    fwd_wait(bq_full + 8 * (qc & 1), (qc >> 1) & 1);
    return tile_info[4 * (qc & 1) + 1];
  };
  bool first = true;
  for (int qt = next(); qt >= 0; qt = next(), first = false) {
    const int qs = qc & 1;
    ++qc;
    const int bh = tile_info[4 * qs], n_kv = tile_info[4 * qs + 2];
    const int q0 = qt * F_BQ;
    const int r_lo = q0 + 64 * wg + 16 * warp + lane / 4;   // and r_lo + 8
    const uint32_t qa = sb + L::Q_OFF + qs * L::Q_TILE + wg * 64 * 128;
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
    // the tile reaches past T, or causally past the q tile's first row
    auto edge = [&](int j) {
      return (j + 1) * F_BKV > T_len || (causal && (j + 1) * F_BKV - 1 > q0);
    };
    if (n_kv > 0) {                    // uniform over the block
      int st = kc % ST;
      fwd_wait(bk_full + 8 * st, (kc / ST) & 1);
      if (TURNS) bar_sync(1 + wg, 256);
      fwd_qk<D>(s, qa, sb + L::K_OFF + st * L::KV_TILE);
      if (TURNS) bar_arrive(2 - wg, 256);
      wgmma_wait0();
      repro_hopper::fence_acc(s);
      if (lane == 0) fwd_arrive(bk_empty + 8 * st);
      ++kc;
      fwd_softmax(s, m, l, corr, edge(0), 0, r_lo, T_len, causal, sl2);
      fwd_pack(s, pa);
      if (!TURNS && first && wg == 0) bar_arrive(3, 256);
#pragma unroll 1
      for (int j = 1; j < n_kv; ++j) {
        st = kc % ST;
        const int vs = vc % ST;
        fwd_wait(bk_full + 8 * st, (kc / ST) & 1);
        if (TURNS) bar_sync(1 + wg, 256);
        fwd_qk<D>(s, qa, sb + L::K_OFF + st * L::KV_TILE);
        fwd_rescale(oacc, corr);
        fwd_wait(bv_full + 8 * vs, (vc / ST) & 1);
        fwd_pv<D>(oacc, pa, sb + L::V_OFF + vs * L::KV_TILE);
        if (TURNS) bar_arrive(2 - wg, 256);
        wgmma_wait1();                 // S of tile j (PV of j - 1 runs on)
        repro_hopper::fence_acc(s);
        if (lane == 0) fwd_arrive(bk_empty + 8 * st);
        ++kc;
        fwd_softmax(s, m, l, corr, edge(j), j * F_BKV, r_lo, T_len, causal,
                    sl2);
        wgmma_wait0();
        repro_hopper::fence_acc(oacc);
        fence_frag(pa);
        repro_hopper::fence_acc(s);
        if (lane == 0) fwd_arrive(bv_empty + 8 * vs);
        ++vc;
        fwd_pack(s, pa);
      }
      fwd_rescale(oacc, corr);
      const int vs = vc % ST;
      fwd_wait(bv_full + 8 * vs, (vc / ST) & 1);
      fwd_pv<D>(oacc, pa, sb + L::V_OFF + vs * L::KV_TILE);
      wgmma_wait0();
      repro_hopper::fence_acc(oacc);
      fence_frag(pa);
      if (lane == 0) fwd_arrive(bv_empty + 8 * vs);
      ++vc;
    }
    if (lane == 0) fwd_arrive(bq_empty + 8 * qs);
    const int b = bh / H, h = bh % H;

    // o = acc / l in bf16 through o's strides, and the logsumexp
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 8 * i;
      if (row >= S) continue;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      if (lse != nullptr && lane % 4 == 0)
        lse[(long long)bh * S + row] =
            l[i] > 0.f ? m[i] * scale + logf(l[i]) : NEG_INF;
      __nv_bfloat16* op = o + b * o_sb + (long long)row * o_ss + h * o_sh +
                          2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * i] * inv,
                                  oacc[4 * j + 2 * i + 1] * inv);
    }
  }
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KH, int S, int T_len,
                     const long long* st, float scale, int causal,
                     float* lse, int blocks, int group, int dynamic,
                     int* next_tile, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  const long long sq[3] = {st[0], st[1], st[2]};
  const long long sk[3] = {st[3], st[4], st[5]};
  const long long sv[3] = {st[6], st[7], st[8]};
  if (!encode_bshd(&mq, q, D, S, H, B, sq, F_BQ) ||
      !encode_bshd(&mk, k, D, T_len, KH, B, sk, F_BKV) ||
      !encode_bshd(&mv, v, D, T_len, KH, B, sv, F_BKV))
    return -2;
  constexpr int bytes = FwdSmem<D>::BYTES;
  // once per instantiation and process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fwd_wgmma<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_attention_fwd_wgmma<D><<<blocks, F_THREADS, bytes, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, next_tile, B, H, KH,
      S, T_len, st[9], st[10], st[11], scale, causal, group, dynamic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn;
// the head dim is contiguous.  dtype: 0 = float32, 1 = bfloat16.  lse:
// null, or an fp32 (B, H, S) output for each row's logsumexp of the
// scaled scores (-inf for a row that sees no key), for the backward.
// Returns cudaGetLastError() after the launch; -1 for an unsupported
// dtype or D.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KH, int S, int T_len, int D,
                                     const long long* strides, float scale,
                                     int causal, int dtype, void* lse,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KH, S, T_len, D, strides,
                                 scale, causal, l, s);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, KH, S, T_len, D, strides, scale,
                         causal, l, s);
  return -1;
}

// The mma variant (bf16, D = 64, 112 or 128; strides and lse as above,
// 16-byte-aligned rows).  Returns as above; -1 for an unsupported D.
extern "C" int repro_flash_attention_mma(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int H, int KH, int S, int T_len,
                                         int D, const long long* strides,
                                         float scale, int causal, void* lse,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return launch_mma<64>(q, k, v, o, B, H, KH, S, T_len, strides, scale,
                          causal, l, s);
  if (D == 112)
    return launch_mma<112>(q, k, v, o, B, H, KH, S, T_len, strides, scale,
                           causal, l, s);
  if (D == 128)
    return launch_mma<128>(q, k, v, o, B, H, KH, S, T_len, strides, scale,
                           causal, l, s);
  return -1;
}

// The wgmma forward (bf16, D = 64, 112 or 128, S, T_len >= 1; strides and
// lse as repro_flash_attention's): q, k and v read by TMA (bases 16-byte
// aligned, strides of the dims of extent > 1 multiples of 8 elements),
// `blocks` persistent blocks over the B * H * ceil(S / 128) query tiles
// (at most that many), causal tiles in groups of `group` (batch, head)
// pairs, taken from the counter next_tile (one int32 zero) when `dynamic`,
// else dealt in alternating rounds.  Returns
// cudaGetLastError() after the launch; -1 for an unsupported D or shape,
// -2 when the tensor maps cannot be encoded.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int KH, int S, int T_len,
                                           int D, const long long* strides,
                                           float scale, int causal,
                                           void* lse, int blocks, int group,
                                           int dynamic, void* next_tile,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  int* n = static_cast<int*>(next_tile);
  if (S < 1 || T_len < 1 || B < 1 || KH < 1 || H % KH || blocks < 1 ||
      group < 1)
    return -1;
  if (D == 64)
    return launch_fwd_wgmma<64>(q, k, v, o, B, H, KH, S, T_len, strides,
                                scale, causal, l, blocks, group, dynamic, n,
                                s);
  if (D == 112)
    return launch_fwd_wgmma<112>(q, k, v, o, B, H, KH, S, T_len, strides,
                                 scale, causal, l, blocks, group, dynamic, n,
                                 s);
  if (D == 128)
    return launch_fwd_wgmma<128>(q, k, v, o, B, H, KH, S, T_len, strides,
                                 scale, causal, l, blocks, group, dynamic, n,
                                 s);
  return -1;
}

// The decode variant (bf16, S = 1, D = 64, 112 or 128, any H / KH) over
// a cache of T_cap keys of which the first min(*len, T_cap) are valid
// (`len` a device int32, >= 0: at 0 o is 0; the caller folds a causal
// mask into it), in `splits` chunks of `chunk` <= 256 keys planned from
// T_cap; `ws` an fp32 workspace of B*H*splits*(D + 2); `lse` null, or
// fp32 (B, H) for each row's logsumexp (-inf where no key is valid).
// Returns as above; -1 for an unsupported shape.
extern "C" int repro_flash_attention_decode_lse(
    const void* q, const void* k, const void* v, void* o, void* ws,
    const void* len, void* lse, int B, int H, int KH, int T_cap, int D,
    const long long* strides, float scale, int splits, int chunk,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk > D_CHUNK_MAX || KH < 1 || H % KH || splits < 1 || T_cap < 1)
    return -1;
  float* w = static_cast<float*>(ws);
  const int* n = static_cast<const int*>(len);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return launch_decode<64>(q, k, v, o, w, n, l, B, H, KH, T_cap, strides,
                             scale, splits, chunk, s);
  if (D == 112)
    return launch_decode<112>(q, k, v, o, w, n, l, B, H, KH, T_cap, strides,
                              scale, splits, chunk, s);
  if (D == 128)
    return launch_decode<128>(q, k, v, o, w, n, l, B, H, KH, T_cap, strides,
                              scale, splits, chunk, s);
  return -1;
}

// The same without the logsumexp (the entry point before it had one).
extern "C" int repro_flash_attention_decode_len(
    const void* q, const void* k, const void* v, void* o, void* ws,
    const void* len, int B, int H, int KH, int T_cap, int D,
    const long long* strides, float scale, int splits, int chunk,
    void* stream) {
  return repro_flash_attention_decode_lse(q, k, v, o, ws, len, nullptr, B, H,
                                          KH, T_cap, D, strides, scale,
                                          splits, chunk, stream);
}

// The fp32 backward (causal or not, D = 8, 16 or 64; causal masks key
// j > query i, positions from 0 in both): q, k, v,
// o, dO and the outputs dq, dk, dv read and written through (batch, seq, head) strides, 24 in all
// (q, k, v, o, dO, dq, dk, dv in turn), the head dim contiguous, rows
// lse the forward's (B, H, S) fp32 logsumexp, delta an fp32 (B, H, S)
// workspace.  dtype 0 (fp32) only, on FMAs: bf16 takes the resident and
// wgmma entry points below.  Returns cudaGetLastError() after the last
// launch; -1 for an unsupported dtype or D.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int KH, int S, int T_len, int D,
    const long long* strides, float scale, int causal, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdStrides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  if (T_len < 1) return -1;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype != 0) return -1;
  if (D == 8)
    return launch_bwd_f32<8>(q, k, v, o, dO, l, dl, dq, dk, dv, B, H, KH, S,
                             T_len, st, scale, causal, s);
  if (D == 16)
    return launch_bwd_f32<16>(q, k, v, o, dO, l, dl, dq, dk, dv, B, H, KH,
                              S, T_len, st, scale, causal, s);
  if (D == 64)
    return launch_bwd_f32<64>(q, k, v, o, dO, l, dl, dq, dk, dv, B, H, KH,
                              S, T_len, st, scale, causal, s);
  return -1;
}

// The wgmma backward (bf16, D = 64, 112 or 128, causal or not, S, T_len
// >= 1):
// one block per (key tile of 128, batch, kv head), one pass; q, k, v, o,
// dO, dq, dk, dv through (batch, seq, head) strides as above (24 in all),
// bases 16-byte aligned, strides of the dims of extent > 1 multiples of 8
// elements (TMA reads q, k, v, o and dO); lse the forward's (B, H, S) fp32
// logsumexp; ws an fp32 (B, H, S, D) workspace and tickets int32 zeros,
// one per (batch, head, chunk of 64 queries), 16-byte aligned.  Two
// launches (the pass, then dQ's cast).  Returns cudaGetLastError() after
// the last; -1 for an unsupported D or shape, -2 when the tensor maps
// cannot be encoded.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* ws, void* tickets, void* dq,
    void* dk, void* dv, int B, int H, int KH, int S, int T_len, int D,
    const long long* strides, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdStrides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  if (T_len < 1 || S < 1 || B < 1 || KH < 1 || H % KH) return -1;
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (D == 64)
    return launch_bwd_wgmma<64>(q, k, v, o, dO, l, w, tk, dq, dk, dv, B, H,
                                KH, S, T_len, st, scale, causal, s);
  if (D == 112)
    return launch_bwd_wgmma<112>(q, k, v, o, dO, l, w, tk, dq, dk, dv, B,
                                 H, KH, S, T_len, st, scale, causal, s);
  if (D == 128)
    return launch_bwd_wgmma<128>(q, k, v, o, dO, l, w, tk, dq, dk, dv, B, H,
                                 KH, S, T_len, st, scale, causal, s);
  return -1;
}

// The resident backward (bf16, non-causal, D = 64, 1 <= T_len <= 256): one
// block per (batch, kv head) holding all its keys in ceil(T_len / 64)
// warpgroups, one pass; q, k, v, o,
// dO, dq, dk, dv through (batch, seq, head) strides as above (24 in all),
// rows 16-byte aligned; lse the forward's (B, H, S) fp32 logsumexp.
// Returns cudaGetLastError() after the launch; -1 for an unsupported D or
// T_len.
extern "C" int repro_flash_attention_bwd_resident(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv, int B,
    int H, int KH, int S, int T_len, int D, const long long* strides,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdStrides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  if (D != 64 || T_len < 1 || T_len > R_T_MAX || S < 1) return -1;
  const float* l = static_cast<const float*>(lse);
  switch ((T_len + 63) / 64) {    // warpgroups of 64 keys
    case 1:
      return launch_bwd_resident<1>(q, k, v, o, dO, l, dq, dk, dv, B, H, KH,
                                    S, T_len, st, scale, s);
    case 2:
      return launch_bwd_resident<2>(q, k, v, o, dO, l, dq, dk, dv, B, H, KH,
                                    S, T_len, st, scale, s);
    case 3:
      return launch_bwd_resident<3>(q, k, v, o, dO, l, dq, dk, dv, B, H, KH,
                                    S, T_len, st, scale, s);
    default:
      return launch_bwd_resident<4>(q, k, v, o, dO, l, dq, dk, dv, B, H, KH,
                                    S, T_len, st, scale, s);
  }
}
