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
// Three variants, chosen on the host by kernels/flash_attention.py:
// choose_variant:
//
// * mma (bf16, D = 64 or 128, S > 1, 16-byte-aligned rows: the ViT at
//   S = T = 197, D = 64 and the LM's causal prefill at S = T = 512,
//   D = 128).  Bound: operations (4*S*T*D a head, half that causal) on
//   the tensor cores; the old FMA kernel ran QK^T and PV on fp32 FMAs from
//   fp32 copies of K and V.  This is the FlashAttention-2 layout on
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate): 4 warps, each owning 16
//   rows of a 64-row q tile; q fragments held in registers (ldmatrix); K
//   and V tiles of 64 keys kept in bf16 shared memory (rows padded by 16
//   bytes, so ldmatrix is free of bank conflicts), double-buffered with
//   16-byte cp.async whose source size zero-fills keys past T; S = QK^T
//   and the online softmax in fp32 registers; P rounded to bf16 in
//   registers and used directly as the A operand of PV (ldmatrix.trans
//   reads V as the B operand).  Causally dead KV tiles are skipped and the
//   diagonal tile masked; the grid runs (batch*head) fastest and, when
//   causal, the q tiles that see the most keys first, so the short tiles
//   fill the tail.  D = 128 takes 87 KB of dynamic shared memory
//   (the attribute is set once).  FA3-style wgmma with a TMA producer
//   warp and warp specialisation is later work.
// * decode (bf16, D = 64 or 128, S = 1, H / KH <= 8: every LM decode
//   step).  Bound: the bytes of the K/V cache (4*T*D bytes a kv head
//   against 4*T*D*R operations).  The old kernel gave each (batch, head)
//   one block with one live query row of 64 reading the whole cache
//   serially.  Here the grid is (B*KH, n_splits): each block takes the
//   R = H/KH query rows that share a kv head over one chunk of T (planned
//   on the host by decode_plan for ~2 blocks per SM, which measured
//   faster than 4), reads K and V rows with 16-byte loads (D/8 threads a
//   row, 4 rows in flight per thread), keeps the chunk's scores in
//   shared memory, and writes an fp32 partial (max,
//   denominator, accumulator) to a workspace; a second kernel merges the
//   partials in split order (deterministic, no atomics) and stores o.
//   The count of valid keys is read from a device int32 (the cache's
//   fill, which a CUDA graph of the decode step advances in place, as
//   the reference's traced `len` scalar); the grid is planned from the
//   cache's capacity, and a block whose chunk starts at or past the fill
//   writes an empty partial (max -inf, denominator 0) and exits, so the
//   device time follows the fill.  The merge skips empty partials.
// Backward (training; the TPU kernel has none): see "backward" below.
// The mma and fma variants write each row's fp32 logsumexp when asked,
// which is all the backward keeps of the forward's softmax.
//
// * fma (fp32 inputs, the smoke configs' head dims 8 and 16, and rows
//   that are not 16-byte aligned): the first port's kernel, kept as the
//   parity and smoke path.  128 threads, two per query row; each thread
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
constexpr int D_R_MAX = 8;        // query heads per kv head
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

// One block: kv head (b, kvh), keys [split*chunk, min(T, (split+1)*chunk))
// with T = min(*len, T_cap), its R query rows.  Writes ws_ml[bh][split] =
// (max, denominator) and ws_acc[bh][split][D] (unnormalised; p rounded to
// bf16 before PV); a chunk past T writes (-inf, 0) and zeros.
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
  constexpr int G = D / 8;             // threads a row, 8 dims each
  constexpr int SLOTS = 32 / G;        // rows a warp reads at once
  constexpr int STEP = D_WARPS * SLOTS;
  const float NEG_INF = -__int_as_float(0x7f800000);
  __shared__ float sc[D_R_MAX][D_CHUNK_MAX];
  __shared__ float red[D_WARPS][D_R_MAX][D];
  __shared__ float ml[D_R_MAX][2];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gi = lane % G, slot = lane / G;
  const int R = H / KH;
  const int b = blockIdx.x / KH, kvh = blockIdx.x % KH;
  const int split = blockIdx.y, splits = gridDim.y;
  const int T_len = min(__ldg(len), T_cap);
  const int t0 = split * chunk, t1 = min(T_len, t0 + chunk);
  const int n = t1 - t0;
  if (n <= 0) {     // past the fill: an empty partial (uniform per block)
    for (int i = tid; i < R * D; i += D_THREADS) {
      const long long bh = (long long)b * H + kvh * R + i / D;
      ws_acc[(bh * splits + split) * D + i % D] = 0.f;
    }
    if (tid < R) {
      const long long bh = (long long)b * H + kvh * R + tid;
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
    if (r < R) {
      unpack8(*reinterpret_cast<const uint4*>(
                  q + b * q_sb + (long long)(kvh * R + r) * q_sh + gi * 8),
              qv[r]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[r][e] *= scale;
    }
  }
  // scores: one row per slot, D/8 lanes a row, reduced across those
  // lanes; D_U rows per thread in flight (the loop runs alike on every
  // lane of a warp: it shuffles)
  for (int jb = warp * SLOTS; jb < n; jb += D_U * STEP) {
    uint4 kr[D_U];
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int j = jb + u * STEP + slot;
      kr[u] = j < n ? *reinterpret_cast<const uint4*>(
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
        if (r < R) {
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
  for (int r = warp; r < R; r += D_WARPS) {
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
      vr[u] = j < n ? *reinterpret_cast<const uint4*>(
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
          if (r < R) {
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
    if (r < R) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        if (slot == 0) red[warp][r][gi * 8 + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += D_THREADS) {
    const int r = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < D_WARPS; ++w) s += red[w][r][d];
    const long long bh = (long long)b * H + kvh * R + r;
    ws_acc[(bh * splits + split) * D + d] = s;
  }
  if (tid < R) {
    const long long bh = (long long)b * H + kvh * R + tid;
    ws_ml[(bh * splits + split) * 2] = ml[tid][0];
    ws_ml[(bh * splits + split) * 2 + 1] = ml[tid][1];
  }
}

// o[b, 0, h] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, in split
// order, over the splits with a denominator (an empty one adds nothing,
// and no NaN: its max is -inf); one block of D threads per (batch, head)
template <int D>
__global__ void __launch_bounds__(D)
flash_attention_merge(const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml,
                      __nv_bfloat16* __restrict__ o, int H, int splits,
                      long long o_sb, long long o_sh) {
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
                  float* ws, const int* len, int B, int H, int KH, int T_cap,
                  const long long* st, float scale, int splits, int chunk,
                  cudaStream_t s) {
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)B * H * splits * D;
  flash_attention_decode<D><<<dim3(B * KH, splits), D_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ws_acc, ws_ml, len, H, KH, T_cap,
      st[0], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_merge<D><<<B * H, D, 0, s>>>(
      ws_acc, ws_ml, static_cast<__nv_bfloat16*>(o), H, splits, st[9],
      st[11]);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward ----
//
// FlashAttention-2's backward, causal or not, D = 64 and (mma) 128.  With
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
//   call of the sandwich step, S = T = 197).  What the two passes below
//   cost at these shapes: 7 products where 5 do (S and dP twice), q, dO,
//   k and v read twice, a delta launch reading o and dO again.  Here one
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
// * mma (every other bf16 call at D = 64: S or T > 256, rows that are not
//   16-byte aligned, which the wrapper copies first).  Three kernels:
//   delta (one warp a row), dK/dV (a block per 64-key tile and (batch, kv
//   head), looping over the R query heads of that kv head and their query
//   tiles, so GQA's sum over heads stays in registers: deterministic) and
//   dQ (a block per 64-query tile and (batch, head), looping over the key
//   tiles: a separate pass, deterministic, no atomics).  Both recompute
//   S = Q K^T and dP = dO V^T on mma.sync with the forward's fragment
//   layouts (P and dS rounded to bf16 as A operands from registers, K, Q,
//   dO and V tiles in padded shared memory, double-buffered by cp.async);
//   dQ's separate pass costs the recomputation of S and dP again.
//   Causal (the LM's training, S = T = 4096, D = 128): a key tile's dK/dV
//   block starts at the query tile holding its first key, a query tile's
//   dQ block stops at the key tile holding its last query, so the dead
//   half of the tiles is never visited; the diagonal tile masks j > i.
//   What bounds it there: operations (the gradient needs 5 products of
//   2 S T D, halved by the mask: 10.7 GFLOP a head, ~11 us at 989
//   TFLOP/s against ~2.5 us for its 8.4 MB; these kernels run 7).  At
//   D = 128, dK and dV (64 registers each a thread) and the S / dP tiles
//   leave no room for Q's or K's fragments held across the loop (the
//   forward spilled at 255 registers fully unrolled): each 16-wide step
//   reads its fragment from shared memory with ldmatrix instead
//   (mma_rows_t_smem); the shared memory (105.5 KB) is set once per
//   instantiation.
//
// fp32 (fma_f32) runs the same three passes on FMAs, causal by the same
// skips at its 32-row blocks.

struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dO[3], dq[3], dk[3], dv[3];
};

constexpr int B_BQ = 64;          // queries a tile
constexpr int B_BKV = 64;         // keys a tile
constexpr int B_THREADS = 128;    // 4 warps, 16 rows each
constexpr int BF_ROWS = 32;       // fp32 kernels: rows a block (one a thread)

template <int D>
constexpr size_t bwd_smem_bytes() {
  // two single tiles and two double-buffered ones of 64 rows, plus
  // (dK/dV) two double-buffered vectors of 64 floats
  return sizeof(__nv_bfloat16) * (D + 8) * (2 * B_BKV + 4 * B_BQ) +
         sizeof(float) * 4 * B_BQ;
}

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

// A operand fragments (16 rows x D) of rows r0 .. r0 + 15 of a [.][D + 8]
// bf16 tile, as the forward loads its q fragments
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int r0, int lane) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    ldmatrix_x4(f[kd], tile + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                  (D + 8) + kd * 16 + (lane / 16) * 8);
}

// c[16 x 64] = A (16 x D, fragments) . rows^T, rows the 64 rows of a
// [.][D + 8] bf16 tile (the forward's S = Q K^T)
template <int D>
__device__ __forceinline__ void mma_rows_t(float (&c)[8][4],
                                           const uint32_t (&a)[D / 16][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, tile + (np * 16 + (lane % 8) + (lane / 16) * 8) * (D + 8)
                          + kd * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(c[2 * np], a[kd], bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], a[kd], bf[2], bf[3]);
    }
  }
}

// the same with A's fragments read from rows r0 .. r0 + 15 of a [.][D + 8]
// tile one 16-wide step at a time (D = 128: the registers of A's
// fragments held across the loop would push dK/dV past 255 registers)
template <int D>
__device__ __forceinline__ void mma_rows_t_smem(float (&c)[8][4],
                                                const __nv_bfloat16* a_tile,
                                                int r0,
                                                const __nv_bfloat16* tile,
                                                int lane) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4];
    ldmatrix_x4(a, a_tile + (r0 + (lane % 8) + ((lane / 8) % 2) * 8) *
                                (D + 8) + kd * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, tile + (np * 16 + (lane % 8) + (lane / 16) * 8) * (D + 8)
                          + kd * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(c[2 * np], a, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// c = A . rows^T with A's fragments kept in registers (D <= 64, loaded
// once) or read from their shared tile a step at a time (D = 128)
template <int D, int KA>
__device__ __forceinline__ void mma_rows_t_any(float (&c)[8][4],
                                               const uint32_t (&a)[KA][4],
                                               const __nv_bfloat16* a_tile,
                                               int r0,
                                               const __nv_bfloat16* tile,
                                               int lane) {
  if constexpr (D <= 64) mma_rows_t<D>(c, a, tile, lane);
  else mma_rows_t_smem<D>(c, a_tile, r0, tile, lane);
}

// acc[16 x D] += P (16 x 64, accumulator layout, rounded to bf16) . tile,
// tile 64 rows x D of a [.][D + 8] bf16 tile (the forward's O += P V)
template <int D>
__device__ __forceinline__ void mma_p_rows(float (&acc)[D / 8][4],
                                           const float (&p)[8][4],
                                           const __nv_bfloat16* tile,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, tile + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * (D + 8)
                  + dp * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

// 64 rows of a (b, seq, head) strided bf16 tensor into a [64][D + 8]
// tile; rows >= n zero-filled (nothing read)
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += B_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n;
    cp_async16(tile + r * (D + 8) + c,
               base + (ok ? (long long)(r0 + r) * row_stride : 0LL) + c, ok);
  }
}

// dK and dV of keys j0 .. j0 + 63 of kv head (b, kvh); warp w owns keys
// j0 + 16w .. + 15 and keeps its dK, dV rows in registers.
template <int D>
__global__ void __launch_bounds__(B_THREADS)
flash_attention_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int KH, int S,
                         int T_len, BwdStrides st, float scale, int causal) {
  constexpr int LDS = D + 8, ND = D / 8;
  constexpr int KD = D <= 64 ? D / 16 : 1;   // fragments held (D <= 64)
  extern __shared__ __align__(128) unsigned char bw_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(bw_smem);
  __nv_bfloat16* Vs = Ks + B_BKV * LDS;
  __nv_bfloat16* Qs = Vs + B_BKV * LDS;          // [2][B_BQ][LDS]
  __nv_bfloat16* Gs = Qs + 2 * B_BQ * LDS;       // dO: [2][B_BQ][LDS]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * B_BQ * LDS);   // [2][B_BQ]
  float* Dl = Ls + 2 * B_BQ;                                    // [2][B_BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / KH, kvh = blockIdx.x % KH;
  const int R = H / KH;
  const int j0 = blockIdx.y * B_BKV;
  const int nq_all = (S + B_BQ - 1) / B_BQ;
  // causal: query tiles before this key tile see none of its keys
  const int q_first = causal ? min(j0 / B_BQ, nq_all) : 0;
  const int nq = nq_all - q_first;
  const int n_it = R * nq;

  load_rows<D>(Ks, k + b * st.k[0] + kvh * st.k[2] + (long long)j0 * st.k[1],
               st.k[1], 0, T_len - j0);
  load_rows<D>(Vs, v + b * st.v[0] + kvh * st.v[2] + (long long)j0 * st.v[1],
               st.v[1], 0, T_len - j0);
  auto load_q = [&](int it, int buf) {
    const int h = kvh * R + it / nq, q0 = (q_first + it % nq) * B_BQ;
    load_rows<D>(Qs + buf * B_BQ * LDS, q + b * st.q[0] + h * st.q[2],
                 st.q[1], q0, S);
    load_rows<D>(Gs + buf * B_BQ * LDS, dO + b * st.dO[0] + h * st.dO[2],
                 st.dO[1], q0, S);
    const long long bh = (long long)b * H + h;
    for (int i = tid; i < B_BQ; i += B_THREADS) {
      const bool ok = q0 + i < S;
      Ls[buf * B_BQ + i] = ok ? lse[bh * S + q0 + i] : 0.f;
      Dl[buf * B_BQ + i] = ok ? delta[bh * S + q0 + i] : 0.f;
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  uint32_t kf[KD][4], vf[KD][4];
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (D <= 64) {
      if (it == 0) {
        load_a_frags<D>(kf, Ks, warp * 16, lane);
        load_a_frags<D>(vf, Vs, warp * 16, lane);
      }
    }
    const int buf = it & 1, q0 = (q_first + it % nq) * B_BQ;
    const __nv_bfloat16* Qt = Qs + buf * B_BQ * LDS;
    const __nv_bfloat16* Gt = Gs + buf * B_BQ * LDS;
    const float* Lt = Ls + buf * B_BQ;
    const float* Dt = Dl + buf * B_BQ;

    float p[8][4], dp[8][4];
    // S^T: 16 keys x 64 queries
    mma_rows_t_any<D>(p, kf, Ks, warp * 16, Qt, lane);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + warp * 16 + g + 8 * (e >> 1);
        const int c = nb * 8 + 2 * t4 + (e & 1);
        // causal: query q0 + c sees keys j <= q0 + c (the diagonal tile)
        p[nb][e] = (j < T_len && q0 + c < S && (!causal || j <= q0 + c))
                       ? __expf(p[nb][e] * scale - Lt[c]) : 0.f;
      }
    mma_rows_t_any<D>(dp, vf, Vs, warp * 16, Gt, lane);   // dP^T = V dO^T
    mma_p_rows<D>(dv_acc, p, Gt, lane);  // dV += P^T dO
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nb][e] *= dp[nb][e] - Dt[nb * 8 + 2 * t4 + (e & 1)];
    mma_p_rows<D>(dk_acc, p, Qt, lane);  // dK += dS^T Q
    __syncthreads();   // this buffer is refilled at the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + warp * 16 + g + 8 * i;
    if (j >= T_len) continue;
    __nv_bfloat16* kp = dk + b * st.dk[0] + (long long)j * st.dk[1] +
                        kvh * st.dk[2];
    __nv_bfloat16* vp = dv + b * st.dv[0] + (long long)j * st.dv[1] +
                        kvh * st.dv[2];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(kp + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk_acc[nd][2 * i] * scale,
                                dk_acc[nd][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vp + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv_acc[nd][2 * i], dv_acc[nd][2 * i + 1]);
    }
  }
}

// dQ of queries q0 .. q0 + 63 of head (b, h); warp w owns queries
// q0 + 16w .. + 15, K and V tiles double-buffered as in the forward.
template <int D>
__global__ void __launch_bounds__(B_THREADS)
flash_attention_bwd_dq(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dO,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int KH, int S,
                       int T_len, BwdStrides st, float scale, int causal) {
  constexpr int LDS = D + 8, ND = D / 8;
  constexpr int KD = D <= 64 ? D / 16 : 1;   // fragments held (D <= 64)
  extern __shared__ __align__(128) unsigned char bw_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(bw_smem);
  __nv_bfloat16* Gs = Qs + B_BQ * LDS;           // dO
  __nv_bfloat16* Ks = Gs + B_BQ * LDS;           // [2][B_BKV][LDS]
  __nv_bfloat16* Vs = Ks + 2 * B_BKV * LDS;      // [2][B_BKV][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.y * B_BQ;
  // causal: key tiles past this query tile's last row are dead
  const int n_kv = causal ? min((T_len + B_BKV - 1) / B_BKV, q0 / B_BKV + 1)
                          : (T_len + B_BKV - 1) / B_BKV;

  load_rows<D>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, S);
  load_rows<D>(Gs, dO + b * st.dO[0] + h * st.dO[2], st.dO[1], q0, S);
  const __nv_bfloat16* kb = k + b * st.k[0] + kvh * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + kvh * st.v[2];
  auto load_kv = [&](int t, int buf) {
    load_rows<D>(Ks + buf * B_BKV * LDS, kb, st.k[1], t * B_BKV, T_len);
    load_rows<D>(Vs + buf * B_BKV * LDS, vb, st.v[1], t * B_BKV, T_len);
  };
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  float L[2], Dv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    L[i] = row < S ? lse[(long long)bh * S + row] : 0.f;
    Dv[i] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }
  uint32_t qf[KD][4], gf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (D <= 64) {
      if (t == 0) {
        load_a_frags<D>(qf, Qs, warp * 16, lane);
        load_a_frags<D>(gf, Gs, warp * 16, lane);
      }
    }
    const __nv_bfloat16* Kt = Ks + (t & 1) * B_BKV * LDS;
    const __nv_bfloat16* Vt = Vs + (t & 1) * B_BKV * LDS;
    float p[8][4], dp[8][4];
    mma_rows_t_any<D>(p, qf, Qs, warp * 16, Kt, lane);    // S = Q K^T
    mma_rows_t_any<D>(dp, gf, Gs, warp * 16, Vt, lane);   // dP = dO V^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t * B_BKV + nb * 8 + 2 * t4 + (e & 1);
        const int row = q0 + warp * 16 + g + 8 * (e >> 1);
        const float pv = (j < T_len && (!causal || j <= row))
                             ? __expf(p[nb][e] * scale - L[e >> 1]) : 0.f;
        p[nb][e] = pv * (dp[nb][e] - Dv[e >> 1]);
      }
    mma_p_rows<D>(acc, p, Kt, lane);     // dQ += dS K
    __syncthreads();   // this buffer is refilled at the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* qp = dq + b * st.dq[0] + (long long)row * st.dq[1] +
                        h * st.dq[2];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(qp + nd * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nd][2 * i] * scale,
                                acc[nd][2 * i + 1] * scale);
  }
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
// arrays are D floats a thread, so it is instantiated at every head dim
// the fp32 forward takes but 128 (8 and 16: the smoke configs; 64).
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

// The bf16 backward on mma.sync (D = 64 or 128): the delta pre-pass,
// then dK/dV and dQ.
template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int H, int KH, int S, int T_len,
               const BwdStrides& st, float scale, int causal,
               cudaStream_t s) {
  const long long rows = (long long)B * H * S;
  const unsigned dblocks = (unsigned)((rows + 3) / 4);
  using bf = __nv_bfloat16;
  flash_attention_bwd_delta<bf><<<dblocks, 128, 0, s>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dO), delta, H, S, D,
      rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t bytes = bwd_smem_bytes<D>();
  // once per instantiation and process (the port drives one card)
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_attention_bwd_dkdv<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_attention_bwd_dq<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  flash_attention_bwd_dkdv<D>
      <<<dim3(B * KH, (T_len + B_BKV - 1) / B_BKV), B_THREADS, bytes, s>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k),
          static_cast<const bf*>(v), static_cast<const bf*>(dO), lse, delta,
          static_cast<bf*>(dk), static_cast<bf*>(dv), H, KH, S, T_len, st,
          scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq<D>
      <<<dim3(B * H, (S + B_BQ - 1) / B_BQ), B_THREADS, bytes, s>>>(
          static_cast<const bf*>(q), static_cast<const bf*>(k),
          static_cast<const bf*>(v), static_cast<const bf*>(dO), lse, delta,
          static_cast<bf*>(dq), H, KH, S, T_len, st, scale, causal);
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

// The mma variant (bf16, D = 64 or 128; strides and lse as above,
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
  if (D == 128)
    return launch_mma<128>(q, k, v, o, B, H, KH, S, T_len, strides, scale,
                           causal, l, s);
  return -1;
}

// The decode variant (bf16, S = 1, D = 64 or 128, H / KH <= 8) over a
// cache of T_cap keys of which the first min(*len, T_cap) are valid
// (`len` a device int32, >= 1; the caller folds a causal mask into it), in
// `splits` chunks of `chunk` <= 256 keys planned from T_cap; `ws` an fp32
// workspace of B*H*splits*(D + 2).  Returns as above; -1 for an
// unsupported shape.
extern "C" int repro_flash_attention_decode_len(
    const void* q, const void* k, const void* v, void* o, void* ws,
    const void* len, int B, int H, int KH, int T_cap, int D,
    const long long* strides, float scale, int splits, int chunk,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk > D_CHUNK_MAX || H / KH > D_R_MAX || splits < 1 || T_cap < 1)
    return -1;
  float* w = static_cast<float*>(ws);
  const int* n = static_cast<const int*>(len);
  if (D == 64)
    return launch_decode<64>(q, k, v, o, w, n, B, H, KH, T_cap, strides,
                             scale, splits, chunk, s);
  if (D == 128)
    return launch_decode<128>(q, k, v, o, w, n, B, H, KH, T_cap, strides,
                              scale, splits, chunk, s);
  return -1;
}

// The backward (causal or not; bf16 at D = 64 or 128, fp32 at D = 8, 16
// or 64; causal masks key j > query i, positions from 0 in both): q, k, v,
// o, dO and the outputs dq, dk, dv read and written through (batch, seq, head) strides, 24 in all
// (q, k, v, o, dO, dq, dk, dv in turn), the head dim contiguous, rows
// 16-byte aligned for bf16; lse the forward's (B, H, S) fp32 logsumexp,
// delta an fp32 (B, H, S) workspace.  dtype 1 (bf16) runs on mma.sync,
// 0 (fp32) on FMAs.  Returns cudaGetLastError() after the last launch;
// -1 for an unsupported dtype or D.
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
  if (dtype == 1) {
    if (D == 64)
      return launch_bwd<64>(q, k, v, o, dO, l, dl, dq, dk, dv, B, H, KH, S,
                            T_len, st, scale, causal, s);
    if (D == 128)
      return launch_bwd<128>(q, k, v, o, dO, l, dl, dq, dk, dv, B, H, KH, S,
                             T_len, st, scale, causal, s);
    return -1;
  }
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
