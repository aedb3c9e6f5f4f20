// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel).  For every (batch, head) and query row
//     o[s] = sum_t softmax_t(q[s] . k[t] / sqrt(D)) v[t]
// over keys t < T (and t <= s when causal), with the running max,
// denominator and accumulator in fp32 and p cast to v's dtype before the
// PV product, as the TPU kernel does.
//
// Differences from the TPU kernel, by design:
//  * keys at positions >= T are MASKED (probability 0).  The reference
//    wrapper pads keys with zeros and lets them into the softmax (fault F1
//    in ROADMAP.md); this kernel never sees padding;
//  * GQA picks the kv head as h / (H / KH) inside the kernel -- no
//    repeated copy of k and v;
//  * q, k, v and o are read and written through (batch, seq, head)
//    strides, so the (B, S, H*D) activations of the ViT go in and come out
//    without a transpose.
//
// Layout: one block per (q tile of 64 rows, batch*head); 128 threads, two
// per query row.  Each thread scores half of each 64-key tile (keys
// interleaved so the two halves hit different shared-memory banks) and
// accumulates half of the output dims.  K and V tiles are staged in
// shared memory as fp32.  Causally dead KV tiles (all keys after the
// tile's last query) are skipped.  Head dims: 128 (the LMs), 64 (every
// full-size ViT config) and 8 and 16 (their smoke configs).
//
// Head dim 128.  Keeping each thread's q row in registers (as for D <= 64)
// next to its half of the accumulator takes 128 + 64 floats a thread and
// spills at the 255-register cap, and fp32 K and V tiles of 64 x 129 take
// 66 KB, above the 48 KB of static shared memory.  So at D = 128 the q
// tile is staged in shared memory beside K and V (three 64 x 129 fp32
// tiles, 99 KB), all shared memory is dynamic, and the launcher raises the
// kernel's dynamic shared-memory limit with cudaFuncSetAttribute.  Each
// thread then holds only its 64 accumulators and 32 scores; the q . k loop
// is unrolled by 8, not fully, or the compiler hoists the q row back into
// registers.  Decode calls
// it with S = 1: one live row of a 64-row tile, right but wasteful.
//
// What bounds it on the H100: at the ViT's shapes (S = T = 197, D = 64) the
// work is 4*S*T*D operations per head on 4*S*D elements, an intensity
// near the bf16 ridge point, so on tensor cores both bounds are close.
// At the LM's causal prefill (S = T = 512, D = 128) it is the operations;
// at decode (S = 1) the bytes of the K/V cache.  This first version
// computes with fp32 FMAs (no tensor cores), so it is bound by its
// arithmetic; moving QK^T and PV onto wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
                       int causal) {
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
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int S, int T_len, int D, const long long* st, float scale,
           int causal, cudaStream_t s) {
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
        st[9], st[10], st[11], scale, causal);                               \
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

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn;
// the head dim is contiguous.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch; -1 for an unsupported dtype or D.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int KH, int S, int T_len, int D,
                                     const long long* strides, float scale,
                                     int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KH, S, T_len, D, strides,
                                 scale, causal, s);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, KH, S, T_len, D, strides, scale,
                         causal, s);
  return -1;
}
