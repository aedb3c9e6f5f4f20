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
// per query row.  Each thread keeps its row of q in registers, scores half
// of each 64-key tile (keys interleaved so the two halves hit different
// shared-memory banks) and accumulates half of the output dims.  K and V
// tiles are staged in shared memory as fp32.  Causally dead KV tiles (all
// keys after the tile's last query) are skipped.  Head dims: 64 (every
// full-size ViT config) and 8 and 16 (their smoke configs).
//
// What bounds it on the H100: at the ViT's shapes (S = T = 197, D = 64) the
// work is 4*S*T*D operations per head on 4*S*D elements, an intensity
// near the bf16 ridge point, so on tensor cores both bounds are close.
// This first version computes with fp32 FMAs (no tensor cores), so it is
// bound by its arithmetic; moving QK^T and PV onto wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;
constexpr int THREADS = 2 * BQ;
constexpr int BKV = 64;   // keys per tile; fp32 K and V tiles: 33 KB at D 64

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
  const float NEG_INF = -__int_as_float(0x7f800000);
  __shared__ float Ks[BKV][D + 1];
  __shared__ float Vs[BKV][D + 1];

  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;   // partner lane = tid ^ 1
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + row;
  const bool valid_q = qi < S;

  float qr[D];
  const T* qp = q + b * q_sb + (long long)qi * q_ss + h * q_sh;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = valid_q ? to_float(qp[d]) : 0.f;

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
      Ks[j][d] = ok ? to_float(kb[(long long)kj * k_ss + d]) : 0.f;
      Vs[j][d] = ok ? to_float(vb[(long long)kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[HALF];
    float m_loc = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < HALF; ++jj) {
      const int j = 2 * jj + half;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
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
        acc[i] = fmaf(pa, Vs[ja][d], fmaf(pb, Vs[jb][d], acc[i]));
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
  flash_attention_kernel<T, DIM><<<grid, THREADS, 0, s>>>(                   \
      static_cast<const T*>(q), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, T_len, st[0],  \
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], \
      st[11], scale, causal)
  switch (D) {
    case 8: REPRO_FA_LAUNCH(8); break;
    case 16: REPRO_FA_LAUNCH(16); break;
    case 64: REPRO_FA_LAUNCH(64); break;
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
