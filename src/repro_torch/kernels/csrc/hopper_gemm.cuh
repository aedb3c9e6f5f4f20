// Hopper (sm_90a) building blocks shared by K1 (elastic_matmul.cu) and K3
// (expert_matmul.cu):
//
// * the TMA / wgmma GEMM machinery of their tma variants (and of K2's
//   wgmma backward and K3's persistent dgrad): tile shapes, mbarrier
//   helpers, 2-, 3- and 4-D TMA loads and the 2- and 3-D TMA stores, an
//   acquire/release flag between blocks, wgmma
//   shared-memory descriptors and the m64n128k16 / m64n256k16 bf16
//   products with fp32 accumulators (either operand K- or MN-major), the
//   accumulator store, and the host-side tensor-map encoding
//   (cuTensorMapEncodeTiled, looked up in libcuda at run time);
// * the weight-streaming core of K1's small_m and K3's stream variants:
//   a block of 256 threads reads 64 weight columns with 16-byte loads, 8 in
//   flight per thread, against rows of x staged in shared memory, in fp32.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace repro_hopper {

// ------------------------------------------------------- TMA + wgmma ----

constexpr int G_BK = 64;
constexpr int G_SMEM_RING = 192 * 1024;   // shared memory for the ring

// Tile shapes: CWG consumer warpgroups of 64 rows each, BN columns (128 or
// 256: one wgmma m64nBNk16 per 16-wide K step), and one producer warp;
// the ring gets RING bytes of shared memory.
template <int CWG, int BN, int RING = G_SMEM_RING>
struct GemmTile {
  static constexpr int BM = 64 * CWG;
  static constexpr int THREADS = 128 * CWG + 32;
  static constexpr int A_BYTES = BM * G_BK * 2;
  static constexpr int B_BYTES = G_BK * BN * 2;      // BN / 64 TMA boxes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      RING / STAGE_BYTES < 8 ? RING / STAGE_BYTES : 8;
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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared -> global of the 3-D box at (c0, c1, c2), as tma_store_2d
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a flag another block publishes (acquire: what it wrote before the
// release is visible after) and its release
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// shared -> global through a tensor map (the box at coordinates c0, c1;
// what falls outside the tensor is not written), in the thread's bulk
// group; smem written by the generic proxy needs fence_async_smem first
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until the thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// wait until the thread's bulk groups are complete (their writes done)
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// d (64 x 128, fp32) += A (64 x 16) * B (16 x 128).  TA, TB: the
// operands' transpose bits, 0 for K-major, 1 for MN-major (the default: A
// K-major, B MN-major, a row-major K x N weight)
template <int TA = 0, int TB = 1>
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
      "}, %64, %65, p, 1, 1, %67, %68;\n\t}"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256, fp32) += A (64 x 16) * B (16 x 256); TA, TB as above
template <int TA = 0, int TB = 1>
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
      "}, %128, %129, p, 1, 1, %131, %132;\n\t}"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A (64 x 16 at a) * B (16 x BN at b), one K step; TA, TB as above
template <int BN, int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256) wgmma_m64n256k16<TA, TB>(d, da, db);
  else wgmma_m64n128k16<TA, TB>(d, da, db);
}

// Store one warpgroup's 64 x BN accumulator (t = thread in the warpgroup)
// as bf16 at rows r0.. and columns c0.. of y (row stride ldy): rows < m_out
// and columns < n_out are written, exact zeros at rows >= m_valid or
// columns >= n_valid.  Register 4j + 2i + e holds row 16*warp + lane/4 + 8i
// and column 8j + 2*(lane%4) + e.
template <int BN>
__device__ __forceinline__ void store_acc(const float (&d)[BN / 2],
                                          __nv_bfloat16* __restrict__ y,
                                          int ldy, int t, int r0, int c0,
                                          int m_valid, int m_out,
                                          int n_valid, int n_out) {
  const int r_base = r0 + (t / 32) * 16 + (t % 32) / 4;
  const int c_base = c0 + 2 * (t % 4);
  const bool pair = (ldy % 2) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c_base + 8 * j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_base + 8 * i;
      if (r >= m_out) continue;
      const bool live = r < m_valid;
      const float v0 = live && col < n_valid ? d[4 * j + 2 * i] : 0.f;
      const float v1 = live && col + 1 < n_valid ? d[4 * j + 2 * i + 1] : 0.f;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up in libcuda at run time (no -lcuda)
inline EncodeTiled encode_tiled() {
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

// bf16 map of `rank` (2 or 3) dims, the first of unit stride; strides of
// the others in bytes; 128-byte swizzle; out-of-bounds boxes read zeros
inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims,
                            const cuuint64_t* strides,
                            const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 4-D bf16 map, the first dim of unit stride, as encode_bf16_map; a dim of
// extent 1 may carry any stride (it is never stepped), so it gets 16 bytes
inline bool encode_bf16_map4(CUtensorMap* map, const void* base,
                             const cuuint64_t (&dims)[4],
                             const cuuint64_t (&strides)[3],
                             const cuuint32_t (&box)[4]) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t st[3];
  for (int i = 0; i < 3; ++i) st[i] = dims[i + 1] == 1 ? 16 : strides[i];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, st, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 2-D bf16 map: inner extent `inner` (unit stride), `outer` rows `ld`
// elements apart, box {64, box_outer}
inline bool encode_map(CUtensorMap* map, const void* base, int inner,
                       int outer, int ld, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return encode_bf16_map(map, base, 2, dims, strides, box);
}

// ------------------------------------------------- weight streaming ----

constexpr int S_THREADS = 256;
constexpr int S_BN = 64;          // output columns per block
constexpr int S_KC_MAX = 512;     // rows of x staged per block
constexpr int S_UNROLL = 8;       // weight loads in flight per thread
constexpr int S_WARPS = S_THREADS / 32;
static_assert(S_WARPS * S_BN == S_KC_MAX, "shared buffer reuse");

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

// One block's share of a small-M product: for m < m_live and the 64
// columns n0 .. n0 + 63,
//     sum_{k0 <= k < min(k0 + kc, k_end)} x[m * ldx + k] * w[k * ldw + n],
// with columns n >= n_valid read as 0 (16-byte loads where vec_ok and the
// segment is whole).  x[:, k0 : k0 + kc] is staged in buf (fp32, MT x
// S_KC_MAX; kc <= S_KC_MAX), rows m_live <= m < MT as zeros (callers pick
// MT >= m_live), the first round of weight loads issued before that.  On
// return buf holds the per-warp partial sums, read by stream_sum; every
// thread of the block calls it.
template <typename T, int MT>
__device__ __forceinline__ void stream_rows(const T* __restrict__ x, int ldx,
                                            const T* __restrict__ w, int ldw,
                                            int m_live, int k0, int kc,
                                            int k_end, int n0, int n_valid,
                                            int vec_ok, float* buf) {
  constexpr int VEC = 16 / sizeof(T);          // columns per 16-byte load
  constexpr int TPR = S_BN / VEC;              // threads per row segment
  constexpr int RG = S_THREADS / TPR;          // rows in flight per block
  const int tid = threadIdx.x;
  const int k1 = min(k_end, k0 + kc);
  const int rows = k1 - k0;
  const int tr = tid % TPR, g = tid / TPR;
  const int c = n0 + tr * VEC;
  const bool whole = vec_ok && c + VEC <= n_valid;
  const int n_left = n_valid - c;
  // S_UNROLL rows of w in flight per thread: RG * S_UNROLL rows a round
  uint4 raw[S_UNROLL];
  auto load_round = [&](int r0) {
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u) {
      const int r = r0 + u * RG;
      raw[u] = r < rows ? load_w(w + (size_t)(k0 + r) * ldw + c, whole,
                                 n_left)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_round(g);            // the first round does not wait for x
  for (int i = tid; i < MT * kc; i += S_THREADS) {
    const int m = i / kc, kk = i % kc;
    buf[m * S_KC_MAX + kk] =
        (m < m_live && kk < rows) ? to_f(x[(size_t)m * ldx + k0 + kk]) : 0.f;
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
}

// the block's sum for row m and column col after stream_rows
template <int MT>
__device__ __forceinline__ float stream_sum(const float* buf, int m, int col) {
  float s = 0.f;
#pragma unroll
  for (int wp = 0; wp < S_WARPS; ++wp) s += buf[(wp * MT + m) * S_BN + col];
  return s;
}

}  // namespace repro_hopper
