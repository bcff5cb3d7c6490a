// Hopper tensor-core building blocks shared by tr_sandwich.cu and
// flash_attention.cu (sm_90a): asynchronous copies (cp.async, bulk and TMA
// copies counted on mbarriers), warpgroup products (wgmma) with the A
// operand in registers, shared-memory descriptors, and the 3xTF32 split
// that keeps float32 products within float32 limits.
//
// Operand layout.  wgmma reads B from shared memory through a descriptor.
// Both kernels keep B K-major without swizzle: the tile is cut into core
// matrices of 8 rows x 16 bytes (8 x 4 tf32 or 8 x 8 bf16), each 128
// contiguous bytes, stored chunk column by chunk column:
//     byte (r, q) = (q * R/8 + r/8) * 128 + (r % 8) * 16
// for row r of R and 16-byte chunk q along K.  One k-step (8 tf32 or 16
// bf16) spans two chunk columns: the descriptor's leading byte offset is
// the step between them (R * 16 bytes), its stride byte offset the step
// between 8-row groups (128 bytes).  TF32 wgmma has no transpose, so a
// B operand that is MN-major in memory (V, A_I) is transposed by the
// threads that stage it.  bf16 tiles copied by TMA in its 128-byte swizzle
// are read as they land (sw128_desc), B MN-major through the bf16
// transpose where needed.
//
// A comes from registers in the mma.m16n8k8 (tf32) / m16n8k16 (bf16)
// fragment order, warp w of the warpgroup holding rows 16w..16w+15; the
// accumulator D is the m16n8 C fragment repeated over N/8 columns of 8:
//     d[4j + 0, 1] -> (row g, cols 8j + 2t, +1),  d[4j + 2, 3] -> row g + 8
// with g = lane / 4, t = lane % 4.
//
// 3xTF32.  x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi); a product is hi.hi + lo.hi + hi.lo summed in float32 (lo.lo, ~2^-22
// relative, is dropped), three TF32 passes at an effective 495/3 = 165
// TFLOP/s on an H100 SXM against 67 TFLOP/s for float32 FMAs.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"  // smem_u32, mbarriers, bulk copies

namespace tc {

// ---- asynchronous copies ---------------------------------------------------

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of a row: `valid` of its elements exist (<= 0: none).
// `vec` (row strides and base 16-byte aligned) takes cp.async; otherwise
// the elements are loaded one by one (ragged widths), synchronously.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int valid,
                                           bool vec, const T* base) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int n = valid < 0 ? 0 : (valid > V ? V : valid);
    cp_async16(dst, n ? src : base, n * (int)sizeof(T));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = e < valid ? src[e] : T(0.f);
  }
}

// Writes by threads (st.shared, cp.async) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the split -------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) = hi + lo in bf16 pairs: hi carries 8 mantissa bits, lo the next 8
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// ---- descriptors -----------------------------------------------------------

// byte offset of 16-byte chunk q (along K) of row r in a K-major tile of R rows
__device__ __forceinline__ int core_off(int r, int q, int R) {
  return ((q * (R >> 3) + (r >> 3)) << 7) + ((r & 7) << 4);
}
// descriptor of k-step ks of a K-major tile of R rows, from row r0 on
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int R,
                                                int ks, int r0) {
  const uint32_t a = smem_u32(static_cast<const char*>(tile) +
                              core_off(r0, 2 * ks, R));
  const uint32_t lbo = R * 16, sbo = 128;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// one box of a tensor map at coordinates c (innermost first; zeros outside
// the tensor), counted on barrier b
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(b))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(b))
      : "memory");
}

// A tiled tensor map (host side) of `rank` dims (innermost first, that one
// contiguous), byte strides of the others, boxes `box`, zero fill, 128-byte
// swizzle if asked.  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so nothing links libcuda.  False where TMA
// cannot take the tensor (a base or stride not on 16 bytes) or the encoder
// refuses.
inline bool tensor_map(CUtensorMap* map, const void* base, int es, int rank,
                       const unsigned long long* dims,
                       const unsigned long long* strides,
                       const unsigned* box, bool swizzle128) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    unit[i] = 1;
    if (i + 1 < rank) {
      if (strides[i] % 16) return false;
      st[i] = strides[i];
    }
  }
  return encode(map,
                es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                rank, const_cast<void*>(base), d, st, bx, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// descriptor of a bf16 tile in TMA's 128-byte swizzle (rows of 128 bytes,
// 8-row groups of 1024 bytes, 1024-byte aligned): K-major from the byte of
// its k-step (+32 a step of 16), or MN-major (transposed B) with lbo the
// step between 64-column blocks
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_u32(p), sbo = 1024;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous product (after a wait, before a fence)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_ACC8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_ACC16(d, i) TC_ACC8(d, i), TC_ACC8(d, i + 8)
#define TC_ACC32(d, i) TC_ACC16(d, i), TC_ACC16(d, i + 16)
#define TC_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TC_R32                                                            \
  TC_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"
#define TC_R64                                                            \
  TC_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
         "%56, %57, %58, %59, %60, %61, %62, %63"
// operands after the accumulators: a0..a3, the B descriptor, scale-d
// (0: D = A.B, which zeroes the accumulator without writing its registers
// outside the asynchronous product; 1: D += A.B)
#define TC_IN(a, b, sc) \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(sc)

// D(64 x N) += A(64 x 8, registers, tf32) . B(8 x N, shared, tf32)
template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d = 1) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma N");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" TC_R16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : TC_ACC16(d, 0)
        : TC_IN(a, b, scale_d)
        : "memory");
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" TC_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : TC_ACC32(d, 0)
        : TC_IN(a, b, scale_d)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" TC_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : TC_ACC32(d, 0), TC_ACC32(d, 32)
        : TC_IN(a, b, scale_d)
        : "memory");
  }
}

// D(64 x N) += A(64 x 16, registers, bf16) . B(16 x N, shared, bf16):
// B K-major, or MN-major (stored N-contiguous) with TNSP = 1
template <int N, int TNSP = 0>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d = 1) {
  static_assert(N == 64 || N == 128, "wgmma N");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TC_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : TC_ACC32(d, 0)
        : TC_IN(a, b, scale_d), "n"(TNSP)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TC_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : TC_ACC32(d, 0), TC_ACC32(d, 32)
        : TC_IN(a, b, scale_d), "n"(TNSP)
        : "memory");
  }
}

// one k-step of a 3xTF32 product: D (= or +=) Alo.Bhi + Ahi.Blo + Ahi.Bhi
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N / 2],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint64_t bhi, uint64_t blo,
                                           int scale_d = 1) {
  mma_tf32<N>(d, alo, bhi, scale_d);
  mma_tf32<N>(d, ahi, blo);
  mma_tf32<N>(d, ahi, bhi);
}

#undef TC_IN

}  // namespace tc
