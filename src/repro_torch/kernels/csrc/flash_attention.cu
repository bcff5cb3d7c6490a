// Causal flash-attention forward (prefill), GQA-aware, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:68 :: flash_attention
//           (Pallas TPU kernel `_kernel`, :25).
//
// Computes  out[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] * hd^-0.5)
//                          @ v[b,h/G,j,:]        (j <= i when causal)
// with q (B,H,S,hd) and k/v (B,KV,S,hd), G = H/KV.  Every tensor is passed
// with its own (batch, head, position) strides and a contiguous last axis,
// so the transformer's head-major view of its (B,S,H,hd) activations and
// a slice of a longer cache need no copy.  float32 and bfloat16 inputs, hd
// up to 128; the running max, denominator and accumulator are float32.
// NEG_INF = -1e30 as in the TPU kernel, so masked logits underflow to exact
// zeros after the max shift; the denominator is max(l, 1e-30).
//
// Bound on the H100: operations.  A causal pass does 2*B*H*S^2*hd FLOPs
// (QK^T and PV over the lower triangle) against ~2*B*(H+2KV)*S*hd*itemsize
// bytes, far above the card's ridge point.  The roof is the tensor cores:
// 165 TFLOP/s for float32 done as 3xTF32 (495 / 3), 989 TFLOP/s in bf16.
//
// Design, the FlashAttention shape for Hopper: a warpgroup (128 threads)
// owns 64 query rows (wgmma M = 64).  The TPU kernel's sequential key-block
// grid axis becomes a loop over key tiles that stops at the diagonal:
// tiles above it are never loaded.  Both products run on the tensor cores
// with the A operand in registers:
//   S = Q K^T  Q in fragment order (from shared memory), K (keys x hd,
//              K-major as stored) the shared B operand;
//   O += P V   P straight from S's accumulator registers (the online
//              softmax runs on them, in base 2: one ex2 a probability).
// Query tiles are issued heaviest first so causal blocks balance.
//
// float32 (3xTF32, wgmma.cuh): two warpgroups (128 rows) a block, key
// tiles of 32.  Q and P are split into TF32 hi and lo in registers, K and
// V into hi and lo planes by the threads: K's hi over its copy, V
// transposed (TF32 wgmma has no transpose).  P's accumulator pairs hold
// keys (2t, 2t+1) where the tf32 A fragment wants (t, t+4), so V's rows are
// staged in that order (keys 0,2,4,6 | 1,3,5,7 of each 8).  K and V arrive
// by cp.async (element-wise where a row is not on 16 bytes) into a ring of
// two slots; tile t + 1 is staged while PV of tile t runs.  Shared memory:
// 108,544 bytes (hd 64: two blocks an SM), 215,040 (hd 128).
//
// bfloat16: one warpgroup and one producer warp a block, key tiles of 64,
// nothing staged: the producer's TMA copies put K and V in the 128-byte
// swizzle that wgmma reads directly (K K-major, V MN-major through the
// bf16 transpose), up to 4 (hd 64) or 2 (hd 128) tiles ahead, on "full"
// and "empty" barriers, so the warpgroup never waits on a barrier of the
// block.  P is rounded to bf16 before PV, as the TPU kernel does.
//
// Head dims.  An instance's HD is a bucket, 64 or 128, and a head dim hd <=
// HD runs in the smallest that holds it (the repo's 16, 20 and 32 in 64, 80
// in 128): Q, K and V are staged HD wide with the columns past hd zero (a
// chunk's copy stops at hd and zero-fills the rest), so QK^T is exact and
// PV's columns past hd are zeros that are never written back.  In bf16,
// where hd < HD or a row, base or stride of k, v is off 16 bytes (hd 20:
// 40-byte rows), TMA cannot fill the tiles, and the producer warp writes
// them itself, 16 bytes a lane in the 128-byte swizzle TMA would have
// made, zeros past hd and past S, then arrives on the tile's barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

using namespace tc;

constexpr int BQ = 128;  // query rows per block: 64 (the wgmma M) a group
constexpr int NT = 256;  // two warpgroups
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int V = 4;         // floats of a 16-byte chunk
  static constexpr int KS = 8;        // wgmma K
  static constexpr int BK = 32;       // keys per tile: S's wgmma N
  static constexpr int QST = HD + V;  // padded Q row (elements)
  static constexpr int PL = 2;        // planes of a B operand: hi, lo
  static constexpr int KB = BK * HD * 4;  // one plane
  // tiles as copied, K (split in place) and V: two, so that two blocks of
  // hd 64 fit on an SM
  static constexpr int RING = 2;
  static constexpr int QB = BQ * QST * 4;
  // Q | RING x (K, V) | K's lo plane | V's planes, two tiles' worth
  static constexpr int SMEM = QB + RING * 2 * KB + KB + 2 * PL * KB;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// 2^x in one MUFU op (relative error ~2^-22; 2^-1e30 is +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int group, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, float scale, int causal, int vec, int hd) {
  using C = Cfg<HD>;
  using T = float;
  constexpr int V = C::V, BK = C::BK, QST = C::QST, KB = C::KB;
  constexpr int QC = HD / V;  // 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BQ][QST]
  unsigned char* ring = smem + C::QB;
  unsigned char* klo = ring + C::RING * 2 * KB;  // f32: K's lo plane
  unsigned char* vops = klo + (C::PL - 1) * KB;  // V's planes, per tile % 2

  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int wg = tid >> 7;
  // this thread's rows of the block: m and m + 8
  const int m = wg * 64 + ((tid >> 5) & 3) * 16 + g;
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  const bool vc = vec & 1;  // inputs' rows on 16 bytes: cp.async
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nt = (kend + BK - 1) / BK;

  // a chunk's values below hd are copied, the rest zero-filled
  for (int c = tid; c < BQ * QC; c += NT) {
    const int r = c / QC, qq = c % QC, s = q0 + r;
    load_chunk<T>(Qs + r * QST + qq * V, qb + s * qss + qq * V,
                  s < S ? hd - qq * V : 0, vc, q);
  }
  auto load_tile = [&](int tt) {
    unsigned char* buf = ring + tt % C::RING * 2 * KB;
    const int k0 = tt * BK;
    // K: K-major chunks straight into plane 0; two lanes share a key
    for (int c = tid; c < BK * QC; c += NT) {
      const int qq = (c & 1) + 2 * (c / (2 * BK)), r = (c >> 1) % BK;
      const int s = k0 + r;
      load_chunk<T>(reinterpret_cast<T*>(buf + core_off(r, qq, BK)),
                    kb + s * kss + qq * V, s < S ? hd - qq * V : 0, vc, k);
    }
    T* vr = reinterpret_cast<T*>(buf + KB);  // [BK][HD] as stored
    for (int c = tid; c < BK * QC; c += NT) {
      const int r = c / QC, qq = c % QC, s = k0 + r;
      load_chunk<T>(vr + r * HD + qq * V, vb + s * vss + qq * V,
                    s < S ? hd - qq * V : 0, vc, v);
    }
  };
  // split K in place (hi over the copy, lo to its plane) and transpose V
  // into K-major planes (rows d, K along keys)
  auto stage_tile = [&](int tt) {
    unsigned char* buf = ring + tt % C::RING * 2 * KB;
    for (int c = tid; c < BK * QC; c += NT) {
      float4* p = reinterpret_cast<float4*>(buf + 16 * c);
      const float4 x = *p;
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(p) = hi;
      *reinterpret_cast<uint4*>(klo + 16 * c) = lo;
    }
    const T* vr = reinterpret_cast<const T*>(buf + KB);
    unsigned char* vop = vops + (tt & 1) * C::PL * KB;
    for (int c = tid; c < HD * (BK / V); c += NT) {
      const int d = c % HD, qq = c / HD;
      uint4 hi;
      // chunk qq of k-step qq/2 holds keys 2e + qq%2, e = 0..3
      const float* p = vr + (8 * (qq >> 1) + (qq & 1)) * HD + d;
      uint4 lo;
      split_tf32(p[0], hi.x, lo.x);
      split_tf32(p[2 * HD], hi.y, lo.y);
      split_tf32(p[4 * HD], hi.z, lo.z);
      split_tf32(p[6 * HD], hi.w, lo.w);
      *reinterpret_cast<uint4*>(vop + KB + core_off(d, qq, HD)) = lo;
      *reinterpret_cast<uint4*>(vop + core_off(d, qq, HD)) = hi;
    }
    fence_proxy_async();
  };
  for (int j = 0; j < C::RING; ++j) {
    if (j < nt) load_tile(j);
    cp_async_commit();
  }
  cp_async_wait<C::RING - 1>();  // Q and tile 0
  fence_proxy_async();
  __syncthreads();
  stage_tile(0);
  __syncthreads();

  float oacc[HD / 2], sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  // the softmax runs in base 2: logits times scale * log2(e), so each
  // probability is one ex2; m0, m1 are in those units
  const float sl = scale * 1.4426950408889634f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // the last key each of this thread's rows sees
  const int r0 = q0 + m, r1 = r0 + 8;
  const int lim0 = causal ? min(r0, S - 1) : S - 1;
  const int lim1 = causal ? min(r1, S - 1) : S - 1;

  // Each iteration: S = Q K^T of tile tt; the online softmax; O += P V
  // issued; tile tt + 1 staged while PV runs; PV waited for; the copy of
  // tile tt + RING started into tile tt's slot.  No product is in flight
  // across iterations, and S starts with scale-d 0 instead of zeroed
  // registers, so ptxas keeps the products asynchronous.
  for (int tt = 0; tt < nt; ++tt) {
    unsigned char* buf = ring + tt % C::RING * 2 * KB;
    unsigned char* vop = vops + (tt & 1) * C::PL * KB;

    // a warpgroup whose rows all lie above this tile (causal) skips it
    const int k0 = tt * BK;
    if (!causal || k0 <= q0 + 64 * wg + 63) {
      // S = Q K^T, k-steps in groups of four (the A fragments of a group
      // stay in registers until its products are done)
      constexpr int NKS = HD / C::KS, GRP = NKS < 4 ? NKS : 4;
#pragma unroll
      for (int g0 = 0; g0 < NKS; g0 += GRP) {
        uint32_t ah[GRP][4], al[GRP][4];
#pragma unroll
        for (int i = 0; i < GRP; ++i) {
          const float* p = reinterpret_cast<const float*>(Qs) + m * QST +
                           (g0 + i) * 8 + t4;
          split_tf32(p[0], ah[i][0], al[i][0]);
          split_tf32(p[8 * QST], ah[i][1], al[i][1]);
          split_tf32(p[4], ah[i][2], al[i][2]);
          split_tf32(p[8 * QST + 4], ah[i][3], al[i][3]);
        }
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < GRP; ++i) {
          const int sc = g0 + i == 0 ? 0 : 1;
          const uint64_t bh = kmajor_desc(buf, BK, g0 + i, 0);
          mma_3xtf32<BK>(sacc, ah[i], al[i], bh,
                         kmajor_desc(klo, BK, g0 + i, 0), sc);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
      }

      // online softmax on the accumulator: sacc[4j + e] is row m, key
      // 8j + 2 t4 + e of the tile; sacc[4j + 2 + e] row m + 8
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + e;
          sacc[4 * j + e] = kp <= lim0 ? sacc[4 * j + e] * sl : NEG_INF;
          sacc[4 * j + 2 + e] =
              kp <= lim1 ? sacc[4 * j + 2 + e] * sl : NEG_INF;
          mx0 = fmaxf(mx0, sacc[4 * j + e]);
          mx1 = fmaxf(mx1, sacc[4 * j + 2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the four lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // key 0 is visible to every row, so after the first tile m is a real
      // logit and masked entries give 2^(-1e30 - m) == 0 exactly
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;  // this thread's share of the row sums
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * j + e] = ex2(sacc[4 * j + e] - mn0);
          sacc[4 * j + 2 + e] = ex2(sacc[4 * j + 2 + e] - mn1);
          rs0 += sacc[4 * j + e];
          rs1 += sacc[4 * j + 2 + e];
        }
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        oacc[4 * j] *= al0;
        oacc[4 * j + 1] *= al0;
        oacc[4 * j + 2] *= al1;
        oacc[4 * j + 3] *= al1;
      }

      // O += P V, P's A fragments from the accumulator registers
      constexpr int NKP = BK / C::KS;
      uint32_t ph[NKP][4], pl[NKP][4];
#pragma unroll
      for (int kk = 0; kk < NKP; ++kk) {
        split_tf32(sacc[4 * kk], ph[kk][0], pl[kk][0]);      // key 2t
        split_tf32(sacc[4 * kk + 2], ph[kk][1], pl[kk][1]);  // row + 8
        split_tf32(sacc[4 * kk + 1], ph[kk][2], pl[kk][2]);  // key 2t + 1
        split_tf32(sacc[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NKP; ++kk) {
        const uint64_t bh = kmajor_desc(vop, HD, kk, 0);
        mma_3xtf32<HD>(oacc, ph[kk], pl[kk], bh,
                       kmajor_desc(vop + KB, HD, kk, 0));
      }
      wgmma_commit();
    }

    if (tt + 1 < nt) {  // stage tile tt + 1 while PV runs
      cp_async_wait<C::RING - 2>();
      fence_proxy_async();
      __syncthreads();
      stage_tile(tt + 1);
    }
    wgmma_wait<0>();
    fence_regs(oacc);
    __syncthreads();  // tile tt's slot is free; tile tt + 1 is staged
    if (tt + C::RING < nt) load_tile(tt + C::RING);
    cp_async_commit();
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* ob = o + b * osb + h * osh;
  if (!(vec & 2)) {  // output rows not on 16 bytes: element by element
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        if (col >= hd) continue;
        if (r0 < S) store(&ob[r0 * oss + col], oacc[4 * j + e] / den0);
        if (r1 < S) store(&ob[r1 * oss + col], oacc[4 * j + 2 + e] / den1);
      }
    }
    return;
  }
  // The tile goes through shared memory (Q's rows, no longer read) so that
  // each output row leaves in 16-byte pieces: the accumulator's layout
  // would store 4- or 8-byte pieces a quarter of a sector apart
  __syncthreads();  // every warp is done with Q
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    store2(Qs + m * QST + col, oacc[4 * j] / den0, oacc[4 * j + 1] / den0);
    store2(Qs + (m + 8) * QST + col, oacc[4 * j + 2] / den1,
           oacc[4 * j + 3] / den1);
  }
  __syncthreads();
  for (int c = tid; c < BQ * QC; c += NT) {  // hd is a multiple of V here
    const int r = c / QC, qq = c % QC, s = q0 + r;
    if (s < S && qq * V < hd)
      *reinterpret_cast<uint4*>(ob + s * oss + qq * V) =
          *reinterpret_cast<const uint4*>(Qs + r * QST + qq * V);
  }
}

// ---- bfloat16: one consumer warpgroup and one producer warp -----------
// Nothing is staged: TMA copies K and V tiles into the 128-byte swizzle
// that wgmma reads directly (K as the K-major B of S = Q K^T, V as the
// MN-major B of O += P V, bf16 wgmma transposing it), so the consumers
// never wait on each other and the producer keeps up to R tiles in flight.
constexpr int BQB = 64;   // query rows per block (one warpgroup)
constexpr int BKB = 64;   // keys per tile
constexpr int NTB = 160;  // the warpgroup and the producer warp

template <int HD>
struct BCfg {
  static constexpr int QST = HD + 8;            // padded Q row (bf16)
  static constexpr int QB = BQB * QST * 2;
  static constexpr int TILE = BKB * HD * 2;     // K or V: HD/64 boxes of
                                                // 64 keys x 128 bytes
  static constexpr int R = HD == 64 ? 4 : 2;    // tiles in flight
  static constexpr int SMEM = 1024 + R * 2 * TILE + QB + 2 * R * 8;
};

template <int HD>
__global__ void __launch_bounds__(NTB)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int group,
                  long long qsb, long long qsh, long long qss, long long ksb,
                  long long ksh, long long kss, long long vsb, long long vsh,
                  long long vss, long long osb, long long osh, long long oss,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, int tma,
                  float scale, int causal, int vec, int hd) {
  using C = BCfg<HD>;
  using T = __nv_bfloat16;
  constexpr int R = C::R, QST = C::QST, TILE = C::TILE;
  constexpr int QC = HD / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((base + 1023) & ~1023u) - base);
  T* Qs = reinterpret_cast<T*>(ring + R * 2 * TILE);  // [BQB][QST]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R * 2 * TILE + C::QB);
  uint64_t* empty = full + R;

  const int tid = threadIdx.x;
  const int nq = (S + BQB - 1) / BQB;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQB;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int kend = causal ? min(S, q0 + BQB) : S;
  const int nt = (kend + BKB - 1) / BKB;
  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(full + i, 1);   // the producer's expect_tx
      mbar_init(empty + i, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 && !tma) {  // the producer warp writes the tiles itself
    const int pl = tid - 128;
    const T* kb = k + b * ksb + kvh * ksh;
    const T* vb = v + b * vsb + kvh * vsh;
    constexpr int CH = HD / 8;  // 16-byte chunks of a row
    for (int t = 0; t < nt; ++t) {
      unsigned char* kt = ring + t % R * 2 * TILE;
      if (t >= R) mbar_wait(empty + t % R, (t / R - 1) & 1);
      for (int c = pl; c < BKB * CH; c += 32) {
        // key row r, chunk ch: box ch / 8 (64 columns), its 128-byte row r
        // with the chunk at (ch % 8) ^ (r % 8), as SWIZZLE_128B stores it
        const int r = c / CH, ch = c % CH, s = t * BKB + r;
        const int off = ch / 8 * 8192 + r * 128 + ((ch % 8 ^ (r & 7)) << 4);
        __align__(16) T kx[8], vx[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = ch * 8 + e;
          const bool in = s < S && d < hd;
          kx[e] = in ? kb[s * kss + d] : __float2bfloat16(0.f);
          vx[e] = in ? vb[s * vss + d] : __float2bfloat16(0.f);
        }
        *reinterpret_cast<uint4*>(kt + off) =
            *reinterpret_cast<const uint4*>(kx);
        *reinterpret_cast<uint4*>(kt + TILE + off) =
            *reinterpret_cast<const uint4*>(vx);
      }
      fence_proxy_async();  // the tile, visible to wgmma
      __syncwarp();
      if (pl == 0) mbar_arrive(full + t % R);
    }
    return;
  }
  if (tid >= 128) {  // the producer warp: K and V tiles, R ahead
    if (tid == 128) {
      for (int t = 0; t < nt; ++t) {
        unsigned char* kt = ring + t % R * 2 * TILE;
        if (t >= R) mbar_wait(empty + t % R, (t / R - 1) & 1);
        mbar_expect(full + t % R, 2 * TILE);
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(kt + c * 8192, &kmap, 64 * c, t * BKB, kvh, b,
                      full + t % R);
          tma_load_4d(kt + TILE + c * 8192, &vmap, 64 * c, t * BKB, kvh, b,
                      full + t % R);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----------------------------------------------
  const int g = (tid & 31) >> 2, t4 = tid & 3, warp = tid >> 5;
  const int m = warp * 16 + g;  // this thread's rows: m and m + 8
  const T* qb = q + b * qsb + h * qsh;
  for (int c = tid; c < BQB * QC; c += 128) {
    const int r = c / QC, qq = c % QC, s = q0 + r;
    load_chunk<T>(Qs + r * QST + qq * 8, qb + s * qss + qq * 8,
                  s < S ? hd - qq * 8 : 0, vec & 1, q);
  }
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  // Q's A fragments stay in registers for every tile
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(Qs + m * QST + ks * 16 + 2 * t4);
    qf[ks][0] = p[0];
    qf[ks][1] = p[4 * QST];
    qf[ks][2] = p[4];
    qf[ks][3] = p[4 * QST + 4];
  }

  float oacc[HD / 2], sacc[BKB / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  const float sl = scale * 1.4426950408889634f;  // base-2 softmax
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int r0 = q0 + m, r1 = r0 + 8;
  const int lim0 = causal ? min(r0, S - 1) : S - 1;
  const int lim1 = causal ? min(r1, S - 1) : S - 1;

  for (int t = 0; t < nt; ++t) {
    const unsigned char* kt = ring + t % R * 2 * TILE;
    mbar_wait(full + t % R, (t / R) & 1);
    // S = Q K^T: k-step ks of K's box ks / 4, 32 bytes into its rows
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      mma_bf16<BKB>(sacc, qf[ks],
                    sw128_desc(kt + ks / 4 * 8192 + ks % 4 * 32, 16),
                    ks == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    const int k0 = t * BKB;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * t4 + e;
        sacc[4 * j + e] = kp <= lim0 ? sacc[4 * j + e] * sl : NEG_INF;
        sacc[4 * j + 2 + e] =
            kp <= lim1 ? sacc[4 * j + 2 + e] * sl : NEG_INF;
        mx0 = fmaxf(mx0, sacc[4 * j + e]);
        mx1 = fmaxf(mx1, sacc[4 * j + 2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BKB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[4 * j + e] = ex2(sacc[4 * j + e] - mn0);
        sacc[4 * j + 2 + e] = ex2(sacc[4 * j + 2 + e] - mn1);
        rs0 += sacc[4 * j + e];
        rs1 += sacc[4 * j + 2 + e];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      oacc[4 * j] *= al0;
      oacc[4 * j + 1] *= al0;
      oacc[4 * j + 2] *= al1;
      oacc[4 * j + 3] *= al1;
    }
    uint32_t ph[BKB / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKB / 16; ++kk) {
      ph[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      ph[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      ph[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      ph[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
    // O += P V: keys 16 kk.. are rows 16 kk.. of V's boxes (MN-major)
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKB / 16; ++kk)
      mma_bf16<HD, 1>(oacc, ph[kk],
                      sw128_desc(kt + TILE + kk * 2048, 8192));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + t % R);  // this warp is done
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  T* ob = o + b * osb + h * osh;
  if (!(vec & 2)) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        if (col >= hd) continue;
        if (r0 < S) store(&ob[r0 * oss + col], oacc[4 * j + e] / den0);
        if (r1 < S) store(&ob[r1 * oss + col], oacc[4 * j + 2 + e] / den1);
      }
    }
    return;
  }
  // each warp stages its 16 rows in Q's (its own) and stores them in
  // 16-byte pieces
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    store2(Qs + m * QST + col, oacc[4 * j] / den0, oacc[4 * j + 1] / den0);
    store2(Qs + (m + 8) * QST + col, oacc[4 * j + 2] / den1,
           oacc[4 * j + 3] / den1);
  }
  __syncwarp();
  for (int c = tid & 31; c < 16 * QC; c += 32) {  // hd a multiple of 8 here
    const int r = warp * 16 + c / QC, qq = c % QC, s = q0 + r;
    if (s < S && qq * 8 < hd)
      *reinterpret_cast<uint4*>(ob + s * oss + qq * 8) =
          *reinterpret_cast<const uint4*>(Qs + r * QST + qq * 8);
  }
}

// K or V, (B, KV, S, hd) with element strides (batch, head, position), as
// a rank-4 tensor map of boxes 64 x 64 (128-byte rows, swizzled)
inline bool kv_map(CUtensorMap* map, const void* p, int B, int KV, int S,
                   int hd, long long sb, long long sh, long long ss) {
  const unsigned long long dims[4] = {(unsigned long long)hd,
                                      (unsigned long long)S,
                                      (unsigned long long)KV,
                                      (unsigned long long)B};
  const unsigned long long strides[3] = {(unsigned long long)ss * 2,
                                         (unsigned long long)sh * 2,
                                         (unsigned long long)sb * 2};
  const unsigned box[4] = {64, BKB, 1, 1};
  return tensor_map(map, p, 2, 4, dims, strides, box, true);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int S, int hd, const long long* st,
                float scale, int causal, cudaStream_t stream) {
  using C = BCfg<HD>;
  // TMA fills the tiles where a row is HD values on 16 bytes; else the
  // producer warp writes them
  CUtensorMap kmap{}, vmap{};
  const int tma = hd == HD &&
                  kv_map(&kmap, k, B, KV, S, HD, st[3], st[4], st[5]) &&
                  kv_map(&vmap, v, B, KV, S, HD, st[6], st[7], st[8]);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0;
  const bool ovec = reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                    st[11] % 8 == 0 && hd % 8 == 0;
  const dim3 grid((S + BQB - 1) / BQB, H, B);
  flash_bf16_kernel<HD><<<grid, NTB, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], kmap, vmap, tma, scale, causal,
      (int)vec | (int)ovec << 1, hd);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int hd, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  using T = float;
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  // cp.async takes 16-byte chunks when every row starts on 16 bytes
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % C::V == 0;
  // bit 1: the output's rows start on 16 bytes too
  const bool ovec = reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                    st[11] % C::V == 0 && hd % C::V == 0;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_f32_kernel<HD><<<grid, NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal, (int)vec | (int)ovec << 1, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, position) for q, k, v, o in that order.  Returns cudaGetLastError()
// after the launch (0 on success); the launch does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int hd,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0) return 0;
  if (hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  // the bucket: the smaller of 64 and 128 that holds hd
  if (dtype == 0 && hd <= 64)
    return launch_f32<64>(q, k, v, o, B, H, KV, S, hd, strides, scale,
                          causal, st);
  if (dtype == 0)
    return launch_f32<128>(q, k, v, o, B, H, KV, S, hd, strides, scale,
                           causal, st);
  if (dtype == 1 && hd <= 64)
    return launch_bf16<64>(q, k, v, o, B, H, KV, S, hd, strides, scale,
                           causal, st);
  if (dtype == 1)
    return launch_bf16<128>(q, k, v, o, B, H, KV, S, hd, strides, scale,
                            causal, st);
  return (int)cudaErrorInvalidValue;
}
