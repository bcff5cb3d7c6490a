// Mango's rank-1 growth sandwich  Y[n] = A_I^T . X[n] . A_O,  for sm_90a.
//
// Replaces: src/repro/kernels/tr_sandwich.py:41 :: tr_sandwich (Pallas TPU
//           kernel `_kernel`, :26), the two large mode products of the
//           TR-MPO contraction (paper Eq. 6) fused so that the intermediate
//           T = X[n] . A_O never goes to device memory.
//
// Shapes: x (N, D1i, D1o), a_i (D1i, D2i), a_o (D1o, D2o), y (N, D2i, D2o),
// all row-major and contiguous; float32 or bfloat16 (one dtype for all
// four), float32 sums, output rounded to the input dtype.  No divisibility
// rule: every ragged edge is zero-filled or masked.
//
// Bound on the H100: operations.  At the growth path's shape (gpt-small ->
// gpt-base: N = 144, 512 -> 768) the work is 2 N (D1i D1o D2o + D1i D2i D2o)
// = 144.95 GFLOP: 0.878 ms at the 165 TFLOP/s of float32 done as 3xTF32
// (495 / 3), 0.147 ms in bf16 at 989 TFLOP/s, against 0.147 ms (f32) to
// move its 494 MB.  T is computed once per (n, column tile): exactly those
// FLOPs, where the TPU kernel recomputes T for every row tile of Y.
//
// Design: one block per (64 columns of Y, n): two consumer warpgroups
// (256 threads) run both products on the tensor cores (wgmma, m64 n64
// each, A from registers, B from shared memory) while one producer warp
// keeps a ring of three shared-memory slots full:
//   product 1  T = X[n] . A_O[:, tile], 128 rows of X a chunk (64 per
//              warpgroup), kept in shared memory as T^T in float32 (64 x
//              D1i: 128 KB at D1i = 512), never in device memory;
//   product 2  Y^T[tile, :] = T^T . A_I, D2i in chunks of 128 (64 per
//              warpgroup), stored transposed into Y.
// Layout: TF32 wgmma reads its shared B operand K-major only, with no
// transpose, and B must already be split.  So B is A_O^T and A_I^T, which
// two small launches first cut into the kernel's shared-memory tiles
// (K-major core matrices; TF32 hi and lo planes in f32, one bf16 plane;
// zero past the edges) in a device scratch: 6 MB at the growth shape, made
// once per call instead of once per block.  The A operands (X[n]'s rows as
// copied, and T^T) are split into hi and lo in registers (3xTF32,
// wgmma.cuh), so T's split costs no shared memory.  In bf16 T enters
// product 2 as two bf16 terms, hi + lo.
// Pipeline: the producer copies each stage with one bulk copy (the B tile)
// and one TMA box (X's 128 rows, zero past the edges, in the 128-byte
// swizzle that keeps the fragment loads on 32 banks; element by element
// where X's rows do not start on 16 bytes), counted on the slot's "full"
// barrier; the consumers' warps release a slot on its "empty" barrier when
// its products are done, so copies run up to three stages ahead and the
// consumers never wait on each other within a product.  Stage depth along
// K: 32 (f32) / 64 (bf16: rows of 128 bytes) up to D1i = 512, 8 / 16 where
// T leaves less room.  The column tile is the fast grid axis, so the
// blocks that read one X[n] run together and X comes from device memory
// about once.  A block needs 256 (ceil64(D1i) + 4) bytes for T plus the
// ring: D1i <= 768; the wrapper raises beyond.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

using namespace tc;

constexpr int NC = 256;       // consumer threads: two warpgroups
constexpr int NT = NC + 32;   // and one producer warp
constexpr int TO = 64;        // columns of Y per block: the wgmma M of Y^T
constexpr int NB = 128;       // B rows per stage, 64 per warpgroup
constexpr int NW = 64;        // wgmma N of one warpgroup (both products)
constexpr int NR = 3;         // stages in the ring
constexpr int MAX_SMEM = 232448;
constexpr int ALIGN = 1024;   // the ring's alignment (TMA's 128-byte swizzle)

__host__ __device__ constexpr int t_bytes(int d1i) {
  return TO * ((d1i + 63) / 64 * 64 + 4) * 4;
}
// B-operand planes of one tile of R rows x kt: TF32 hi and lo, or bf16
__host__ __device__ constexpr int tile_bytes(int es, int rows, int kt) {
  return rows * kt * es * (es == 4 ? 2 : 1);
}
// a ring slot at stage depth kt: product 1's A_O^T tile and NB rows of X,
// or product 2's A_I^T tile
__host__ __device__ constexpr int slot_bytes(int es, int kt) {
  const int p1 = tile_bytes(es, TO, kt) + NB * kt * es;
  const int p2 = tile_bytes(es, NB, kt);
  return p1 > p2 ? p1 : p2;
}
// T^T, the ring (aligned), and its 2 x NR barriers
__host__ __device__ constexpr int smem_total(int es, int kt, int d1i) {
  return t_bytes(d1i) + ALIGN + NR * slot_bytes(es, kt) + 2 * NR * 8;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the consumer warpgroups only (the producer warp may have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// The B operands' image: src (K x Nn, src[k * Nn + n], A_I or A_O) cut
// into tiles of R rows n x KT k, each stored as the kernel's shared-memory
// planes (K-major core matrices; TF32 hi then lo, or one bf16 plane), zero
// past the edges, tile (nt, kt) at ((nt * nkt) + kt) * tile_bytes.  One
// block per tile; the main kernel then copies a tile as it is.
template <typename T, int R, int KT>
__global__ void __launch_bounds__(256)
image_kernel(const T* __restrict__ src, int K, int Nn, int nkt,
             unsigned char* __restrict__ img) {
  constexpr int V = 16 / sizeof(T), QC = KT / V;
  constexpr int TB = tile_bytes(sizeof(T), R, KT), PB = R * KT * sizeof(T);
  const int nt = blockIdx.x / nkt, kt = blockIdx.x % nkt;
  unsigned char* tile = img + (long long)blockIdx.x * TB;
  for (int c = threadIdx.x; c < R * QC; c += blockDim.x) {
    const int r = c % R, q = c / R;
    const int n = nt * R + r, k0 = kt * KT + q * V;
    float v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int k = k0 + e;
      v[e] = n < Nn && k < K ? float(src[(long long)k * Nn + n]) : 0.f;
    }
    uint4 hi;
    if constexpr (sizeof(T) == 4) {
      uint4 lo;
      split_tf32(v[0], hi.x, lo.x);
      split_tf32(v[1], hi.y, lo.y);
      split_tf32(v[2], hi.z, lo.z);
      split_tf32(v[3], hi.w, lo.w);
      *reinterpret_cast<uint4*>(tile + PB + core_off(r, q, R)) = lo;
    } else {  // bf16 values: exact through float
      hi.x = pack_bf16(v[0], v[1]);
      hi.y = pack_bf16(v[2], v[3]);
      hi.z = pack_bf16(v[4], v[5]);
      hi.w = pack_bf16(v[6], v[7]);
    }
    *reinterpret_cast<uint4*>(tile + core_off(r, q, R)) = hi;
  }
}

template <typename T, int KT>
__global__ void __launch_bounds__(NT, 1)
tr_sandwich_kernel(const T* __restrict__ x, T* __restrict__ y, int d1i,
                   int d1o, int d2i, int d2o,
                   const unsigned char* __restrict__ img_o,
                   const unsigned char* __restrict__ img_i,
                   const __grid_constant__ CUtensorMap xmap, int tma) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int V = 16 / sizeof(T);   // elements of a 16-byte chunk
  constexpr int KS = F32 ? 8 : 16;    // wgmma K
  constexpr int NKS = KT / KS;        // k-steps of a stage
  constexpr int QC = KT / V;          // 16-byte chunks of a row of X's tile
  // X's 128-byte rows come swizzled by TMA (chunk q of row r lands at
  // q ^ (r % 8)), so the fragment loads below hit 32 banks; shorter rows
  // come as they are
  constexpr int SW = QC == 8 ? 7 : 0;
  constexpr int TB1 = tile_bytes(sizeof(T), TO, KT);  // A_O^T tile
  constexpr int TB2 = tile_bytes(sizeof(T), NB, KT);  // A_I^T tile
  constexpr int XB = NB * KT * (int)sizeof(T);        // X's rows
  constexpr int PB1 = TB1 / (F32 ? 2 : 1), PB2 = TB2 / (F32 ? 2 : 1);
  constexpr int SB = slot_bytes(sizeof(T), KT);

  extern __shared__ __align__(128) unsigned char smem[];
  const int d1k = (d1i + 63) / 64 * 64;
  const int tst = d1k + 4;  // padded row of T^T: fragment loads hit 32 banks
  float* Ts = reinterpret_cast<float*>(smem);  // [TO][tst]
  const uint32_t base = smem_u32(smem);
  unsigned char* ring =
      smem + (((base + t_bytes(d1i) + ALIGN - 1) & ~(ALIGN - 1)) - base);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NR * SB);
  uint64_t* empty = full + NR;

  const int tid = threadIdx.x;
  const long long n = blockIdx.y;
  const int c0 = blockIdx.x * TO;
  const int nk1 = (d1o + KT - 1) / KT;
  const int ns1 = nk1 * ((d1k + NB - 1) / NB);
  const int nk2 = d1k / KT;
  const int ns2 = nk2 * ((d2i + NB - 1) / NB);
  if (tid == 0) {
    for (int i = 0; i < NR; ++i) {
      mbar_init(full + i, 1);        // the producer's expect_tx
      mbar_init(empty + i, NC / 32); // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC) {  // ---- the producer warp: fills the ring ----------
    const int lane = tid - NC;
    const T* xn = x + n * d1i * d1o;
    for (int s = 0; s < ns1 + ns2; ++s) {
      unsigned char* buf = ring + s % NR * SB;
      if (s >= NR) mbar_wait(empty + s % NR, (s / NR - 1) & 1);
      if (s < ns1) {  // A_O^T's tile and X[n]'s rows i0.., cols k0..
        const int i0 = s / nk1 * NB, kc = s % nk1;
        if (!tma) {  // rows not on 16 bytes: element by element
          T* xs = reinterpret_cast<T*>(buf + TB1);
          for (int e = lane; e < NB * KT; e += 32) {
            const int r = e / KT, k = e % KT, i = i0 + r, kk = kc * KT + k;
            const int q = (k / V) ^ (r & SW);
            xs[r * KT + q * V + k % V] =
                i < d1i && kk < d1o ? xn[(long long)i * d1o + kk] : T(0.f);
          }
          __threadfence_block();
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect(full + s % NR, TB1 + (tma ? XB : 0));
          bulk_load(buf, img_o + ((long long)blockIdx.x * nk1 + kc) * TB1,
                    TB1, full + s % NR);
          if (tma)
            tma_load_3d(buf + TB1, &xmap, kc * KT, i0, (int)n,
                        full + s % NR);
        }
      } else if (lane == 0) {  // A_I^T's tile
        mbar_expect(full + s % NR, TB2);
        bulk_load(buf, img_i + (long long)(s - ns1) * TB2, TB2,
                  full + s % NR);
      }
    }
    return;
  }

  // ---- the consumer warpgroups -------------------------------------------
  const int wg = tid >> 7;
  const int m = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);  // row (and +8)
  const int t4 = tid & 3;
  const bool lead = (tid & 31) == 0;
  // The tensor cores add into the accumulator rounding toward zero, a
  // bias that grows with the number of adds: over K = 768 in f32 it
  // reached the 1e-5 limit of the gradient check.  So in f32 the products
  // start afresh (scale-d 0) every FOLD stages and the folds are summed
  // here, rounding to nearest; every fold costs its adds on the critical
  // path, and bf16 (whose limits are far looser) folds once a chunk.
  constexpr int FOLD = F32 ? 4 : 1 << 30;
  float acc[NW / 2], sum[NW / 2];

  // product 1: T = X[n] . A_O[:, c0:c0+TO], 128 rows of X a chunk; A =
  // X[n] (fragments from its copied rows, 64 per warpgroup), B = A_O^T
  for (int s = 0; s < ns1; ++s) {
    const unsigned char* buf = ring + s % NR * SB;
    mbar_wait(full + s % NR, (s / NR) & 1);
    // this thread's rows of X's tile: r = 64 wg + m and r + 8
    const T* xr = reinterpret_cast<const T*>(buf + TB1) + (NW * wg + m) * KT;
    const int sw = m & SW;
    uint32_t ah[NKS][4], al[NKS][4];
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      // chunks 2 ks and 2 ks + 1 of the row hold this k-step
      const int q0 = ((2 * ks) ^ sw) * V, q1 = ((2 * ks + 1) ^ sw) * V;
      if constexpr (F32) {
        split_tf32(xr[q0 + t4], ah[ks][0], al[ks][0]);
        split_tf32(xr[8 * KT + q0 + t4], ah[ks][1], al[ks][1]);
        split_tf32(xr[q1 + t4], ah[ks][2], al[ks][2]);
        split_tf32(xr[8 * KT + q1 + t4], ah[ks][3], al[ks][3]);
      } else {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(xr);
        ah[ks][0] = w[(q0 >> 1) + t4];
        ah[ks][1] = w[4 * KT + (q0 >> 1) + t4];
        ah[ks][2] = w[(q1 >> 1) + t4];
        ah[ks][3] = w[4 * KT + (q1 >> 1) + t4];
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const int sc = ks == 0 && s % nk1 % FOLD == 0 ? 0 : 1;
      const uint64_t bh = kmajor_desc(buf, TO, ks, 0);
      if constexpr (F32)
        mma_3xtf32<NW>(acc, ah[ks], al[ks], bh,
                       kmajor_desc(buf + PB1, TO, ks, 0), sc);
      else
        mma_bf16<NW>(acc, ah[ks], bh, sc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lead) mbar_arrive(empty + s % NR);  // this warp is done with it
    if (s % nk1 % FOLD == FOLD - 1 || s % nk1 == nk1 - 1) {  // a fold ends
#pragma unroll
      for (int i = 0; i < NW / 2; ++i)
        sum[i] = (s % nk1 < FOLD ? 0.f : sum[i]) + acc[i];
    }
    if (s % nk1 == nk1 - 1) {  // T rows i, i + 8 of this chunk, to T^T
      const int i = s / nk1 * NB + NW * wg + m;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          if (i < d1k) Ts[c * tst + i] = sum[4 * j + e];
          if (i + 8 < d1k) Ts[c * tst + i + 8] = sum[4 * j + 2 + e];
        }
      }
    }
  }
  consumers_sync();  // T^T is complete

  // product 2: Y^T[c0:c0+TO, :] = T^T . A_I; A = T^T (registers from
  // shared memory), B = A_I^T
  T* yn = y + n * d2i * d2o;
  for (int s2 = 0; s2 < ns2; ++s2) {
    const int s = ns1 + s2;
    const unsigned char* buf = ring + s % NR * SB;
    const float* tp = Ts + m * tst + s2 % nk2 * KT;
    uint32_t ah[NKS][4], al[NKS][4];
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if constexpr (F32) {
        const float* p = tp + ks * 8 + t4;
        split_tf32(p[0], ah[ks][0], al[ks][0]);
        split_tf32(p[8 * tst], ah[ks][1], al[ks][1]);
        split_tf32(p[4], ah[ks][2], al[ks][2]);
        split_tf32(p[8 * tst + 4], ah[ks][3], al[ks][3]);
      } else {
        const float* p = tp + ks * 16 + 2 * t4;
        split_bf16(p[0], p[1], ah[ks][0], al[ks][0]);
        split_bf16(p[8 * tst], p[8 * tst + 1], ah[ks][1], al[ks][1]);
        split_bf16(p[8], p[9], ah[ks][2], al[ks][2]);
        split_bf16(p[8 * tst + 8], p[8 * tst + 9], ah[ks][3], al[ks][3]);
      }
    }
    mbar_wait(full + s % NR, (s / NR) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const int sc = ks == 0 && s2 % nk2 % FOLD == 0 ? 0 : 1;
      const uint64_t bh = kmajor_desc(buf, NB, ks, NW * wg);
      if constexpr (F32) {
        mma_3xtf32<NW>(acc, ah[ks], al[ks], bh,
                       kmajor_desc(buf + PB2, NB, ks, NW * wg), sc);
      } else {
        mma_bf16<NW>(acc, al[ks], bh, sc);
        mma_bf16<NW>(acc, ah[ks], bh);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lead) mbar_arrive(empty + s % NR);
    if (s2 % nk2 % FOLD == FOLD - 1 || s2 % nk2 == nk2 - 1) {
#pragma unroll
      for (int i = 0; i < NW / 2; ++i)
        sum[i] = (s2 % nk2 < FOLD ? 0.f : sum[i]) + acc[i];
    }
    if (s2 % nk2 == nk2 - 1) {  // Y[n][j][c0 + m] for this chunk's j
      const int jb = s2 / nk2 * NB + NW * wg + 2 * t4;
#pragma unroll
      for (int jj = 0; jj < NW / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jb + 8 * jj + e;
          if (j >= d2i) continue;
          if (c0 + m < d2o)
            store(&yn[(long long)j * d2o + c0 + m], sum[4 * jj + e]);
          if (c0 + m + 8 < d2o)
            store(&yn[(long long)j * d2o + c0 + m + 8],
                  sum[4 * jj + 2 + e]);
        }
      }
    }
  }
}

// bytes of the two images (A_O^T's tiles, then A_I^T's) at depth kt
long long image_bytes(int es, int kt, int d1i, int d1o, int d2i, int d2o) {
  const int d1k = (d1i + 63) / 64 * 64;
  const long long io = (long long)((d2o + TO - 1) / TO) *
                       ((d1o + kt - 1) / kt) * tile_bytes(es, TO, kt);
  const long long ii = (long long)((d2i + NB - 1) / NB) * (d1k / kt) *
                       tile_bytes(es, NB, kt);
  return io + ii;
}

// the stage depth (elements along K): DEEP (rows of X 128 bytes) up to the
// growth path's D1i of 512, SHALLOW where T leaves less room (D1i up to
// 768), 0 beyond
template <typename T>
constexpr int kDeep = sizeof(T) == 4 ? 32 : 64;
template <typename T>
constexpr int kShallow = sizeof(T) == 4 ? 8 : 16;
template <typename T>
int depth(int d1i) {
  if (smem_total(sizeof(T), kDeep<T>, d1i) <= MAX_SMEM) return kDeep<T>;
  if (smem_total(sizeof(T), kShallow<T>, d1i) <= MAX_SMEM) return kShallow<T>;
  return 0;
}

// X as a rank-3 tensor (D1o, D1i, N), boxes of KT x NB x 1; returns false
// where TMA cannot take it (a row not on 16 bytes) or the encoder refuses
template <typename T, int KT>
bool x_map(CUtensorMap* map, const void* x, int n, int d1i, int d1o) {
  const int es = sizeof(T);
  const unsigned long long dims[3] = {(unsigned long long)d1o,
                                      (unsigned long long)d1i,
                                      (unsigned long long)n};
  const unsigned long long strides[2] = {(unsigned long long)d1o * es,
                                         (unsigned long long)d1i * d1o * es};
  const unsigned box[3] = {KT, NB, 1};
  return tensor_map(map, x, es, 3, dims, strides, box, KT * es == 128);
}

template <typename T, int KT>
int launch_kt(const void* x, const void* a_i, const void* a_o, void* y,
              void* scratch, int n, int d1i, int d1o, int d2i, int d2o,
              cudaStream_t stream) {
  const int d1k = (d1i + 63) / 64 * 64;
  const int nko = (d1o + KT - 1) / KT, nki = d1k / KT;
  unsigned char* img_o = static_cast<unsigned char*>(scratch);
  unsigned char* img_i = img_o + (long long)((d2o + TO - 1) / TO) * nko *
                                     tile_bytes(sizeof(T), TO, KT);
  image_kernel<T, TO, KT><<<((d2o + TO - 1) / TO) * nko, 256, 0, stream>>>(
      static_cast<const T*>(a_o), d1o, d2o, nko, img_o);
  image_kernel<T, NB, KT><<<((d2i + NB - 1) / NB) * nki, 256, 0, stream>>>(
      static_cast<const T*>(a_i), d1i, d2i, nki, img_i);
  CUtensorMap map = {};
  const bool tma = x_map<T, KT>(&map, x, n, d1i, d1o);
  const int smem = smem_total(sizeof(T), KT, d1i);
  cudaError_t err = cudaFuncSetAttribute(
      tr_sandwich_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d2o + TO - 1) / TO, n);
  tr_sandwich_kernel<T, KT><<<grid, NT, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), d1i, d1o, d2i, d2o,
      img_o, img_i, map, tma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* a_i, const void* a_o, void* y,
           void* scratch, int n, int d1i, int d1o, int d2i, int d2o,
           cudaStream_t stream) {
  const int kt = depth<T>(d1i);
  if (kt == kDeep<T>)
    return launch_kt<T, kDeep<T>>(x, a_i, a_o, y, scratch, n, d1i, d1o, d2i,
                                  d2o, stream);
  if (kt == kShallow<T>)
    return launch_kt<T, kShallow<T>>(x, a_i, a_o, y, scratch, n, d1i, d1o,
                                     d2i, d2o, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of device scratch that tr_sandwich_fwd needs for these shapes (the
// B operands' images), or -1 when D1i does not fit in shared memory.
extern "C" long long tr_sandwich_scratch_bytes(int dtype, int d1i, int d1o,
                                               int d2i, int d2o) {
  const int kt = dtype == 0 ? depth<float>(d1i) : depth<__nv_bfloat16>(d1i);
  if (kt == 0) return -1;
  return image_bytes(dtype == 0 ? 4 : 2, kt, d1i, d1o, d2i, d2o);
}

// x (N,D1i,D1o), a_i (D1i,D2i), a_o (D1o,D2o), y (N,D2i,D2o); contiguous on
// the device; scratch: tr_sandwich_scratch_bytes of device memory, 16-byte
// aligned.  dtype: 0 = float32, 1 = bfloat16.  Three launches on `stream`
// (the two images, then the sandwich); returns cudaGetLastError() after
// them (0 on success); no synchronisation.
extern "C" int tr_sandwich_fwd(const void* x, const void* a_i,
                               const void* a_o, void* y, void* scratch,
                               int dtype, int n, int d1i, int d1o, int d2i,
                               int d2o, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d2i <= 0 || d2o <= 0) return 0;
  if (d1i <= 0 || d1o <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, a_i, a_o, y, scratch, n, d1i, d1o, d2i, d2o,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a_i, a_o, y, scratch, n, d1i, d1o, d2i,
                                 d2o, st);
  return (int)cudaErrorInvalidValue;
}
