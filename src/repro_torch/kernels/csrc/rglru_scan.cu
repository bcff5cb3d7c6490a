// Linear-recurrence scan (the RG-LRU core) for sm_90a.
//
// Replaces: src/repro/kernels/rglru_scan.py :: rglru_scan
//           (Pallas TPU kernel `_kernel`).
//
// Computes h_t = a_t * h_{t-1} + b_t over t = 0..S-1 for every (b, w)
// lane, with h_{-1} = h0[b, w] (float32; zeros when h0 is NULL).  a, b
// (B, S, W) and the output h (B, S, W) share float32 or bfloat16; the
// carry is float32.  Each step rounds the product and then the sum
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version's
// two tensor ops do, so float32 results equal it bit for bit, and a frozen
// position (a = 1, b = 0, a padded admission tail) carries h through
// exactly.  Any B, S, W: unlike the TPU grid there is no divisibility
// rule (admission buckets and prompt lengths are ragged).
//
// Bound on the H100: bytes.  a and b are read once and h written once:
// 3 * B * S * W * itemsize bytes for 2 operations per lane and step.
//
// Design.  Bit-equality keeps every lane's chain sequential in t (a
// two-pass scan that composes affine maps across chunks would round
// otherwise), so the card is filled across lanes and fed from deep
// asynchronous copies.  The TPU kernel carries h in scratch across the
// sequence blocks of its grid; here one block walks a tile's whole
// sequence.
//  - One block a tile of LANES = 32 lanes (w) of one row b: recurrentgemma-
//    2b's 8 x 2560 lanes make 640 blocks, about 5 on every SM at once (the
//    first design's 160 blocks of 128 lanes left 28 SMs holding two and
//    setting the finish time); a single admission's 80 tiles each get an
//    SM of their own.
//  - A producer warp keeps NS = 4 stages of `steps` x LANES tiles of a and
//    b in flight, one 3-d TMA box (LANES lanes x steps steps x 1 row) of
//    each a stage on the stage's mbarrier; the host sizes `steps` so that
//    the blocks an SM holds share its shared memory (rglru_scan.scan_plan:
//    32 steps in float32 and 64 in bfloat16 at 640 tiles, up to 160 KB of
//    loads in flight an SM).  Boxes past W or S are zero-filled.
//  - One consumer warp runs the 32 chains out of shared memory (lane l
//    reads word l of each 128-byte row: no bank conflict), writes h into
//    one of two output tiles, and one TMA box store a stage takes the tile
//    to device memory (clipped at W and S), overlapping the next stage.
// Widths whose rows are not on 16 bytes (W * itemsize % 16 != 0), or
// tensors off 16 bytes, cannot be described to the TMA unit; they take the
// first design instead: one thread per lane, in 128-thread blocks, loading
// UNR steps ahead into registers.
//
// The backward (rglru_scan_bwd; the TPU kernel has none: JAX differentiates
// lax.associative_scan, src/repro/models/griffin.py:154).  For upstream
// g_t = dL/dh_t it walks the sequence backwards:
//   dh_t = g_t + a_{t+1} * dh_{t+1}   (0 past the last step)
//   db_t = dh_t,  da_t = dh_t * h_{t-1}  (h_{-1} = h0),  dh0 = a_0 * dh_0,
// the carry in float32 with each product and sum rounded, as autograd
// through the plain version rounds them (float32 results equal it bit for
// bit).  It reads h_{t-1} from a float32 h: in float32 the forward's own
// output is that h exactly; in bfloat16 the forward runs on float32 copies
// of a and b and keeps its float32 h, since the bf16 output is rounded and
// a product with it would be too.  Bound: bytes, a, g (itemsize) and h (4)
// read once and da, db written once, 4 itemsize + 4 bytes a lane and step.
// Same plan as the forward, walked in reverse: the producer warp issues the
// stages last to first, each three boxes (a, g, and h one step back: row
// coordinate it * steps - 1, which the TMA unit zero-fills at -1), the
// consumer warp runs 32 chains from the end of each stage to its start and
// stores da and db by two TMA boxes a stage; rows past S are zeros, so the
// carry starts at 0 through them.  Rows off 16 bytes: one thread a lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"  // mbarriers, TMA loads, tensor maps

namespace {

constexpr int LANES = 32;  // lanes (w) a tile: one consumer warp
constexpr int NS = 4;      // stages of a and b in flight
constexpr int NTT = 64;    // the consumer warp, then the producer warp
constexpr int NT = 128;    // threads a block of the per-lane path
constexpr int UNR = 8;     // steps the per-lane path loads ahead

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory of a TMA-path block: barriers, NS stages of a and b, two
// output tiles.
__host__ __device__ constexpr int tma_smem_bytes(int steps, int item) {
  return 128 + (2 * NS + 2) * steps * LANES * item;
}

// one box of shared memory to a tensor map at coordinates c (innermost
// first; elements outside the tensor are not written), in a bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(tc::smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Block x: tile (b, w0) = (x / wtiles, (x % wtiles) * LANES); the tensor
// maps view a, b and h as (W, S, B) with boxes (LANES, steps, 1).
template <typename T>
__global__ void __launch_bounds__(NTT)
rglru_scan_tma(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap omap,
               const float* __restrict__ h0, int S, int W, int wtiles,
               int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [NS]
  uint64_t* empty = full + NS;                         // [NS]
  const int te = steps * LANES;                        // elements a tile
  T* sA = reinterpret_cast<T*>(smem + 128);            // [NS][steps][LANES]
  T* sB = sA + NS * te;                                // [NS][steps][LANES]
  T* sO = sB + NS * te;                                // [2][steps][LANES]
  const int bi = blockIdx.x / wtiles;
  const int w0 = (blockIdx.x - bi * wtiles) * LANES;
  const int nst = (S + steps - 1) / steps;  // stages along the sequence
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tc::mbar_init(full + s, 1);   // the producer's expect_tx
      tc::mbar_init(empty + s, 1);  // the consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // ---- producer: one lane issues the boxes ------------
    if (lane == 0) {
      for (int it = 0; it < nst; ++it) {
        const int s = it % NS;
        if (it >= NS) tc::mbar_wait(empty + s, (it / NS - 1) & 1);
        tc::mbar_expect(full + s, 2 * te * (int)sizeof(T));
        tc::tma_load_3d(sA + s * te, &amap, w0, it * steps, bi, full + s);
        tc::tma_load_3d(sB + s * te, &bmap, w0, it * steps, bi, full + s);
      }
    }
    return;
  }

  // ---- consumer: lane l carries lane w0 + l ------------------------------
  const int w = w0 + lane;
  float h = h0 != nullptr && w < W ? h0[(long long)bi * W + w] : 0.f;
  for (int it = 0; it < nst; ++it) {
    const int s = it % NS;
    T* ob = sO + (it & 1) * te + lane;
    if (it >= 2) {  // the store of stage it - 2 has read this output tile
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
    }
    tc::mbar_wait(full + s, (it / NS) & 1);
    const T* ta = sA + s * te + lane;
    const T* tb = sB + s * te + lane;
    // steps is a multiple of 8; rows past S are zeros and are not stored
    for (int j = 0; j < steps; j += 8) {
      float av[8], bv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        av[u] = to_f(ta[(j + u) * LANES]);
        bv[u] = to_f(tb[(j + u) * LANES]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        store(ob + (j + u) * LANES, h);
      }
    }
    __syncwarp();  // every lane has read stage s and written its h
    if (lane == 0) tc::mbar_arrive(empty + s);
    tc::fence_proxy_async();  // this lane's h, visible to the bulk store
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&omap, ob - lane, w0, it * steps, bi);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_all();  // no store still reads shared memory
}

// The per-lane path (rows off 16 bytes): one thread per (b, w) lane.
template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_lanes(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ h0, T* __restrict__ o, int B,
                 int S, int W) {
  const long long lane = (long long)blockIdx.x * NT + threadIdx.x;
  if (lane >= (long long)B * W) return;
  const long long bi = lane / W, w = lane - bi * W;
  float h = h0 != nullptr ? h0[lane] : 0.f;
  const long long base = bi * S * W + w;
  int t = 0;
  for (; t + UNR <= S; t += UNR) {
    float av[UNR], bv[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const long long i = base + (long long)(t + u) * W;
      av[u] = to_f(a[i]);
      bv[u] = to_f(b[i]);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      store(&o[base + (long long)(t + u) * W], h);
    }
  }
  for (; t < S; ++t) {
    const long long i = base + (long long)t * W;
    h = __fadd_rn(__fmul_rn(to_f(a[i]), h), to_f(b[i]));
    store(&o[i], h);
  }
}

// Shared memory of a backward TMA-path block: barriers, NS stages of h
// (float32), a and g, and two output tiles each of da and db.
__host__ __device__ constexpr int bwd_smem_bytes(int steps, int item) {
  return 128 + (NS * (2 * item + 4) + 4 * item) * steps * LANES;
}

// Block x: tile (b, w0) as in the forward; maps view a, g, h, da and db as
// (W, S, B) with boxes (LANES, steps, 1).  dh0 (B, W) float32 or null.
template <typename T>
__global__ void __launch_bounds__(NTT)
rglru_scan_bwd_tma(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap damap,
                   const __grid_constant__ CUtensorMap dbmap,
                   const float* __restrict__ h0, float* __restrict__ dh0,
                   int S, int W, int wtiles, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [NS]
  uint64_t* empty = full + NS;                         // [NS]
  const int te = steps * LANES;                        // elements a tile
  float* sH = reinterpret_cast<float*>(smem + 128);    // [NS][steps][LANES]
  T* sA = reinterpret_cast<T*>(sH + NS * te);          // [NS][steps][LANES]
  T* sG = sA + NS * te;                                // [NS][steps][LANES]
  T* sDA = sG + NS * te;                               // [2][steps][LANES]
  T* sDB = sDA + 2 * te;                               // [2][steps][LANES]
  const int bi = blockIdx.x / wtiles;
  const int w0 = (blockIdx.x - bi * wtiles) * LANES;
  const int nst = (S + steps - 1) / steps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tc::mbar_init(full + s, 1);
      tc::mbar_init(empty + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // ---- producer: the stages, last to first -----------
    if (lane == 0) {
      for (int k = 0; k < nst; ++k) {
        const int it = nst - 1 - k, s = k % NS;
        if (k >= NS) tc::mbar_wait(empty + s, (k / NS - 1) & 1);
        tc::mbar_expect(full + s, te * (2 * (int)sizeof(T) + 4));
        tc::tma_load_3d(sA + s * te, &amap, w0, it * steps, bi, full + s);
        tc::tma_load_3d(sG + s * te, &gmap, w0, it * steps, bi, full + s);
        // h one step back: row j holds h_{it * steps + j - 1}
        tc::tma_load_3d(sH + s * te, &hmap, w0, it * steps - 1, bi,
                        full + s);
      }
    }
    return;
  }

  // ---- consumer: lane l carries lane w0 + l backwards --------------------
  const int w = w0 + lane;
  const float hinit = h0 != nullptr && w < W ? h0[(long long)bi * W + w] : 0.f;
  float carry = 0.f;  // a_{t+1} * dh_{t+1}
  for (int k = 0; k < nst; ++k) {
    const int it = nst - 1 - k, s = k % NS;
    T* oa = sDA + (k & 1) * te + lane;
    T* ob = sDB + (k & 1) * te + lane;
    if (k >= 2) {  // the stores of stage k - 2 have read these tiles
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
    }
    tc::mbar_wait(full + s, (k / NS) & 1);
    const T* ta = sA + s * te + lane;
    const T* tg = sG + s * te + lane;
    const float* th = sH + s * te + lane;
    for (int j = steps - 8; j >= 0; j -= 8) {
      float av[8], gv[8], hv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        av[u] = to_f(ta[(j + u) * LANES]);
        gv[u] = to_f(tg[(j + u) * LANES]);
        hv[u] = th[(j + u) * LANES];
      }
      if (it == 0 && j == 0) hv[0] = hinit;  // h_{-1}
#pragma unroll
      for (int u = 7; u >= 0; --u) {
        const float dh = __fadd_rn(gv[u], carry);
        store(ob + (j + u) * LANES, dh);
        store(oa + (j + u) * LANES, __fmul_rn(dh, hv[u]));
        carry = __fmul_rn(av[u], dh);
      }
    }
    __syncwarp();  // every lane has read stage s and written its tiles
    if (lane == 0) tc::mbar_arrive(empty + s);
    tc::fence_proxy_async();  // this lane's da, db, visible to the stores
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&damap, oa - lane, w0, it * steps, bi);
      tma_store_3d(&dbmap, ob - lane, w0, it * steps, bi);
      bulk_commit();
    }
  }
  if (dh0 != nullptr && w < W) dh0[(long long)bi * W + w] = carry;
  if (lane == 0) bulk_wait_all();
}

// The backward's per-lane path (rows off 16 bytes): one thread per lane.
template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_lanes(const T* __restrict__ a, const T* __restrict__ g,
                     const float* __restrict__ h,
                     const float* __restrict__ h0, T* __restrict__ da,
                     T* __restrict__ db, float* __restrict__ dh0, int B,
                     int S, int W) {
  const long long lane = (long long)blockIdx.x * NT + threadIdx.x;
  if (lane >= (long long)B * W) return;
  const long long bi = lane / W, w = lane - bi * W;
  const long long base = bi * S * W + w;
  const float hinit = h0 != nullptr ? h0[lane] : 0.f;
  float carry = 0.f;
  for (int t = S - 1; t >= 0; --t) {
    const long long i = base + (long long)t * W;
    const float dh = __fadd_rn(to_f(g[i]), carry);
    const float hp = t > 0 ? h[i - W] : hinit;
    store(&db[i], dh);
    store(&da[i], __fmul_rn(dh, hp));
    carry = __fmul_rn(to_f(a[i]), dh);
  }
  if (dh0 != nullptr) dh0[lane] = carry;
}

template <typename T>
int launch_bwd_tma(const void* a, const void* g, const float* h,
                   const float* h0, void* da, void* db, float* dh0, int B,
                   int S, int W, int steps, cudaStream_t st) {
  auto kern = rglru_scan_bwd_tma<T>;
  static int smem_max = 0;  // per type: the attributes, once
  if (smem_max == 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    smem_max = optin;
  }
  const int smem = bwd_smem_bytes(steps, (int)sizeof(T));
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  const unsigned long long es = sizeof(T);
  const unsigned long long dims[3] = {(unsigned long long)W,
                                      (unsigned long long)S,
                                      (unsigned long long)B};
  const unsigned long long strides[2] = {W * es, (unsigned long long)S * W *
                                                     es};
  const unsigned long long hstrides[2] = {W * 4ull,
                                          (unsigned long long)S * W * 4ull};
  const unsigned box[3] = {LANES, (unsigned)steps, 1};
  CUtensorMap amap{}, gmap{}, hmap{}, damap{}, dbmap{};
  if (!tc::tensor_map(&amap, a, (int)es, 3, dims, strides, box, false) ||
      !tc::tensor_map(&gmap, g, (int)es, 3, dims, strides, box, false) ||
      !tc::tensor_map(&hmap, h, 4, 3, dims, hstrides, box, false) ||
      !tc::tensor_map(&damap, da, (int)es, 3, dims, strides, box, false) ||
      !tc::tensor_map(&dbmap, db, (int)es, 3, dims, strides, box, false))
    return (int)cudaErrorInvalidValue;  // the host's plan checks alignment
  const int wtiles = (W + LANES - 1) / LANES;
  const long long blocks = (long long)B * wtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NTT, smem, st>>>(amap, gmap, hmap, damap, dbmap,
                                             h0, dh0, S, W, wtiles, steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_lanes(const void* a, const void* g, const float* h,
                     const float* h0, void* da, void* db, float* dh0, int B,
                     int S, int W, cudaStream_t st) {
  const long long blocks = ((long long)B * W + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rglru_scan_bwd_lanes<T><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), h, h0,
      static_cast<T*>(da), static_cast<T*>(db), dh0, B, S, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tma(const void* a, const void* b, const float* h0, void* o, int B,
               int S, int W, int steps, cudaStream_t st) {
  auto kern = rglru_scan_tma<T>;
  static int smem_max = 0;  // per type: the attributes, once
  if (smem_max == 0) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return (int)e;
    smem_max = optin;
  }
  const int smem = tma_smem_bytes(steps, (int)sizeof(T));
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  const unsigned long long es = sizeof(T);
  const unsigned long long dims[3] = {(unsigned long long)W,
                                      (unsigned long long)S,
                                      (unsigned long long)B};
  const unsigned long long strides[2] = {W * es, (unsigned long long)S * W *
                                                     es};
  const unsigned box[3] = {LANES, (unsigned)steps, 1};
  CUtensorMap amap{}, bmap{}, omap{};
  if (!tc::tensor_map(&amap, a, (int)es, 3, dims, strides, box, false) ||
      !tc::tensor_map(&bmap, b, (int)es, 3, dims, strides, box, false) ||
      !tc::tensor_map(&omap, o, (int)es, 3, dims, strides, box, false))
    return (int)cudaErrorInvalidValue;  // the host's plan checks alignment
  const int wtiles = (W + LANES - 1) / LANES;
  const long long blocks = (long long)B * wtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NTT, smem, st>>>(
      amap, bmap, omap, h0, S, W, wtiles, steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lanes(const void* a, const void* b, const float* h0, void* o,
                 int B, int S, int W, cudaStream_t st) {
  const long long blocks = ((long long)B * W + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rglru_scan_lanes<T><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(o), B, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, o (B,S,W) contiguous, dtype 0 = float32, 1 = bfloat16; h0 (B,W)
// float32 contiguous or NULL.  steps > 0 (a multiple of 8, at most 256):
// the TMA path with that many steps a stage (a, b and o 16-byte aligned,
// W * itemsize a multiple of 16); steps = 0: the per-lane path.  One
// launch; returns cudaGetLastError() after it (0 on success); no
// synchronisation.
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* o, int dtype, int B, int S, int W,
                              int steps, void* stream) {
  if (B < 0 || S < 0 || W < 0 || steps < 0 || steps > 256 || steps % 8 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * W == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h0);
  if (steps > 0)
    return dtype == 0
               ? launch_tma<float>(a, b, hp, o, B, S, W, steps, st)
               : launch_tma<__nv_bfloat16>(a, b, hp, o, B, S, W, steps, st);
  return dtype == 0 ? launch_lanes<float>(a, b, hp, o, B, S, W, st)
                    : launch_lanes<__nv_bfloat16>(a, b, hp, o, B, S, W, st);
}

// The backward.  a, g (upstream dL/dh), da, db (B,S,W) contiguous in one
// dtype (0 = float32, 1 = bfloat16); h (B,S,W) the forward's float32 h;
// h0 (B,W) float32 or NULL (zeros); dh0 (B,W) float32 written when not
// NULL.  steps as the forward's (the host's plan sizes it for this
// kernel's shared memory; every pointer 16-byte aligned on the TMA path).
// One launch; returns cudaGetLastError() after it; no synchronisation.
extern "C" int rglru_scan_bwd(const void* a, const void* g, const void* h,
                              const void* h0, void* da, void* db, void* dh0,
                              int dtype, int B, int S, int W, int steps,
                              void* stream) {
  if (B < 0 || S < 0 || W < 0 || steps < 0 || steps > 256 || steps % 8 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const float* h0p = static_cast<const float*>(h0);
  float* dh0p = static_cast<float*>(dh0);
  if (S == 0) {  // nothing to walk: dh0 = 0
    if (dh0p != nullptr)
      return (int)cudaMemsetAsync(dh0p, 0, (size_t)B * W * 4, st);
    return 0;
  }
  if (steps > 0)
    return dtype == 0 ? launch_bwd_tma<float>(a, g, hp, h0p, da, db, dh0p, B,
                                              S, W, steps, st)
                      : launch_bwd_tma<__nv_bfloat16>(a, g, hp, h0p, da, db,
                                                      dh0p, B, S, W, steps,
                                                      st);
  return dtype == 0 ? launch_bwd_lanes<float>(a, g, hp, h0p, da, db, dh0p, B,
                                              S, W, st)
                    : launch_bwd_lanes<__nv_bfloat16>(a, g, hp, h0p, da, db,
                                                      dh0p, B, S, W, st);
}
