// Ring-buffer window slot decode for sm_90a: the kernels of
// ring_decode_attention.cu (one ring row per slot).  The paged twin,
// paged_ring_decode_attention.cu, runs the paged body of paged_decode.cuh.
//
// Computes, for each slot b at query position pos = slot_positions[b],
//   out[b,h,:] = softmax_{p in band}(q[b,h,:] . K[p,h/G,:] * scale) @ V[p,h/G,:]
// over the band p in [lo, pos], lo = max(0, pos - min(window, ring) + 1),
// where position p sits in ring slot p % ring.  That is the set the ring
// invariant leaves attendable: slot s holds the largest position <= pos
// with p % ring == s, and the band keeps (pos - window, pos].  A row with
// pos < 0 (an idle or finished slot) writes exact zeros.  Walking the
// band by position, not by slot, means no negative number is ever divided
// (C++ `/` truncates where the reference floors).
//
// Bound on the H100: bytes.  Each band position's K and V row is read
// once: sum_b n_b * KV * hd * 2 * itemsize, about 2 * hd operations per
// byte (f32) -- far below the ridge point, so 3.35 TB/s is the roof.
//
// Design: split the band.  A slot with KV = 1 (recurrentgemma-2b: 10
// query heads over one KV head, hd 256) has one (b, kv head) pair, so one
// block per pair would put 8 blocks on 132 SMs.  Instead the band is cut
// into chunks of CHUNK = 64 positions, one block of 4 warps per (kv head,
// b, chunk): grid (KV, B, nsplit), nsplit = ceil(min(window, ring) /
// CHUNK), 256 blocks at recurrentgemma-2b's 8 slots.  A block
//   0. stages the G query rows in shared memory as float;
//   1. computes its chunk's logits: each warp takes U positions at a time,
//      one coalesced vector load per lane per K row, and every query head
//      of the group reads that row (G up to 16, a runtime value) -- the
//      logits go to shared memory;
//   2. takes, per head, the chunk's max and the sum of exponentials (one
//      warp per head) and leaves the exponentials in place;
//   3. accumulates P @ V with each thread owning G*hd/128 outputs, one
//      coalesced V row per position;
// and writes the partial (m, l, acc) of its chunk to a float32 workspace.
// A second kernel merges the chunks of each (b, kv head) row, one output
// per thread.  A chunk past a short band writes the neutral partial
// (m = -1e30, l = 0), which the merge weighs by exp(-1e30 - M) = 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

constexpr int NT = 128;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int CHUNK = 64;  // band positions per block
constexpr int GMAX = 16;    // query heads per kv head
constexpr int U = 4;        // positions per warp per phase-1 iteration
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N contiguous values at p (aligned to N * sizeof(T)) into floats r[0..N)
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* r) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* r) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    r[0] = a.x; r[1] = a.y; r[2] = c.x; r[3] = c.y;
  } else {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    r[0] = f.x; r[1] = f.y;
  }
}

// Element offset of position p's K/V row (kv head 0) in one slot's ring
// row (B, ring, KV, hd).
struct DenseRows {
  long long base;  // b * ring * KV * hd
  long long stride;  // KV * hd
  int ring;
  __device__ __forceinline__ long long operator()(int p) const {
    return base + (long long)(p % ring) * stride;
  }
};

// Workspace layout per (row = b * KV + kvh, split): m[G], l[G], acc[G][hd]
// at offsets of a float buffer of nrow * nsplit * G * (hd + 2) floats.
struct Work {
  float* m;
  float* l;
  float* acc;
};
__device__ __forceinline__ Work work_at(float* work, int nrow, int nsplit,
                                        int G, int hd, int row, int split) {
  const long long cell = (long long)row * nsplit + split;
  const long long ncell = (long long)nrow * nsplit;
  return Work{work + cell * G, work + ncell * G + cell * G,
              work + 2 * ncell * G + cell * G * hd};
}

template <typename T, int HD, typename Rows>
__device__ __forceinline__ void partial_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const Rows& rows, int pos, float* work,
    int nrow, int nsplit, int KV, int G, int window, int ring, float scale) {
  constexpr int E = HD / 32;  // values per lane per row (phase 1)
  constexpr int VEC = E < 4 ? E : 4;
  constexpr int NV = E / VEC;
  constexpr int DPT = HD >= NT ? HD / NT : 1;  // V values per thread
  constexpr int JMAX = GMAX * HD / NT;  // outputs per thread, at most
  __shared__ __align__(16) float sq[GMAX * HD];
  __shared__ float ss[GMAX * CHUNK];
  __shared__ float sm[GMAX], sl[GMAX];

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const Work out = work_at(work, nrow, nsplit, G, HD, b * KV + kvh, split);
  int p0 = 0, cnt = 0;
  if (pos >= 0) {
    const int lo = max(0, pos - min(window, ring) + 1);
    p0 = lo + split * CHUNK;
    cnt = min(CHUNK, pos + 1 - p0);
  }
  if (cnt <= 0) {  // past the band (or a done row): the neutral partial
    for (int i = threadIdx.x; i < G; i += NT) {
      out.m[i] = NEG_INF;
      out.l[i] = 0.f;
    }
    for (int i = threadIdx.x; i < G * HD; i += NT) out.acc[i] = 0.f;
    return;
  }
  const long long H = (long long)KV * G;
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += NT) sq[i] = to_f(qb[i]);
  __syncthreads();

  // 1. logits of the chunk's positions, every head of the group
  const long long koff = (long long)kvh * HD;
  for (int i0 = w * U; i0 < cnt; i0 += NWARP * U) {
    float kr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u < cnt) {
        const T* kp = k + rows(p0 + i0 + u) + koff;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          load_vec<VEC>(kp + j * 32 * VEC + lane * VEC, &kr[u][j * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = 0.f;
      }
    }
    for (int g = 0; g < G; ++g) {
      float qv[E];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        load_vec<VEC>(sq + g * HD + j * 32 * VEC + lane * VEC, &qv[j * VEC]);
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qv[e] * kr[u][e];
        s[u] = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + u < cnt) ss[g * CHUNK + i0 + u] = s[u] * scale;
      }
    }
  }
  __syncthreads();

  // 2. per head: the chunk's max and sum; exponentials stay in ss
  for (int g = w; g < G; g += NWARP) {
    float mx = NEG_INF;
    for (int i = lane; i < cnt; i += 32) mx = fmaxf(mx, ss[g * CHUNK + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int i = lane; i < cnt; i += 32) {
      const float e = expf(ss[g * CHUNK + i] - mx);
      ss[g * CHUNK + i] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      sm[g] = mx;
      sl[g] = sum;
    }
  }
  __syncthreads();

  // 3. P @ V: output i = threadIdx.x + j * NT is head i / HD, dim i % HD
  float acc[JMAX];
#pragma unroll
  for (int j = 0; j < JMAX; ++j) acc[j] = 0.f;
  const int GH = G * HD;
#pragma unroll 8
  for (int i = 0; i < cnt; ++i) {
    const T* vp = v + rows(p0 + i) + koff;
    float vv[DPT];
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      vv[jj] = to_f(vp[HD >= NT ? threadIdx.x + jj * NT : threadIdx.x % HD]);
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int o = threadIdx.x + j * NT;
      if (o < GH) acc[j] += ss[(o / HD) * CHUNK + i] * vv[j % DPT];
    }
  }
  for (int i = threadIdx.x; i < G; i += NT) {
    out.m[i] = sm[i];
    out.l[i] = sl[i];
  }
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int o = threadIdx.x + j * NT;
    if (o < GH) out.acc[o] = acc[j];
  }
}

// Merge each (b, kv head) row's nsplit partials: grid (KV, B,
// ceil(G * hd / NT)), one output per thread, so the merge's loads run on
// as many SMs as the partials did (its loop over the splits has no
// dependence between iterations but the sums).
template <typename T>
__global__ void __launch_bounds__(NT)
ring_combine_kernel(float* __restrict__ work, const int* __restrict__ pos_b,
                    T* __restrict__ o, int nrow, int nsplit, int KV, int G,
                    int hd) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int i = blockIdx.z * NT + threadIdx.x;  // output (head i / hd)
  if (i >= G * hd) return;
  const long long H = (long long)KV * G;
  T* ob = o + ((long long)b * H + (long long)kvh * G) * hd;
  if (pos_b[b] < 0) {  // done row: exact zeros
    store(&ob[i], 0.f);
    return;
  }
  const int g = i / hd;
  // split s of this row sits s * G (m, l) or s * G * hd (acc) further on
  const Work w0 = work_at(work, nrow, nsplit, G, hd, b * KV + kvh, 0);
  const float* m = w0.m + g;
  const float* l = w0.l + g;
  const float* acc = w0.acc + i;
  float M = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m[(long long)s * G]);
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float f = expf(m[(long long)s * G] - M);
    L += l[(long long)s * G] * f;
    A += acc[(long long)s * G * hd] * f;
  }
  store(&ob[i], A / fmaxf(L, 1e-30f));
}

// The entry's checks; returns 0 when the geometry is taken.
inline int check_geometry(int B, int KV, int H, int hd, int ring, int window,
                          int nsplit) {
  if (B < 0 || KV < 1 || H % KV || H / KV < 1 || H / KV > GMAX)
    return (int)cudaErrorInvalidValue;
  if (hd != 64 && hd != 128 && hd != 256) return (int)cudaErrorInvalidValue;
  if (ring < 1 || window < 1 || nsplit < 1) return (int)cudaErrorInvalidValue;
  const int span = window < ring ? window : ring;
  if ((long long)nsplit * CHUNK < span) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace ring
