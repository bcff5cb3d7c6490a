// One-query decode attention over the serve engine's slot pool for sm_90a:
// the kernel of slot_decode_attention.cu.
//
// Computes  out[b,h,:] = softmax_{j < kv_len[b]}(q[b,h,:] . k[b,h/G,j,:]
//                        * scale) @ v[b,h/G,j,:]
// with q (B,H,hd) contiguous and k/v (B,KV,S,hd) read through element
// strides (sb, skv, ss) for B, KV and S, hd contiguous: the pool's
// (B,S,KV,hd) layer cache as its transpose(1, 2) view (sb = S*KV*hd, skv =
// hd, ss = KV*hd), with no copy.  Every row has its own valid length; a
// row with kv_len == 0 (an idle or finished slot) writes exact zeros.
// float32 and bfloat16, hd in {64, 128}, G = H/KV in {1, 2, 4, 8}; softmax
// state and accumulators are float32.  No rule ties S to a block size (the
// TPU kernels' bk had to divide S): ragged tails are masked.
//
// Bound on the H100: bytes.  The work streams each row's valid cache once,
// sum_b kv_len_b * KV * hd * 2 * itemsize bytes, at ~4*G FLOPs per byte
// loaded (float32) -- far below the ridge point, so 3.35 TB/s is the roof.
//
// Design: the TPU kernels' sequential cache-block grid axis becomes a loop
// inside a block, one block of 8 warps per (kv head, b) over the whole
// cache axis.  The G query heads of the group share every K/V row the
// block loads (the GQA bandwidth win).  Each warp takes U consecutive
// positions per iteration, one hd-wide row per position over its 32 lanes
// (2 or 4 values per lane, one vector load), and keeps its own
// online-softmax state (m, l, acc); the 8 warp states merge through shared
// memory and the block writes the output.
// Empty-block safety: a warp only runs an iteration whose first position
// is valid, so its max is a real logit; warps that saw no position carry
// m = NEG_INF and weigh exp(NEG_INF - M) == 0; kv_len <= 0 writes zeros
// before any load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dattn {

constexpr int NW = 8;  // warps per block
constexpr int U = 8;   // consecutive positions per warp per iteration
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// E contiguous values at p (E*sizeof(T) bytes, aligned) into float registers
__device__ __forceinline__ void load_vec(const float* p, float (&r)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  r[0] = t.x;
  r[1] = t.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&r)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x;
  r[1] = t.y;
  r[2] = t.z;
  r[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&r)[2]) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  r[0] = f.x;
  r[1] = f.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&r)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  r[0] = a.x;
  r[1] = a.y;
  r[2] = c.x;
  r[3] = c.y;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ o, int S, int KV, long long sb, long long skv,
              long long ss, float scale) {
  constexpr int E = HD / 32;  // values per lane per row
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long H = (long long)KV * G;
  const int n = min(kv_len[b], S);
  T* ob = o + (b * H + kvh * G) * HD;
  if (n <= 0) {  // idle / finished row: exact zeros, no cache read
    for (int i = threadIdx.x; i < G * HD; i += NW * 32) store(&ob[i], 0.f);
    return;
  }

  const T* qb = q + (b * H + kvh * G) * HD + lane * E;
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) load_vec(qb + g * HD, qr[g]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const long long row0 = (long long)b * sb + (long long)kvh * skv + lane * E;
  const T* kb = k + row0;
  const T* vb = v + row0;
  for (int base = w * U; base < n; base += NW * U) {
    float kr[U][E], vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u < n) {
        load_vec(kb + (base + u) * ss, kr[u]);
        load_vec(vb + (base + u) * ss, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[g][e] * kr[u][e];
        s[u] = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = base + u < n ? s[u] * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      // position `base` is valid, so mx (and m_new) is a real logit
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - m_new);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vr[u][e];
      }
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[w][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += NW * 32) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float f = expf(sm_m[ww][g] - M);
      L += sm_l[ww][g] * f;
      A += sm_acc[ww][g][d] * f;
    }
    store(&ob[i], A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
int launch_g(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int S, int KV, int G, long long sb,
             long long skv, long long ss, float scale, cudaStream_t stream) {
  const dim3 grid(KV, B);
#define DECODE_LAUNCH(GG)                                                  \
  decode_kernel<T, HD, GG><<<grid, NW * 32, 0, stream>>>(                  \
      static_cast<const T*>(q), static_cast<const T*>(k),                  \
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), S, KV, sb, skv, \
      ss, scale)
  switch (G) {
    case 1: DECODE_LAUNCH(1); break;
    case 2: DECODE_LAUNCH(2); break;
    case 4: DECODE_LAUNCH(4); break;
    case 8: DECODE_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
  return (int)cudaGetLastError();
}

// Launch the kernel on `stream`.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success); no
// synchronisation.
inline int run(const void* q, const void* k, const void* v, const int* kl,
               void* o, int dtype, int B, int S, int KV, int H, int hd,
               long long sb, long long skv, long long ss, float scale,
               cudaStream_t st) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (dtype == 0 && hd == 64)
    return launch_g<float, 64>(q, k, v, kl, o, B, S, KV, G, sb, skv, ss,
                               scale, st);
  if (dtype == 0 && hd == 128)
    return launch_g<float, 128>(q, k, v, kl, o, B, S, KV, G, sb, skv, ss,
                                scale, st);
  if (dtype == 1 && hd == 64)
    return launch_g<__nv_bfloat16, 64>(q, k, v, kl, o, B, S, KV, G, sb, skv,
                                       ss, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_g<__nv_bfloat16, 128>(q, k, v, kl, o, B, S, KV, G, sb,
                                        skv, ss, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dattn
