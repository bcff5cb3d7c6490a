// One-query decode attention for sm_90a: the kernels shared by
// decode_attention.cu (a head-major cache read through strides) and
// slot_decode_attention.cu (the serve engine's (B,S,KV,hd) slot pool).
//
// Computes  out[b,h,:] = softmax_{j < kv_len[b]}(q[b,h,:] . k[b,h/G,j,:]
//                        * scale) @ v[b,h/G,j,:]
// with q (B,H,hd) contiguous and k/v (B,KV,S,hd) read through element
// strides (sb, skv, ss) for B, KV and S, hd contiguous: a contiguous
// head-major cache (sb = KV*S*hd, skv = S*hd, ss = hd), or the pool's
// (B,S,KV,hd) layer cache, as itself or as its transpose(1, 2) view
// (sb = S*KV*hd, skv = hd, ss = KV*hd), with no copy.  Every row has its
// own valid length; a row with kv_len == 0 (an idle or finished slot)
// writes exact zeros.  float32 and bfloat16, hd in {64, 128}, G = H/KV in
// {1, 2, 4, 8}; softmax state and accumulators are float32.  No rule ties
// S to a block size (the TPU kernels' bk had to divide S): ragged tails
// are masked.
//
// Bound on the H100: bytes.  The work streams each row's valid cache once,
// sum_b kv_len_b * KV * hd * 2 * itemsize bytes, at ~4*G FLOPs per byte
// loaded (float32) -- far below the ridge point, so 3.35 TB/s is the roof.
//
// Design: the TPU kernels' sequential cache-block grid axis becomes a loop
// inside a block, and the cache axis is also cut into `nsplit` chunks of
// `chunk` positions (a multiple of NW*U), one block of 8 warps per (kv
// head, b, chunk).  The scalar decode route runs at few rows (generate at
// B = 1 over 12 KV heads would be 12 blocks on 132 SMs), so its wrapper
// picks nsplit for about two blocks per SM; the slot entry runs one chunk.
// The G query heads of the group share every K/V row the block loads (the
// GQA bandwidth win).  Each warp takes U consecutive positions per
// iteration, one hd-wide row per position over its 32 lanes (2 or 4 values
// per lane, one vector load), and keeps its own online-softmax state (m,
// l, acc); the 8 warp states merge through shared memory.  With one chunk
// the block writes the output; with more, it writes its chunk's (m, l,
// acc) to a float32 workspace and a second kernel merges the chunks of
// each (b, kv head) row.  A chunk that starts at or past kv_len[b] returns
// at once and the merge reads only the chunks below kv_len[b].
// The kernel is specialised on SPLIT at compile time: the one-chunk
// instance (the slot entry, and decode_attention where one chunk gives
// enough blocks) holds no chunk bounds and no workspace path, which as
// run-time branches changed its register allocation and slowed the slot
// kernel by ~40 % at gpt-base's shape (chip_smoke.py phase 3).
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
constexpr int MERGE_NT = 128;  // threads per merge block
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

// Workspace of one (b, kv head, chunk): m[G], l[G], acc[G][HD] (floats).
__device__ __forceinline__ float* work_at(float* work, int row, int split,
                                          int nsplit, int G, int hd) {
  return work + ((long long)row * nsplit + split) * G * (hd + 2);
}

template <typename T, int HD, int G, bool SPLIT>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ o, float* __restrict__ work, int S, int KV,
              long long sb, long long skv, long long ss, int chunk,
              int nsplit, float scale) {
  constexpr int E = HD / 32;  // values per lane per row
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = SPLIT ? (int)blockIdx.z : 0;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long H = (long long)KV * G;
  const int n = min(kv_len[b], S);
  const int lo = SPLIT ? split * chunk : 0;
  const int hi = SPLIT ? min(lo + chunk, n) : n;
  T* ob = o + (b * H + kvh * G) * HD;
  if (n <= 0) {  // idle / finished row: exact zeros, no cache read
    if (!SPLIT)
      for (int i = threadIdx.x; i < G * HD; i += NW * 32) store(&ob[i], 0.f);
    return;  // with chunks, the merge writes the zeros
  }
  if (SPLIT && lo >= hi) return;  // past this row's length: merge skips it

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
  for (int base = lo + w * U; base < hi; base += NW * U) {
    float kr[U][E], vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u < hi) {
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
        s[u] = base + u < hi ? s[u] * scale : NEG_INF;
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
  float* wr = SPLIT ? work_at(work, b * KV + kvh, split, nsplit, G, HD)
                    : nullptr;
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
    if (!SPLIT) {
      store(&ob[i], A / fmaxf(L, 1e-30f));
    } else {
      wr[2 * G + i] = A;
      if (d == 0) {
        wr[g] = M;
        wr[G + g] = L;
      }
    }
  }
}

// Merge the chunks of each (b, kv head) row: grid (B*KV), one output per
// thread.  Only the ceil(n / chunk) chunks below the row's length hold a
// partial; each has a real max, so M is real and the weights finite.
template <typename T>
__global__ void __launch_bounds__(MERGE_NT)
decode_merge_kernel(float* __restrict__ work, const int* __restrict__ kv_len,
                    T* __restrict__ o, int S, int KV, int G, int hd,
                    int chunk, int nsplit) {
  const int row = blockIdx.x;  // b * KV + kv head
  const int n = min(kv_len[row / KV], S);
  T* ob = o + (long long)row * G * hd;  // (b*H + kvh*G)*hd, H = KV*G
  const int ns = n <= 0 ? 0 : min(nsplit, (n + chunk - 1) / chunk);
  const long long step = (long long)G * (hd + 2);  // one chunk's partial
  const float* w0 = work_at(work, row, 0, nsplit, G, hd);
  for (int i = threadIdx.x; i < G * hd; i += MERGE_NT) {
    if (ns == 0) {  // idle / finished row: exact zeros
      store(&ob[i], 0.f);
      continue;
    }
    const int g = i / hd;
    float M = NEG_INF;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, w0[s * step + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float f = expf(w0[s * step + g] - M);
      L += w0[s * step + G + g] * f;
      A += w0[s * step + 2 * G + i] * f;
    }
    store(&ob[i], A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
int launch_g(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, float* work, int B, int S, int KV, int G, long long sb,
             long long skv, long long ss, int chunk, int nsplit, float scale,
             cudaStream_t stream) {
  const dim3 grid(KV, B, nsplit);
#define DECODE_LAUNCH(GG)                                                   \
  if (nsplit == 1)                                                          \
    decode_kernel<T, HD, GG, false><<<grid, NW * 32, 0, stream>>>(          \
        static_cast<const T*>(q), static_cast<const T*>(k),                 \
        static_cast<const T*>(v), kv_len, static_cast<T*>(o), work, S, KV,  \
        sb, skv, ss, chunk, nsplit, scale);                                 \
  else                                                                      \
    decode_kernel<T, HD, GG, true><<<grid, NW * 32, 0, stream>>>(           \
        static_cast<const T*>(q), static_cast<const T*>(k),                 \
        static_cast<const T*>(v), kv_len, static_cast<T*>(o), work, S, KV,  \
        sb, skv, ss, chunk, nsplit, scale)
  switch (G) {
    case 1: DECODE_LAUNCH(1); break;
    case 2: DECODE_LAUNCH(2); break;
    case 4: DECODE_LAUNCH(4); break;
    case 8: DECODE_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  decode_merge_kernel<T><<<B * KV, MERGE_NT, 0, stream>>>(
      work, kv_len, static_cast<T*>(o), S, KV, G, HD, chunk, nsplit);
  return (int)cudaGetLastError();
}


// Launch the chunk kernel (and, with nsplit > 1, the merge) on `stream`.
// work: B*KV*nsplit*G*(hd+2) floats when nsplit > 1 (else unused); the
// chunks must cover S (chunk * nsplit >= S).  dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launches (0 on
// success); no synchronisation.
inline int run(const void* q, const void* k, const void* v,
               const int* kl, void* o, float* wk, int dtype, int B, int S,
               int KV, int H, int hd, long long sb, long long skv,
               long long ss, int chunk, int nsplit, float scale,
               cudaStream_t st) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || nsplit < 1 || chunk < 1 ||
      (long long)chunk * nsplit < S || (nsplit > 1 && wk == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (dtype == 0 && hd == 64)
    return launch_g<float, 64>(q, k, v, kl, o, wk, B, S, KV, G, sb, skv, ss,
                               chunk, nsplit, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_g<float, 128>(q, k, v, kl, o, wk, B, S, KV, G, sb, skv, ss,
                                chunk, nsplit, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_g<__nv_bfloat16, 64>(q, k, v, kl, o, wk, B, S, KV, G, sb,
                                       skv, ss, chunk, nsplit, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_g<__nv_bfloat16, 128>(q, k, v, kl, o, wk, B, S, KV, G, sb,
                                        skv, ss, chunk, nsplit, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dattn
