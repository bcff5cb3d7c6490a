// One-query flash decode over a PAGED slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: paged_slot_decode_attention
//           (Pallas TPU kernel `_paged_slot_kernel` with `_page_index_map`).
//
// Computes  out[b,h,:] = softmax_{j < kv_len[b]}(q[b,h,:] . K_b[j,h/G,:]
//                        * hd^-0.5) @ V_b[j,h/G,:]
// where row b's cache is spread over a shared page arena k/v
// (n_pages, page, KV, hd) through its block table bt (B, nblk) int32:
// position j lives at arena[bt[b, j / page], j % page].  A table entry
// outside [0, n_pages) (the sentinel n_pages of a block with no page)
// clamps into the arena, to page n_pages - 1 as in the reference: what it
// reads there is finite and, on every caller's path, masked or never
// accepted.  No read leaves the arena.  A row with kv_len == 0 (an idle or
// finished slot) writes exact zeros; kv_len > nblk * page reads nblk *
// page.  float32 and bfloat16, hd in {64, 128}, G = H/KV in {1, 2, 4, 8},
// any page size; softmax state and accumulators are float32.
//
// Bound on the H100: bytes.  As the dense slot kernel: each row's valid
// positions once, sum_b kv_len_b * KV * hd * 2 * itemsize bytes, plus the
// table, far below the ridge point, so 3.35 TB/s is the roof.
//
// Design: the dense slot kernel's (csrc/slot_decode_attention.cu) with
// the row addressing swapped.  One block of 8 warps per (b, kv head); the
// G query heads of the group share every K/V row the block loads.  The
// TPU kernel pins its cache block to one page and resolves the page in
// the BlockSpec index map from the scalar-prefetched table; here the
// block loads its table row into shared memory once (clamped), and each
// lane resolves position p to (page, offset) itself, so the loop over
// positions -- 8 consecutive positions per warp per iteration, one vector
// load per hd-wide row -- runs across page boundaries unchanged.  The
// online softmax and the merge of the 8 warp states are the dense
// kernel's, with its empty-block safety (a warp only runs an iteration
// whose first position is valid).  Known limit: B*KV blocks (96 for
// gpt-base at 8 slots) do not fill the 132 SMs; split-K is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps per block
constexpr int U = 8;   // consecutive positions per warp per iteration
constexpr float NEG_INF = -1e30f;
constexpr int MAX_NBLK = 2048;  // table entries per row (8 KB of shared)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
paged_slot_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ bt,
                         const int* __restrict__ kv_len, T* __restrict__ o,
                         int n_pages, int page, int nblk, int KV,
                         float scale) {
  constexpr int E = HD / 32;  // values per lane per row
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];
  extern __shared__ int sm_bt[];  // the row's block table, clamped

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long H = (long long)KV * G;
  const int n = min(kv_len[b], nblk * page);
  T* ob = o + (b * H + kvh * G) * HD;
  if (n <= 0) {  // idle / finished slot: exact zeros, no cache read
    for (int i = threadIdx.x; i < G * HD; i += NW * 32) store(&ob[i], 0.f);
    return;
  }
  for (int i = threadIdx.x; i < nblk; i += NW * 32)
    sm_bt[i] = min(max(bt[(long long)b * nblk + i], 0), n_pages - 1);
  __syncthreads();

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

  const long long ps = (long long)KV * HD;  // position stride of a page
  const long long head = kvh * HD + lane * E;
  for (int base = w * U; base < n; base += NW * U) {
    float kr[U][E], vr[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      if (p < n) {
        const int blk = p / page;
        const long long row =
            ((long long)sm_bt[blk] * page + (p - blk * page)) * ps + head;
        load_vec(k + row, kr[u]);
        load_vec(v + row, vr[u]);
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
int launch_g(const void* q, const void* k, const void* v, const int* bt,
             const int* kv_len, void* o, int B, int n_pages, int page,
             int nblk, int KV, int G, float scale, cudaStream_t stream) {
  const dim3 grid(KV, B);
  const size_t smem = (size_t)nblk * sizeof(int);
#define SLOT_LAUNCH(GG)                                                     \
  paged_slot_decode_kernel<T, HD, GG><<<grid, NW * 32, smem, stream>>>(     \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), bt, kv_len, static_cast<T*>(o), n_pages,    \
      page, nblk, KV, scale)
  switch (G) {
    case 1: SLOT_LAUNCH(1); break;
    case 2: SLOT_LAUNCH(2); break;
    case 4: SLOT_LAUNCH(4); break;
    case 8: SLOT_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLOT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,hd), k/v (n_pages,page,KV,hd) arenas, bt (B,nblk) int32, kv_len
// (B,) int32, o (B,H,hd); all contiguous on the device.  dtype: 0 =
// float32, 1 = bfloat16.  nblk <= MAX_NBLK (the table lives in shared
// memory).  Returns cudaGetLastError() after the launch (0 on success); no
// synchronisation.
extern "C" int paged_slot_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* bt,
    const void* kv_len, void* o, int dtype, int B, int n_pages, int page,
    int nblk, int KV, int H, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(bt);
  const int* kl = static_cast<const int*>(kv_len);
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || n_pages < 1 || page < 1 || nblk < 1 ||
      nblk > MAX_NBLK)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (dtype == 0 && hd == 64)
    return launch_g<float, 64>(q, k, v, tb, kl, o, B, n_pages, page, nblk,
                               KV, G, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_g<float, 128>(q, k, v, tb, kl, o, B, n_pages, page, nblk,
                                KV, G, scale, st);
  if (dtype == 1 && hd == 64)
    return launch_g<__nv_bfloat16, 64>(q, k, v, tb, kl, o, B, n_pages, page,
                                       nblk, KV, G, scale, st);
  if (dtype == 1 && hd == 128)
    return launch_g<__nv_bfloat16, 128>(q, k, v, tb, kl, o, B, n_pages,
                                        page, nblk, KV, G, scale, st);
  return (int)cudaErrorInvalidValue;
}
