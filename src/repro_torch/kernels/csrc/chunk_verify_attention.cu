// Speculative chunk-verify attention over the serve engine's slot pool, for
// sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: chunk_verify_attention
//           (Pallas TPU kernel `_chunk_kernel`).
//
// Computes, for each row b with off = offsets[b] >= 0 and each of its S
// queries i (absolute position qpos = off + i):
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . key_j * hd^-0.5) @ value_j
// over the keys of [cache ‖ chunk] of kv head h/G: the read-only cache
// ck/cv (B,Sc,KV,hd) and the chunk's own k/v (B,S,KV,hd) at positions
// off .. off+S-1.  A key at position kpos is attended iff kpos <= qpos
// (causal) and, when a window is given, kpos > qpos - window.  The cache's
// key positions are rebuilt per layout:
//   full: slot s holds position s, written iff s < off;
//   ring: slot s holds the largest p < off with p % Sc == s (p >= 0).
// Rows with off < 0 (done slots) write exact zeros.  float32 and bfloat16,
// hd in {64, 128}, G = H/KV in {1, 2, 4, 8}, S in 1..16, any Sc; softmax
// state and sums are float32.  The cache is never written.
//
// Bound on the H100: bytes.  The work streams each row's attended cache
// positions and the S chunk keys once,
// sum_b (valid cache positions + S) * KV * hd * 2 * itemsize bytes, plus q
// and out, at ~4*S*G FLOPs per cache byte (float32) -- far below the ridge
// point for S*G <= 16, so 3.35 TB/s is the roof.  For gpt-base's verify
// (B 8, S 5, KV 12, ~300 valid positions a row) that is ~15 MB a layer,
// ~4.4 us.
//
// Design: the slot-decode kernel's (csrc/slot_decode_attention.cu), with
// the chunk's queries added.  One block of 8 warps per (b, kv head, tile of
// up to 8 query rows), where a query row is one (i, g) pair of the S
// queries and G heads of the group; all rows of the tile share every K/V
// row the block loads, which is where the byte saving over S separate
// decode calls lies.  The TPU kernel's sequential grid axis (nk cache
// blocks, then one chunk step) becomes a loop inside the block over the
// attended key positions only: the cache keys [lo, off) -- lo raised by
// the ring's capacity and by the window of the block's first query -- and
// then the chunk's keys 0 .. (last query of the tile).  In ring mode a
// position p maps to slot p % Sc with p >= 0, so no negative number is
// ever divided (C's `/` and `%` truncate toward zero; the reference's
// `(off - 1) // Sc` floors, and the loop over positions sidesteps it).
// Each warp takes U consecutive positions per iteration, one hd-wide row
// per position spread over its 32 lanes (one vector load), and keeps its
// own online-softmax state per query row; masked keys get weight exactly
// 0 (never exp(NEG_INF - NEG_INF)), and a final pass merges the 8 warp
// states through shared memory.  Every live query attends at least its own
// chunk key (window >= 1), so no denominator is 0.
// Query rows beyond 8 per (b, kv head) -- S*G up to 128 -- go to further
// blocks along grid.z, each re-reading the cache: registers hold at most 8
// query states per warp.  Known limits: B*KV blocks (96 for gpt-base at 8
// slots) do not fill 132 SMs; split-K and tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps per block
constexpr int R = 8;   // query rows (i, g) per block
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = 0x7fffffff;  // position of a padding lane: masked

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

template <typename T, int HD>
__global__ void __launch_bounds__(NW * 32)
chunk_verify_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ offsets, T* __restrict__ o,
                    int S, int Sc, int KV, int G, int ring, int window,
                    float scale) {
  constexpr int E = HD / 32;  // values per lane per row
  constexpr int U = 16 / E;   // consecutive positions per warp per iteration
  __shared__ float sm_m[NW][R];
  __shared__ float sm_l[NW][R];
  __shared__ float sm_acc[NW][R][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * R;  // first query row of the tile: i * G + g
  const int nr = min(R, S * G - r0);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long H = (long long)KV * G;
  const int off = offsets[b];

  // element offset of query row r0 + r in q and o: (b, i, kvh * G + g, :)
  auto row_at = [&](int r) {
    const int rr = r0 + r;
    return (((long long)b * S + rr / G) * H + kvh * G + rr % G) * HD;
  };
  if (off < 0) {  // done slot: exact zeros, no cache read
    for (int i = threadIdx.x; i < nr * HD; i += NW * 32)
      store(&o[row_at(i / HD) + i % HD], 0.f);
    return;
  }

  float qr[R][E];
  int qpos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qpos[r] = off + (r0 + r) / G;
    if (r < nr) {
      load_vec(q + row_at(r) + lane * E, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    }
  }

  // attended cache positions [lo, hi), then chunk keys 0 .. i_last
  const int i_first = r0 / G, i_last = (r0 + nr - 1) / G;
  const int hi = ring ? off : min(off, Sc);
  int lo = ring ? max(0, off - Sc) : 0;
  if (window > 0) lo = max(lo, off + i_first - window + 1);
  const int n_cache = max(hi - lo, 0);
  const int n = n_cache + i_last + 1;

  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const long long ps = (long long)KV * HD;  // position stride of the pool
  const long long head = kvh * HD + lane * E;
  const T* ckb = ck + (long long)b * Sc * ps + head;
  const T* cvb = cv + (long long)b * Sc * ps + head;
  const T* kcb = kc + (long long)b * S * ps + head;
  const T* vcb = vc + (long long)b * S * ps + head;
  for (int base = w * U; base < n; base += NW * U) {
    float kr[U][E], vr[U][E];
    int kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u;
      if (i < n) {
        const T *kptr, *vptr;
        if (i < n_cache) {
          const int p = lo + i;
          const long long slot = ring ? p % Sc : p;  // p >= 0
          kptr = ckb + slot * ps;
          vptr = cvb + slot * ps;
          kp[u] = p;
        } else {
          const int t = i - n_cache;
          kptr = kcb + t * ps;
          vptr = vcb + t * ps;
          kp[u] = off + t;
        }
        load_vec(kptr, kr[u]);
        load_vec(vptr, vr[u]);
      } else {
        kp[u] = NO_KEY;
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;  // uniform across the block
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part += qr[r][e] * kr[u][e];
        s[u] = part;
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], sh);
      bool ok[U];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = kp[u] <= qpos[r] &&
                (window <= 0 || kp[u] > qpos[r] - window);
        s[u] = ok[u] ? s[u] * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      // a row with no attended key here keeps m = NEG_INF and alpha = 1;
      // its masked keys get weight 0 below, never exp(NEG_INF - NEG_INF)
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(s[u] - m_new) : 0.f;
        l[r] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += p * vr[u][e];
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) continue;
    if (lane == 0) {
      sm_m[w][r] = m[r];
      sm_l[w][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[w][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * HD; i += NW * 32) {
    const int r = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      // a warp that saw no attended key has l = 0 and adds nothing
      const float f = expf(sm_m[ww][r] - M);
      L += sm_l[ww][r] * f;
      A += sm_acc[ww][r][d] * f;
    }
    store(&o[row_at(r) + d], A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* ck, const void* cv, const void* k,
           const void* v, const int* offsets, void* o, int B, int S, int Sc,
           int KV, int G, int ring, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid(KV, B, (S * G + R - 1) / R);
  chunk_verify_kernel<T, HD><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), static_cast<const T*>(k),
      static_cast<const T*>(v), offsets, static_cast<T*>(o), S, Sc, KV, G,
      ring, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,H,hd), ck/cv (B,Sc,KV,hd), k/v (B,S,KV,hd), offsets (B,) int32,
// o (B,S,H,hd); all contiguous on the device.  dtype: 0 = float32,
// 1 = bfloat16; ring: 0 full layout, 1 ring buffer; window: 0 = none.
// Returns cudaGetLastError() after the launch (0 on success); no
// synchronisation.
extern "C" int chunk_verify_attention_fwd(
    const void* q, const void* ck, const void* cv, const void* k,
    const void* v, const void* offsets, void* o, int dtype, int B, int S,
    int Sc, int KV, int H, int hd, int ring, int window, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || S < 1 || S > 16 || Sc < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, ck, cv, k, v, off, o, B, S, Sc, KV, G, ring,
                             window, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, ck, cv, k, v, off, o, B, S, Sc, KV, G, ring,
                              window, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, ck, cv, k, v, off, o, B, S, Sc, KV,
                                     G, ring, window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, ck, cv, k, v, off, o, B, S, Sc, KV,
                                      G, ring, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
