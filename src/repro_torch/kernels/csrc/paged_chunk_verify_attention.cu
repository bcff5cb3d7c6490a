// Speculative chunk-verify attention over a PAGED slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py ::
//           paged_chunk_verify_attention (Pallas TPU kernel
//           `_paged_chunk_kernel`).
//
// Computes, for each row b with off = offsets[b] >= 0 and each of its S
// queries i (absolute position qpos = off + i):
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . key_j * hd^-0.5) @ value_j
// over the keys of [cache ‖ chunk] of kv head h/G: the read-only cache
// held in the page arenas ck/cv (n_pages, page, KV, hd) through row b's
// block table bt (B, nblk) int32 -- cache position p lives at
// arena[bt[b, p / page], p % page], written iff p < off (full layout;
// the logical cache length is nblk * page) -- and the chunk's own k/v
// (B,S,KV,hd) at positions off .. off+S-1.  A key at position kpos is
// attended iff kpos <= qpos (causal) and, when a window is given,
// kpos > qpos - window.  A table entry outside [0, n_pages) (the
// sentinel of a block with no page, which a draft's catch-up past its
// budget can reach) clamps to page n_pages - 1 as in the reference, so
// no read leaves the arena.  Rows with off < 0 (done slots) write exact
// zeros.  float32 and bfloat16, hd in {64, 128}, G = H/KV in {1, 2, 4,
// 8}, S in 1..16, any page size; softmax state and sums are float32.  The
// arenas are never written.  The ring-buffer layout is not taken here
// (the ring slice).
//
// Bound on the H100: bytes, as the dense chunk kernel: each row's
// attended cache positions and its S chunk keys once,
// sum_b (min(off_b, nblk * page) + S) * KV * hd * 2 * itemsize bytes,
// plus q, out and the table, far below the ridge point.
//
// Design: the dense chunk kernel's (csrc/chunk_verify_attention.cu) with
// the cache rows resolved through the table.  One block of 8 warps per
// (b, kv head, tile of up to 8 query rows (i, g)); all rows of the tile
// share every K/V row the block loads.  The TPU grid (nblk cache blocks,
// each pinned to one page by the index map, then one chunk step) becomes
// a loop inside the block over the attended key positions only -- the
// cache keys [lo, min(off, nblk * page)), lo raised by the window of the
// tile's first query, then the chunk's keys 0 .. (last query of the
// tile).  The block loads its table row into shared memory once
// (clamped) and each lane resolves a cache position to (page, offset)
// itself.  Online softmax per query row with masked keys at weight
// exactly 0, and the merge of the 8 warp states, are the dense kernel's.
// Query rows beyond 8 per (b, kv head) go to further blocks along grid.z.
// Known limits: B*KV blocks (96 for gpt-base at 8 slots) do not fill 132
// SMs; split-K and tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps per block
constexpr int R = 8;   // query rows (i, g) per block
constexpr float NEG_INF = -1e30f;
constexpr int NO_KEY = 0x7fffffff;  // position of a padding lane: masked
constexpr int MAX_NBLK = 2048;  // table entries per row (8 KB of shared)

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
paged_chunk_verify_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                          const T* __restrict__ cv,
                          const int* __restrict__ bt,
                          const T* __restrict__ kc, const T* __restrict__ vc,
                          const int* __restrict__ offsets, T* __restrict__ o,
                          int S, int n_pages, int page, int nblk, int KV,
                          int G, int window, float scale) {
  constexpr int E = HD / 32;  // values per lane per row
  constexpr int U = 16 / E;   // consecutive positions per warp per iteration
  __shared__ float sm_m[NW][R];
  __shared__ float sm_l[NW][R];
  __shared__ float sm_acc[NW][R][HD];
  extern __shared__ int sm_bt[];  // the row's block table, clamped

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
  for (int i = threadIdx.x; i < nblk; i += NW * 32)
    sm_bt[i] = min(max(bt[(long long)b * nblk + i], 0), n_pages - 1);
  __syncthreads();

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
  const int hi = min(off, nblk * page);
  int lo = 0;
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

  const long long ps = (long long)KV * HD;  // position stride of a page
  const long long head = kvh * HD + lane * E;
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
          const int blk = p / page;
          const long long row =
              ((long long)sm_bt[blk] * page + (p - blk * page)) * ps + head;
          kptr = ck + row;
          vptr = cv + row;
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
int launch(const void* q, const void* ck, const void* cv, const int* bt,
           const void* k, const void* v, const int* offsets, void* o, int B,
           int S, int n_pages, int page, int nblk, int KV, int G, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid(KV, B, (S * G + R - 1) / R);
  paged_chunk_verify_kernel<T, HD>
      <<<grid, NW * 32, (size_t)nblk * sizeof(int), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(ck),
          static_cast<const T*>(cv), bt, static_cast<const T*>(k),
          static_cast<const T*>(v), offsets, static_cast<T*>(o), S, n_pages,
          page, nblk, KV, G, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,S,H,hd), ck/cv (n_pages,page,KV,hd) arenas, bt (B,nblk) int32, k/v
// (B,S,KV,hd), offsets (B,) int32, o (B,S,H,hd); all contiguous on the
// device.  dtype: 0 = float32, 1 = bfloat16; window: 0 = none; nblk <=
// MAX_NBLK (the table lives in shared memory).  Returns cudaGetLastError()
// after the launch (0 on success); no synchronisation.
extern "C" int paged_chunk_verify_attention_fwd(
    const void* q, const void* ck, const void* cv, const void* bt,
    const void* k, const void* v, const void* offsets, void* o, int dtype,
    int B, int S, int n_pages, int page, int nblk, int KV, int H, int hd,
    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(bt);
  const int* off = static_cast<const int*>(offsets);
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || S < 1 || S > 16 || n_pages < 1 || page < 1 ||
      nblk < 1 || nblk > MAX_NBLK || window < 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, ck, cv, tb, k, v, off, o, B, S, n_pages, page,
                             nblk, KV, G, window, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, ck, cv, tb, k, v, off, o, B, S, n_pages,
                              page, nblk, KV, G, window, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, ck, cv, tb, k, v, off, o, B, S,
                                     n_pages, page, nblk, KV, G, window,
                                     scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, ck, cv, tb, k, v, off, o, B, S,
                                      n_pages, page, nblk, KV, G, window,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}
