// One-query decode over a PAGED pool for sm_90a: the body shared by
// paged_slot_decode_attention.cu and paged_ring_decode_attention.cu.
//
// Computes, for each row b and kv head h,
//   out[b,hG+g,:] = softmax_{p in band}(q[b,hG+g,:] . K[p] * scale) @ V[p]
// where position p of row b sits in slot s = p % cap (cap = nblk * page)
// of its block table: K[p] = k[bt[b, s / page], s % page, h, :].  A table
// entry outside [0, n_pages) (the sentinel n_pages of a block the row
// never got) clamps to page n_pages - 1, as in the reference; no read
// leaves the arena, and the arenas are never written.  The band is
//   slot (RING false, rowarg = kv_len):   [0, min(kv_len, cap))
//   ring (RING true, rowarg = position):  [max(0, pos - min(window, cap)
//                                          + 1), pos]
// walked by position, so no negative number is ever divided.  An empty
// band (kv_len <= 0, pos < 0: an idle or finished slot) writes exact
// zeros.  float32 and bfloat16; the ring takes hd in {64, 128, 256} and
// G = H / KV in 1..16, the slot hd in {64, 128} and G up to 8.  Softmax
// state and sums are float32, products float32 FMAs.
//
// Bound on the H100: bytes.  Each band position's K and V row is read
// once, sum_b n_b * KV * hd * 2 * itemsize bytes, at ~2 * G FLOPs a byte
// (float32) -- far below the ridge point, so 3.35 TB/s is the roof.
//
// Design, for what held the earlier kernels back (one latency chain per
// iteration, the longest row on one SM, a merge kernel and a workspace):
//  1. Split the band, merge in the launch.  Each (b, kv head) band is cut
//     into `nsplit` pieces of `chunk` positions (a host choice,
//     `paged_decode_splits` in kernels/decode_attention.py); the pieces of
//     one band are one thread-block cluster (grid (nsplit, KV, B), cluster
//     (nsplit, 1, 1), nsplit <= 16).  Each block leaves its piece's
//     partial (m, l, acc) in its shared memory; after a cluster barrier
//     every rank merges a slice of the band's G * hd outputs, reading the
//     partials of the ranks that hold positions through distributed shared
//     memory (all loads in flight at once), and a second barrier keeps
//     each block alive until it has been read.  One launch, no workspace.
//  2. Stage K/V asynchronously.  One producer warp walks the piece a tile
//     of 32 positions at a time: each lane resolves one position to its
//     page (the table entry read once per position, by one lane) and
//     issues `cp.async.bulk` copies of its K and V rows (hd * itemsize
//     contiguous bytes) into a ring of S stages, counted on the stage's
//     mbarrier.  With KV == 1 the rows of a page are contiguous and one
//     copy takes the whole run up to the page's end; on the slot band,
//     whose tiles start on multiples of 32, pages of whole tiles take one
//     TMA box (hd x 1 head x 32 rows, strided) a tile instead.  The next
//     tiles land while the consumers compute on this one.
//  3. Compute from shared memory, four consumer warps, per tile of 32
//     positions:
//     a. logits: L threads a row (4, or 8 over two rows 16 apart when the
//        group has 8 or more heads, so each q read serves two rows), each
//        a strided share of the hd dot products for every head, then
//        log2(L) shuffles; the chunk order is rotated by row so the K
//        reads hit distinct banks, and q sits in 16-byte planes so a
//        warp's q reads are contiguous;
//     b. online softmax, every head at once: 128 / heads lanes a head
//        (at most 32), a few positions a lane;
//     c. P @ V: each thread owns a 16-byte column chunk of V for a set of
//        heads (or, when the group has fewer heads than thread groups, one
//        head over a class of positions, summed before the merge).
//     Float32 FMAs throughout (bfloat16 converted on load), so float32
//     matches the plain version to summation order.  The group's head
//     count is a compile-time 1, 2, 4, 8, 10 (recurrentgemma-2b) or 16;
//     other counts run in the next one up with zero q rows.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"  // mbarriers, bulk and TMA copies, tensor maps

namespace pdec {

namespace cg = cooperative_groups;

constexpr int NCW = 4;         // consumer warps
constexpr int NC = NCW * 32;   // consumer threads
constexpr int NT = NC + 32;    // and one producer warp
constexpr int CLUSTER_MAX = 16;  // pieces of one band (a cluster)
// Bytes of K + V stages at most: the slot kernel keeps three blocks an SM
// at hd 64 in float32 (gpt-base: 96 bands); a ring band of one KV head
// (recurrentgemma-2b: 8 bands of 16 blocks) has an SM to itself and keeps
// a third bfloat16 stage in flight
__host__ __device__ constexpr int stage_bytes(bool ring) {
  return (ring ? 96 : 64) * 1024;
}
constexpr float NEG_INF = -1e30f;

// Tile geometry of a (type, head_dim, band) instance.
template <typename T, int HD, bool RING>
struct Geo {
  static constexpr int R = HD * (int)sizeof(T);  // bytes of a K or V row
  static constexpr int TR = 32;       // positions a tile
  static constexpr int C = R / 16;    // 16-byte chunks a row
  static constexpr int VALS = 16 / (int)sizeof(T);  // values a chunk
  static constexpr int S0 = stage_bytes(RING) / (2 * TR * R);
  static constexpr int S = S0 > 4 ? 4 : S0 < 2 ? 2 : S0;  // stages (2..4)
  static constexpr int NR = NC / C;   // P @ V thread groups (2..16)
  static constexpr int SP = TR + 4;   // row stride of the P tile (floats)
};

__host__ __device__ constexpr int pow2ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2);
}

// Shared memory of an instance (GC heads a group, compile time): barriers,
// the K and V rings, q (float), the partial accumulators, P (two tiles),
// alpha (two tiles), m, l.
template <typename T, int HD, int GC, bool RING>
constexpr int smem_bytes() {
  using G_ = Geo<T, HD, RING>;
  constexpr int GP = pow2ceil(GC);
  constexpr int PF = G_::NR > GP ? G_::NR / GP : 1;
  return 128 + 2 * G_::S * G_::TR * G_::R + (GC + PF * GP) * HD * 4 +
         (2 * GC * G_::SP + 4 * GC) * 4;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte chunk of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float (&r)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&r)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    r[2 * i] = f.x;
    r[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// GC: the group's heads at compile time (1, 2, 4, 8, 10 or 16); a group of
// G < GC heads runs with the q rows past G zero and their outputs dropped.
template <typename T, int HD, int GC, bool RING>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ bt,
                    const int* __restrict__ rowarg, T* __restrict__ o,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, int tma,
                    int n_pages, int page, int nblk, int KV, int G,
                    int window, int chunk, float scale) {
  using Gm = Geo<T, HD, RING>;
  constexpr int TR = Gm::TR, C = Gm::C, VALS = Gm::VALS;
  constexpr int S = Gm::S, NR = Gm::NR, SP = Gm::SP, R = Gm::R;
  constexpr int PB = GC >= 8 ? 2 : 1;  // logit rows a thread (q reuse)
  constexpr int RS = TR / PB;          // ... RS apart
  constexpr int L = NC * PB / TR;      // logit threads a row group
  constexpr int GP = pow2ceil(GC);
  constexpr int PF = NR > GP ? NR / GP : 1;  // P @ V position classes
  constexpr int HPT = (GC + NR - 1) / NR;    // heads a P @ V thread (PF 1)
  constexpr int LH = NC / GP < TR ? NC / GP : TR;  // softmax lanes a head
  constexpr int PPL = TR / LH;                     // ... positions a lane

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [S]
  uint64_t* empty = full + S;                          // [S]
  T* sK = reinterpret_cast<T*>(smem + 128);            // [S][TR][HD]
  T* sV = sK + S * TR * HD;                            // [S][TR][HD]
  // q as float, [GC][VALS / 4][C][4]: the 16-byte column chunk c of a row
  // in VALS / 4 planes, so a warp's reads of 8 chunks are 128 contiguous
  // bytes in each plane
  float* sQ = reinterpret_cast<float*>(sV + S * TR * HD);
  float* sAcc = sQ + GC * HD;            // [PF][GP][HD]
  float* sP = sAcc + PF * GP * HD;       // [2][GC][SP]
  float* sAlpha = sP + 2 * GC * SP;      // [2][GC]
  float* sM = sAlpha + 2 * GC;           // [GC]
  float* sL = sM + GC;                   // [GC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int cap = nblk * page;
  int lo = 0, n;
  if (RING) {
    const int pos = rowarg[b];
    n = 0;
    if (pos >= 0) {
      lo = max(0, pos - min(window, cap) + 1);
      n = pos + 1 - lo;
    }
  } else {
    n = min(rowarg[b], cap);
  }
  T* ob = o + ((long long)b * KV * G + (long long)kvh * G) * HD;
  const int GH = G * HD;
  const int per = (GH + nsplit - 1) / nsplit;  // outputs this rank merges
  const int o0 = rank * per, o1 = min(GH, o0 + per);
  if (n <= 0) {  // empty band, the same for the whole cluster: zeros
    for (int i = o0 + tid; i < o1; i += NT) store(&ob[i], 0.f);
    return;
  }
  // this rank's piece [p0, p1) of the band
  const int p0 = lo + (int)min((long long)n, (long long)rank * chunk);
  const int p1 = lo + (int)min((long long)n, (long long)(rank + 1) * chunk);
  const int ntile = (p1 - p0 + TR - 1) / TR;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(full + s, 1);      // the producer's expect_tx
      tc::mbar_init(empty + s, NCW);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers; the producer starts without waiting for q

  if (warp == NCW) {
    // ---- producer: one lane per position of the tile -------------------
    const long long ps = (long long)KV * HD;  // elements between positions
    const T* kb = k + (long long)kvh * HD;
    const T* vb = v + (long long)kvh * HD;
    const int* btb = bt + (long long)b * nblk;
    for (int it = 0; it < ntile; ++it) {
      const int s = it % S;
      if (it >= S) tc::mbar_wait(empty + s, (it / S - 1) & 1);
      const int tp = p0 + it * TR;
      const int tv = min(TR, p1 - tp);
      if (tma) {  // the tile lies in one page: one box of TR rows each
        if (lane == 0) {
          const int blk = tp / page;
          const int pg = min(max(__ldg(btb + blk), 0), n_pages - 1);
          const int row = pg * page + tp - blk * page;
          tc::mbar_expect(full + s, 2 * TR * R);
          tc::tma_load_3d(sK + s * TR * HD, &kmap, 0, kvh, row, full + s);
          tc::tma_load_3d(sV + s * TR * HD, &vmap, 0, kvh, row, full + s);
        }
        continue;
      }
      if (lane == 0) tc::mbar_expect(full + s, 2 * tv * R);
      __syncwarp();
      if (lane < tv) {
        const int slot = (tp + lane) % cap;
        const int blk = slot / page, off = slot - blk * page;
        // with one kv head a page's rows are contiguous: one copy a run
        const bool start = KV != 1 || lane == 0 || off == 0;
        if (start) {
          const int rows = KV != 1 ? 1 : min(tv - lane, page - off);
          const int pg = min(max(__ldg(btb + blk), 0), n_pages - 1);
          const long long src = ((long long)pg * page + off) * ps;
          const int dst = (s * TR + lane) * HD;
          tc::bulk_load(sK + dst, kb + src, rows * R, full + s);
          tc::bulk_load(sV + dst, vb + src, rows * R, full + s);
        }
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------
    const T* qb = q + ((long long)b * KV * G + (long long)kvh * G) * HD;
    for (int i = tid; i < GC * HD; i += NC) {
      const int d = i % HD, c = d / VALS, e = d % VALS;
      sQ[i - d + (e / 4) * C * 4 + c * 4 + e % 4] =
          i < GH ? to_f(qb[i]) : 0.f;
    }
    for (int g = tid; g < GC; g += NC) {
      sM[g] = NEG_INF;
      sL[g] = 0.f;
    }
    consumer_sync();
    const int qg = tid / L, qj = tid % L;  // logits: rows qg + RS u, part
    const int rot = L < 8 ? L * (qg % (8 / L)) : 0;
    const int dc = tid % C, pr = tid / C;  // P @ V: chunk, group
    const int pc = PF > 1 ? pr / GP : 0;   // position class
    const int sg = tid / LH, sj = tid % LH;  // softmax: head, lane
    const int sgc = sg < GC ? sg : GC - 1;
    float acc[HPT][VALS];
#pragma unroll
    for (int h = 0; h < HPT; ++h)
#pragma unroll
      for (int e = 0; e < VALS; ++e) acc[h][e] = 0.f;

    for (int it = 0; it < ntile; ++it) {
      const int s = it % S;
      const int tv = min(TR, p1 - (p0 + it * TR));
      const T* tK = sK + s * TR * HD;
      const T* tV = sV + s * TR * HD;
      float* P = sP + (it & 1) * GC * SP;
      float* alpha = sAlpha + (it & 1) * GC;
      tc::mbar_wait(full + s, (it / S) & 1);

      // a. logits of the tile's positions, every head of the group (rows
      // past tv hold stale bytes: their sums are dropped below)
      float part[PB][GC];
#pragma unroll
      for (int u = 0; u < PB; ++u)
#pragma unroll
        for (int g = 0; g < GC; ++g) part[u][g] = 0.f;
#pragma unroll
      for (int i = 0; i < C / L; ++i) {
        const int c = (L * i + qj + rot) % C;
        float kf[PB][VALS];
#pragma unroll
        for (int u = 0; u < PB; ++u)
          load16(tK + (qg + RS * u) * HD + c * VALS, kf[u]);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
#pragma unroll
          for (int e4 = 0; e4 < VALS; e4 += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(
                sQ + g * HD + e4 * C + c * 4);
#pragma unroll
            for (int u = 0; u < PB; ++u) {
              part[u][g] = fmaf(qv.x, kf[u][e4], part[u][g]);
              part[u][g] = fmaf(qv.y, kf[u][e4 + 1], part[u][g]);
              part[u][g] = fmaf(qv.z, kf[u][e4 + 2], part[u][g]);
              part[u][g] = fmaf(qv.w, kf[u][e4 + 3], part[u][g]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PB; ++u) {
        const int row = qg + RS * u;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1)
            part[u][g] += __shfl_xor_sync(0xffffffffu, part[u][g], off);
          if (g % L == qj)
            P[g * SP + row] = row < tv ? part[u][g] * scale : NEG_INF;
        }
      }
      consumer_sync();

      // b. online softmax, every head at once: LH lanes a head
      {
        float x[PPL];
        float mx = NEG_INF;
#pragma unroll
        for (int u = 0; u < PPL; ++u) {
          x[u] = P[sgc * SP + sj + LH * u];
          mx = fmaxf(mx, x[u]);
        }
#pragma unroll
        for (int off = LH / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        // the tile's first position is in the band: mx is a real logit
        const float m_old = sM[sgc];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < PPL; ++u) {
          x[u] = expf(x[u] - m_new);
          sum += x[u];
        }
#pragma unroll
        for (int off = LH / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (sg < GC) {
#pragma unroll
          for (int u = 0; u < PPL; ++u) P[sg * SP + sj + LH * u] = x[u];
          if (sj == 0) {
            const float a = expf(m_old - m_new);
            sM[sg] = m_new;
            sL[sg] = sL[sg] * a + sum;
            alpha[sg] = a;
          }
        }
      }
      consumer_sync();

      // c. P @ V over this thread's chunk of the row
      if constexpr (PF == 1) {  // heads pr, pr + NR, ...
        int gh[HPT];
#pragma unroll
        for (int h = 0; h < HPT; ++h) {
          gh[h] = pr + NR * h;
          const float a = gh[h] < GC ? alpha[gh[h]] : 0.f;
#pragma unroll
          for (int e = 0; e < VALS; ++e) acc[h][e] *= a;
        }
        int t = 0;
        for (; t + 4 <= tv; t += 4) {
          float4 pv[HPT];
#pragma unroll
          for (int h = 0; h < HPT; ++h)
            pv[h] = gh[h] < GC
                        ? *reinterpret_cast<const float4*>(P + gh[h] * SP + t)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float vf[VALS];
            load16(tV + (t + u) * HD + dc * VALS, vf);
#pragma unroll
            for (int h = 0; h < HPT; ++h) {
              const float pu = u == 0 ? pv[h].x
                               : u == 1 ? pv[h].y
                               : u == 2 ? pv[h].z
                                        : pv[h].w;
#pragma unroll
              for (int e = 0; e < VALS; ++e)
                acc[h][e] = fmaf(pu, vf[e], acc[h][e]);
            }
          }
        }
        for (; t < tv; ++t) {
          float vf[VALS];
          load16(tV + t * HD + dc * VALS, vf);
#pragma unroll
          for (int h = 0; h < HPT; ++h) {
            const float pu = gh[h] < GC ? P[gh[h] * SP + t] : 0.f;
#pragma unroll
            for (int e = 0; e < VALS; ++e)
              acc[h][e] = fmaf(pu, vf[e], acc[h][e]);
          }
        }
      } else {  // one head (GC = GP), positions pc, pc + PF, ...
        const int g = pr % GP;
        const float a = alpha[g];
#pragma unroll
        for (int e = 0; e < VALS; ++e) acc[0][e] *= a;
        for (int t = pc; t < tv; t += PF) {
          float vf[VALS];
          load16(tV + t * HD + dc * VALS, vf);
          const float pu = P[g * SP + t];
#pragma unroll
          for (int e = 0; e < VALS; ++e)
            acc[0][e] = fmaf(pu, vf[e], acc[0][e]);
        }
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(empty + s);  // this warp is done
    }

    // this piece's partial accumulators, for the cluster's merge
#pragma unroll
    for (int h = 0; h < HPT; ++h) {
      const int g = PF > 1 ? pr % GP : pr + NR * h;
      if (PF > 1 || g < GC) {
        float* dst = sAcc + ((pc * GP + g) * HD + dc * VALS);
#pragma unroll
        for (int e = 0; e < VALS; ++e) dst[e] = acc[h][e];
      }
    }
    if constexpr (PF > 1) {  // sum the position classes into class 0
      consumer_sync();
      for (int i = tid; i < GP * HD; i += NC) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < PF; ++c) a += sAcc[c * GP * HD + i];
        sAcc[i] = a;
      }
    }
  }

  // ---- merge the cluster's pieces: rank r writes outputs [o0, o1) -------
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every piece's (m, l, acc) is in its shared memory
  const int nr = min(nsplit, (n + chunk - 1) / chunk);  // pieces with data
  for (int i = o0 + tid; i < o1; i += NT) {
    const int g = i / HD;
    float mr[CLUSTER_MAX], lr[CLUSTER_MAX], ar[CLUSTER_MAX];
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {  // all loads in flight at once
      mr[r] = NEG_INF;
      lr[r] = ar[r] = 0.f;
      if (r < nr) {
        mr[r] = *cluster.map_shared_rank(sM + g, r);
        lr[r] = *cluster.map_shared_rank(sL + g, r);
        ar[r] = *cluster.map_shared_rank(sAcc + i, r);
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) M = fmaxf(M, mr[r]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      const float f = expf(mr[r] - M);  // 0 for a rank past nr
      Lsum += lr[r] * f;
      A += ar[r] * f;
    }
    store(&ob[i], A / fmaxf(Lsum, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// The instance's attributes (shared memory past 48 KB, clusters past 8
// blocks), set once; then, with `resident`, the blocks an SM holds at once
// (*resident) instead of a launch.
template <typename T, int HD, int GC, bool RING>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* rowarg, void* o, int B, int n_pages, int page,
           int nblk, int KV, int G, int window, int chunk, int nsplit,
           float scale, cudaStream_t st, int* resident) {
  auto kern = paged_decode_kernel<T, HD, GC, RING>;
  constexpr int smem = smem_bytes<T, HD, GC, RING>();
  static bool ready = false;  // per instance: the attributes, once
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  if (resident)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern,
                                                              NT, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, KV, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the slot band's tiles start on multiples of TR (chunk is one): with
  // several kv heads (strided rows) and pages of whole tiles, one 3-d box
  // (hd, 1 head, TR positions) of the arena a tile; else row copies
  CUtensorMap kmap{}, vmap{};
  int tma = 0;
  if (!RING && KV > 1 && page % Geo<T, HD, RING>::TR == 0 &&
      chunk % Geo<T, HD, RING>::TR == 0) {
    const unsigned long long es = sizeof(T);
    const unsigned long long dims[3] = {(unsigned long long)HD,
                                        (unsigned long long)KV,
                                        (unsigned long long)n_pages * page};
    const unsigned long long strides[2] = {HD * es, KV * HD * es};
    const unsigned box[3] = {HD, 1, Geo<T, HD, RING>::TR};
    tma = tc::tensor_map(&kmap, k, (int)es, 3, dims, strides, box, false) &&
          tc::tensor_map(&vmap, v, (int)es, 3, dims, strides, box, false);
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, rowarg, static_cast<T*>(o), kmap, vmap,
      tma, n_pages, page, nblk, KV, G, window, chunk, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool RING>
int launch_g(const void* q, const void* k, const void* v, const int* bt,
             const int* rowarg, void* o, int B, int n_pages, int page,
             int nblk, int KV, int G, int window, int chunk, int nsplit,
             float scale, cudaStream_t st, int* resident) {
#define PDEC_LAUNCH(GC)                                                     \
  return launch<T, HD, GC, RING>(q, k, v, bt, rowarg, o, B, n_pages, page,  \
                                 nblk, KV, G, window, chunk, nsplit, scale, \
                                 st, resident)
  if (G == 1) PDEC_LAUNCH(1);
  if (G == 2) PDEC_LAUNCH(2);
  if (G <= 4) PDEC_LAUNCH(4);
  if (G <= 8) PDEC_LAUNCH(8);
  if constexpr (RING) {  // the slot kernel takes G <= 8
    if (G == 10) PDEC_LAUNCH(10);  // recurrentgemma-2b
    PDEC_LAUNCH(16);
  }
#undef PDEC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Checks shared by both entries, then the launch.  `span` is the longest
// band a row can have (cap, or min(window, cap)); the pieces must cover it.
template <bool RING>
int run(const void* q, const void* k, const void* v, const void* bt,
        const void* rowarg, void* o, int dtype, int B, int n_pages, int page,
        int nblk, int KV, int H, int hd, int window, int chunk, int nsplit,
        float scale, void* stream) {
  if (B < 0 || KV < 1 || H % KV || H / KV < 1 || H / KV > 16 ||
      n_pages < 1 || page < 1 || nblk < 1 || chunk < 1 || nsplit < 1 ||
      nsplit > CLUSTER_MAX || (RING && window < 1))
    return (int)cudaErrorInvalidValue;
  const long long cap = (long long)nblk * page;
  const long long span = RING && window < cap ? window : cap;
  if (cap > (1 << 30) || (long long)chunk * nsplit < span)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(bt);
  const int* ra = static_cast<const int*>(rowarg);
  const int G = H / KV;
#define PDEC_RUN(TT, HH)                                                   \
  return launch_g<TT, HH, RING>(q, k, v, tb, ra, o, B, n_pages, page,      \
                                nblk, KV, G, window, chunk, nsplit, scale, \
                                st, nullptr)
  if (dtype == 0 && hd == 64) PDEC_RUN(float, 64);
  if (dtype == 0 && hd == 128) PDEC_RUN(float, 128);
  if (dtype == 1 && hd == 64) PDEC_RUN(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PDEC_RUN(__nv_bfloat16, 128);
  if constexpr (RING) {  // the slot kernel takes hd 64 and 128
    if (dtype == 0 && hd == 256) PDEC_RUN(float, 256);
    if (dtype == 1 && hd == 256) PDEC_RUN(__nv_bfloat16, 256);
  }
#undef PDEC_RUN
  return (int)cudaErrorInvalidValue;
}

// Blocks of the (dtype, hd, G) instance an SM holds at once, in *out (the
// host's split takes it).  Returns a CUDA error code (0 on success).
template <bool RING>
int blocks_per_sm(int dtype, int hd, int G, int* out) {
  if (G < 1 || G > (RING ? 16 : 8)) return (int)cudaErrorInvalidValue;
#define PDEC_Q(TT, HH)                                                    \
  return launch_g<TT, HH, RING>(nullptr, nullptr, nullptr, nullptr,       \
                                nullptr, nullptr, 0, 1, 1, 1, 1, G, 1, 1, \
                                1, 1.f, nullptr, out)
  if (dtype == 0 && hd == 64) PDEC_Q(float, 64);
  if (dtype == 0 && hd == 128) PDEC_Q(float, 128);
  if (dtype == 1 && hd == 64) PDEC_Q(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PDEC_Q(__nv_bfloat16, 128);
  if constexpr (RING) {
    if (dtype == 0 && hd == 256) PDEC_Q(float, 256);
    if (dtype == 1 && hd == 256) PDEC_Q(__nv_bfloat16, 256);
  }
#undef PDEC_Q
  return (int)cudaErrorInvalidValue;
}

}  // namespace pdec
