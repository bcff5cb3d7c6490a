// Decode-side attention over a PAGED or DENSE pool for sm_90a: the body
// shared by paged_slot_decode_attention.cu, paged_ring_decode_attention.cu,
// paged_chunk_verify_attention.cu, ring_decode_attention.cu,
// chunk_verify_attention.cu, decode_attention.cu and
// slot_decode_attention.cu.
//
// Computes, for each row b, kv head h and query row r of the group,
//   out[r,:] = softmax_{p in band, p seen by r}(q[r,:] . K[p] * scale) @ V[p]
// over one band of key positions of (b, h).  The row address is a
// compile-time policy (DENSE) over element strides (sb, skv, ss) of a page,
// a kv head and a page row (hd contiguous; an arena's or a pool's own
// strides unless the entry gives others):
//   paged: position p of row b sits in slot s = p % cap (cap = nblk *
//          page) of its block table: K[p] = k[bt[b, s / page], s % page,
//          h, :].  A table entry outside [0, n_pages) (the sentinel
//          n_pages of a block the row never got) clamps to page n_pages -
//          1, as in the reference; no read leaves the arena;
//   dense: row b's cache is page b of cap rows (the pool (B, cap, KV, hd),
//          or decode_attention's (B, KV, S, hd) at any such strides); no
//          table is read.
// The band kind (KIND) sets the band and the query rows:
//   SLOT   (rowarg = kv_len):    [0, min(kv_len, cap)); the G heads of h;
//   RING   (rowarg = position):  [max(0, pos - min(window, cap) + 1), pos],
//                                walked by position, so no negative number
//                                is ever divided; the G heads of h;
//   VERIFY (rowarg = offset):    the cache, then the chunk's own S keys
//                                kc/vc (B, S, KV, hd) at positions off ..
//                                off + S - 1.  The cache is [lo, min(off,
//                                cap)) in the full layout (slot p), [max(lo,
//                                off - cap), off) in the ring layout (slot p
//                                % cap, walked by position as RING is), lo =
//                                max(0, off - window + 1) with a window.  The
//                                S * G query rows (i, g), i at position off +
//                                i, come in tiles of at most 16 (grid z).  Row
//                                i sees a key at kpos iff kpos <= off + i
//                                and, with a window, kpos > off + i - window:
//                                masked keys weigh exactly 0.
// An empty band (kv_len <= 0, pos < 0, off < 0: an idle or finished slot)
// writes exact zeros; the pools are never written.  float32 and bfloat16;
// the ring takes hd in {64, 128, 256} and G = H / KV in 1..16, the slot hd
// in {64, 128} and G up to 8, the verify hd in {64, 128}, G up to 16 and
// any S: its chunk keys are further positions of the band, staged through
// the same tile ring as the cache (a tile may hold both; a long chunk spans
// tiles), so only the grid's z limit bounds it, B * tiles <= 65,535.
// Softmax state and sums are float32, products float32 FMAs.
//
// Bound on the H100: bytes.  Each band position's K and V row is read
// once, sum_b n_b * KV * hd * 2 * itemsize bytes, at ~2 * (query rows)
// FLOPs a byte (float32) -- far below the ridge point, so 3.35 TB/s is
// the roof.
//
// Design, for what held the earlier kernels back (one latency chain per
// iteration, the longest row on one SM, a merge kernel and a workspace):
//  1. Split the band, merge in the launch.  Each band is cut into `nsplit`
//     pieces of `chunk` positions (a host choice, `paged_decode_splits` in
//     kernels/decode_attention.py, covering the longest band a row can
//     have).  With `devcut` (every verify; decode_attention and the dense
//     slot, whose caches are max_len wide, as their wrappers choose) a
//     band cuts its own length, which only the device knows, into nsplit
//     pieces of a multiple of 32 positions instead (such bands are rarely
//     full; the paged slot's and the ring's are, and an even spread only
//     crowds their SMs).  The pieces of one
//     band are one thread-block cluster (grid (nsplit, KV, B * tiles),
//     cluster (nsplit, 1, 1), nsplit <= 16).  Each block leaves its piece's
//     partial (m, l, acc) in its shared memory; after a cluster barrier
//     every rank merges a slice of the band's outputs, reading the partials
//     of the ranks that hold positions through distributed shared memory
//     (all loads in flight at once), and a second barrier keeps each block
//     alive until it has been read.  One launch, no workspace.
//  2. Stage K/V asynchronously.  One producer warp walks the piece a tile
//     of 32 positions at a time: each lane resolves one position to its
//     row (the table entry read once per position, by one lane; the
//     verify's chunk keys come from kc/vc) and issues `cp.async.bulk`
//     copies of its K and V rows (hd * itemsize contiguous bytes) into a
//     ring of S stages, counted on the stage's mbarrier.  Where a page's
//     rows are contiguous (ss == hd: one kv head, or a head-major cache;
//     a chunk's rows with one kv head) one copy takes the whole run up to
//     its end; on a band whose tiles start on multiples of 32 (slot; a
//     full-layout verify without a window), pages of whole tiles with
//     strided rows take one TMA box (hd x 1 head x 32 rows x 1 page) a
//     cache tile instead.  The next tiles land while the consumers compute
//     on this one.
//  3. Compute from shared memory, four consumer warps, per tile of 32
//     positions:
//     a. logits: L threads a row (4, or 8 over two rows 16 apart when the
//        block has 8 or more query rows, so each q read serves two rows),
//        each a strided share of the hd dot products for every query row,
//        then log2(L) shuffles; the chunk order is rotated by row so the K
//        reads hit distinct banks, and q sits in 16-byte planes so a
//        warp's q reads are contiguous; the verify masks here;
//     b. online softmax, every query row at once: 128 / rows lanes a row
//        (at most 32), a few positions a lane;
//     c. P @ V: each thread owns a 16-byte column chunk of V for a set of
//        rows (or, when the block has fewer rows than thread groups, one
//        row over a class of positions, summed before the merge).
//     Float32 FMAs throughout (bfloat16 converted on load), so float32
//     matches the plain version to summation order.  The block's query row
//     count is a compile-time 1, 2, 4, 8, 10 (recurrentgemma-2b's group,
//     qwen3-0.6b's self-draft verify) or 16; other counts run in the next
//     one up with zero q rows.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"  // mbarriers, bulk and TMA copies, tensor maps

namespace pdec {
// Internal linkage: two libraries may hold the same instance (the dense
// slot and decode_attention both run SLOT over a dense row), and a
// function-local static of a shared template (launch's `ready`) would be
// one object across every loaded library, so one library's attributes
// would pass for the other's.
namespace {

namespace cg = cooperative_groups;

enum Kind : int { SLOT = 0, RING = 1, VERIFY = 2 };  // the band kinds

constexpr int NCW = 4;         // consumer warps
constexpr int NC = NCW * 32;   // consumer threads
constexpr int NT = NC + 32;    // and one producer warp
constexpr int CLUSTER_MAX = 16;  // pieces of one band (a cluster)
constexpr int ROWS_MAX = 16;     // query rows a block
constexpr long long GRID_Z_MAX = 65535;  // CUDA's limit: B * tiles blocks
// Bytes of K + V stages at most: the slot and verify kernels keep three
// blocks an SM at hd 64 in float32 (gpt-base: 96 bands); a ring band of one
// KV head (recurrentgemma-2b: 8 bands of 16 blocks) has an SM to itself and
// keeps a third bfloat16 stage in flight
__host__ __device__ constexpr int stage_bytes(int kind) {
  return (kind == RING ? 96 : 64) * 1024;
}
constexpr float NEG_INF = -1e30f;

// Tile geometry of a (type, head_dim, band) instance.
template <typename T, int HD, int KIND>
struct Geo {
  static constexpr int R = HD * (int)sizeof(T);  // bytes of a K or V row
  static constexpr int TR = 32;       // positions a tile
  static constexpr int C = R / 16;    // 16-byte chunks a row
  static constexpr int VALS = 16 / (int)sizeof(T);  // values a chunk
  static constexpr int S0 = stage_bytes(KIND) / (2 * TR * R);
  static constexpr int S = S0 > 4 ? 4 : S0 < 2 ? 2 : S0;  // stages (2..4)
  static constexpr int NR = NC / C;   // P @ V thread groups (2..16)
  static constexpr int SP = TR + 4;   // row stride of the P tile (floats)
};

__host__ __device__ constexpr int pow2ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2);
}

// Shared memory of an instance (GC query rows, compile time): barriers,
// the K and V rings, q (float), the partial accumulators, P (two tiles),
// alpha (two tiles), m, l and, for a verify, each row's query position.
template <typename T, int HD, int GC, int KIND>
constexpr int smem_bytes() {
  using G_ = Geo<T, HD, KIND>;
  constexpr int GP = pow2ceil(GC);
  constexpr int PF = G_::NR > GP ? G_::NR / GP : 1;
  return 128 + 2 * G_::S * G_::TR * G_::R + (GC + PF * GP) * HD * 4 +
         (2 * GC * G_::SP + 4 * GC) * 4 + (KIND == VERIFY ? GC * 4 : 0);
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

// GC: the block's query rows at compile time (1, 2, 4, 8, 10 or 16); a
// block of fewer rows runs with the q rows past them zero and their outputs
// dropped.  A verify's chunk has `slen` keys and its query rows come in
// tiles of `rows` (slen and rows are 1 and G outside a verify); `ring`
// picks its cache's ring layout.  (sb, skv, ss): the elements between
// pages, kv heads and page rows of k and v.
template <typename T, int HD, int GC, int KIND, bool DENSE>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ bt,
                    const int* __restrict__ rowarg, T* __restrict__ o,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, int tma,
                    int n_pages, int page, int nblk, long long sb,
                    long long skv, long long ss, int KV, int G, int slen,
                    int rows, int window, int ring, int chunk, int devcut,
                    float scale) {
  using Gm = Geo<T, HD, KIND>;
  constexpr bool VER = KIND == VERIFY;
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
  int* sQp = reinterpret_cast<int*>(sL + GC);  // [GC] verify: query position

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  // a verify's blocks of one row b are its tiles of query rows (i, g)
  const int tiles = VER ? (slen * G + rows - 1) / rows : 1;
  const int b = VER ? blockIdx.z / tiles : blockIdx.z;
  const int r0 = VER ? (blockIdx.z - b * tiles) * rows : 0;  // first row
  const int nq = VER ? min(rows, slen * G - r0) : G;  // rows this block answers
  const int cap = nblk * page;
  // the band [lo, lo + n); a verify's cache part ends at ce, its chunk's
  // keys follow (key position pos0 + t for chunk row t)
  int lo = 0, n, ce = 0, pos0 = 0;
  if constexpr (KIND == RING) {
    const int pos = rowarg[b];
    n = 0;
    if (pos >= 0) {
      lo = max(0, pos - min(window, cap) + 1);
      n = pos + 1 - lo;
    }
  } else if constexpr (VER) {
    pos0 = rowarg[b];
    n = 0;
    if (pos0 >= 0) {
      lo = window > 0 ? max(0, pos0 - window + 1) : 0;
      if (ring) {  // the ring holds [pos0 - cap, pos0)
        lo = max(lo, pos0 - cap);
        ce = pos0;
      } else {
        ce = max(lo, min(pos0, cap));
      }
      n = ce - lo + slen;
    }
  } else {
    n = min(rowarg[b], cap);
  }
  // element i of the block's nq x HD query rows, in q and in o: (b, i, kvh
  // * G + g) for row r0 + i / HD = i * G + g of a verify, else the group's
  // rows (b, kvh * G + i / HD)
  const long long grp = ((long long)b * KV * G + (long long)kvh * G) * HD;
  auto elem = [&](int i) -> long long {
    if constexpr (VER) {
      const int rr = r0 + i / HD, qi = rr / G;
      return (((long long)b * slen + qi) * KV * G + (long long)kvh * G + rr -
              qi * G) * HD + i % HD;
    } else {
      return grp + i;
    }
  };
  const int GH = nq * HD;
  const int per = (GH + nsplit - 1) / nsplit;  // outputs this rank merges
  const int o0 = rank * per, o1 = min(GH, o0 + per);
  if (n <= 0) {  // empty band, the same for the whole cluster: zeros
    for (int i = o0 + tid; i < o1; i += NT) store(&o[elem(i)], 0.f);
    return;
  }
  // the pieces: the host's chunk, which covers the longest band a row can
  // have; with devcut a band, rarely that long, cuts its own n positions
  // over the cluster's ranks in pieces of a multiple of TR.  This rank's
  // piece is [p0, p1)
  const int cut =
      devcut ? min(chunk, ((n + nsplit - 1) / nsplit + TR - 1) / TR * TR)
             : chunk;
  const int p0 = lo + (int)min((long long)n, (long long)rank * cut);
  const int p1 = lo + (int)min((long long)n, (long long)(rank + 1) * cut);
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
    const T* kb = k + kvh * skv;
    const T* vb = v + kvh * skv;
    const bool contig = ss == HD;  // a page's rows are contiguous
    const long long cs = (long long)KV * HD;  // a chunk key's row stride
    // the page holding block blk of row b: its own (dense), or its table
    // entry clamped into the arena
    auto page_of = [&](int blk) -> int {
      if constexpr (DENSE) {
        return b;
      } else {
        return min(max(__ldg(bt + (long long)b * nblk + blk), 0),
                   n_pages - 1);
      }
    };
    for (int it = 0; it < ntile; ++it) {
      const int s = it % S;
      if (it >= S) tc::mbar_wait(empty + s, (it / S - 1) & 1);
      const int tp = p0 + it * TR;
      const int tv = min(TR, p1 - tp);
      // the tile lies in one page (of the cache): one box of TR rows each
      if (tma && (!VER || tp + TR <= ce)) {
        if (lane == 0) {
          const int blk = tp / page, pg = page_of(blk);
          tc::mbar_expect(full + s, 2 * TR * R);
          tc::tma_load_4d(sK + s * TR * HD, &kmap, 0, kvh, tp - blk * page,
                          pg, full + s);
          tc::tma_load_4d(sV + s * TR * HD, &vmap, 0, kvh, tp - blk * page,
                          pg, full + s);
        }
        continue;
      }
      if (lane == 0) tc::mbar_expect(full + s, 2 * tv * R);
      __syncwarp();
      if (lane < tv) {
        const int p = tp + lane;
        const int dst = (s * TR + lane) * HD;
        if (!VER || p < ce) {
          const int slot = p < cap ? p : p % cap;
          const int blk = slot / page, off = slot - blk * page;
          // contiguous rows: one copy a run, up to the page's end
          const bool start = !contig || lane == 0 || off == 0;
          if (start) {
            int nrow = contig ? min(tv - lane, page - off) : 1;
            if (VER) nrow = min(nrow, ce - p);  // the cache part ends at ce
            const long long src = page_of(blk) * sb + off * ss;
            tc::bulk_load(sK + dst, kb + src, nrow * R, full + s);
            tc::bulk_load(sV + dst, vb + src, nrow * R, full + s);
          }
        } else {  // a verify's chunk row t: (b, t, kvh) of kc/vc
          const bool start = KV != 1 || lane == 0 || p == ce;
          if (start) {
            const int nrow = KV != 1 ? 1 : tv - lane;
            const long long src = ((long long)b * slen + p - ce) * cs;
            tc::bulk_load(sK + dst, kc + (long long)kvh * HD + src, nrow * R,
                          full + s);
            tc::bulk_load(sV + dst, vc + (long long)kvh * HD + src, nrow * R,
                          full + s);
          }
        }
      }
    }
  } else {
    // ---- consumers -----------------------------------------------------
    for (int i = tid; i < GC * HD; i += NC) {
      const int d = i % HD, c = d / VALS, e = d % VALS;
      sQ[i - d + (e / 4) * C * 4 + c * 4 + e % 4] =
          i < GH ? to_f(q[elem(i)]) : 0.f;
    }
    for (int g = tid; g < GC; g += NC) {
      sM[g] = NEG_INF;
      sL[g] = 0.f;
      if constexpr (VER) sQp[g] = pos0 + (r0 + g) / G;
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
      const int tp = p0 + it * TR;
      const int tv = min(TR, p1 - tp);
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
        int kp = 0;  // a verify's key position at this row of the tile
        if constexpr (VER) kp = tp + row < ce ? tp + row : pos0 + tp + row - ce;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1)
            part[u][g] += __shfl_xor_sync(0xffffffffu, part[u][g], off);
          if (g % L == qj) {
            bool seen = row < tv;
            if constexpr (VER)  // causal, and inside the query's window
              seen = seen && kp <= sQp[g] &&
                     (window <= 0 || kp > sQp[g] - window);
            P[g * SP + row] = seen ? part[u][g] * scale : NEG_INF;
          }
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
        // slot and ring: the tile's first position is in the band, so mx is
        // a real logit; a verify's row may see no key of the tile (mx and
        // m_new NEG_INF), and its masked keys weigh exactly 0
        const float m_old = sM[sgc];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < PPL; ++u) {
          if constexpr (VER)
            x[u] = x[u] == NEG_INF ? 0.f : expf(x[u] - m_new);
          else
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
  const int nr = min(nsplit, (n + cut - 1) / cut);  // pieces with data
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
      // 0 for a rank past nr, and for a verify row's piece of masked keys
      const float f = expf(mr[r] - M);
      Lsum += lr[r] * f;
      A += ar[r] * f;
    }
    store(&o[elem(i)], A / fmaxf(Lsum, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// One call's arguments.  kc, vc: a verify's chunk keys (else null); bt: the
// block tables (null with a dense pool, which is n_pages = B pages of page
// = cap rows, nblk 1); (sb, skv, ss): k's and v's element strides of a
// page, a kv head and a page row (own_strides: an arena's or a pool's);
// S and rows are 1 and G outside a verify; ring: a verify's ring layout;
// devcut: each band cuts its own length (set for every verify).
struct Call {
  const void *q, *k, *v, *kc, *vc;
  const int *bt, *rowarg;
  void* o;
  int B, n_pages, page, nblk, KV, G, S, rows, window, chunk, nsplit;
  long long sb, skv, ss;
  int ring, devcut;
  float scale;
};

// The strides of (n_pages, page, KV, hd) rows: an arena's, or a dense
// pool (B, cap, KV, hd) read as B pages.
inline void own_strides(Call& c, int hd) {
  c.skv = hd;
  c.ss = (long long)c.KV * hd;
  c.sb = c.page * c.ss;
}

// The instance's attributes (shared memory past 48 KB, clusters past 8
// blocks), set once; then, with `resident`, the blocks an SM holds at once
// (*resident) instead of a launch.
template <typename T, int HD, int GC, int KIND, bool DENSE>
int launch(const Call& c, cudaStream_t st, int* resident) {
  auto kern = paged_decode_kernel<T, HD, GC, KIND, DENSE>;
  constexpr int smem = smem_bytes<T, HD, GC, KIND>();
  constexpr int TR = Geo<T, HD, KIND>::TR;
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
  const int tiles = (c.S * c.G + c.rows - 1) / c.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.nsplit, c.KV, c.B * tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // bands whose tiles start on multiples of TR (the slot's, a full-layout
  // verify's without a window; chunk is one): with strided rows and pages
  // of whole tiles, one 4-d box (hd, 1 head, TR rows, 1 page) a cache
  // tile; else row copies (also where the encoder refuses the strides)
  CUtensorMap kmap{}, vmap{};
  int tma = 0;
  if (KIND != RING && (KIND == SLOT || (c.window == 0 && !c.ring)) &&
      c.ss != HD && c.page % TR == 0 && c.chunk % TR == 0) {
    const unsigned long long es = sizeof(T);
    const unsigned long long dims[4] = {
        (unsigned long long)HD, (unsigned long long)c.KV,
        (unsigned long long)c.page, (unsigned long long)c.n_pages};
    const unsigned long long strides[3] = {c.skv * es, c.ss * es,
                                           c.sb * es};
    const unsigned box[4] = {HD, 1, TR, 1};
    tma = tc::tensor_map(&kmap, c.k, (int)es, 4, dims, strides, box, false) &&
          tc::tensor_map(&vmap, c.v, (int)es, 4, dims, strides, box, false);
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(c.q), static_cast<const T*>(c.k),
      static_cast<const T*>(c.v), static_cast<const T*>(c.kc),
      static_cast<const T*>(c.vc), c.bt, c.rowarg, static_cast<T*>(c.o),
      kmap, vmap, tma, c.n_pages, c.page, c.nblk, c.sb, c.skv, c.ss, c.KV,
      c.G, c.S, c.rows, c.window, c.ring, c.chunk, c.devcut, c.scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instance for c.rows query rows a block (the group's G outside a
// verify): 1, 2, 4, 8 and, but for the slot (G <= 8), 10 and 16.
template <typename T, int HD, int KIND, bool DENSE>
int launch_g(const Call& c, cudaStream_t st, int* resident) {
#define PDEC_LAUNCH(GC) return launch<T, HD, GC, KIND, DENSE>(c, st, resident)
  const int g = c.rows;
  if (g == 1) PDEC_LAUNCH(1);
  if (g == 2) PDEC_LAUNCH(2);
  if (g <= 4) PDEC_LAUNCH(4);
  if (g <= 8) PDEC_LAUNCH(8);
  if constexpr (KIND != SLOT) {
    if (g <= 10) PDEC_LAUNCH(10);  // recurrentgemma-2b, qwen3-0.6b's verify
    PDEC_LAUNCH(16);
  }
#undef PDEC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The (dtype, hd) instance: hd 64 or 128, and 256 for the ring.
template <int KIND, bool DENSE>
int launch_t(const Call& c, int dtype, int hd, cudaStream_t st,
             int* resident) {
#define PDEC_TYPE(TT, HH) return launch_g<TT, HH, KIND, DENSE>(c, st, resident)
  if (dtype == 0 && hd == 64) PDEC_TYPE(float, 64);
  if (dtype == 0 && hd == 128) PDEC_TYPE(float, 128);
  if (dtype == 1 && hd == 64) PDEC_TYPE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PDEC_TYPE(__nv_bfloat16, 128);
  if constexpr (KIND == RING) {
    if (dtype == 0 && hd == 256) PDEC_TYPE(float, 256);
    if (dtype == 1 && hd == 256) PDEC_TYPE(__nv_bfloat16, 256);
  }
#undef PDEC_TYPE
  return (int)cudaErrorInvalidValue;
}

// Checks shared by every entry, then the launch.  H: query heads; c.G,
// and outside a verify c.S and c.rows, are set here; a verify cuts its
// bands on the device.  The pieces must cover the longest band a row can
// have: cap (slot), min(window, cap) (ring), the cache part plus the chunk
// (verify, either layout).
template <int KIND, bool DENSE>
int run(Call c, int H, int dtype, int hd, void* stream) {
  if (c.B < 0 || c.KV < 1 || H % c.KV || H / c.KV < 1 ||
      H / c.KV > ROWS_MAX || c.n_pages < 1 || c.page < 1 || c.nblk < 1 ||
      c.chunk < 1 || c.nsplit < 1 || c.nsplit > CLUSTER_MAX ||
      c.window < 0 || (KIND == RING && c.window < 1))
    return (int)cudaErrorInvalidValue;
  c.G = H / c.KV;
  if (KIND != VERIFY) {
    c.S = 1;
    c.rows = c.G;
    c.ring = 0;
  } else if (c.S < 1 || c.rows < 1 || c.rows > ROWS_MAX ||
             c.rows > (long long)c.S * c.G) {
    return (int)cudaErrorInvalidValue;
  } else {
    c.devcut = 1;
  }
  const long long cap = (long long)c.nblk * c.page;
  long long span = cap;
  if (KIND == RING && c.window < cap) span = c.window;
  if (KIND == VERIFY)
    span = (c.window > 0 && c.window - 1 < cap ? c.window - 1 : cap) + c.S;
  const long long tiles = ((long long)c.S * c.G + c.rows - 1) / c.rows;
  if (cap > (1 << 30) || (long long)c.chunk * c.nsplit < span ||
      (long long)c.B * tiles > GRID_Z_MAX)
    return (int)cudaErrorInvalidValue;
  if (c.B == 0) return 0;
  return launch_t<KIND, DENSE>(c, dtype, hd, static_cast<cudaStream_t>(stream),
                               nullptr);
}

// Blocks of the (dtype, hd, rows) instance an SM holds at once, in *out (the
// host's split takes it); rows is the group's G outside a verify.  Returns
// a CUDA error code (0 on success).
template <int KIND, bool DENSE>
int blocks_per_sm(int dtype, int hd, int rows, int* out) {
  if (rows < 1 || rows > (KIND == SLOT ? 8 : ROWS_MAX))
    return (int)cudaErrorInvalidValue;
  Call c = {};
  c.rows = rows;
  return launch_t<KIND, DENSE>(c, dtype, hd, nullptr, out);
}

}  // namespace
}  // namespace pdec
