// The ring layout of the two verify kernels (paged_chunk_verify_attention.cu
// and chunk_verify_attention.cu with ring = 1), for sm_90a: a body of its
// own beside paged_decode.cuh, whose band setup, row address, cluster
// split and checks it shares.
//
// Computes, for each row b with off = offsets[b] >= 0, kv head h and each
// of the block's query rows r = (i, g) (query position off + i):
//   out[r,:] = softmax_{p in band, p seen by r}(q[r,:] . K[p] * scale) @ V[p]
// over the band [lo, off + S): the ring's cache positions [lo, off), lo =
// max(off - cap, off - window + 1 with a window, 0), position p at slot p %
// cap (through the block table on the paged pool, the row's own page on
// the dense one), then the chunk's S keys kc/vc at positions off .. off + S
// - 1.  Row r sees a key at p iff p <= off + i and, with a window, p > off
// + i - window.  Done rows (off < 0) write exact zeros; sentinel table
// entries clamp to page n_pages - 1.  This is the contract of the Pallas
// `_chunk_kernel`'s ring branch (src/repro/kernels/decode_attention.py).
//
// Bound on the H100: bytes, as the full layout's.  At phase 17's shape (B
// 8, S 5, 16 heads over 8 KV heads of 128, cap 1,088, window 1,025) each
// of the 64 bands reads 1,029 K and V rows, 67.4 MB in float32: 0.0203 ms
// at 3.35 TB/s (0.0102 in bf16).  The shared body, paged_decode.cuh, took
// 0.0970 / 0.1016 ms (f32 / bf16) for it, and as much for the full layout
// at the same band length with TMA boxes (0.0956 / 0.1021): its SIMT
// products over 10 query rows bound it, not its per-row copies.
//
// Design:
//  1. Aligned tiles, one TMA box each.  The band is walked in tiles of TR
//     = 32 positions from la = lo rounded down to a multiple of 32, so each
//     band is up to 31 positions longer (verify_span adds them; `check`
//     holds the host's pieces to it).  Where rows are staged whole (hd ==
//     the bucket HD), 16-byte aligned, and pages hold whole tiles (page %
//     32 == 0, so cap % 32 == 0 and slot p % cap agrees with p mod 32), an
//     aligned tile of cache positions is TR consecutive slots of one page
//     and lands by one 4-d TMA box (HD + pad, 1 head, TR rows, 1 page) for
//     K and one for V, as the full layout's tiles do.  Tiles that reach
//     the chunk (tp + 32 > off), and every tile of a shape outside that
//     rule (cap % 32 != 0, pages of 8, 16 or 24, hd 80 in the 128 bucket),
//     take one bulk copy a band row, from the slot or from kc/vc.  The
//     rule is `ring_verify_box` in kernels/decode_attention.py.
//  2. Staged rows outside the band add nothing.  A box stages the rows of
//     [la, lo), which hold older positions or anything at all (the fault
//     layer's NaN); a row-copied tile leaves its rows outside the band as
//     an earlier tile left them.  Their logits are masked by selection
//     (never by a product), and their V values are replaced by zeros
//     before the P @ V product, so 0 * NaN never happens.
//  3. Tensor cores for both products.  A block's query rows (at most 16,
//     `verify_tiles`) are the M = 16 of `mma.sync`, padded with zero rows
//     (qwen3-0.6b's self-draft verify: 10 of 16, so 3/8 of the products
//     are padding).  Each consumer warp takes 8 of a tile's 32 keys and
//     keeps its own (m, l, O) in registers: S = Q K^T by m16n8k8 (TF32) or
//     m16n8k16 (bf16) over hd in two chains, an online softmax on S's
//     fragments (4 lanes a row, two shuffles), then O += P V by m16n8k8
//     with P straight from S's fragments (P's k index t is key 2t, t + 4
//     key 2t + 1, so no shuffle is needed).  float32 runs each product as
//     3xTF32 (hi.hi + lo.hi + hi.lo) with a two-instruction split that
//     clears bits (`split_tf32_cut`, an instruction fewer than the
//     rounding split); q's split is redone each tile, as hoisting its 128
//     halves out of the loop spilled.  The
//     float32 tolerance holds, one TF32 pass would not (tests/test_torch_
//     tensorcore_numerics.py), so float32 differs from the plain version by
//     the split (~2^-20 relative a product) as well as the summation order.
//     bfloat16 runs bf16 products, P rounded to bf16 for P @ V, sums in
//     float32.  The warps' partials merge in the block, then the
//     cluster's pieces merge as in paged_decode.cuh.
//  4. No bank conflicts.  A staged row is HD + 16 bytes long (the box's
//     extra columns are outside the tensor, so TMA fills them with zeros),
//     so the 8 rows a fragment load touches start 4 banks apart: the
//     float32 fragments are conflict-free 4-byte loads, the bf16 ones
//     `ldmatrix` (K) and `ldmatrix.trans` (V).
//  5. One block an SM, two consumer groups.  Two groups of four consumer
//     warps take alternate tiles of a 200 KB stage ring (6 float32 stages
//     at hd 128, 8 in bf16; the shared body has 2), so eight warps of one
//     band share each SM; the host's split asks this instance's occupancy
//     (`*_ring_blocks_per_sm`, 1) and the clusters the card holds at once
//     (`*_ring_clusters`), cutting fewer pieces a band while its cluster
//     would wait for a second wave: phase 17's 64 bands take 2 pieces (an
//     H100 holds 66 clusters of 2 of this instance, 39 of 3, 30 of 4;
//     chip_smoke.py phase 3 times the split at 1 to 4 pieces).
#pragma once

#include <type_traits>

#include "paged_decode.cuh"

namespace pdec {
namespace {

// ---- mma.sync (m16n8) and ldmatrix ------------------------------------------
// Fragments, lane = 4 g + t: A (16 x k) rows g and g + 8; B (k x 8) column g;
// C/D (16 x 8): d0, d1 -> (g, 2t, 2t + 1), d2, d3 -> (g + 8, 2t, 2t + 1).

// D += A (16 x 8, tf32: (g, t) (g + 8, t) (g, t + 4) (g + 8, t + 4)) . B
// (8 x 8: (t, g) (t + 4, g))
__device__ __forceinline__ void mma_tf32_k8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D += A (16 x 16 bf16 pairs: (g, 2t) (g + 8, 2t) (g, 2t + 8) (g + 8, 2t +
// 8)) . B (16 x 8 pairs: (2t, g) (2t + 8, g))
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D += A (16 x 8 bf16 pairs: (g, 2t) (g + 8, 2t)) . B (8 x 8: pair (2t, g))
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
// four 8 x 8 b16 matrices, lanes 8j .. 8j + 7 giving the row addresses of
// matrix j: r[j] = (row g, cols 2t, 2t + 1), or with TRANS (rows 2t, 2t +
// 1, col g).  Volatile: it reads stages the mbarrier waits publish.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(tc::smem_u32(p))
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(tc::smem_u32(p))
        : "memory");
}

// x = hi + lo for a 3xTF32 product, in two instructions: hi is x with its
// 13 low mantissa bits cleared (a TF32 value), lo = x - hi exactly, whose
// own low bits the tensor core ignores (~2^-20 of x lost, against ~2^-22
// for wgmma.cuh's rounding split_tf32, which takes three)
__device__ __forceinline__ void split_tf32_cut(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&x));
}

// Two groups of four consumer warps take alternate tiles, one block an SM
constexpr int RV_GROUPS = 2;
constexpr int RV_NCW = RV_GROUPS * NCW;  // consumer warps
constexpr int RV_NC = RV_NCW * 32;       // consumer threads
constexpr int RV_NT = RV_NC + 32;        // and the producer warp
constexpr int RV_STAGE_BYTES = 200 * 1024;  // K + V stages a block at most
constexpr int RV_ROWS = 16;                 // query rows of a block (M)

__device__ __forceinline__ void ring_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(RV_NC) : "memory");
}
constexpr float LOG2E = 1.4426950408889634f;

// Geometry of a (type, bucket) instance of the ring verify.
template <typename T, int HD>
struct RGeo {
  static constexpr int TR = 32;                       // positions a tile
  static constexpr int HDP = HD + 16 / (int)sizeof(T);  // a staged row
  static constexpr int TILE = TR * HDP * (int)sizeof(T);  // bytes of K or V
  static constexpr int S0 = RV_STAGE_BYTES / (2 * TILE);
  static constexpr int S = S0 > 8 ? 8 : S0 < 2 ? 2 : S0;  // stages (2..8)
  static constexpr int OP = HD + 8;  // row stride (floats) of a warp's O
  // the warps' partials (O, then m and l) reuse the stages' memory
  static constexpr int PART = RV_NCW * RV_ROWS * (OP + 2) * 4;
  static constexpr int RING = 2 * S * TILE > PART ? 2 * S * TILE : PART;
};

// barriers, the stage ring (or the warps' partials), then the block's
// merged (acc, m, l) that the cluster reads
template <typename T, int HD>
constexpr int ring_smem_bytes() {
  return 128 + RGeo<T, HD>::RING + (RV_ROWS * HD + 2 * RV_ROWS) * 4;
}

// One block: query rows r0 .. r0 + nq - 1 of (row b, kv head blockIdx.y),
// the piece `rank` of its band.  Arguments as paged_decode_kernel's.
template <typename T, int HD, bool DENSE>
__global__ void __launch_bounds__(RV_NT, 1)
ring_verify_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ bt,
                   const int* __restrict__ offsets, T* __restrict__ o,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int tma, int hd,
                   int vec, int n_pages, int page, int nblk, long long sb,
                   long long skv, long long ss, int KV, int G, int slen,
                   int rows, int window, int chunk, float scale) {
  using Gm = RGeo<T, HD>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int TR = Gm::TR, HDP = Gm::HDP, S = Gm::S, OP = Gm::OP;
  constexpr int NJ = HD / 8;  // n-tiles of O (8 columns each)
  const int RB = hd * (int)sizeof(T);  // bytes of a row in device memory

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [S]
  uint64_t* empty = full + S;                          // [S]
  T* sK = reinterpret_cast<T*>(smem + 128);            // [S][TR][HDP]
  T* sV = sK + S * TR * HDP;                           // [S][TR][HDP]
  float* sPart = reinterpret_cast<float*>(smem + 128);  // after the tiles
  float* sAcc = reinterpret_cast<float*>(smem + 128 + Gm::RING);  // [16][HD]
  float* sM = sAcc + RV_ROWS * HD;  // [16], log2 units
  float* sL = sM + RV_ROWS;         // [16]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int tiles = (slen * G + rows - 1) / rows;
  const int b = blockIdx.z / tiles;
  const int r0 = (blockIdx.z - b * tiles) * rows;  // the block's first row
  const int nq = min(rows, slen * G - r0);
  const int cap = nblk * page;
  // the band [lo, end) walked from la, lo rounded down to a tile: the
  // cache [lo, off) (the ring holds [off - cap, off)), then the chunk
  const int off = offsets[b];
  int lo = 0, la = 0, n = 0;
  if (off >= 0) {
    lo = max(window > 0 ? max(0, off - window + 1) : 0, off - cap);
    la = lo / TR * TR;
    n = off + slen - la;
  }
  // element (row r, column d) of the block's query rows, in q and in o
  auto elem = [&](int r, int d) -> long long {
    const int rr = r0 + r, qi = rr / G;
    return (((long long)b * slen + qi) * KV * G + (long long)kvh * G + rr -
            qi * G) * hd + d;
  };
  const int GH = nq * hd;
  const int per = (GH + nsplit - 1) / nsplit;  // outputs this rank merges
  const int o0 = rank * per, o1 = min(GH, o0 + per);
  if (n <= 0) {  // a done row, the same for the whole cluster: zeros
    for (int i = o0 + tid; i < o1; i += RV_NT)
      store(&o[elem(i / hd, i % hd)], 0.f);
    return;
  }
  // this rank's piece [p0, p1) of the aligned band: whole tiles but at
  // the band's end
  const int cut = min(chunk, ((n + nsplit - 1) / nsplit + TR - 1) / TR * TR);
  const int p0 = la + (int)min((long long)n, (long long)rank * cut);
  const int p1 = la + (int)min((long long)n, (long long)(rank + 1) * cut);
  const int ntile = (p1 - p0 + TR - 1) / TR;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      tc::mbar_init(full + s, 1);     // the producer's arrival
      tc::mbar_init(empty + s, NCW);  // one arrival per warp of its group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (hd < HD) {  // columns hd .. HD of every staged row: zeros (no box)
    const int tail = HD - hd;
    for (int i = tid; i < 2 * S * TR * tail; i += RV_NT)
      sK[(i / tail) * HDP + hd + i % tail] = T(0.f);
  }
  __syncthreads();

  if (warp == RV_NCW) {
    // ---- producer: a box a whole cache tile, else a copy a band row ------
    const T* kb = k + kvh * skv;
    const T* vb = v + kvh * skv;
    const long long cs = (long long)KV * hd;  // a chunk key's row stride
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
      if (tma && tp + TR <= off) {  // TR slots of one page
        if (lane == 0) {
          const int slot = tp % cap, blk = slot / page, pg = page_of(blk);
          tc::mbar_expect(full + s, 2 * Gm::TILE);
          tc::tma_load_4d(sK + s * TR * HDP, &kmap, 0, kvh, slot - blk * page,
                          pg, full + s);
          tc::tma_load_4d(sV + s * TR * HDP, &vmap, 0, kvh, slot - blk * page,
                          pg, full + s);
        }
        continue;
      }
      // row copies: the tile's rows in [lo, p1) (the band's, this piece's)
      auto src_of = [&](int p, const T*& ks, const T*& vs) {
        if (p < off) {
          const int slot = p % cap, blk = slot / page;
          const long long src = page_of(blk) * sb + (slot - blk * page) * ss;
          ks = kb + src;
          vs = vb + src;
        } else {  // chunk row p - off: (b, p - off, kvh) of kc/vc
          const long long src =
              ((long long)b * slen + p - off) * cs + (long long)kvh * hd;
          ks = kc + src;
          vs = vc + src;
        }
      };
      if (!vec) {  // rows off 16 bytes: the warp copies them itself
        for (int t = 0; t < TR; ++t) {
          const int p = tp + t;
          if (p < lo || p >= p1) continue;
          const T* ks;
          const T* vs;
          src_of(p, ks, vs);
          T* dk = sK + (s * TR + t) * HDP;
          T* dv = sV + (s * TR + t) * HDP;
          for (int d = lane; d < hd; d += 32) {
            dk[d] = ks[d];
            dv[d] = vs[d];
          }
        }
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(full + s);
        continue;
      }
      const int p = tp + lane;
      const bool in = p >= lo && p < p1;
      const unsigned rowmask = __ballot_sync(0xffffffffu, in);
      if (lane == 0) tc::mbar_expect(full + s, 2 * __popc(rowmask) * RB);
      __syncwarp();
      if (in) {
        const T* ks;
        const T* vs;
        src_of(p, ks, vs);
        tc::bulk_load(sK + (s * TR + lane) * HDP, ks, RB, full + s);
        tc::bulk_load(sV + (s * TR + lane) * HDP, vs, RB, full + s);
      }
    }
  } else {
    // ---- consumers: group warp / 4 takes every other tile, warp w of a
    // group its keys 8w .. 8w + 7 -------------------------------------------
    const int grp = warp / NCW, wk = warp % NCW;
    const int g = lane >> 2, t = lane & 3;
    // query positions of this lane's rows g and g + 8
    const int qp0 = off + (r0 + g) / G, qp1 = off + (r0 + g + 8) / G;
    // q's rows g and g + 8 (the element of column 0; -1 past nq)
    const long long qrow[2] = {g < nq ? elem(g, 0) : -1,
                               g + 8 < nq ? elem(g + 8, 0) : -1};
    auto qval = [&](int h, int d) -> T {  // row g + 8h, column d
      return qrow[h] >= 0 && d < hd ? q[qrow[h] + d] : T(0.f);
    };
    // Q's A fragments, once: float32 as it is (split each use), bf16 pairs
    constexpr int QN = F32 ? HD / 8 : HD / 16;  // k-steps over hd
    using QF = typename std::conditional<F32, float, uint32_t>::type;
    QF qf[QN][4];
#pragma unroll
    for (int kk = 0; kk < QN; ++kk) {
      if constexpr (F32) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qf[kk][e] = qval(e & 1, 8 * kk + t + 4 * (e >> 1));
      } else {
        const int d = 16 * kk + 2 * t;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int dd = d + 8 * (h >> 1);
          qf[kk][h] = bits(qval(h & 1, dd)) | bits(qval(h & 1, dd + 1)) << 16;
        }
      }
    }
    const float sl2 = scale * LOG2E;  // logits in log2 units
    float m0 = NEG_INF, m1 = NEG_INF;  // rows g, g + 8 (log2 units)
    float l0 = 0.f, l1 = 0.f;          // this lane's share of their sums
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int it = grp; it < ntile; it += RV_GROUPS) {
      const int s = it % S;
      const T* tK = sK + (s * TR + 8 * wk) * HDP;  // this warp's 8 keys
      const T* tV = sV + (s * TR + 8 * wk) * HDP;
      const int kp = p0 + it * TR + 8 * wk + 2 * t;  // keys kp, kp + 1
      const bool ok0 = kp >= lo && kp < p1, ok1 = kp + 1 >= lo && kp + 1 < p1;
      tc::mbar_wait(full + s, (it / S) & 1);

      // S = Q K^T: rows g, g + 8 x keys 2t, 2t + 1 (two chains)
      constexpr int NCH = 2;
      float sc[NCH][4] = {};
      if constexpr (F32) {
        // q's split is the same every tile: kept from being hoisted out
        // of the loop, where its 128 halves would spill
#pragma unroll
        for (int kk = 0; kk < QN; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(qf[kk][e]));
#pragma unroll
        for (int kk = 0; kk < QN; ++kk) {
          uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_cut(qf[kk][e], ah[e], al[e]);
          split_tf32_cut(tK[g * HDP + 8 * kk + t], bh0, bl0);
          split_tf32_cut(tK[g * HDP + 8 * kk + t + 4], bh1, bl1);
          mma_tf32_k8(sc[kk % NCH], al, bh0, bh1);
          mma_tf32_k8(sc[kk % NCH], ah, bl0, bl1);
          mma_tf32_k8(sc[kk % NCH], ah, bh0, bh1);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {  // two k-steps a load
          uint32_t kr[4];
          ldsm_x4<false>(kr, tK + (lane & 7) * HDP + 32 * kk + 8 * (lane >> 3));
          mma_bf16_k16(sc[(2 * kk) % NCH], qf[2 * kk], kr[0], kr[1]);
          mma_bf16_k16(sc[(2 * kk + 1) % NCH], qf[2 * kk + 1], kr[2], kr[3]);
        }
      }
      // mask (selection: staged rows outside the band may hold anything),
      // then the online softmax of rows g and g + 8 over the 4 lanes of g
      auto seen = [&](int qp, int p, bool ok) {
        return ok && p <= qp && (window <= 0 || p > qp - window);
      };
      const bool v00 = seen(qp0, kp, ok0), v01 = seen(qp0, kp + 1, ok1);
      const bool v10 = seen(qp1, kp, ok0), v11 = seen(qp1, kp + 1, ok1);
#pragma unroll
      for (int c = 1; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[0][e] += sc[c][e];
      const float x00 = v00 ? sc[0][0] * sl2 : NEG_INF;
      const float x01 = v01 ? sc[0][1] * sl2 : NEG_INF;
      const float x10 = v10 ? sc[0][2] * sl2 : NEG_INF;
      const float x11 = v11 ? sc[0][3] * sl2 : NEG_INF;
      float mx0 = fmaxf(x00, x01), mx1 = fmaxf(x10, x11);
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // a row that has seen no key yet has m NEG_INF: its masked keys
      // must weigh 0, not exp2(0)
      const float p00 = v00 ? exp2f(x00 - mn0) : 0.f;
      const float p01 = v01 ? exp2f(x01 - mn0) : 0.f;
      const float p10 = v10 ? exp2f(x10 - mn1) : 0.f;
      const float p11 = v11 ? exp2f(x11 - mn1) : 0.f;
      l0 = l0 * a0 + p00 + p01;
      l1 = l1 * a1 + p10 + p11;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }

      // O += P V: P's k index t <-> key 2t, t + 4 <-> key 2t + 1 (float32),
      // pairs (2t, 2t + 1) (bf16), so P is S's fragment as it stands; V
      // rows outside the band read as zeros
      if constexpr (F32) {
        const float pa[4] = {p00, p10, p01, p11};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_cut(pa[e], ph[e], pl[e]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float w0 = ok0 ? tV[2 * t * HDP + 8 * j + g] : 0.f;
          const float w1 = ok1 ? tV[(2 * t + 1) * HDP + 8 * j + g] : 0.f;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_cut(w0, bh0, bl0);
          split_tf32_cut(w1, bh1, bl1);
          mma_tf32_k8(acc[j], pl, bh0, bh1);
          mma_tf32_k8(acc[j], ph, bl0, bl1);
          mma_tf32_k8(acc[j], ph, bh0, bh1);
        }
      } else {
        const uint32_t pa0 = tc::pack_bf16(p00, p01);
        const uint32_t pa1 = tc::pack_bf16(p10, p11);
        const uint32_t keep = (ok0 ? 0x0000ffffu : 0u) | (ok1 ? 0xffff0000u : 0u);
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) {  // four n-tiles a load
          uint32_t vr[4];
          ldsm_x4<true>(vr, tV + (lane & 7) * HDP + 32 * c + 8 * (lane >> 3));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16_k8(acc[4 * c + j], pa0, pa1, vr[j] & keep);
        }
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(empty + s);  // this warp is done
    }

    // the warp's partial (m, l, O) of its keys, then the block's merge
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    ring_consumer_sync();  // every warp is done with the stages
    float* pO = sPart + warp * RV_ROWS * OP;  // [warp][16][OP]
    float* pM = sPart + RV_NCW * RV_ROWS * OP;  // [warp][16]
    float* pL = pM + RV_NCW * RV_ROWS;          // [warp][16]
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float2*>(pO + g * OP + 8 * j + 2 * t) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(pO + (g + 8) * OP + 8 * j + 2 * t) =
          make_float2(acc[j][2], acc[j][3]);
    }
    if (t == 0) {
      pM[warp * RV_ROWS + g] = m0;
      pM[warp * RV_ROWS + g + 8] = m1;
      pL[warp * RV_ROWS + g] = l0;
      pL[warp * RV_ROWS + g + 8] = l1;
    }
    ring_consumer_sync();
    for (int i = tid; i < nq * HD; i += RV_NC) {
      const int r = i / HD, d = i - r * HD;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < RV_NCW; ++w) M = fmaxf(M, pM[w * RV_ROWS + r]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < RV_NCW; ++w) {
        const float f = exp2f(pM[w * RV_ROWS + r] - M);
        a += sPart[(w * RV_ROWS + r) * OP + d] * f;
        l += pL[w * RV_ROWS + r] * f;
      }
      sAcc[i] = a;
      if (d == 0) {
        sM[r] = M;
        sL[r] = l;
      }
    }
  }

  // ---- merge the cluster's pieces: rank r writes outputs [o0, o1) -------
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every piece's (m, l, acc) is in its shared memory
  const int nr = min(nsplit, (n + cut - 1) / cut);  // pieces with data
  for (int i = o0 + tid; i < o1; i += RV_NT) {
    const int r = i / hd, ia = r * HD + i - r * hd;  // its sAcc element
    float mr[CLUSTER_MAX], lr[CLUSTER_MAX], ar[CLUSTER_MAX];
#pragma unroll
    for (int c = 0; c < CLUSTER_MAX; ++c) {  // all loads in flight at once
      mr[c] = NEG_INF;
      lr[c] = ar[c] = 0.f;
      if (c < nr) {
        mr[c] = *cluster.map_shared_rank(sM + r, c);
        lr[c] = *cluster.map_shared_rank(sL + r, c);
        ar[c] = *cluster.map_shared_rank(sAcc + ia, c);
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int c = 0; c < CLUSTER_MAX; ++c) M = fmaxf(M, mr[c]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int c = 0; c < CLUSTER_MAX; ++c) {
      const float f = exp2f(mr[c] - M);  // 0 past nr
      Lsum += lr[c] * f;
      A += ar[c] * f;
    }
    store(&o[elem(r, i - r * hd)], A / fmaxf(Lsum, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// Attributes once, then the occupancy (*resident) or the launch.  The box
// rule: rows staged whole and 16-byte aligned, pages of whole tiles.
template <typename T, int HD, bool DENSE>
int ring_launch(const Call& c, cudaStream_t st, int* resident,
                int* clusters = nullptr) {
  auto kern = ring_verify_kernel<T, HD, DENSE>;
  constexpr int smem = ring_smem_bytes<T, HD>();
  using Gm = RGeo<T, HD>;
  static bool ready = false;
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
                                                              RV_NT, smem);
  const int tiles = (c.S * c.G + c.rows - 1) / c.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = clusters ? dim3(c.nsplit) : dim3(c.nsplit, c.KV, c.B * tiles);
  cfg.blockDim = dim3(RV_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters)
    return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  const long long es = sizeof(T);
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = c.hd * es % 16 == 0 && a16(c.k) && a16(c.v) && a16(c.kc) &&
                  a16(c.vc) && c.sb * es % 16 == 0 && c.skv * es % 16 == 0 &&
                  c.ss * es % 16 == 0;
  CUtensorMap kmap{}, vmap{};
  const int tma = vec && c.hd == HD && c.page % Gm::TR == 0;
  if (tma) {
    // (HD + pad) x 1 head x TR rows x 1 page: the pad lies past the
    // tensor's HD columns, so it lands as zeros
    const unsigned long long dims[4] = {
        (unsigned long long)HD, (unsigned long long)c.KV,
        (unsigned long long)c.page, (unsigned long long)c.n_pages};
    const unsigned long long strides[3] = {c.skv * es, c.ss * es,
                                           c.sb * es};
    const unsigned box[4] = {Gm::HDP, 1, Gm::TR, 1};
    if (!tc::tensor_map(&kmap, c.k, (int)es, 4, dims, strides, box, false) ||
        !tc::tensor_map(&vmap, c.v, (int)es, 4, dims, strides, box, false))
      return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(c.q), static_cast<const T*>(c.k),
      static_cast<const T*>(c.v), static_cast<const T*>(c.kc),
      static_cast<const T*>(c.vc), c.bt, c.rowarg, static_cast<T*>(c.o),
      kmap, vmap, tma, c.hd, vec, c.n_pages, c.page, c.nblk, c.sb, c.skv,
      c.ss, c.KV, c.G, c.S, c.rows, c.window, c.chunk, c.scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The (dtype, bucket) instance: 64 or 128, the smallest that holds hd.
template <bool DENSE>
int ring_launch_t(const Call& c, int dtype, int hd, cudaStream_t st,
                  int* resident, int* clusters = nullptr) {
  if (dtype == 0 && hd >= 1 && hd <= 64)
    return ring_launch<float, 64, DENSE>(c, st, resident, clusters);
  if (dtype == 0 && hd > 64 && hd <= 128)
    return ring_launch<float, 128, DENSE>(c, st, resident, clusters);
  if (dtype == 1 && hd >= 1 && hd <= 64)
    return ring_launch<__nv_bfloat16, 64, DENSE>(c, st, resident, clusters);
  if (dtype == 1 && hd > 64 && hd <= 128)
    return ring_launch<__nv_bfloat16, 128, DENSE>(c, st, resident, clusters);
  return (int)cudaErrorInvalidValue;
}

// A verify of either layout: the shared checks (the ring's pieces must
// cover its aligned band), then the ring body or paged_decode's.
template <bool DENSE>
int run_verify(Call c, int H, int dtype, int hd, void* stream) {
  if (!c.ring) return run<VERIFY, DENSE>(c, H, dtype, hd, stream);
  const int e = check<VERIFY>(c, H, hd);
  if (e || c.B == 0) return e;
  return ring_launch_t<DENSE>(c, dtype, hd, static_cast<cudaStream_t>(stream),
                              nullptr);
}

// Blocks of the ring instance for (dtype, hd) an SM holds at once.
template <bool DENSE>
int ring_blocks_per_sm(int dtype, int hd, int rows, int* out) {
  if (rows < 1 || rows > RV_ROWS) return (int)cudaErrorInvalidValue;
  Call c = {};
  c.rows = rows;
  c.hd = hd;
  return ring_launch_t<DENSE>(c, dtype, hd, nullptr, out);
}

// Clusters of nsplit blocks of that instance the card holds at once.
template <bool DENSE>
int ring_clusters(int dtype, int hd, int nsplit, int* out) {
  if (nsplit < 1 || nsplit > CLUSTER_MAX) return (int)cudaErrorInvalidValue;
  Call c = {};
  c.nsplit = nsplit;
  c.hd = hd;
  int resident = 0;  // the attributes first
  const int e = ring_launch_t<DENSE>(c, dtype, hd, nullptr, &resident);
  if (e) return e;
  return ring_launch_t<DENSE>(c, dtype, hd, nullptr, nullptr, out);
}

}  // namespace
}  // namespace pdec
