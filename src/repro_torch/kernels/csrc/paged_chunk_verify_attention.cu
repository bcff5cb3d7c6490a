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
// block table bt (B, nblk) int32 and the chunk's own k/v (B,S,KV,hd) at
// positions off .. off+S-1.  With cap = nblk * page, the cache's key
// positions follow its layout:
//   full: position p lives at slot p, written iff p < off;
//   ring: slot s holds the largest p < off with p % cap == s (p >= 0),
// and slot s lives at arena[bt[b, s / page], s % page].  A key at
// position kpos is attended iff kpos <= qpos (causal) and, when a window
// is given, kpos > qpos - window.  A table entry outside [0, n_pages)
// (the sentinel of a block with no page, which a draft's catch-up past
// its budget can reach) clamps to page n_pages - 1 as in the reference,
// so no read leaves the arena.  Rows with off < 0 (done slots) write
// exact zeros.  float32 and bfloat16, hd up to 128, G = H/KV in 1..16,
// any S and page size; softmax state and sums are float32.  The arenas
// are never written.
//
// Bound on the H100: bytes, as the dense chunk kernel: each row's
// attended cache positions (full: min(off_b, cap) less the window's cut;
// ring: at most min(cap, window - 1) below off_b) and its S chunk keys
// once, times KV * hd * 2 * itemsize bytes, plus q, out and the table,
// far below the ridge point (10 query rows: ~5 FLOPs a byte in float32).
//
// Design: the verify band of the decode body, paged_decode.cuh (shared
// with the paged slot and the ring kernels).  A verify reads the same band
// a one-query decode does, by S * G query rows instead of G, plus one tile
// of the chunk's own S keys.  The S * G rows (i, g) of a (b, kv head) are
// tiled by at most 16 a block (gpt-base's 5 rows run in the 8-row
// instance, qwen3-0.6b's self-draft's 10 in the 10-row one); each band --
// the cache [lo, min(off, nblk * page)) then the chunk -- is a
// thread-block cluster of pieces merged in the launch (one launch, no
// workspace): the host picks the pieces a band (`paged_decode_splits`
// over B * KV * tiles bands of the longest length), and each band cuts
// its own length over them on the device, so a short cache does not leave
// its tiles to two of the cluster's blocks while the others idle.  A
// producer warp stages K/V through bulk copies on mbarriers, reading the
// table once per position (no shared copy of the table); without a
// window the cache tiles start on multiples of 32 and take one TMA box
// each when pages hold whole tiles.  Each row masks at the window's low
// edge and in the chunk tile only; masked keys weigh exactly 0.  What is
// left is the launch, the cluster barriers and the merge, and float32 FMAs
// over the block's rows (zero rows included).
//
// The ring layout (ring = 1) runs in its own body, ring_verify.cuh: its
// band [max(lo, off - cap), off) walked by position (slot p % cap, so no
// negative number is divided) in tiles aligned to 32 positions, one TMA
// box a whole cache tile where pages hold whole tiles (pages of 64 at
// qwen3-0.6b's window), row copies elsewhere, staged rows outside the band
// masked by selection and zeroed before P @ V, both products on the
// tensor cores (mma.sync; 3xTF32 in float32, so float32 no longer matches
// the plain version to summation order alone: the split adds ~2^-20 a
// product), two groups of four consumer warps on alternate tiles of a
// 200 KB stage ring, one block an SM.  At phase 17's shape it takes 0.0347
// ms (f32) and 0.0228 ms (bf16) where the shared body took 0.0970 and
// 0.1016 (chip_smoke.py phase 3, PR 31; the design is in that header).
#include "ring_verify.cuh"

// q (B,S,H,hd), ck/cv (n_pages,page,KV,hd) arenas, bt (B,nblk) int32, k/v
// (B,S,KV,hd), offsets (B,) int32, o (B,S,H,hd); all contiguous on the
// device.  dtype: 0 = float32, 1 = bfloat16; ring: 0 full layout, 1 ring
// buffer; window: 0 = none.  The S * G query rows of a (b, kv head) come
// in tiles of `rows` (1..16); each band is cut into nsplit (1..16) pieces
// of chunk positions, chunk * nsplit >= min(window - 1, nblk * page) + S
// (+ 31 in the ring layout, chunk a multiple of 32).
// One launch; returns cudaGetLastError() after it (0 on success); no
// synchronisation.
extern "C" int paged_chunk_verify_attention_fwd(
    const void* q, const void* ck, const void* cv, const void* bt,
    const void* k, const void* v, const void* offsets, void* o, int dtype,
    int B, int S, int n_pages, int page, int nblk, int KV, int H, int hd,
    int ring, int window, int rows, int chunk, int nsplit, float scale,
    void* stream) {
  pdec::Call c = {};
  c.q = q;
  c.k = ck;
  c.v = cv;
  c.kc = k;
  c.vc = v;
  c.bt = static_cast<const int*>(bt);
  c.rowarg = static_cast<const int*>(offsets);
  c.o = o;
  c.B = B;
  c.n_pages = n_pages;
  c.page = page;
  c.nblk = nblk;
  c.KV = KV;
  pdec::own_strides(c, hd);
  c.S = S;
  c.rows = rows;
  c.ring = ring != 0;
  c.window = window;
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.scale = scale;
  return pdec::run_verify<false>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, rows) instance an SM holds at once, in
// *out (rows: query rows a tile); returns a CUDA error code (0 on
// success).
extern "C" int paged_chunk_verify_attention_blocks_per_sm(int dtype, int hd,
                                                          int rows,
                                                          int* out) {
  return pdec::blocks_per_sm<pdec::VERIFY, false>(dtype, hd, rows, out);
}

// The same for the ring layout's instance (ring_verify.cuh).
extern "C" int paged_chunk_verify_attention_ring_blocks_per_sm(
    int dtype, int hd, int rows, int* out) {
  return pdec::ring_blocks_per_sm<false>(dtype, hd, rows, out);
}

// Clusters of nsplit blocks of the ring layout's instance the card holds at
// once, in *out; returns a CUDA error code (0 on success).
extern "C" int paged_chunk_verify_attention_ring_clusters(int dtype, int hd, int nsplit,
                                                          int* out) {
  return pdec::ring_clusters<false>(dtype, hd, nsplit, out);
}
