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
// zeros.  float32 and bfloat16, hd in {64, 128}, G = H/KV in 1..16, any S
// and page size; softmax state and sums are float32.  The arenas
// are never written.  The ring-buffer layout is not taken here (the ring
// slice).
//
// Bound on the H100: bytes, as the dense chunk kernel: each row's
// attended cache positions and its S chunk keys once,
// sum_b (min(off_b, nblk * page) + S) * KV * hd * 2 * itemsize bytes,
// plus q, out and the table, far below the ridge point.
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
#include "paged_decode.cuh"

// q (B,S,H,hd), ck/cv (n_pages,page,KV,hd) arenas, bt (B,nblk) int32, k/v
// (B,S,KV,hd), offsets (B,) int32, o (B,S,H,hd); all contiguous on the
// device.  dtype: 0 = float32, 1 = bfloat16; window: 0 = none.  The S * G
// query rows of a (b, kv head) come in tiles of `rows` (1..16); each band
// is cut into nsplit (1..16) pieces of chunk positions, chunk * nsplit >=
// min(window - 1, nblk * page) + S.  One launch; returns
// cudaGetLastError() after it (0 on success); no synchronisation.
extern "C" int paged_chunk_verify_attention_fwd(
    const void* q, const void* ck, const void* cv, const void* bt,
    const void* k, const void* v, const void* offsets, void* o, int dtype,
    int B, int S, int n_pages, int page, int nblk, int KV, int H, int hd,
    int window, int rows, int chunk, int nsplit, float scale, void* stream) {
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
  c.window = window;
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.scale = scale;
  return pdec::run<pdec::VERIFY, false>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, rows) instance an SM holds at once, in
// *out (rows: query rows a tile); returns a CUDA error code (0 on
// success).
extern "C" int paged_chunk_verify_attention_blocks_per_sm(int dtype, int hd,
                                                          int rows,
                                                          int* out) {
  return pdec::blocks_per_sm<pdec::VERIFY, false>(dtype, hd, rows, out);
}
