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
// key positions follow its layout:
//   full: slot s holds position s, written iff s < off;
//   ring: slot s holds the largest p < off with p % Sc == s (p >= 0).
// Rows with off < 0 (done slots) write exact zeros.  float32 and bfloat16,
// hd in {64, 128}, G = H/KV in {1, 2, 4, 8}, any S and Sc; softmax
// state and sums are float32.  The cache is never written.
//
// Bound on the H100: bytes.  Each row's attended cache positions and its S
// chunk keys once, sum_b (valid cache positions + S) * KV * hd * 2 *
// itemsize bytes, plus q and out, far below the ridge point at a block's
// 16 query rows.
//
// Design: the verify band of the decode body, paged_decode.cuh, with the
// dense row address (row b's cache is page b of Sc rows, as the dense ring
// reads it), so the paged verify's design holds here: the S * G query rows
// (i, g) of a (b, kv head) in tiles of at most 16 a block (gpt-base's 5
// rows run in the 8-row instance); each band a thread-block cluster of
// pieces merged in the launch (one launch, no workspace), cut over its own
// length on the device; a producer warp staging K/V with bulk copies on
// mbarriers, or one TMA box a cache tile in the full layout without a
// window.  The ring layout runs in ring_verify.cuh's body, as the paged
// verify's does, over the same dense row address: its band [max(lo, off -
// Sc), off) walked by position, slot p % Sc, so no negative number is
// divided (the reference's `(off - 1) // Sc` floors; C's `/` truncates),
// in tiles aligned to 32 positions (one TMA box each where Sc % 32 == 0,
// row copies for a cache like 300), products on the tensor cores (3xTF32
// in float32).  At phase 17's shape (Sc 1,088) it takes 0.0348 ms (f32)
// and 0.0206 ms (bf16); the shared body took 0.0955 and 0.0955
// (chip_smoke.py phase 3, PR 31).
#include "ring_verify.cuh"

// q (B,S,H,hd), ck/cv (B,Sc,KV,hd), k/v (B,S,KV,hd), offsets (B,) int32,
// o (B,S,H,hd); all contiguous on the device.  dtype: 0 = float32,
// 1 = bfloat16; ring: 0 full layout, 1 ring buffer; window: 0 = none.  The
// S * G query rows of a (b, kv head) come in tiles of `rows` (1..16); each
// band is cut into nsplit (1..16) pieces of at most chunk positions, chunk
// * nsplit >= min(window - 1, Sc) + S (+ 31 in the ring layout, chunk a
// multiple of 32).  One launch; returns
// cudaGetLastError() after it (0 on success); no synchronisation.
extern "C" int chunk_verify_attention_fwd(
    const void* q, const void* ck, const void* cv, const void* k,
    const void* v, const void* offsets, void* o, int dtype, int B, int S,
    int Sc, int KV, int H, int hd, int ring, int window, int rows, int chunk,
    int nsplit, float scale, void* stream) {
  pdec::Call c = {};
  c.q = q;
  c.k = ck;
  c.v = cv;
  c.kc = k;
  c.vc = v;
  c.rowarg = static_cast<const int*>(offsets);
  c.o = o;
  c.B = B;
  c.n_pages = B > 0 ? B : 1;  // row b's cache is page b
  c.page = Sc;
  c.nblk = 1;
  c.KV = KV;
  pdec::own_strides(c, hd);
  c.S = S;
  c.rows = rows;
  c.ring = ring != 0;
  c.window = window;
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.scale = scale;
  return pdec::run_verify<true>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, rows) instance an SM holds at once, in
// *out (rows: query rows a tile); returns a CUDA error code (0 on
// success).
extern "C" int chunk_verify_attention_blocks_per_sm(int dtype, int hd,
                                                    int rows, int* out) {
  return pdec::blocks_per_sm<pdec::VERIFY, true>(dtype, hd, rows, out);
}

// The same for the ring layout's instance (ring_verify.cuh).
extern "C" int chunk_verify_attention_ring_blocks_per_sm(
    int dtype, int hd, int rows, int* out) {
  return pdec::ring_blocks_per_sm<true>(dtype, hd, rows, out);
}

// Clusters of nsplit blocks of the ring layout's instance the card holds at
// once, in *out; returns a CUDA error code (0 on success).
extern "C" int chunk_verify_attention_ring_clusters(int dtype, int hd, int nsplit,
                                                    int* out) {
  return pdec::ring_clusters<true>(dtype, hd, nsplit, out);
}
