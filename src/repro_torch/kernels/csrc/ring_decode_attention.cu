// One-query ring-buffer window decode over the dense slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: ring_decode_attention
//           (Pallas TPU kernel `_ring_kernel`).
//
// q (B, H, hd); k/v (B, ring, KV, hd) ring caches that already hold this
// step's K/V at slot pos % ring; slot_positions (B,) int32, -1 for a done
// row (exact zeros).  The band is [max(0, pos - min(window, ring) + 1),
// pos], walked by position (p in slot p % ring).  float32 and bfloat16, hd
// in {64, 128, 256}, G = H/KV in 1..16 (recurrentgemma-2b: G 10, hd 256),
// any ring length; softmax state and accumulators are float32.
//
// Bound on the H100: bytes (each band position's K and V row once).  The
// dense pool is an arena of B pages of `ring` rows in which row b owns page
// b, so this is the paged ring kernel with a compile-time dense row address
// (no table read): the body, paged_decode.cuh, cuts each (b, kv head) band
// into a thread-block cluster of pieces merged in the launch (one launch,
// no workspace; recurrentgemma-2b's 8 bands take 16 pieces each), and a
// producer warp stages K/V with bulk copies on mbarriers, one copy per run
// of rows up to the ring's end when KV == 1.  What is left is the launch,
// the cluster barriers and the merge, and float32 FMAs over the G heads.
#include "paged_decode.cuh"

// q (B,H,hd), k/v (B,ring,KV,hd), slot_positions (B,) int32, o (B,H,hd);
// all contiguous on the device.  The band is cut into nsplit (1..16)
// pieces of chunk positions, chunk * nsplit >= min(window, ring).  dtype:
// 0 = float32, 1 = bfloat16.  One launch; returns cudaGetLastError() after
// it (0 on success); no synchronisation.
extern "C" int ring_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* slot_positions,
    void* o, int dtype, int B, int ring, int KV, int H, int hd, int window,
    int chunk, int nsplit, float scale, void* stream) {
  pdec::Call c = {};
  c.q = q;
  c.k = k;
  c.v = v;
  c.rowarg = static_cast<const int*>(slot_positions);
  c.o = o;
  c.B = B;
  c.n_pages = B > 0 ? B : 1;  // row b's ring is page b
  c.page = ring;
  c.nblk = 1;
  c.KV = KV;
  pdec::own_strides(c, hd);
  c.window = window;
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.scale = scale;
  return pdec::run<pdec::RING, true>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, G) instance an SM holds at once, in *out;
// returns a CUDA error code (0 on success).
extern "C" int ring_decode_attention_blocks_per_sm(int dtype, int hd, int G,
                                                   int* out) {
  return pdec::blocks_per_sm<pdec::RING, true>(dtype, hd, G, out);
}
