// One-query flash decode over the serve engine's dense slot pool, for
// sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: slot_decode_attention
//           (Pallas TPU kernel `_slot_kernel` with `_flash_update`).
//
// Computes  out[b,h,:] = softmax_{j < kv_len[b]}(q[b,h,:] . k[b,j,h/G,:]
//                        * hd^-0.5) @ v[b,j,h/G,:]
// with q (B,H,hd) and the pool layout k/v (B,S,KV,hd), all contiguous.
// kv_len (B,) int32; a row with kv_len <= 0 (an idle or finished slot)
// writes exact zeros, kv_len > S reads S.  float32 and bfloat16, hd in
// {64, 128}, G = H/KV in {1, 2, 4, 8}; softmax state and sums are float32.
//
// Bound on the H100: bytes.  Each row's valid cache once, sum_b kv_len_b *
// KV * hd * 2 * itemsize bytes, at ~4*G FLOPs a byte (float32) -- far
// below the ridge point.
//
// Design: the SLOT band of the decode body, paged_decode.cuh, with the
// dense row address at the pool's own strides (row b's cache is page b of
// S rows: page stride S*KV*hd, kv-head stride hd, row stride KV*hd), as
// the paged slot runs it over an arena: each (b, kv head) band is a
// thread-block cluster of pieces merged in the launch (gpt-base's 96 bands
// take 4 to 6 pieces each, where one block a band left 36 of 132 SMs
// idle), and a producer warp stages K/V tiles by TMA boxes (the pool's
// rows are strided by KV*hd) on mbarriers, or one bulk copy a run where a
// pool has one kv head.  With `devcut` each band cuts its own kv_len over
// the pieces on the device instead of the host's cut of S.
#include "paged_decode.cuh"

// q (B,H,hd), k/v (B,S,KV,hd), kv_len (B,) int32, o (B,H,hd); all
// contiguous on the device.  The band is cut into nsplit (1..16) pieces of
// chunk positions, chunk * nsplit >= S; devcut: 1 cuts each band's own
// length on the device, 0 the host's pieces.  dtype: 0 = float32, 1 =
// bfloat16.  One launch; returns cudaGetLastError() after it (0 on
// success); no synchronisation.
extern "C" int slot_decode_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* kv_len,
                                         void* o, int dtype, int B, int S,
                                         int KV, int H, int hd, int chunk,
                                         int nsplit, int devcut, float scale,
                                         void* stream) {
  pdec::Call c = {};
  c.q = q;
  c.k = k;
  c.v = v;
  c.rowarg = static_cast<const int*>(kv_len);
  c.o = o;
  c.B = B;
  c.n_pages = B > 0 ? B : 1;  // row b's cache is page b
  c.page = S;
  c.nblk = 1;
  c.KV = KV;
  pdec::own_strides(c, hd);
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.devcut = devcut != 0;
  c.scale = scale;
  return pdec::run<pdec::SLOT, true>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, G) instance an SM holds at once, in *out;
// returns a CUDA error code (0 on success).
extern "C" int slot_decode_attention_blocks_per_sm(int dtype, int hd, int G,
                                                   int* out) {
  return pdec::blocks_per_sm<pdec::SLOT, true>(dtype, hd, G, out);
}
