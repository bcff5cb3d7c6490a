// One-query decode attention over a head-major KV cache, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: decode_attention
//           (Pallas TPU kernel `_kernel`, cache-block picker `_pick_bk`).
//
// Computes  out[b,h,:] = softmax_{j < kv_len[b]}(q[b,h,:] . k[b,h/G,j,:]
//                        * hd^-0.5) @ v[b,h/G,j,:]
// with q (B,H,hd) contiguous and k/v (B,KV,S,hd) read through element
// strides (sb, skv, ss) for B, KV and S with hd contiguous: a contiguous
// head-major cache, or the serve pool's (B,S,KV,hd) layer cache as its
// transpose(1, 2) view, with no copy.  kv_len (B,) int32; kv_len 0 writes
// exact zeros, kv_len > S reads S.  float32 and bfloat16, hd in {64, 128},
// G = H/KV in {1, 2, 4, 8}, any S; softmax state and sums are float32.
//
// Bound on the H100: bytes.  Each row's valid cache once, sum_b kv_len_b *
// KV * hd * 2 * itemsize bytes, at ~4*G FLOPs a byte (float32) -- far
// below the ridge point.
//
// Design: the SLOT band of the decode body, paged_decode.cuh, with the
// dense row address at the cache's own strides (row b's cache is page b of
// S rows): each (b, kv head) band is a thread-block cluster of pieces
// merged in the launch (one launch, no merge kernel, no workspace; the
// scalar decode at B 1 over 12 kv heads takes 16 pieces a band), and a
// producer warp stages K/V with bulk copies on mbarriers -- one copy a run
// of rows where they are contiguous (a head-major cache), or one TMA box a
// tile where they are strided (the pool's view).  generate's cache is
// max_len wide and mostly unfilled, so with `devcut` each band cuts its own
// kv_len over the pieces on the device instead of the host's cut of S.
#include "paged_decode.cuh"

// q (B,H,hd) contiguous; k/v (B,KV,S,hd) at element strides (sb, skv, ss)
// with hd contiguous, both with the same strides; kv_len (B,) int32; o
// (B,H,hd) contiguous.  The band is cut into nsplit (1..16) pieces of chunk
// positions, chunk * nsplit >= S; devcut: 1 cuts each band's own length on
// the device, 0 the host's pieces.  dtype: 0 = float32, 1 = bfloat16.  One
// launch; returns cudaGetLastError() after it (0 on success); no
// synchronisation.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* o, int dtype, int B, int S, int KV,
                                    int H, int hd, long long sb,
                                    long long skv, long long ss, int chunk,
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
  c.sb = sb;
  c.skv = skv;
  c.ss = ss;
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.devcut = devcut != 0;
  c.scale = scale;
  return pdec::run<pdec::SLOT, true>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, G) instance an SM holds at once, in *out;
// returns a CUDA error code (0 on success).
extern "C" int decode_attention_blocks_per_sm(int dtype, int hd, int G,
                                              int* out) {
  return pdec::blocks_per_sm<pdec::SLOT, true>(dtype, hd, G, out);
}
