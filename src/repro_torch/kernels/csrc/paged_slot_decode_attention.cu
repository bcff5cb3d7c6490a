// One-query flash decode over a PAGED slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: paged_slot_decode_attention
//           (Pallas TPU kernel `_paged_slot_kernel` with `_page_index_map`).
//
// Computes  out[b,h,:] = softmax_{j < kv_len[b]}(q[b,h,:] . K_b[j,h/G,:]
//                        * hd^-0.5) @ V_b[j,h/G,:]
// where row b's cache is spread over a shared page arena k/v
// (n_pages, page, KV, hd) through its block table bt (B, nblk) int32:
// position j lives at arena[bt[b, j / page], j % page].  A table entry
// outside [0, n_pages) (the sentinel n_pages of a block with no page)
// clamps into the arena, to page n_pages - 1 as in the reference: what it
// reads there is finite and, on every caller's path, masked or never
// accepted.  A row with kv_len <= 0 (an idle or finished slot) writes
// exact zeros; kv_len > nblk * page reads nblk * page.  float32 and
// bfloat16, hd in {64, 128}, G = H/KV in {1, 2, 4, 8}, any page size.
//
// Bound on the H100: bytes (each row's valid positions once).  The body,
// paged_decode.cuh, is shared with the ring and verify kernels: the band
// [0, kv_len) is cut into clusters of pieces merged in the launch, and a
// producer warp stages K/V rows with bulk copies on mbarriers; the TPU
// kernel's page-pinned blocks and BlockSpec index map become one table
// read per position by the producer.
#include "paged_decode.cuh"

// q (B,H,hd), k/v (n_pages,page,KV,hd) arenas, bt (B,nblk) int32, kv_len
// (B,) int32, o (B,H,hd); all contiguous on the device.  The band is cut
// into nsplit (1..16) pieces of chunk positions, chunk * nsplit >= nblk *
// page.  dtype: 0 = float32, 1 = bfloat16.  One launch; returns
// cudaGetLastError() after it (0 on success); no synchronisation.
extern "C" int paged_slot_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* bt,
    const void* kv_len, void* o, int dtype, int B, int n_pages, int page,
    int nblk, int KV, int H, int hd, int chunk, int nsplit, float scale,
    void* stream) {
  pdec::Call c = {};
  c.q = q;
  c.k = k;
  c.v = v;
  c.bt = static_cast<const int*>(bt);
  c.rowarg = static_cast<const int*>(kv_len);
  c.o = o;
  c.B = B;
  c.n_pages = n_pages;
  c.page = page;
  c.nblk = nblk;
  c.KV = KV;
  pdec::own_strides(c, hd);
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.scale = scale;
  return pdec::run<pdec::SLOT, false>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, G) instance an SM holds at once, in *out;
// returns a CUDA error code (0 on success).
extern "C" int paged_slot_decode_attention_blocks_per_sm(
    int dtype, int hd, int G, int* out) {
  return pdec::blocks_per_sm<pdec::SLOT, false>(dtype, hd, G, out);
}
