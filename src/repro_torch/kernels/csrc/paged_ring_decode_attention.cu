// One-query ring-buffer window decode over a PAGED slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: paged_ring_decode_attention
//           (Pallas TPU kernel `_paged_ring_kernel` with `_page_index_map`).
//
// q (B, H, hd); k/v (n_pages, page, KV, hd) page arenas; bt (B, nblk)
// int32 block tables; the ring modulus is nblk * page and ring slot s of
// row b lives at arena[bt[b, s / page], s % page]; slot_positions (B,)
// int32, -1 for a done row (exact zeros).  The band is [max(0, pos -
// min(window, ring) + 1), pos], walked by position (p in slot p % ring).
// A table entry outside [0, n_pages) (the sentinel of a block the row
// never got) clamps into the arena, to page n_pages - 1 as in the
// reference; such blocks hold no band position on any caller's path.
// float32 and bfloat16, hd in {64, 128, 256}, G = H/KV in 1..16
// (recurrentgemma-2b: G 10, hd 256), any page size.
//
// Bound on the H100: bytes (each band position's K and V row once).  The
// body, paged_decode.cuh, is shared with the slot, dense ring and verify
// kernels: the band is cut into clusters of pieces merged in the launch
// (recurrentgemma-2b has one KV head, so 8 slots are 8 bands; 16 pieces
// each fill the card), and a producer warp stages K/V with bulk copies on
// mbarriers, one copy per run of a page's rows (one KV head: the rows are
// contiguous).
#include "paged_decode.cuh"

// q (B,H,hd), k/v (n_pages,page,KV,hd) arenas, bt (B,nblk) int32,
// slot_positions (B,) int32, o (B,H,hd); all contiguous on the device.
// The band is cut into nsplit (1..16) pieces of chunk positions, chunk *
// nsplit >= min(window, nblk * page).  dtype: 0 = float32, 1 = bfloat16.
// One launch; returns cudaGetLastError() after it (0 on success); no
// synchronisation.
extern "C" int paged_ring_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* bt,
    const void* slot_positions, void* o, int dtype, int B, int n_pages,
    int page, int nblk, int KV, int H, int hd, int window, int chunk,
    int nsplit, float scale, void* stream) {
  pdec::Call c = {};
  c.q = q;
  c.k = k;
  c.v = v;
  c.bt = static_cast<const int*>(bt);
  c.rowarg = static_cast<const int*>(slot_positions);
  c.o = o;
  c.B = B;
  c.n_pages = n_pages;
  c.page = page;
  c.nblk = nblk;
  c.KV = KV;
  pdec::own_strides(c, hd);
  c.window = window;
  c.chunk = chunk;
  c.nsplit = nsplit;
  c.scale = scale;
  return pdec::run<pdec::RING, false>(c, H, dtype, hd, stream);
}

// The blocks of the (dtype, hd, G) instance an SM holds at once, in *out;
// returns a CUDA error code (0 on success).
extern "C" int paged_ring_decode_attention_blocks_per_sm(
    int dtype, int hd, int G, int* out) {
  return pdec::blocks_per_sm<pdec::RING, false>(dtype, hd, G, out);
}
