// One-query ring-buffer window decode over a PAGED slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: paged_ring_decode_attention
//           (Pallas TPU kernel `_paged_ring_kernel` with `_page_index_map`).
//
// q (B, H, hd); k/v (n_pages, page, KV, hd) page arenas; bt (B, nblk)
// int32 block tables; the ring modulus is nblk * page and ring slot s of
// row b lives at arena[bt[b, s / page], s % page]; slot_positions (B,)
// int32, -1 for a done row (exact zeros).  A table entry outside
// [0, n_pages) (the sentinel of a block the row never got) clamps into the
// arena, to page n_pages - 1 as in the reference; such blocks hold no band
// position on any caller's path, and no read leaves the arena.
//
// Bound on the H100: bytes, as the dense ring kernel (plus the table).
// Design: the dense ring kernel's split band (ring_decode_attention.cuh)
// with the row addressing swapped: each block loads its row's table into
// shared memory once, clamped, and resolves position p to its page and
// offset itself, so a chunk runs across page boundaries unchanged (the
// TPU kernel resolves pages in its BlockSpec index map from the
// scalar-prefetched table).  float32 and bfloat16, hd in {64, 128, 256},
// G = H/KV in 1..16, any page size, nblk <= 2048.
#include "ring_decode_attention.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(ring::NT)
paged_ring_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ bt,
                          const int* __restrict__ pos_b,
                          float* __restrict__ work, int nrow, int nsplit,
                          int n_pages, int page, int nblk, int KV, int G,
                          int window, float scale) {
  extern __shared__ int sbt[];  // the row's block table, clamped
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < nblk; i += ring::NT)
    sbt[i] = min(max(bt[(long long)b * nblk + i], 0), n_pages - 1);
  __syncthreads();
  const ring::PagedRows rows{sbt, (long long)KV * HD, nblk * page, page};
  ring::partial_block<T, HD>(q, k, v, rows, pos_b[b], work, nrow, nsplit, KV,
                             G, window, nblk * page, scale);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* pos, void* o, float* work, int B, int n_pages,
           int page, int nblk, int KV, int G, int window, int nsplit,
           float scale, cudaStream_t st) {
  const int nrow = B * KV;
  const size_t smem = (size_t)nblk * sizeof(int);
  paged_ring_partial_kernel<T, HD>
      <<<dim3(KV, B, nsplit), ring::NT, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bt, pos, work, nrow, nsplit, n_pages,
          page, nblk, KV, G, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int zb = (G * HD + ring::NT - 1) / ring::NT;
  ring::ring_combine_kernel<T><<<dim3(KV, B, zb), ring::NT, 0, st>>>(
      work, pos, static_cast<T*>(o), nrow, nsplit, KV, G, HD);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,hd), k/v (n_pages,page,KV,hd) arenas, bt (B,nblk) int32,
// slot_positions (B,) int32, o (B,H,hd); work: B*KV*nsplit*G*(hd+2)
// floats of scratch; all contiguous on the device.  nsplit * 64 >=
// min(window, nblk * page); nblk <= 2048 (the table lives in shared
// memory).  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launches (0 on success); no synchronisation.
extern "C" int paged_ring_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* bt,
    const void* slot_positions, void* o, void* work, int dtype, int B,
    int n_pages, int page, int nblk, int KV, int H, int hd, int window,
    int nsplit, float scale, void* stream) {
  if (n_pages < 1 || page < 1 || nblk < 1 || nblk > ring::MAX_NBLK)
    return (int)cudaErrorInvalidValue;
  const int rc =
      ring::check_geometry(B, KV, H, hd, nblk * page, window, nsplit);
  if (rc) return rc;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(bt);
  const int* pos = static_cast<const int*>(slot_positions);
  float* wk = static_cast<float*>(work);
  const int G = H / KV;
#define PAGED_RING_LAUNCH(TT, HH)                                          \
  return launch<TT, HH>(q, k, v, tb, pos, o, wk, B, n_pages, page, nblk,   \
                        KV, G, window, nsplit, scale, st)
  if (dtype == 0 && hd == 64) PAGED_RING_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) PAGED_RING_LAUNCH(float, 128);
  if (dtype == 0 && hd == 256) PAGED_RING_LAUNCH(float, 256);
  if (dtype == 1 && hd == 64) PAGED_RING_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PAGED_RING_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) PAGED_RING_LAUNCH(__nv_bfloat16, 256);
#undef PAGED_RING_LAUNCH
  return (int)cudaErrorInvalidValue;
}
