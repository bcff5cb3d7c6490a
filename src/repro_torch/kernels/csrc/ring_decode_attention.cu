// One-query ring-buffer window decode over the dense slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: ring_decode_attention
//           (Pallas TPU kernel `_ring_kernel`).
//
// q (B, H, hd); k/v (B, ring, KV, hd) ring caches that already hold this
// step's K/V at slot pos % ring; slot_positions (B,) int32, -1 for a done
// row (exact zeros).  The band, the bound on the H100 (bytes) and the
// split-band design are described in ring_decode_attention.cuh.  float32
// and bfloat16, hd in {64, 128, 256}, G = H/KV in 1..16; softmax state and
// accumulators are float32.
#include "ring_decode_attention.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(ring::NT)
ring_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_b,
                    float* __restrict__ work, int nrow, int nsplit, int ring_n,
                    int KV, int G, int window, float scale) {
  const int b = blockIdx.y;
  const ring::DenseRows rows{(long long)b * ring_n * KV * HD,
                             (long long)KV * HD, ring_n};
  ring::partial_block<T, HD>(q, k, v, rows, pos_b[b], work, nrow, nsplit, KV,
                             G, window, ring_n, scale);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, float* work, int B, int ring_n, int KV, int G,
           int window, int nsplit, float scale, cudaStream_t st) {
  const int nrow = B * KV;
  ring_partial_kernel<T, HD><<<dim3(KV, B, nsplit), ring::NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, work, nrow, nsplit, ring_n, KV, G,
      window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int zb = (G * HD + ring::NT - 1) / ring::NT;
  ring::ring_combine_kernel<T><<<dim3(KV, B, zb), ring::NT, 0, st>>>(
      work, pos, static_cast<T*>(o), nrow, nsplit, KV, G, HD);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,hd), k/v (B,ring,KV,hd), slot_positions (B,) int32, o (B,H,hd);
// work: B*KV*nsplit*G*(hd+2) floats of scratch; all contiguous on the
// device.  nsplit * 64 >= min(window, ring).  dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError() after the launches (0 on
// success); no synchronisation.
extern "C" int ring_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* slot_positions,
    void* o, void* work, int dtype, int B, int ring_n, int KV, int H, int hd,
    int window, int nsplit, float scale, void* stream) {
  const int rc = ring::check_geometry(B, KV, H, hd, ring_n, window, nsplit);
  if (rc) return rc;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(slot_positions);
  float* wk = static_cast<float*>(work);
  const int G = H / KV;
#define RING_LAUNCH(TT, HH)                                                \
  return launch<TT, HH>(q, k, v, pos, o, wk, B, ring_n, KV, G, window,     \
                        nsplit, scale, st)
  if (dtype == 0 && hd == 64) RING_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) RING_LAUNCH(float, 128);
  if (dtype == 0 && hd == 256) RING_LAUNCH(float, 256);
  if (dtype == 1 && hd == 64) RING_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) RING_LAUNCH(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) RING_LAUNCH(__nv_bfloat16, 256);
#undef RING_LAUNCH
  return (int)cudaErrorInvalidValue;
}
