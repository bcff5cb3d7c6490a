// One-query flash decode over the serve engine's slot pool, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: slot_decode_attention
//           (Pallas TPU kernel `_slot_kernel` with `_flash_update`).
//
// q (B,H,hd) and the pool layout k/v (B,S,KV,hd): position stride KV*hd,
// each (position, kv head) row hd contiguous values.  kv_len (B,) int32;
// a row with kv_len == 0 (an idle or finished slot) writes exact zeros.
// The body is the one of decode_attention.cuh, read at the pool's strides
// with the whole cache axis in one block of 8 warps per (b, kv head), no
// merge pass.  Known limit: B*KV blocks (96 for gpt-base at 8 slots) do
// not fill the 132 SMs (paged_decode.cuh splits its bands over clusters).
#include "decode_attention.cuh"

// q (B,H,hd), k/v (B,S,KV,hd), kv_len (B,) int32, o (B,H,hd); all
// contiguous on the device.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); no synchronisation.
extern "C" int slot_decode_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* kv_len,
                                         void* o, int dtype, int B, int S,
                                         int KV, int H, int hd, float scale,
                                         void* stream) {
  const long long ps = (long long)KV * hd;  // position stride of the pool
  return dattn::run(q, k, v, static_cast<const int*>(kv_len), o, dtype, B,
                    S, KV, H, hd, (long long)S * ps, hd, ps, scale,
                    static_cast<cudaStream_t>(stream));
}
