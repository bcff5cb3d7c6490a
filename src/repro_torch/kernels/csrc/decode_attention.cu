// One-query decode attention over a head-major KV cache, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py :: decode_attention
//           (Pallas TPU kernel `_kernel`, cache-block picker `_pick_bk`).
//
// q (B,H,hd) contiguous; k/v (B,KV,S,hd) read through element strides for
// B, KV and S with hd contiguous: a contiguous head-major cache, or the
// serve pool's (B,S,KV,hd) layer cache as its transpose(1, 2) view, with
// no copy.  kv_len (B,) int32, 0 for exact zeros.  The function, the
// bound on the H100 (bytes) and the split-cache design are described in
// decode_attention.cuh, which slot_decode_attention.cu shares.
#include "decode_attention.cuh"

// q (B,H,hd) contiguous; k/v (B,KV,S,hd) at element strides (sb, skv, ss)
// with hd contiguous, both with the same strides; kv_len (B,) int32; o
// (B,H,hd) contiguous; work: B*KV*nsplit*G*(hd+2) floats when nsplit > 1
// (else unused).  The cache axis is cut into nsplit chunks of `chunk`
// positions (a multiple of 64).  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launches (0 on success); no
// synchronisation.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* o, void* work, int dtype, int B,
                                    int S, int KV, int H, int hd,
                                    long long sb, long long skv,
                                    long long ss, int chunk, int nsplit,
                                    float scale, void* stream) {
  return dattn::run(q, k, v, static_cast<const int*>(kv_len), o,
                    static_cast<float*>(work), dtype, B, S, KV, H, hd, sb,
                    skv, ss, chunk, nsplit, scale,
                    static_cast<cudaStream_t>(stream));
}
