// Linear-recurrence scan (the RG-LRU core) for sm_90a.
//
// Replaces: src/repro/kernels/rglru_scan.py :: rglru_scan
//           (Pallas TPU kernel `_kernel`).
//
// Computes h_t = a_t * h_{t-1} + b_t over t = 0..S-1 for every (b, w)
// lane, with h_{-1} = h0[b, w] (float32; zeros when h0 is NULL).  a, b
// (B, S, W) and the output h (B, S, W) share float32 or bfloat16; the
// carry is float32.  Each step rounds the product and then the sum
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version's
// two tensor ops do, so float32 results equal it bit for bit, and a frozen
// position (a = 1, b = 0, a padded admission tail) carries h through
// exactly.  Any B, S, W: unlike the TPU grid there is no divisibility
// rule (admission buckets and prompt lengths are ragged).
//
// Bound on the H100: bytes.  a and b are read once and h written once:
// 3 * B * S * W * itemsize bytes for 2 operations per lane and step.
//
// Design: one thread per (b, w) lane walks the sequence; neighbouring
// threads take neighbouring w, so every load and store of a step is
// coalesced across the warp.  The recurrence is sequential in t, but
// the loads are not: each thread loads UNR steps of a and b before it
// runs them, which keeps UNR step loads in flight per lane.  (The TPU
// kernel carries h in scratch across sequence blocks of its grid; here
// the loop inside the thread takes that axis.)  B * W lanes (20,480 at
// recurrentgemma-2b's 8 slots) fill the card's 132 SMs only thinly; a
// chunked two-pass scan that also splits S is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int UNR = 8;   // steps loaded ahead

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ o, int B,
                  int S, int W) {
  const long long lane = (long long)blockIdx.x * NT + threadIdx.x;
  if (lane >= (long long)B * W) return;
  const long long bi = lane / W, w = lane - bi * W;
  float h = h0 != nullptr ? h0[lane] : 0.f;
  const long long base = bi * S * W + w;
  int t = 0;
  for (; t + UNR <= S; t += UNR) {
    float av[UNR], bv[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const long long i = base + (long long)(t + u) * W;
      av[u] = to_f(a[i]);
      bv[u] = to_f(b[i]);
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      store(&o[base + (long long)(t + u) * W], h);
    }
  }
  for (; t < S; ++t) {
    const long long i = base + (long long)t * W;
    h = __fadd_rn(__fmul_rn(to_f(a[i]), h), to_f(b[i]));
    store(&o[i], h);
  }
}

}  // namespace

// a, b, o (B,S,W) contiguous, dtype 0 = float32, 1 = bfloat16; h0 (B,W)
// float32 contiguous or NULL.  Returns cudaGetLastError() after the launch
// (0 on success); no synchronisation.
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* o, int dtype, int B, int S, int W,
                              void* stream) {
  if (B < 0 || S < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)B * W;
  if (lanes == 0 || S == 0) return 0;
  const long long blocks = (lanes + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h0);
  if (dtype == 0) {
    rglru_scan_kernel<float><<<(unsigned)blocks, NT, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), hp,
        static_cast<float*>(o), B, S, W);
  } else if (dtype == 1) {
    rglru_scan_kernel<__nv_bfloat16><<<(unsigned)blocks, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), hp,
        static_cast<__nv_bfloat16*>(o), B, S, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
