// Mango's rank-1 growth sandwich  Y[n] = A_I^T . X[n] . A_O,  for sm_90a.
//
// Replaces: src/repro/kernels/tr_sandwich.py:41 :: tr_sandwich (Pallas TPU
//           kernel `_kernel`), the two large mode products of the TR-MPO
//           contraction (paper Eq. 6) fused so that the intermediate
//           T = X[n] . A_O never goes to device memory.
//
// Shapes: x (N, D1i, D1o), a_i (D1i, D2i), a_o (D1o, D2o), y (N, D2i, D2o),
// all row-major and contiguous; float32 or bfloat16 (one dtype for all
// four), float32 sums, output rounded to the input dtype.  No divisibility
// rule: every ragged edge is masked.
//
// Bound on the H100: operations.  At the growth path's shape (gpt-small ->
// gpt-base: N = 144, 512 -> 768) the work is 2 N (D1i D1o D2o + D1i D2i D2o)
// = 144.95 GFLOP, 2.16 ms at 67 TFLOP/s (float32 outside the tensor cores),
// against 0.147 ms to move its 494 MB.  This kernel does exactly that many
// FLOPs (plus the zero rows that pad D1i to a multiple of 16): unlike the
// TPU kernel, which recomputes T for every TI-row tile of Y (D2i/TI times
// the first product), T is computed once per (n, column tile).
//
// Design: one block of 256 threads per (TO = 32 columns of Y, n).
//   phase 1  T[:, tile] = X[n] . A_O[:, tile]  (D1i x 32 floats) is built in
//            dynamic shared memory (64 KB at D1i = 512), 256 rows at a time
//            from 16-deep tiles of X and A_O staged in shared memory;
//   phase 2  Y[n][:, tile] = A_I^T . T, streaming A_I in 16-row chunks
//            and reading T straight from shared memory.
// Each thread keeps an 8 x 4 register tile of sums, fed by float4 shared
// loads: 32 FMAs per 3 vector loads.  The next 16-deep tile is loaded into
// registers while the current one is multiplied, so device-memory and L2
// latency hide behind the FMAs.  The column tile is the fast grid axis,
// so the blocks that read one X[n] run together and X comes from device
// memory about once.  CUDA-core FMAs; tensor cores (wgmma) fed by TMA are
// the next step.  A block needs
// (ceil16(D1i) x 32 + 16 x 260 + 16 x 32) x 4 bytes of shared memory, at
// most the 227 KB a block may use (D1i <= 1664); the wrapper raises beyond.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int TM = 8, TN = 4;     // register tile of one thread
constexpr int TO = 32;            // columns of Y per block (8 threads x TN)
constexpr int BM = NT / (TO / TN) * TM;  // rows per output chunk: 256
constexpr int BK = 16;            // contraction depth per shared step
constexpr int AS = BM + 4;        // padded row of the staged A tile
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use
static_assert(BM == NT && BK == 16 && TO == 32, "the loaders' index maps");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc[i][j] += sum_kk As[kk][ty*TM + i] * Bs[kk][tx*TN + j] over one BK step
// (As rows of stride AS, Bs rows of stride TO)
__device__ __forceinline__ void fma_step(const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         int ty, int tx, float (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * AS + ty * TM);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * AS + ty * TM + 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + kk * TO + tx * TN);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
tr_sandwich_kernel(const T* __restrict__ x, const T* __restrict__ a_i,
                   const T* __restrict__ a_o, T* __restrict__ y, int d1i,
                   int d1o, int d2i, int d2o) {
  extern __shared__ float4 smem4[];
  const int d1k = (d1i + BK - 1) / BK * BK;
  float* Ts = reinterpret_cast<float*>(smem4);  // [d1k][TO]
  float* As = Ts + d1k * TO;                    // [BK][AS]
  float* Bs = As + BK * AS;                     // [BK][TO]

  const int o0 = blockIdx.x * TO;
  const long long n = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % (TO / TN), ty = tid / (TO / TN);
  float acc[TM][TN];
  // the next tile's values, loaded into registers while the current tile
  // is multiplied (BK * BM / NT = 16 of A and BK * TO / NT = 2 of B)
  constexpr int RA = BK * BM / NT, RB = BK * TO / NT;
  float ra[RA], rb[RB];

  // phase 1: Ts = X[n] . A_O[:, o0:o0+TO]; rows d1i..d1k-1 come out zero.
  // Thread tid loads X rows m0 + tid/BK + 16 i at column k0 + tid%BK, and
  // A_O rows k0 + tid/TO + 8 i at column o0 + tid%TO.
  const int kx = tid % BK, mx = tid / BK;
  const int kb = tid / TO, cb = tid % TO;
  const bool cb_in = o0 + cb < d2o;
  const T* xn = x + n * d1i * d1o;
  const T* aob = a_o + (long long)kb * d2o + o0 + cb;
  auto load_x = [&](int m0, int k0) {
    const bool k_in = k0 + kx < d1o;
    const T* p = xn + (long long)(m0 + mx) * d1o + k0 + kx;
#pragma unroll
    for (int i = 0; i < RA; ++i)
      ra[i] = k_in && m0 + mx + 16 * i < d1i
                  ? to_f(p[(long long)16 * i * d1o]) : 0.f;
#pragma unroll
    for (int i = 0; i < RB; ++i)
      rb[i] = cb_in && k0 + kb + 8 * i < d1o
                  ? to_f(aob[(long long)(k0 + 8 * i) * d2o]) : 0.f;
  };
  for (int m0 = 0; m0 < d1k; m0 += BM) {
    zero(acc);
    load_x(m0, 0);
    for (int k0 = 0; k0 < d1o; k0 += BK) {
#pragma unroll
      for (int i = 0; i < RA; ++i) As[kx * AS + mx + 16 * i] = ra[i];
#pragma unroll
      for (int i = 0; i < RB; ++i) Bs[(kb + 8 * i) * TO + cb] = rb[i];
      __syncthreads();
      if (k0 + BK < d1o) load_x(m0, k0 + BK);
      fma_step(As, Bs, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty * TM + i;
      if (r < d1k)
        *reinterpret_cast<float4*>(Ts + r * TO + tx * TN) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();

  // phase 2: Y[n][:, o0:o0+TO] = A_I^T . Ts.  Thread tid loads A_I rows
  // k0 .. k0+15 at column m0 + tid (BM == NT).
  auto load_ai = [&](int m0, int k0) {
    const bool m_in = m0 + tid < d2i;
    const T* p = a_i + (long long)k0 * d2i + m0 + tid;
#pragma unroll
    for (int i = 0; i < RA; ++i)
      ra[i] = m_in && k0 + i < d1i ? to_f(p[(long long)i * d2i]) : 0.f;
  };
  T* yn = y + n * d2i * d2o;
  for (int m0 = 0; m0 < d2i; m0 += BM) {
    zero(acc);
    load_ai(m0, 0);
    for (int k0 = 0; k0 < d1k; k0 += BK) {
#pragma unroll
      for (int i = 0; i < RA; ++i) As[i * AS + tid] = ra[i];
      __syncthreads();
      if (k0 + BK < d1k) load_ai(m0, k0 + BK);
      fma_step(As, Ts + k0 * TO, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty * TM + i;
      if (r >= d2i) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = o0 + tx * TN + j;
        if (c < d2o) store(&yn[(long long)r * d2o + c], acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* a_i, const void* a_o, void* y, int n,
           int d1i, int d1o, int d2i, int d2o, cudaStream_t stream) {
  const int d1k = (d1i + BK - 1) / BK * BK;
  const long long smem =
      ((long long)d1k * TO + BK * AS + BK * TO) * (long long)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tr_sandwich_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d2o + TO - 1) / TO, n);
  tr_sandwich_kernel<T><<<grid, NT, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_i),
      static_cast<const T*>(a_o), static_cast<T*>(y), d1i, d1o, d2i, d2o);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N,D1i,D1o), a_i (D1i,D2i), a_o (D1o,D2o), y (N,D2i,D2o); contiguous on
// the device.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 on success); no synchronisation.
extern "C" int tr_sandwich_fwd(const void* x, const void* a_i,
                               const void* a_o, void* y, int dtype, int n,
                               int d1i, int d1o, int d2i, int d2o,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d2i <= 0 || d2o <= 0) return 0;
  if (d1i <= 0 || d1o <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, a_i, a_o, y, n, d1i, d1o, d2i, d2o, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a_i, a_o, y, n, d1i, d1o, d2i, d2o, st);
  return (int)cudaErrorInvalidValue;
}
