// Causal flash-attention forward (prefill), GQA-aware, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention
//           (Pallas TPU kernel `_kernel`).
//
// Computes  out[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] * hd^-0.5)
//                          @ v[b,h/G,j,:]        (j <= i when causal)
// with q (B,H,S,hd) and k/v (B,KV,S,hd), G = H/KV.  Every tensor is passed
// with its own (batch, head, position) strides and a contiguous last axis,
// so the transformer's head-major view of its (B,S,H,hd) activations needs
// no copy.  float32 and bfloat16 inputs, hd in {64, 128}; the running max,
// denominator and accumulator are float32.  NEG_INF = -1e30 as in the TPU
// kernel, so masked logits underflow to exact zeros after the max shift.
//
// Bound on the H100: operations.  A causal pass does 2*B*H*S^2*hd FLOPs
// (QK^T and PV over the lower triangle) against ~2*B*(H+2KV)*S*hd*itemsize
// bytes, far above the card's ridge point; without tensor cores the roof is
// the 67 TFLOP/s float32 rate.
//
// Design: one block of 256 threads per (b, h, 64-row query tile).  The TPU
// kernel's sequential key-block grid axis becomes a loop inside the block
// over 64-key tiles, stopping at the diagonal (tiles above it are never
// loaded).  Q, K, V and the probability tile live in shared memory as
// float32; each thread owns a 4x4 register tile of the logits (4 query rows
// x 4 keys strided by 16) read with float4 loads from padded rows, and a
// 4 x hd/16 slice of the output accumulator.  The 16 threads that share a
// query row reduce the row max / sum with warp shuffles and share P through
// shared memory with only a warp barrier.  Query tiles are issued heaviest
// first so causal blocks balance across the SMs.  No tensor cores, TMA or
// pipelining yet: this is the simple, correct first version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * (BK + 4));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S,
                 int group, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, float scale, int causal) {
  constexpr int QSTR = HD + 4;  // padding keeps float4 row reads conflict-free
  constexpr int KSTR = HD + 4;
  constexpr int VSTR = HD;
  constexpr int PSTR = BK + 4;
  constexpr int DJ = HD / 64;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QSTR;
  float* Vs = Ks + BK * KSTR;
  float* Ps = Vs + BK * VSTR;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column lane within a row group
  const int ty = tid >> 4;  // row group: query rows ty*4 .. ty*4+3
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * QSTR + d] = s < S ? to_f(qb[s * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DJ; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // Q is loaded; the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool ok = s < S;
      Ks[r * KSTR + d] = ok ? to_f(kb[s * kss + d]) : 0.f;
      Vs[r * VSTR + d] = ok ? to_f(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QSTR + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KSTR + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += a[i].x * bk[j].x + a[i].y * bk[j].y +
                      a[i].z * bk[j].z + a[i].w * bk[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < S && (!causal || kpos <= qpos);
        sc[i][j] = valid ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key 0 is visible to every row, so after the first tile m_new is a
      // real logit and masked entries give exp(-1e30 - m) == 0 exactly
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * PSTR + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DJ; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows of this row group are written by its own lanes

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PSTR + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[c * VSTR + tx * 4 + 64 * jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] += p[i] * vv.x;
          acc[i][jj * 4 + 1] += p[i] * vv.y;
          acc[i][jj * 4 + 2] += p[i] * vv.z;
          acc[i][jj * 4 + 3] += p[i] * vv.w;
        }
      }
    }
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(&ob[s * oss + tx * 4 + 64 * jj + e], acc[i][jj * 4 + e] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, position) for q, k, v, o in that order.  Returns cudaGetLastError()
// after the launch (0 on success); the launch does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KV, int S, int hd,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0) return 0;
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, H, KV, S, strides, scale, causal, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, H, KV, S, strides, scale, causal, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KV, S, strides, scale,
                                     causal, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KV, S, strides,
                                      scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
