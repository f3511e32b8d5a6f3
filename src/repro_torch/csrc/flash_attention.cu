// Flash attention for Hopper (sm_90a): causal or full self-attention with
// an online softmax, for prefill.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention
// (_flash_kernel) of the reference package, with its semantics: scores
// q.k^T * D^-0.5 in fp32, masked entries set to NEG_INF = -1e30, running
// max m, sum l and output accumulator kept in fp32, the probabilities
// cast to the input type before the P.V product (as the TPU kernel does),
// output = acc / max(l, 1e-30) cast once.  KV tiles wholly above the
// causal diagonal of a query tile are skipped.
//
// Layout: q (B, Sq, H, D) and k, v (B, Sk, KH, D), read through their
// strides (the last dim contiguous), so the model's (batch, seq, heads,
// dim) tensors need no transpose.  Grouped-query attention reads KV head
// h / (H / KH) for query head h: the KV heads are never repeated in
// memory.  D is 32, 64 or 128.
//
// What bounds it.  At the prefill shapes of the main path (S = 256,
// D = 128) attention is a small share of the flops next to the
// projections; its bound is the flops of QK^T and PV over the tensor-core
// rate.  This first kernel is the simple one: one CTA of 4 warps per
// (batch*head, 16-query tile); 32-key K/V tiles are staged in shared
// memory as fp32; each warp owns 4 query rows, each lane one key of the
// tile for the scores and D/32 output dims for P.V, with warp shuffles for
// the row max and sum.  It uses CUDA cores, not wgmma, and reloads each KV
// tile for every 16 queries, so it stays far from the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 16, BKV = 32, NWARPS = 4, RPW = BQ / NWARPS;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  long long b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int Sq, int Sk, int H, int KH, Strides qs_, Strides ks_,
          Strides vs_, Strides os_, int causal, float scale) {
  constexpr int DPL = D / 32;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BKV][D + 1];
  __shared__ float vs[BKV][D];
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y - (blockIdx.y / H) * H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kh * ks_.h;
  const T* vb = v + b * vs_.b + kh * vs_.h;
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qs[r][d] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * qs_.s + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  int ntiles = (Sk + BKV - 1) / BKV;
  if (causal) ntiles = min(ntiles, (q0 + BQ - 1) / BKV + 1);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const bool ok = k0 + j < Sk;
      ks[j][d] = ok ? to_f(kb[(k0 + j) * ks_.s + d]) : 0.f;
      vs[j][d] = ok ? to_f(vb[(k0 + j) * vs_.s + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qpos = q0 + r;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      s *= scale;
      const int key = k0 + lane;
      if (key >= Sk || (causal && key > qpos)) s = NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      const float pr = to_f(from_f<T>(p));   // P cast to the input type
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(pj, vs[j][lane + 32 * i], acc[rr][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qpos = q0 + warp * RPW + rr;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    T* ob = out + b * os_.b + h * os_.h + qpos * os_.s;
#pragma unroll
    for (int i = 0; i < DPL; ++i) ob[lane + 32 * i] = from_f<T>(acc[rr][i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Sk, int H, int KH, Strides qs_, Strides ks_, Strides vs_,
                   Strides os_, int causal, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T, D><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
                       int Sq, int Sk, int H, int KH, int D, Strides qs_, Strides ks_,
                       Strides vs_, Strides os_, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every tensor is contiguous.  Returns cudaGetLastError() after the
// launch (non-zero: refused, or an unsupported D).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int KH, int D,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      long long osb, long long oss, long long osh,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  Strides qs_{qsb, qss, qsh}, ks_{ksb, kss, ksh}, vs_{vsb, vss, vsh}, os_{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, D, qs_, ks_, vs_, os_, causal, s)
      : dispatch_d<float>(q, k, v, out, B, Sq, Sk, H, KH, D, qs_, ks_, vs_, os_, causal, s);
  return (int)err;
}
