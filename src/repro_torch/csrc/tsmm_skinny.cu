// Skinny-A TSMM for Hopper (sm_90a): out = epilogue(X @ W) with a skinny
// X (m, K) and a wide weight W that is either pre-packed block-major
// (nk, nn, bk, bn) or in its natural (K, N) layout.
//
// Replaces the TPU kernels of the reference package's skinny-A family:
//   kernels/tsmm.py  tsmm_skinny_a   (_skinny_a_kernel; the baseline point)
//   kernels/gen.py   _skinny_kinner  (natural W / resident X / acc=revisit /
//                                     epi=split grammar points)
//   kernels/gen.py   _skinny_ksplit  (k-split fp32 partial sums)
// One kernel serves all three: dtype (f32, bf16) x W layout (packed,
// natural) x k-splits (grid z) x output mode:
//   mode 0  cast epilogue: bias in fp32, then relu / silu / tanh-gelu on
//           the fp32 sum, then one cast (kernels/tsmm.py::_epilogue).
//           With no bias and no activation it is the raw cast output of
//           epi=split points, whose caller runs the bias/activation pass
//           on the cast result;
//   mode 1  raw fp32 sums, one (m, N) slab per split (acc=revisit, and
//           the k-split partials the caller reduces).
// "X resident" (bres=resident) changes only where the TPU kept X; here X
// is always staged through shared memory in k chunks and the 50 MB L2
// keeps the whole X panel on chip across CTAs, so both residencies run
// this same code and give the same result.
//
// What bounds it.  At decode (m <= 8) the work is ~2 flops per weight
// byte, far below the H100's ridge (~295 flop/byte in bf16): the bound is
// the weight bytes over HBM bandwidth (3.35 TB/s).  At prefill (m = b*S,
// hundreds to thousands of rows) it is the flops over the tensor-core
// rate.  The design is the simple one:
//   * small m (<= 8 rows): a CTA owns 64 output columns and one k range;
//     its 8 warps stride over that range, each lane reading 2 adjacent
//     columns of one W row per step (coalesced rows of 64 elements), with
//     X broadcast from shared memory; the warps' partial sums are reduced
//     in shared memory before the epilogue.  No cp.async/TMA pipeline and
//     one CTA per 64 columns, so a 2560-wide projection fills only 40 SMs:
//     it does not reach the bandwidth bound.
//   * large m: a classic SIMT tiled GEMM (64x64 CTA tile, 16-deep k tiles
//     staged in shared memory as fp32, 4x4 outputs per thread).  It uses
//     no tensor cores (no wgmma/mma), so it runs far below the bf16 peak.
// Both accumulate in fp32.  The packed (bk, bn) block is the weight's
// layout, not the CTA tile: a 64-column CTA tile always lies inside one
// block column because bn is a multiple of 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __bfloat162float(v.x);
  b = __bfloat162float(v.y);
}

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v * (1.f / (1.f + expf(-v)));
  if (act == ACT_GELU)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

// Write one output element in the requested mode.
template <typename T>
__device__ __forceinline__ void store_out(void* out, const T* bias, float v, int row,
                                          int col, int m, int N, int split, int mode,
                                          int act) {
  if (mode == 1) {
    static_cast<float*>(out)[((size_t)split * m + row) * N + col] = v;
    return;
  }
  if (mode == 0) {
    if (bias != nullptr) v += to_f(bias[col]);
    v = activate(v, act);
  }
  static_cast<T*>(out)[(size_t)row * N + col] = from_f<T>(v);
}

// Address of W(k, col): natural (K, N) row-major, or packed block-major
// (nk, nn, bk, bn) with each (bk, bn) block row-major.
template <typename T>
__device__ __forceinline__ const T* w_at(const T* w, int k, int col, int N, int bk,
                                         int bn, int natural) {
  if (natural) return w + (size_t)k * N + col;
  int nn = N / bn;
  int kb = k / bk, nb = col / bn;
  return w + (((size_t)kb * nn + nb) * bk + (k - kb * bk)) * bn + (col - nb * bn);
}

constexpr int SM_MT = 8, SM_NT = 64, SM_KC = 512, SM_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(256)
skinny_small(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
             void* __restrict__ out, int m, int K, int N, int ldx, int bk, int bn,
             int natural, int kps, int mode, int act) {
  __shared__ float xs[SM_MT][SM_KC];
  __shared__ float red[SM_WARPS][SM_MT][SM_NT];
  const int n0 = blockIdx.x * SM_NT;
  const int r0 = blockIdx.y * SM_MT;
  const int split = blockIdx.z;
  const int kbeg = split * kps, kend = kbeg + kps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = n0 + 2 * lane;
  float acc[SM_MT][2];
#pragma unroll
  for (int r = 0; r < SM_MT; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int kc = kbeg; kc < kend; kc += SM_KC) {
    const int klen = min(SM_KC, kend - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < SM_MT * SM_KC; i += blockDim.x) {
      const int r = i / SM_KC, kk = i - r * SM_KC;
      float v = 0.f;
      if (r0 + r < m && kk < klen) v = to_f(x[(size_t)(r0 + r) * ldx + kc + kk]);
      xs[r][kk] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = warp; kk < klen; kk += SM_WARPS) {
      float w0, w1;
      load2(w_at(w, kc + kk, col, N, bk, bn, natural), w0, w1);
#pragma unroll
      for (int r = 0; r < SM_MT; ++r) {
        const float xv = xs[r][kk];
        acc[r][0] = fmaf(xv, w0, acc[r][0]);
        acc[r][1] = fmaf(xv, w1, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SM_MT; ++r) {
    red[warp][r][2 * lane] = acc[r][0];
    red[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SM_MT * SM_NT; i += blockDim.x) {
    const int r = i / SM_NT, c = i - r * SM_NT;
    if (r0 + r >= m) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < SM_WARPS; ++wi) v += red[wi][r][c];
    store_out<T>(out, bias, v, r0 + r, n0 + c, m, N, split, mode, act);
  }
}

constexpr int LG_MT = 64, LG_NT = 64, LG_KT = 16;

template <typename T>
__global__ void __launch_bounds__(256)
skinny_large(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
             void* __restrict__ out, int m, int K, int N, int ldx, int bk, int bn,
             int natural, int kps, int mode, int act) {
  __shared__ __align__(16) float xs[LG_KT][LG_MT + 4];
  __shared__ __align__(16) float ws[LG_KT][LG_NT + 4];
  const int n0 = blockIdx.x * LG_NT;
  const int r0 = blockIdx.y * LG_MT;
  const int split = blockIdx.z;
  const int kbeg = split * kps, kend = kbeg + kps;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = kbeg; kt < kend; kt += LG_KT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + 256 * i;
      const int r = idx / LG_KT, kk = idx - r * LG_KT;
      float v = 0.f;
      if (r0 + r < m && kt + kk < kend) v = to_f(x[(size_t)(r0 + r) * ldx + kt + kk]);
      xs[kk][r] = v;
      const int wk = idx / LG_NT, c = idx - wk * LG_NT;
      float wv = 0.f;
      if (kt + wk < kend) wv = to_f(*w_at(w, kt + wk, n0 + c, N, bk, bn, natural));
      ws[wk][c] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < LG_KT; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_out<T>(out, bias, acc[i][j], row, n0 + tx * 4 + j, m, N, split, mode, act);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int m, int K,
                   int N, int ldx, int bk, int bn, int natural, int splits, int mode,
                   int act, cudaStream_t stream) {
  const int kps = K / splits;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  if (m <= SM_MT) {
    dim3 grid(N / SM_NT, 1, splits);
    skinny_small<T><<<grid, 256, 0, stream>>>(xp, wp, bp, out, m, K, N, ldx, bk, bn,
                                               natural, kps, mode, act);
  } else {
    dim3 grid(N / LG_NT, (m + LG_MT - 1) / LG_MT, splits);
    skinny_large<T><<<grid, 256, 0, stream>>>(xp, wp, bp, out, m, K, N, ldx, bk, bn,
                                               natural, kps, mode, act);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  K must split evenly into `splits`
// ranges, N must be a multiple of 64 (the wrapper pads it to bn), and for a
// natural W, N is its row stride.  Returns cudaGetLastError() after the
// launch (non-zero: the launch was refused).
extern "C" int tsmm_skinny_launch(const void* x, const void* w, const void* bias, void* out,
                                  int m, int K, int N, int ldx, int bk, int bn, int natural,
                                  int splits, int mode, int act, int dtype, void* stream) {
  if (m <= 0 || K <= 0 || N <= 0 || splits <= 0 || K % splits != 0 || N % 64 != 0 ||
      bk <= 0 || bn <= 0 || N % bn != 0 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, w, bias, out, m, K, N, ldx, bk, bn, natural, splits, mode,
                              act, s)
      : launch<float>(x, w, bias, out, m, K, N, ldx, bk, bn, natural, splits, mode, act, s);
  return (int)err;
}
