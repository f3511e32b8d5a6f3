// Tall-A TSMM for Hopper (sm_90a): out = f(A @ B) with a tall A (M, K) and a
// skinny B (K, N), N <= 256 in the paper's regime (any multiple of 128 is
// taken).  A is either natural row-major (M, K) or pre-packed block-major
// (nm, nk, bm, bk); B is natural (K, N).
//
// Replaces the TPU kernels of the reference package's tall-A family:
//   kernels/tsmm.py  tsmm_tall_a    (_tall_a_kernel; natural A, baseline)
//   kernels/tsmm.py  tsmm_packed_a  (_packed_a_kernel; packed A, baseline)
//   kernels/gen.py   _tall_kinner   (B resident / acc=revisit)
//   kernels/gen.py   _tall_ksplit   (k-split fp32 partial sums)
//   kernels/gen.py   _tall_kouter   (single-k-slice passes into an fp32
//                                    accumulator; nk launches per call)
// One kernel serves all five: dtype (f32, bf16) x A layout (natural,
// packed) x output mode:
//   mode 0  cast epilogue: bias in fp32, then relu / silu / tanh-gelu on
//           the fp32 sum, then one cast (kernels/tsmm.py::_epilogue of the
//           reference).  With no bias and no activation it is the raw cast
//           output of the epi=split points;
//   mode 1  raw fp32 sums, one (M, N) slab per k-split (the k-split
//           partials the caller reduces);
//   mode 2  accumulate into an fp32 (M, N) output: out = out + A@B over the
//           launch's k range, then bias and activation if given, stored in
//           fp32.  acc=revisit is one launch over all of K into a zeroed
//           output with the epilogue; loop=kouter is one launch per k block
//           with no epilogue (the caller's cast pass applies it), so each
//           launch reads and writes the fp32 (M, N) accumulator as the
//           cost model prices it.
// The k range of a launch is [kbeg, kbeg + splits * kps): split z covers
// [kbeg + z*kps, kbeg + (z+1)*kps).
//
// "B resident" (bres=resident) changes only where the TPU kept B.  Here B
// is staged through shared memory in 32-deep k slices whatever the point:
// the whole of B (4096 x 256 bf16 = 2 MB at GLM-4-9B's K/V projections) is
// far above the 227 KB of shared memory a CTA may hold, but far below the
// 50 MB L2, which keeps it on chip across the CTAs that all read it.  Both
// residencies run this same code and give the same result.
//
// m_split (the TPU's leading parallel row-panel axis) has no counterpart
// here: a CUDA grid already spreads the row tiles over every SM.
//
// What bounds it.  At GLM-4-9B's prefill shape (M, K, N) = (2048, 4096,
// 256) in bf16 the function moves ~20 MB (A once, B once, the output once)
// and does 4.3 GFLOP: ~6 us of HBM time against ~4.3 us of bf16
// tensor-core time, so the bound is the bytes.  This first kernel is the
// simple one and runs far from that bound: a SIMT tiled GEMM (fp32 FMA on
// CUDA cores, no wgmma/mma, no TMA).  Its design choices:
//   * a CTA owns BM rows and the whole skinny width (NT = 256, or 128 when
//     N is not a multiple of 256), as the paper's GEBB keeps the whole B
//     panel: A is read from HBM exactly once;
//   * the CTA tile over M is the kernel's own choice, not the plan's bm
//     (the H100 plan at M = 2048 is one 2048-row panel): the largest of
//     BM = 64, 32, 16 that still gives at least one CTA per SM, so M = 2048
//     runs 128 CTAs of 16 rows instead of 32 CTAs of 64;
//   * 256 threads as 8 row groups x 32 column groups, each thread TM x TN
//     outputs (TM = BM/8, TN = NT/32); A and B k slices staged in shared
//     memory as fp32 (A transposed, so a warp's TM row values are
//     broadcasts and B's TN values two float4 loads);
//   * ragged rows and k ranges are masked; the packed layout is addressed
//     per element (its (bm, bk) is the layout, not the tile).

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
enum { MODE_EPILOGUE = 0, MODE_PARTIAL = 1, MODE_ACCUM = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v * (1.f / (1.f + expf(-v)));
  if (act == ACT_GELU)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

// A(row, k): natural (M, K) row-major, or packed block-major (nm, nk, pbm,
// pbk) with each (pbm, pbk) block row-major.
template <typename T>
__device__ __forceinline__ float a_at(const T* a, int row, int k, int K, int packed, int pbm,
                                      int pbk) {
  if (!packed) return to_f(a[(size_t)row * K + k]);
  const int ib = row / pbm, kb = k / pbk;
  const int nk = K / pbk;
  return to_f(a[(((size_t)ib * nk + kb) * pbm + (row - ib * pbm)) * pbk + (k - kb * pbk)]);
}

constexpr int KT = 32;            // k depth of one shared-memory stage
constexpr int TY = 8, TX = 32;    // thread grid: 8 row groups x 32 column groups
constexpr int THREADS = TY * TX;

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
tall_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ bias,
            void* __restrict__ out, int M, int K, int N, int packed, int pbm, int pbk,
            int kbeg, int kps, int splits, int mode, int act) {
  constexpr int BM = TM * TY;       // rows of the CTA tile
  constexpr int NT = TN * TX;       // columns of the CTA tile
  __shared__ __align__(16) float as[KT][BM + 1];
  __shared__ __align__(16) float bs[KT][NT];

  const int split = blockIdx.z;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * NT;
  const int k0 = kbeg + split * kps, k1 = k0 + kps;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = k0; kt < k1; kt += KT) {
    // A slice: BM x KT, one warp per row, lanes along k (coalesced).
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / KT, kk = e % KT;
      const int row = r0 + r, k = kt + kk;
      as[kk][r] = (row < M && k < k1) ? a_at(a, row, k, K, packed, pbm, pbk) : 0.f;
    }
    // B slice: KT x NT, two adjacent columns per thread (coalesced rows).
#pragma unroll
    for (int i = 0; i < KT * NT / 2 / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int kk = e / (NT / 2), c = 2 * (e % (NT / 2));
      const int k = kt + kk;
      float v0 = 0.f, v1 = 0.f;
      if (k < k1) load2(b + (size_t)k * N + n0 + c, v0, v1);
      *reinterpret_cast<float2*>(&bs[kk][c]) = make_float2(v0, v1);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&bs[kk][tx * TN + j]);
        bv[j] = v.x;
        bv[j + 1] = v.y;
        bv[j + 2] = v.z;
        bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      float v = acc[i][j];
      if (mode == MODE_PARTIAL) {
        static_cast<float*>(out)[((size_t)split * M + row) * N + col] = v;
        continue;
      }
      if (mode == MODE_ACCUM) v += static_cast<const float*>(out)[(size_t)row * N + col];
      if (bias != nullptr) v += to_f(bias[col]);
      v = activate(v, act);
      if (mode == MODE_ACCUM)
        static_cast<float*>(out)[(size_t)row * N + col] = v;
      else
        static_cast<T*>(out)[(size_t)row * N + col] = from_f<T>(v);
    }
  }
}

template <typename T, int TM, int TN>
cudaError_t launch_tile(const void* a, const void* b, const void* bias, void* out, int M,
                        int K, int N, int packed, int pbm, int pbk, int kbeg, int kps,
                        int splits, int mode, int act, cudaStream_t stream) {
  constexpr int BM = TM * TY, NT = TN * TX;
  dim3 grid((M + BM - 1) / BM, N / NT, splits);
  tall_kernel<T, TM, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(bias), out, M,
      K, N, packed, pbm, pbk, kbeg, kps, splits, mode, act);
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t launch_rows(const void* a, const void* b, const void* bias, void* out, int M,
                        int K, int N, int packed, int pbm, int pbk, int kbeg, int kps,
                        int splits, int sms, int mode, int act, cudaStream_t stream) {
  // the largest row tile that still gives every SM a CTA
  const long long cols = (long long)(N / (TN * TX)) * splits;
  if ((long long)((M + 63) / 64) * cols >= sms)
    return launch_tile<T, 8, TN>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps,
                                 splits, mode, act, stream);
  if ((long long)((M + 31) / 32) * cols >= sms)
    return launch_tile<T, 4, TN>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps,
                                 splits, mode, act, stream);
  return launch_tile<T, 2, TN>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                               mode, act, stream);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* bias, void* out, int M, int K,
                   int N, int packed, int pbm, int pbk, int kbeg, int kps, int splits,
                   int sms, int mode, int act, cudaStream_t stream) {
  if (N % 256 == 0)
    return launch_rows<T, 8>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                             sms, mode, act, stream);
  return launch_rows<T, 4>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                           sms, mode, act, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  M, K: A's logical (padded) dims; for a
// packed A, M = nm * pbm and K = nk * pbk.  N must be a multiple of 128
// (the wrapper pads it).  The launch covers k in [kbeg, kbeg + splits*kps),
// within [0, K); with splits > 1 only mode 1 is meaningful.  sms: the
// card's SM count (the caller reads it once), which picks the row tile.
// Returns cudaGetLastError() after the launch (non-zero: the launch was
// refused).
extern "C" int tsmm_tall_launch(const void* a, const void* b, const void* bias, void* out,
                                int M, int K, int N, int packed, int pbm, int pbk, int kbeg,
                                int kps, int splits, int sms, int mode, int act,
                                int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 128 != 0 || kbeg < 0 || kps <= 0 || splits <= 0 ||
      sms <= 0 || (long long)kbeg + (long long)splits * kps > K || mode < 0 || mode > 2 ||
      act < 0 || act > 3 || (splits > 1 && mode != MODE_PARTIAL))
    return (int)cudaErrorInvalidValue;
  if (packed && (pbm <= 0 || pbk <= 0 || M % pbm != 0 || K % pbk != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                              sms, mode, act, s)
      : launch<float>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits, sms,
                      mode, act, s);
  return (int)err;
}
