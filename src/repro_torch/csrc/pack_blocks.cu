// Block-major pre-pack for Hopper (sm_90a): (L, M, K) -> (L, nm, nk, bm, bk),
// zero-padded to block multiples, alpha folded in (fp32 multiply, cast
// back).  L stacked matrices (a layer-stacked weight) pack independently.
//
// Replaces the TPU kernel kernels/tsmm.py::pack_blocks_kernel
// (_pack_kernel) of the reference package: the paper's PACKA as a
// streaming re-tile.  Unlike the TPU kernel it takes any M and K and
// writes the zero padding itself, so the caller never materialises a
// padded copy of the operand first.  With alpha = 1 every element is a
// bit copy of its source (or a +0.0 pad), so the result is bit-equal to
// the plain reshape/transpose.
//
// What bounds it.  It does no arithmetic to speak of: the bound is reading
// the operand once and writing the packed copy once over HBM bandwidth.
// Design: one CTA per (bm, bk) output block (grid x) and stacked matrix
// (grid y); its threads walk the block in output order, so writes are
// fully contiguous and each source row segment of bk elements is read
// contiguously.  Only the block coordinates take a division per CTA; the
// per-element index is one division by bk.

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

template <typename T>
__global__ void __launch_bounds__(256)
pack_kernel(const T* __restrict__ a, T* __restrict__ out, int M, int K, int nk, int bm,
            int bk, float alpha, int scale) {
  const int blk = blockIdx.x;
  const int ib = blk / nk, kb = blk - ib * nk;
  const size_t mat = blockIdx.y;
  const int nm = gridDim.x / nk;
  const T* src = a + mat * (size_t)M * K;
  T* dst = out + (mat * nm * nk + blk) * (size_t)bm * bk;
  const int row0 = ib * bm, col0 = kb * bk;
  const int elems = bm * bk;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / bk, c = e - r * bk;
    const int row = row0 + r, col = col0 + c;
    T v = from_f<T>(0.f);
    if (row < M && col < K) v = src[(size_t)row * K + col];
    if (scale) v = from_f<T>(to_f(v) * alpha);
    dst[e] = v;
  }
}

template <typename T>
cudaError_t launch(const void* a, void* out, int L, int M, int K, int bm, int bk, float alpha,
                   cudaStream_t stream) {
  const int nm = (M + bm - 1) / bm, nk = (K + bk - 1) / bk;
  dim3 grid(nm * nk, L);
  pack_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(a), static_cast<T*>(out), M,
                                           K, nk, bm, bk, alpha, alpha != 1.f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a: L contiguous (M, K) matrices; out:
// L contiguous (nm, nk, bm, bk) blocks with nm = ceil(M / bm), nk =
// ceil(K / bk).  Returns cudaGetLastError() after the launch (non-zero:
// the launch was refused, or the sizes are out of range).
extern "C" int pack_blocks_launch(const void* a, void* out, int L, int M, int K, int bm,
                                  int bk, float alpha, int dtype, void* stream) {
  if (L <= 0 || L > 65535 || M <= 0 || K <= 0 || bm <= 0 || bk <= 0 ||
      (long long)bm * bk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((M + bm - 1) / bm) * ((K + bk - 1) / bk);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(a, out, L, M, K, bm, bk, alpha, s)
      : launch<float>(a, out, L, M, K, bm, bk, alpha, s);
  return (int)err;
}
