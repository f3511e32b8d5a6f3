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
// is staged through shared memory in k slices whatever the point:
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
// tensor-core time, so the bound is the bytes.
//
// bf16: a warp-specialised wgmma kernel (tall_wgmma_kernel).
//   * Tensor cores: one consumer warpgroup issues wgmma m64n128k16 on a
//     64 x 128 tile, A K-major from shared memory, B (K, N) row-major as
//     the MN-major operand.  A 64 x 128 tile's ring of 4 stages takes
//     99 KB, so two CTAs share an SM; a 64 x 256 tile (the whole skinny
//     panel, as the paper's GEBB keeps it) takes one SM per CTA and
//     measured slower at GLM-4-9B's shapes, so the kernel has one column
//     tile.  launch/tall_sweep.py times every (cluster, stages) it takes.
//   * Copies: one producer warp keeps TMA loads of 64-deep k tiles (A:
//     64 rows x 64 k; B: two boxes of 64 columns x 64 k) in flight
//     through a ring of `stages` shared-memory stages with full / empty
//     mbarriers, 128-byte swizzle.
//   * Packed A costs what natural A costs: the (nm, nk, pbm, pbk) array is
//     a 2-D tensor map over its (nm*nk*pbm, pbk) view; each (pbm, pbk)
//     block is contiguous and row-major, so a 64 x 64 tile inside a block
//     is a plain box (the wrapper requires 64 | pbm and 64 | pbk).
//   * Filling 132 SMs: GLM's M = 2048 has only 32 x 2 tiles of 64 x 128, so K
//     is split across a thread-block cluster of `cluster` CTAs (1 to 8,
//     on grid x beside the tile).  Each CTA keeps its fp32 partial in
//     registers; the cluster reduce-scatters the partials through
//     distributed shared memory (each CTA sums one 64/cluster-row slice,
//     in the freed ring, and runs the epilogue on it), so the fp32 sums
//     never leave the chip and no second pass runs.  The alternative, a
//     split-K through an fp32 workspace, writes and rereads cluster x the
//     output in HBM and needs a second launch.
//   * Ragged M: TMA fills rows past M with zeros and the stores are masked.
//     A kouter launch (one 128-deep k block) is a 2-CTA cluster of one
//     k tile each, so it stays cheap.
//
// fp32: the SIMT kernel (tall_kernel): wgmma has no fp32 path and TF32
// would break the card-vs-CPU fp32 parity.  A CTA owns BM rows (64, 32 or
// 16, chosen by the same Python plan) and the whole skinny width; 256
// threads as 8 row groups x 32 column groups, each TM x TN outputs; A and
// B k slices staged in shared memory as fp32; ragged rows and k ranges
// are masked; the packed layout is addressed per element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

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
cudaError_t launch_simt(const void* a, const void* b, const void* bias, void* out, int M,
                        int K, int N, int packed, int pbm, int pbk, int kbeg, int kps,
                        int splits, int mode, int act, cudaStream_t stream) {
  constexpr int BM = TM * TY, NT = TN * TX;
  dim3 grid((M + BM - 1) / BM, N / NT, splits);
  tall_kernel<T, TM, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(bias), out, M,
      K, N, packed, pbm, pbk, kbeg, kps, splits, mode, act);
  return cudaGetLastError();
}

template <int TN>
cudaError_t simt_rows(const void* a, const void* b, const void* bias, void* out, int M, int K,
                      int N, int packed, int pbm, int pbk, int kbeg, int kps, int splits,
                      int bm, int mode, int act, cudaStream_t s) {
  switch (bm) {
    case 64: return launch_simt<float, 8, TN>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg,
                                              kps, splits, mode, act, s);
    case 32: return launch_simt<float, 4, TN>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg,
                                              kps, splits, mode, act, s);
    case 16: return launch_simt<float, 2, TN>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg,
                                              kps, splits, mode, act, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: the wgmma kernel ------------------------------------------------

constexpr int WBM = 64;                  // rows of a CTA tile (one wgmma M)
constexpr int WNT = 128;                 // columns of a CTA tile (one wgmma N)
constexpr int WBK = 64;                  // k depth of a stage (one 128-byte swizzle row)
constexpr int WTHREADS = 160;            // consumer warpgroup (warps 0-3) + producer warp 4

// The shared-memory layout: a 1024-aligned ring of `stages` (A, B) tiles,
// then a full and an empty mbarrier per stage.  The cluster's reduction
// buffer reuses the drained ring.
constexpr uint32_t A_BYTES = WBM * WBK * 2;
constexpr uint32_t B_BYTES = WBK * WNT * 2;
constexpr uint32_t STAGE = A_BYTES + B_BYTES;              // a multiple of 1024
constexpr int LD = WNT + 8;                                // reduction row stride (floats)
static_assert((size_t)2 * STAGE >= (size_t)WBM * LD * 4, "two stages hold the reduction");
inline size_t ring_bytes(int stages) { return 1024 + (size_t)stages * (STAGE + 16); }

__global__ void __launch_bounds__(WTHREADS, 1)
tall_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __nv_bfloat16* __restrict__ bias, void* __restrict__ out, int M, int N,
                  int packed, int pbm, int pbk, int nkb, int kbeg, int kps, int stages,
                  int cluster, int mode, int act) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw));   // aliases the ring
  const uint32_t bars = base + stages * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  auto stage_a = [&](int s) { return base + s * STAGE; };
  auto stage_b = [&](int s) { return base + s * STAGE + A_BYTES; };

  // grid x: (row tile, column tile, cluster rank), the rank fastest and
  // the column tiles of one row tile next, so they share A through L2
  const int rank = (int)hopper::cluster_rank();
  const int tile = blockIdx.x / cluster, ntn = N / WNT;
  const int r0 = (tile / ntn) * WBM;
  const int n0 = (tile % ntn) * WNT;
  const int split = blockIdx.z;
  const int ktiles = kps / (WBK * cluster);
  const int kstart = kbeg + split * kps + rank * ktiles * WBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float acc[WNT / 2];
#pragma unroll
  for (int i = 0; i < WNT / 2; ++i) acc[i] = 0.f;

  if (warp == 4) {
    // producer: one thread issues every TMA load
    if (lane == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(empty(s), ((t / stages) - 1) & 1);
        hopper::mbar_expect_tx(full(s), STAGE);
        const int k = kstart + t * WBK;
        int arow = r0, acol = k;
        if (packed) {
          const int ib = r0 / pbm, kb = k / pbk;
          arow = (ib * nkb + kb) * pbm + (r0 - ib * pbm);
          acol = k - kb * pbk;
        }
        hopper::tma_load_2d(stage_a(s), &amap, full(s), acol, arow);
#pragma unroll
        for (int j = 0; j < WNT / 64; ++j)
          hopper::tma_load_2d(stage_b(s) + j * WBK * 128, &bmap, full(s), n0 + 64 * j, k);
      }
    }
  } else {
    // consumer warpgroup: wgmma over each arrived stage, one group in flight
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % stages;
      hopper::mbar_wait(full(s), (t / stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(stage_a(s) + 32 * kk, 16, 1024);
        const uint64_t db = hopper::desc_sw128(stage_b(s) + 2048 * kk, WBK * 128, 1024);
        hopper::wgmma_ss_n128_t1(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (t > 0) hopper::mbar_arrive(empty((t - 1) % stages));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }

  // Reduce-scatter over the cluster through distributed shared memory: CTA
  // q owns rows [q*R, (q+1)*R) of the tile and receives every CTA's partial
  // of them in slot (sender rank) of its buffer red[cluster][R][LD].  A
  // lane pair of a quad swaps halves first, so each lane stores 4
  // consecutive columns of one row (even lanes row_a, odd lanes row_a + 8).
  const int R = WBM / cluster;
  __syncwarp();
  if (cluster > 1) hopper::cluster_sync(); else __syncthreads();   // rings drained
  if (warp < 4) {
    const int quad = lane % 4, odd = quad & 1;
    const int row = 16 * warp + lane / 4 + 8 * odd;
    const int dst = row / R, lr = row - dst * R;
    const uint32_t slot = hopper::smem_u32(red + ((size_t)rank * R + lr) * LD);
    const uint32_t to = cluster > 1 ? hopper::map_rank(slot, dst) : slot;
#pragma unroll
    for (int j = 0; j < WNT / 8; ++j) {
      const float k0 = odd ? acc[4 * j + 2] : acc[4 * j];
      const float k1 = odd ? acc[4 * j + 3] : acc[4 * j + 1];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
      const uint32_t at = to + 4 * (8 * j + 2 * (quad & 2));
      if (odd)
        hopper::st_cluster_f32x4(at, s0, s1, k0, k1);
      else
        hopper::st_cluster_f32x4(at, k0, k1, s0, s1);
    }
  }
  if (cluster > 1) hopper::cluster_sync(); else __syncthreads();   // partials landed

  // epilogue on this CTA's R rows: each thread owns 4 columns (its bias
  // read once) and walks rows
  constexpr int G = WNT / 4;
  constexpr int LANES = WTHREADS / G;
  if (threadIdx.x >= LANES * G) return;
  const int c4 = 4 * (threadIdx.x % G);
  const int col = n0 + c4;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr && mode != MODE_PARTIAL) {
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = __bfloat162float(bias[col + i]);
  }
  for (int lr = threadIdx.x / G; lr < R; lr += LANES) {
    const int row = r0 + rank * R + lr;
    if (row >= M) break;
    float4 v = *reinterpret_cast<const float4*>(red + (size_t)lr * LD + c4);
    for (int q = 1; q < cluster; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(red + ((size_t)q * R + lr) * LD + c4);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    if (mode == MODE_PARTIAL) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + ((size_t)split * M + row) * N + col) = v;
      continue;
    }
    float r[4] = {v.x, v.y, v.z, v.w};
    float* accum = static_cast<float*>(out) + (size_t)row * N + col;
    if (mode == MODE_ACCUM) {
      const float4 o = *reinterpret_cast<const float4*>(accum);
      r[0] += o.x;
      r[1] += o.y;
      r[2] += o.z;
      r[3] += o.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = activate(r[i] + bv[i], act);
    if (mode == MODE_ACCUM) {
      *reinterpret_cast<float4*>(accum) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
          static_cast<__nv_bfloat16*>(out) + (size_t)row * N + col);
      o2[0] = __floats2bfloat162_rn(r[0], r[1]);
      o2[1] = __floats2bfloat162_rn(r[2], r[3]);
    }
  }
}

cudaError_t launch_wgmma(const void* a, const void* b, const void* bias, void* out, int M,
                         int K, int N, int packed, int pbm, int pbk, int kbeg, int kps,
                         int splits, int cluster, int stages, int mode, int act,
                         cudaStream_t stream) {
  if (stages < 2 || ring_bytes(stages) > 232448) return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  const uint32_t box[2] = {WBK, WBM};
  bool ok;
  if (packed) {
    const uint64_t dims[2] = {(uint64_t)pbk, (uint64_t)(M / pbm) * (K / pbk) * pbm};
    const uint64_t strides[1] = {(uint64_t)pbk * 2};
    ok = hopper::make_map(&amap, a, 2, dims, strides, box);
  } else {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)K * 2};
    ok = hopper::make_map(&amap, a, 2, dims, strides, box);
  }
  const uint64_t bdims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t bstrides[1] = {(uint64_t)N * 2};
  const uint32_t bbox[2] = {64, WBK};
  ok = ok && hopper::make_map(&bmap, b, 2, bdims, bstrides, bbox);
  if (!ok) return cudaErrorInvalidValue;
  // the opt-in shared memory, raised once to the most any plan takes, and
  // the L1 / shared split set to all shared, so two 99 KB CTAs fit an SM
  static const cudaError_t raised = [] {
    cudaError_t e = cudaFuncSetAttribute(tall_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(tall_wgmma_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (raised != cudaSuccess) return raised;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + WBM - 1) / WBM) * (N / WNT) * cluster, 1, splits);
  cfg.blockDim = dim3(WTHREADS);
  cfg.dynamicSmemBytes = ring_bytes(stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tall_wgmma_kernel, amap, bmap, static_cast<const __nv_bfloat16*>(bias),
      out, M, N, packed, pbm, pbk, packed ? K / pbk : 0, kbeg, kps, stages, cluster, mode, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  M, K: A's logical (padded) dims; for a
// packed A, M = nm * pbm and K = nk * pbk.  N must be a multiple of nt
// (fp32: 256 or 128; bf16: 128; the wrapper pads N to 128).  The launch
// covers k in [kbeg, kbeg + splits*kps), within [0, K); with splits > 1
// only mode 1 is meaningful.  The launch plan comes from the caller
// (kernels/tsmm.py::tall_plan): bm, the CTA row tile (bf16: 64; fp32: 64,
// 32 or 16); nt, the CTA column tile (bf16: 128); cluster, the CTAs that split each
// kps range (bf16 only; kps % (64 * cluster) == 0); stages, the ring depth
// (bf16 only).  bf16 also needs A and B 16-byte aligned, K % 8 == 0 for a
// natural A and 64 | pbm, 64 | pbk for a packed one (TMA boxes), and a
// ring that fits shared memory and holds the cluster's reduction.  Returns
// cudaGetLastError() after the launch (non-zero: refused).
extern "C" int tsmm_tall_launch(const void* a, const void* b, const void* bias, void* out,
                                int M, int K, int N, int packed, int pbm, int pbk, int kbeg,
                                int kps, int splits, int bm, int nt, int cluster, int stages,
                                int mode, int act, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (nt != 128 && nt != 256) || N % nt != 0 || kbeg < 0 ||
      kps <= 0 || splits <= 0 || (long long)kbeg + (long long)splits * kps > K || mode < 0 ||
      mode > 2 || act < 0 || act > 3 || (splits > 1 && mode != MODE_PARTIAL))
    return (int)cudaErrorInvalidValue;
  if (packed && (pbm <= 0 || pbk <= 0 || M % pbm != 0 || K % pbk != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (bm != WBM || nt != WNT || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
        kps % (WBK * cluster) != 0 || ((uintptr_t)a | (uintptr_t)b) % 16 != 0 ||
        (packed ? (pbm % WBM != 0 || pbk % WBK != 0) : K % 8 != 0))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                             cluster, stages, mode, act, s);
  }
  if (dtype != 0 || cluster != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = nt == 256
      ? simt_rows<8>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits, bm, mode,
                     act, s)
      : simt_rows<4>(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits, bm, mode,
                     act, s);
  return (int)err;
}
