// Tall-A TSMM for Hopper (sm_90a): out = f(A @ B) with a tall A (M, K) and a
// skinny B (K, N), N <= 256 in the paper's regime.  A is either natural
// row-major (M, K) or pre-packed block-major (nm, nk, bm, bk); B is natural
// (K, N).
//
// Replaces the TPU kernels of the reference package's tall-A family:
//   kernels/tsmm.py  tsmm_tall_a    (_tall_a_kernel; natural A, baseline)
//   kernels/tsmm.py  tsmm_packed_a  (_packed_a_kernel; packed A, baseline)
//   kernels/gen.py   _tall_kinner   (B resident / acc=revisit)
//   kernels/gen.py   _tall_ksplit   (k-split fp32 partial sums)
//   kernels/gen.py   _tall_kouter   (single-k-slice passes into an fp32
//                                    accumulator; nk launches per call)
// Three designs serve all five, one for bf16 and two for fp32, chosen by
// the caller's launch plan (kernels/tsmm.py::tall_plan).  Each takes both A
// layouts and every output mode:
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
// tensor-core time, so the bound is the bytes.  At the paper's fp32 shape
// (A 25600 x 25600, 2.62 GB) A's bytes take 0.78 ms at 3.35 TB/s; the
// 2 M K N flops at the 67 TFLOP/s of fp32 FMA take 0.63 ms at N = 32 and
// 4.7 ms at N = 240.  So fp32 FMA is bound by A's bytes below N ~ 32 and
// by its rate above, and fp32 has one design for each side (the crossover
// is launch/tall_sweep.py --dtype float32's: N = 32).
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
// fp32, narrow N (tall_f32_kernel): FMA tiles fed by TMA, for the byte-bound
// side.  No tensor cores, so the sums stay in the card-vs-CPU fp32 parity
// class.
//   * Tiles: a CTA owns bm = 64 or 128 rows and a column tile nt of 8, 16,
//     32 or 64 (N padded by the caller to a multiple of 8, never to 128:
//     at N = 4 a 128-wide tile computed 32x the flops).  Four consumer
//     warps keep 2 x tn fp32 accumulators a thread (tn = nt / (4 x 64 /
//     bm)): lanes along rows, warps over row groups of 64 and column
//     groups.
//   * Copies: one producer warp keeps TMA loads of 32-deep k tiles of A
//     (bm rows of one 128-byte swizzle row each) and of B (32 k x nt,
//     unswizzled) in flight through a ring of `stages` stages with full /
//     empty mbarriers: 4 stages of 16 KB of A at bm = 128 keep 64 KB in
//     flight a CTA, above the ~32 KB (3.35 TB/s x ~1 us over 132 SMs) an
//     SM needs.  A packed A is a 2-D tensor map over its (nm*nk*pbm, pbk)
//     view, as for bf16: no per-element address arithmetic.
//   * Reads: a lane reads its row's 4 k values as one 16-byte access; the
//     swizzle puts the 8 rows of a quarter warp on 8 different 16-byte
//     chunks, so A's reads are free of bank conflicts, and B's row is the
//     same address across the warp (a broadcast).
//
// fp32, wider N (tall_tf32x3_kernel): 3xTF32 on wgmma, for the side bound
// by the FMA rate.  Each operand splits into big = tf32(x) (rounded to
// nearest) and small = tf32(x - big); each k8 step adds small.big,
// big.small and big.big (the small terms first), so a product keeps
// ~2^-21 of relative error, fp32's level, at up to 495 / 3 = 165 TFLOP/s
// against the 67 of FMA.
//   * Tensor cores: one or two consumer warpgroups (bm = 64 or 128 rows),
//     each issuing wgmma m64nNk8 .tf32 over the column tile nt (a multiple
//     of 8 up to 128, so N is padded to 8 only) as n64 pieces and one
//     narrower tail, the layout fixed for the whole k loop; A from
//     registers, B K-major from shared memory.  A producer warpgroup (one
//     thread issues the loads) hands its registers to two of them
//     (setmaxnreg).
//   * Sums: the tensor cores' fp32 accumulation truncates, so over the
//     paper's K = 25600 a wgmma accumulator drifts by ~0.1 at outputs of
//     magnitude ~160 (measured: outside the 1e-2 + 1e-2 |ref| tolerance).
//     Each stage (32 k) starts its wgmma sums afresh and adds them to
//     running sums in registers with round-to-nearest: the truncation then
//     acts on a stage's partial only.  The two sets of sums cap the column
//     tile at 128 (N up to 256 is two tiles, neighbours in launch order so
//     they share A through L2).
//   * B: .tf32 wgmma takes only K-major shared-memory operands, so a pass
//     in this file (tf32_split_kernel, part of the design's launch) writes
//     B^T big and B^T small of the launch's k range to a scratch the
//     caller allocates (2 x N x K fp32: 49 MB at the paper's N = 240, ~20
//     us).  The main kernel's TMA ring loads both 32 k deep.
//   * A: the same TMA tiles as the narrow design; each thread reads its
//     m64k8 fragment from the swizzled tile (free of bank conflicts) and
//     splits it in registers, so A is never copied in device memory.
//   * The ring: (A, B big, B small) stages of 16 KB + 2 x nt x 128 bytes,
//     as deep as 227 KB allows, up to 4.
//
// Both fp32 designs: ragged M and a B narrower than the column tile come
// in as zeros from TMA, and the stores are masked.  The wrapper requires
// N % 4 == 0 and 16-byte aligned operands (TMA strides), a k range in
// whole 32-deep tiles, K % 4 == 0 for a natural A, and 8 | pbm, 32 | pbk
// for a packed one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };
enum { MODE_EPILOGUE = 0, MODE_PARTIAL = 1, MODE_ACCUM = 2 };
enum { DESIGN_WGMMA = 0, DESIGN_F32 = 1, DESIGN_TF32X3 = 2 };

constexpr int SMEM_MAX = 232448;          // opt-in shared memory of one CTA

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v * (1.f / (1.f + expf(-v)));
  if (act == ACT_GELU)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

// ---- fp32: shared by both designs ------------------------------------------

constexpr int FBK = 32;                   // k depth of a stage: 128 bytes of fp32

// The stores of the fp32 designs: W (2 or 4) consecutive fp32 sums `r` of
// one row at `at`, through the output mode's epilogue (`bias` holds the
// columns' bias, zeros without one).
template <int W>
__device__ __forceinline__ void store_f32(float* __restrict__ out, float (&r)[W],
                                          const float (&bias)[W], size_t at, int mode, int act) {
  if (mode != MODE_PARTIAL) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      r[i] = activate(r[i] + (mode == MODE_ACCUM ? out[at + i] : 0.f) + bias[i], act);
  }
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(out + at) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *reinterpret_cast<float2*>(out + at) = make_float2(r[0], r[1]);
}

// The TMA loads of one stage's A tile (bm rows x 32 k, 128-byte swizzle):
// `bm / abox` boxes of abox rows (a packed A's block may be shorter than the
// tile), each at its place in the natural (M, K) or packed (nm*nk*pbm, pbk)
// view.  Rows past M are outside the map and arrive as zeros.
__device__ __forceinline__ void load_a_tile(uint32_t dst, const CUtensorMap* amap, uint32_t bar,
                                            int bm, int abox, int r0, int k, int packed, int pbm,
                                            int pbk, int nkb) {
  for (int h = 0; h < bm; h += abox) {
    int row = r0 + h, col = k;
    if (packed) {
      const int ib = row / pbm, kb = k / pbk;
      row = (ib * nkb + kb) * pbm + (row - ib * pbm);
      col = k - kb * pbk;
    }
    hopper::tma_load_2d(dst + h * 128, amap, bar, col, row);
  }
}

// ---- fp32, narrow N: the FMA kernel ------------------------------------------

constexpr int F_THREADS = 160;            // 4 consumer warps + 1 producer warp

template <int BM, int NT>
__global__ void __launch_bounds__(F_THREADS)
tall_f32_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                const float* __restrict__ bias, float* __restrict__ out, int M, int N, int packed,
                int pbm, int pbk, int nkb, int abox, int kbeg, int kps, int stages, int ncols,
                int mode, int act) {
  constexpr int RG = BM / 64;             // row groups of 64 (32 lanes x 2 rows)
  constexpr int CG = 4 / RG;              // column groups
  constexpr int TN = NT / CG;             // columns a thread
  constexpr int VW = TN % 4 == 0 ? 4 : 2; // floats an access
  constexpr uint32_t A_BYTES = BM * FBK * 4;
  constexpr uint32_t B_BYTES = FBK * NT * 4;
  static_assert(RG * CG == 4 && TN % 2 == 0, "4 consumer warps tile the CTA");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - raw);
  const uint32_t b0 = base + stages * A_BYTES;
  const uint32_t bars = b0 + stages * B_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };

  // grid x: (row tile, column tile), the column tiles of a row tile
  // neighbours so they share A through L2; grid y: the k split
  const int r0 = (blockIdx.x / ncols) * BM;
  const int n0 = (blockIdx.x % ncols) * NT;
  const int split = blockIdx.y;
  const int ktiles = kps / FBK;
  const int kstart = kbeg + split * kps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: one thread issues every TMA load
    if (lane == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(empty(s), ((t / stages) - 1) & 1);
        hopper::mbar_expect_tx(full(s), A_BYTES + B_BYTES);
        const int k = kstart + t * FBK;
        load_a_tile(base + s * A_BYTES, &amap, full(s), BM, abox, r0, k, packed, pbm, pbk, nkb);
        hopper::tma_load_2d(b0 + s * B_BYTES, &bmap, full(s), n0, k);
      }
    }
    return;
  }

  // consumers: rows ra and ra + 32 of the tile, columns cg*TN .. + TN
  const int rg = warp / CG, cg = warp % CG;
  const int ra = rg * 64 + lane;
  const int sw = lane & 7;                // ra % 8: the row's swizzle
  float acc[2][TN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ktiles; ++t) {
    const int s = t % stages;
    hopper::mbar_wait(full(s), (t / stages) & 1);
    const uint8_t* at = sm + s * A_BYTES + ra * 128;
    const float* bt = reinterpret_cast<const float*>(sm + stages * A_BYTES + s * B_BYTES) + cg * TN;
#pragma unroll
    for (int c = 0; c < FBK / 4; ++c) {
      // 4 k values of each row: the 16-byte chunk c, swizzled to c ^ (row % 8)
      const float4 a0 = *reinterpret_cast<const float4*>(at + ((c ^ sw) << 4));
      const float4 a1 = *reinterpret_cast<const float4*>(at + 32 * 128 + ((c ^ sw) << 4));
      const float av[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bt + (4 * c + kk) * NT;
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN; j += VW) {
          if constexpr (VW == 4) {
            const float4 v = *reinterpret_cast<const float4*>(brow + j);
            bv[j] = v.x;
            bv[j + 1] = v.y;
            bv[j + 2] = v.z;
            bv[j + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(brow + j);
            bv[j] = v.x;
            bv[j + 1] = v.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
      }
    }
    hopper::mbar_arrive(empty(s));
  }

  const int cb = n0 + cg * TN;
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j)
    bv[j] = (bias != nullptr && mode != MODE_PARTIAL && cb + j < N) ? bias[cb + j] : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ra + 32 * i;
    if (row >= M) continue;
    const size_t at = (mode == MODE_PARTIAL ? (size_t)split * M + row : (size_t)row) * N;
#pragma unroll
    for (int j = 0; j < TN; j += VW) {
      if (cb + j >= N) break;
      float r[VW], b[VW];
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        r[u] = acc[i][j + u];
        b[u] = bv[j + u];
      }
      store_f32<VW>(out, r, b, at + cb + j, mode, act);
    }
  }
}

template <int BM, int NT>
cudaError_t launch_f32(const CUtensorMap& amap, const CUtensorMap& bmap, const void* bias,
                       void* out, int M, int N, int packed, int pbm, int pbk, int nkb, int abox,
                       int kbeg, int kps, int splits, int stages, int mode, int act,
                       cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)stages * (BM * FBK * 4 + FBK * NT * 4 + 16);
  if (stages < 2 || smem > SMEM_MAX) return cudaErrorInvalidValue;
  static const cudaError_t raised = cudaFuncSetAttribute(
      tall_f32_kernel<BM, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (raised != cudaSuccess) return raised;
  const int ncols = (N + NT - 1) / NT;
  dim3 grid(((M + BM - 1) / BM) * ncols, splits);
  tall_f32_kernel<BM, NT><<<grid, F_THREADS, smem, stream>>>(
      amap, bmap, static_cast<const float*>(bias), static_cast<float*>(out), M, N, packed, pbm,
      pbk, nkb, abox, kbeg, kps, stages, ncols, mode, act);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_f32_nt(int nt, const CUtensorMap& amap, const CUtensorMap& bmap,
                          const void* bias, void* out, int M, int N, int packed, int pbm, int pbk,
                          int nkb, int abox, int kbeg, int kps, int splits, int stages, int mode,
                          int act, cudaStream_t s) {
  switch (nt) {
    case 8: return launch_f32<BM, 8>(amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox,
                                     kbeg, kps, splits, stages, mode, act, s);
    case 16: return launch_f32<BM, 16>(amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox,
                                       kbeg, kps, splits, stages, mode, act, s);
    case 32: return launch_f32<BM, 32>(amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox,
                                       kbeg, kps, splits, stages, mode, act, s);
    case 64: return launch_f32<BM, 64>(amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox,
                                       kbeg, kps, splits, stages, mode, act, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- fp32, wider N: 3xTF32 on wgmma --------------------------------------------

// B^T big and small: bt is (2, np, klen), bt[0][n][k] = tf32(B[kbeg + k][n])
// and bt[1][n][k] = tf32(B[kbeg + k][n] - bt[0][n][k]), zeros for n >= N.
// One 32 x 32 tile a CTA, transposed through shared memory so that both the
// reads of B and the writes of B^T are coalesced.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ b, float* __restrict__ bt, int N, int np, int kbeg,
                  int klen) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < klen && n < N) ? b[(size_t)(kbeg + k) * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n >= np || k >= klen) continue;
    const float x = tile[tx][i];
    const float big = hopper::to_tf32(x);
    bt[(size_t)n * klen + k] = big;
    bt[((size_t)np + n) * klen + k] = hopper::to_tf32(x - big);
  }
}

// 1 or 2 consumer warpgroups and a producer warpgroup, whose one thread
// issues the loads.  With 2 consumers the 384 threads get 168 registers
// each at launch; the producer gives its registers to the consumers (a
// stage's sums and the running sums of up to 128 columns, the stage's
// split fragments).
constexpr int X3_PRODUCER_REGS = 40, X3_CONSUMER_REGS = 232;
constexpr int X3_MAX_NT = 128;            // columns of a CTA tile

template <int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
tall_tf32x3_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, const float* __restrict__ bias,
                   float* __restrict__ out, int M, int N, int packed, int pbm, int pbk, int nkb,
                   int abox, int kbeg, int kps, int stages, int ncols, int nt, int np, int mode,
                   int act) {
  constexpr int BM = 64 * WGS;
  constexpr uint32_t A_BYTES = BM * FBK * 4;
  const uint32_t B_BYTES = nt * FBK * 4;   // one of big / small (nt % 8 == 0)
  const uint32_t STAGE = A_BYTES + 2 * B_BYTES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + stages * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };

  const int r0 = (blockIdx.x / ncols) * BM;
  const int n0 = (blockIdx.x % ncols) * nt;
  const int split = blockIdx.y;
  const int ktiles = kps / FBK;
  const int kstart = kbeg + split * kps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 128 * WGS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {
    // producer: A's tile and B^T big / small's (k local to the scratch)
    if constexpr (WGS == 2) hopper::setmaxnreg_dec<X3_PRODUCER_REGS>();
    if (warp == 4 * WGS && lane == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(empty(s), ((t / stages) - 1) & 1);
        hopper::mbar_expect_tx(full(s), STAGE);
        const int k = kstart + t * FBK;
        const uint32_t st = base + s * STAGE;
        load_a_tile(st, &amap, full(s), BM, abox, r0, k, packed, pbm, pbk, nkb);
        hopper::tma_load_2d(st + A_BYTES, &bmap, full(s), k - kbeg, n0);
        hopper::tma_load_2d(st + A_BYTES + B_BYTES, &bmap, full(s), k - kbeg, np + n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  if constexpr (WGS == 2) hopper::setmaxnreg_inc<X3_CONSUMER_REGS>();
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const int ra = 64 * wg + 16 * (warp % 4) + g;   // fragment rows ra, ra + 8
  // the column tile as pieces: q of 64 columns, then the tail
  const int q = nt / 64, tail = nt % 64;
  float acc[2][32];   // this stage's sums (the tensor cores truncate)
  float sum[2][32];   // the running sums, added with round-to-nearest
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = sum[c][i] = 0.f;

  // the k loop for one piece layout (Q pieces of 64, then a TAIL-wide one),
  // chosen once below: a width chosen inside the loop splits the chain of
  // wgmma into branches, and a 48-wide tile then took longer than a 64-wide
  // one (launch/tall_sweep.py --dtype float32)
  auto mainloop = [&](auto q_c, auto tail_c) {
    constexpr int Q = decltype(q_c)::value, TAIL = decltype(tail_c)::value;
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % stages;
      hopper::mbar_wait(full(s), (t / stages) & 1);
      const uint8_t* at = sm + s * STAGE;
      const uint32_t big = base + s * STAGE + A_BYTES, small = big + B_BYTES;
      // the m64k8 fragments of the stage's 4 k8 steps, split in registers
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ra + 8 * (e & 1), k = 8 * kk + tq + 4 * (e >> 1);
          const float x = *reinterpret_cast<const float*>(
              at + row * 128 + (((k >> 2) ^ g) << 4) + (k & 3) * 4);
          const float xb = hopper::to_tf32(x);
          ab[kk][e] = __float_as_uint(xb);
          as[kk][e] = __float_as_uint(hopper::to_tf32(x - xb));
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int add = kk > 0;   // the stage's first product overwrites
        const uint64_t db0 = hopper::desc_sw128(big + 32 * kk, 16, 1024);
        const uint64_t ds0 = hopper::desc_sw128(small + 32 * kk, 16, 1024);
        const uint64_t db1 = hopper::desc_sw128(big + 64 * 128 + 32 * kk, 16, 1024);
        const uint64_t ds1 = hopper::desc_sw128(small + 64 * 128 + 32 * kk, 16, 1024);
        hopper::tf32x3_step<Q >= 1 ? 64 : TAIL>(acc[0], ab[kk], as[kk], db0, ds0, add);
        if constexpr (Q == 2 || (Q == 1 && TAIL > 0))
          hopper::tf32x3_step<Q == 2 ? 64 : TAIL>(acc[1], ab[kk], as[kk], db1, ds1, add);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(empty(s));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        hopper::fence_regs(acc[c]);
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[c][i] += acc[c][i];
      }
    }
  };
  using std::integral_constant;
  auto with_tail = [&](auto q_c) {
    switch (tail) {
      case 0:   // a whole number of pieces: q = 1 (q = 2 is below)
        if constexpr (decltype(q_c)::value == 1) mainloop(q_c, integral_constant<int, 0>{});
        break;
      case 8: mainloop(q_c, integral_constant<int, 8>{}); break;
      case 16: mainloop(q_c, integral_constant<int, 16>{}); break;
      case 24: mainloop(q_c, integral_constant<int, 24>{}); break;
      case 32: mainloop(q_c, integral_constant<int, 32>{}); break;
      case 40: mainloop(q_c, integral_constant<int, 40>{}); break;
      case 48: mainloop(q_c, integral_constant<int, 48>{}); break;
      default: mainloop(q_c, integral_constant<int, 56>{}); break;
    }
  };
  if (q == 2)
    mainloop(integral_constant<int, 2>{}, integral_constant<int, 0>{});
  else if (q == 1)
    with_tail(integral_constant<int, 1>{});
  else
    with_tail(integral_constant<int, 0>{});

  // the accumulator layout: value i of a piece at row ra + 8 ((i / 2) % 2),
  // column (i / 4) * 8 + 2 tq + i % 2 of the piece; pairs of columns stored
  // together
  auto emit = [&](float v0, float v1, int i, int col) {
    const int row = r0 + ra + 8 * ((i / 2) % 2);
    if (row >= M || col >= N) return;
    float r[2] = {v0, v1}, b[2] = {0.f, 0.f};
    if (bias != nullptr && mode != MODE_PARTIAL) {
      b[0] = bias[col];
      b[1] = bias[col + 1];
    }
    const size_t at = (mode == MODE_PARTIAL ? (size_t)split * M + row : (size_t)row) * N + col;
    store_f32<2>(out, r, b, at, mode, act);
  };
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int width = c < q ? 64 : c == q ? tail : 0;
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      if (i < width / 2) emit(sum[c][i], sum[c][i + 1], i, n0 + 64 * c + (i / 4) * 8 + 2 * tq);
  }
}

inline size_t tf32x3_smem(int bm, int nt, int stages) {
  return 1024 + (size_t)stages * ((size_t)bm * FBK * 4 + 2 * (size_t)nt * FBK * 4 + 16);
}

template <int WGS>
cudaError_t launch_tf32x3(const CUtensorMap& amap, const CUtensorMap& bmap, const void* bias,
                          void* out, int M, int N, int packed, int pbm, int pbk, int nkb,
                          int abox, int kbeg, int kps, int splits, int nt, int np, int stages,
                          int mode, int act, cudaStream_t stream) {
  const size_t smem = tf32x3_smem(64 * WGS, nt, stages);
  if (stages < 2 || smem > SMEM_MAX) return cudaErrorInvalidValue;
  static const cudaError_t raised = cudaFuncSetAttribute(
      tall_tf32x3_kernel<WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (raised != cudaSuccess) return raised;
  const int ncols = np / nt;
  dim3 grid(((M + 64 * WGS - 1) / (64 * WGS)) * ncols, splits);
  tall_tf32x3_kernel<WGS><<<grid, 128 * (WGS + 1), smem, stream>>>(
      amap, bmap, static_cast<const float*>(bias), static_cast<float*>(out), M, N, packed, pbm,
      pbk, nkb, abox, kbeg, kps, stages, ncols, nt, np, mode, act);
  return cudaGetLastError();
}

// A's fp32 tensor map (both fp32 designs): boxes of 32 k x abox rows,
// 128-byte swizzle, over the natural (M, K) or packed (nm*nk*pbm, pbk) view.
bool map_a_f32(CUtensorMap* map, const void* a, int M, int K, int packed, int pbm, int pbk,
               int abox) {
  const uint32_t box[2] = {FBK, (uint32_t)abox};
  uint64_t dims[2], strides[1];
  if (packed) {
    dims[0] = pbk;
    dims[1] = (uint64_t)(M / pbm) * (K / pbk) * pbm;
    strides[0] = (uint64_t)pbk * 4;
  } else {
    dims[0] = K;
    dims[1] = M;
    strides[0] = (uint64_t)K * 4;
  }
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, 2, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t launch_fp32(const void* a, const void* b, const void* bias, void* out, void* scratch,
                        int M, int K, int N, int packed, int pbm, int pbk, int kbeg, int kps,
                        int splits, int design, int bm, int nt, int stages, int mode, int act,
                        cudaStream_t s) {
  // A's box: the tile, or the largest power-of-two part of it a packed
  // block holds (8 | pbm keeps each box on whole 1024-byte swizzle atoms)
  int abox = bm;
  if (packed)
    while (pbm % abox) abox /= 2;
  CUtensorMap amap, bmap;
  if (!map_a_f32(&amap, a, M, K, packed, pbm, pbk, abox)) return cudaErrorInvalidValue;
  const int nkb = packed ? K / pbk : 0;
  if (design == DESIGN_F32) {
    const uint64_t dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint64_t strides[1] = {(uint64_t)N * 4};
    const uint32_t box[2] = {(uint32_t)nt, FBK};
    if (!hopper::make_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, b, 2, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
    if (bm == 128)
      return launch_f32_nt<128>(nt, amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox,
                                kbeg, kps, splits, stages, mode, act, s);
    return launch_f32_nt<64>(nt, amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox, kbeg,
                             kps, splits, stages, mode, act, s);
  }
  // 3xTF32: B^T big / small of the launch's k range into the scratch first
  const int klen = splits * kps;
  const int np = ((N + nt - 1) / nt) * nt;
  tf32_split_kernel<<<dim3((klen + 31) / 32, (np + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(b), static_cast<float*>(scratch), N, np, kbeg, klen);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint64_t dims[2] = {(uint64_t)klen, 2 * (uint64_t)np};
  const uint64_t strides[1] = {(uint64_t)klen * 4};
  const uint32_t box[2] = {FBK, (uint32_t)nt};
  if (!hopper::make_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scratch, 2, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (bm == 128)
    return launch_tf32x3<2>(amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox, kbeg, kps,
                            splits, nt, np, stages, mode, act, s);
  return launch_tf32x3<1>(amap, bmap, bias, out, M, N, packed, pbm, pbk, nkb, abox, kbeg, kps,
                          splits, nt, np, stages, mode, act, s);
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

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = wgmma (bf16), 1 = f32,
// 2 = tf32x3 (fp32).  M, K: A's logical (padded) dims; for a packed A,
// M = nm * pbm and K = nk * pbk.  The launch covers k in [kbeg, kbeg +
// splits*kps), within [0, K); with splits > 1 only mode 1 is meaningful.
// The launch plan comes from the caller (kernels/tsmm.py::tall_plan): bm,
// the CTA row tile (wgmma: 64; f32 and tf32x3: 64 or 128); nt, the CTA
// column tile (wgmma: 128, N a multiple of it; f32: 8, 16, 32 or 64;
// tf32x3: a multiple of 8 up to 128; the fp32 designs mask the columns of
// the last tile past N); cluster, the CTAs that split each kps range
// (wgmma only; kps % (64 * cluster) == 0); stages, the ring depth.  bf16
// needs A and B 16-byte aligned, K % 8 == 0 for a natural A and 64 | pbm,
// 64 | pbk for a packed one (TMA boxes).  fp32 needs A, B (and the
// scratch) 16-byte aligned, N % 4 == 0, kps % 32 == 0, K % 4 == 0 for a
// natural A and 8 | pbm, 32 | pbk for a packed one.  tf32x3 also needs
// `scratch`: 2 x ceil(N / nt) * nt x splits * kps fp32 values for B^T big
// and small.  Every design needs a ring that fits shared memory.  Returns
// cudaGetLastError() after the launch (non-zero: refused).
extern "C" int tsmm_tall_launch(const void* a, const void* b, const void* bias, void* out,
                                void* scratch, int M, int K, int N, int packed, int pbm, int pbk,
                                int kbeg, int kps, int splits, int design, int bm, int nt,
                                int cluster, int stages, int mode, int act, int dtype,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || kbeg < 0 || kps <= 0 || splits <= 0 ||
      (long long)kbeg + (long long)splits * kps > K || mode < 0 || mode > 2 || act < 0 ||
      act > 3 || (splits > 1 && mode != MODE_PARTIAL))
    return (int)cudaErrorInvalidValue;
  if (packed && (pbm <= 0 || pbk <= 0 || M % pbm != 0 || K % pbk != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (design != DESIGN_WGMMA || bm != WBM || nt != WNT || N % WNT != 0 ||
        (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
        kps % (WBK * cluster) != 0 || ((uintptr_t)a | (uintptr_t)b) % 16 != 0 ||
        (packed ? (pbm % WBM != 0 || pbk % WBK != 0) : K % 8 != 0))
      return (int)cudaErrorInvalidValue;
    return (int)launch_wgmma(a, b, bias, out, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                             cluster, stages, mode, act, s);
  }
  const bool f32 = design == DESIGN_F32, x3 = design == DESIGN_TF32X3;
  if (dtype != 0 || cluster != 1 || !(f32 || x3) || (bm != 64 && bm != 128) || N % 4 != 0 ||
      kps % FBK != 0 || ((uintptr_t)a | (uintptr_t)b | (uintptr_t)scratch) % 16 != 0 ||
      (packed ? (pbm % 8 != 0 || pbk % FBK != 0) : K % 4 != 0) ||
      (f32 && nt != 8 && nt != 16 && nt != 32 && nt != 64) ||
      (x3 && (nt % 8 != 0 || nt < 8 || nt > X3_MAX_NT || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_fp32(a, b, bias, out, scratch, M, K, N, packed, pbm, pbk, kbeg, kps, splits,
                          design, bm, nt, stages, mode, act, s);
}
