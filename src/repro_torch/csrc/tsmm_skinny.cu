// Skinny-A TSMM for Hopper (sm_90a): out = epilogue(X @ W) with a skinny
// X (m, K) and a wide weight W that is either pre-packed block-major
// (nk, nn, bk, bn) or in its natural (K, N) layout.
//
// Replaces the TPU kernels of the reference package's skinny-A family:
//   kernels/tsmm.py  tsmm_skinny_a   (_skinny_a_kernel; the baseline point)
//   kernels/gen.py   _skinny_kinner  (natural W / resident X / acc=revisit /
//                                     epi=split grammar points)
//   kernels/gen.py   _skinny_ksplit  (k-split fp32 partial sums)
// Every design serves all three: W layout (packed, natural) x k-splits
// (grid z, each over kps = K / splits) x output mode:
//   mode 0  cast epilogue: bias in fp32, then relu / silu / tanh-gelu on
//           the fp32 sum, then one cast (kernels/tsmm.py::_epilogue).
//           With no bias and no activation it is the raw cast output of
//           epi=split points, whose caller runs the bias/activation pass
//           on the cast result;
//   mode 1  raw fp32 sums, one (m, N) slab per split (acc=revisit, and
//           the k-split partials the caller reduces).
// "X resident" (bres=resident) changes only where the TPU kept X; here X
// is staged through shared memory in k slices and the 50 MB L2 keeps the
// whole X panel on chip across CTAs, so both residencies run the same
// code and give the same result.
//
// The launch plan (design, row tile, cluster, ring depth) comes from the
// caller, kernels/tsmm.py::skinny_plan.  Two designs for each dtype:
//
// bf16, m > 8 (prefill; skinny_wgmma_kernel).  Bound by operations: at
// qwen1.5-4b's (1024, 2560, 6912) the function does 36 GFLOP against
// 38 MB of bytes, ~3 ops per byte above the H100's ridge (~295); at
// GLM-4-9B's m = 2048 more so.  A warp-specialised tensor-core GEMM: a
// CTA tile of bm = 128 (two consumer warpgroups) or 64 (one) rows by 128
// columns; each warpgroup issues wgmma m64n128k16 with X as the K-major A
// operand and W as the MN-major B operand, both from shared memory.  One
// producer warp keeps TMA loads of 64-deep k stages in flight through a
// ring of full / empty mbarriers, 128-byte swizzle.  The row tiles of one
// column tile are neighbours in launch order, so W is read from HBM about
// once and X stays in L2.  The ring is 3 stages deep, so two 128-row CTAs
// (three 64-row ones) share an SM and one CTA's prologue and epilogue
// hide behind the other's main loop: 4- to 6-stage rings (one CTA an SM)
// and a 128 x 256 tile (two wgmma n128 a k step, one CTA an SM) measured
// slower or no faster at every qwen1.5-4b and GLM-4-9B prefill shape
// (launch/skinny_sweep.py) and were dropped.
//
// bf16, m <= 8 (decode; skinny_stream_kernel).  Bound by the weight bytes:
// ~2 flops per W byte, so the card's 3.35 TB/s sets the time and the
// design keeps bytes in flight.  W streams through the same TMA ring (one
// W-loading path for both designs, the same tensor maps) in stages of
// 64 k x 128 columns (16 KB) plus the stage's X rows (1 KB); 4 stages
// keep ~68 KB in flight per CTA, several CTAs share an SM.  The math is
// the swapped product on the tensor cores, wgmma m64n8k16 with W's tile
// as the MN-major A operand and X (8 rows, zero-filled past m) as the
// K-major B operand: with bytes the bound either FMA or wgmma would do,
// and wgmma reads the swizzled stage as TMA wrote it, with no conversion
// or shared-memory traffic in the threads.  A column tile alone gives
// too few CTAs at 2560-4096-wide projections (20-32 tiles), so each
// tile's k range is split over a thread-block cluster of up to 8 CTAs at
// stage granularity (unequal ranges where the stages do not divide:
// GLM-4-9B's w_down has 214); the CTAs' fp32 partials meet in the
// leader's shared memory (distributed shared memory) and the leader runs
// the epilogue: no fp32 workspace, no second pass.
//
// Packed W costs what natural W costs: a (bk, bn) block is contiguous and
// row-major, so W is a 2-D tensor map over its (nk*nn*bk, bn) view and a
// stage's rows start at (kb*nn + nb)*bk + (k - kb*bk), one coordinate
// change per stage (the plan requires 64 | bk and 128 | bn, so no stage
// or tile crosses a block).  Natural W is a 2-D map over (K, N).  TMA
// fills X's rows past m with zeros and the stores are masked.  Both bf16
// designs end the same way: the fp32 tile goes to shared memory (the
// drained ring) and every thread stores 8 columns of a row, bias read
// once, in 16-byte stores.
//
// fp32, m <= the crossover, 16 rows (decode, the gate's 16-row context
// problem; skinny_f32_kernel).  Bound by W's bytes: a skinny product does
// m/2 flops per W byte, under fp32 FMA's ridge (~20: 67 TFLOP/s over 3.35
// TB/s) below m ~ 40; tf32x3 overtakes it from ~32 rows
// (launch/skinny_sweep.py --dtype float32).  A TMA-fed FMA stream, no tensor cores, so the sums stay
// in the card-vs-CPU fp32 parity class.  One producer warp keeps TMA loads
// of 32-deep stages in flight through a ring of full / empty mbarriers: W's
// 32 k x nt columns (nt 32, 64 or 128) as boxes of 32 columns (one
// 128-byte swizzle row), X's k slice (bm rows, zeros past m from TMA) in
// the same stage.  Four consumer warps keep bm x nt fp32 sums in
// registers: a thread 4 columns by bm / (512 / nt) rows, each W float4
// read once from the swizzled tile (a quarter warp reads 8 distinct
// chunks) and X's rows as broadcasts.  The card needs ~32 KB in flight an
// SM (3.35 TB/s x ~1.3 us over 132 SMs): a ring of 4 stages keeps 16-64
// KB of W a CTA (8 stages measured within a few percent, 16 slower).
// A column tile alone gives too few CTAs (16 at the gate's N = 2048), so
// each tile's k range is split over a cluster of up to 8 CTAs, the
// smallest that gives every SM one while each rank keeps enough stages;
// the ranks' partials are reduce-scattered through distributed shared
// memory into the drained rings and each rank runs the epilogue on its
// share.  No fp32 workspace and no second pass; k-split partials (mode 1)
// keep one slab per split.
//
// fp32, m above the crossover (the fp32 prefills; skinny_tf32x3_kernel).
// Bound by the FMA rate (m/2 flops per W byte is past the ridge), so the
// design runs 3xTF32 on wgmma (495 / 3 = 165 TFLOP/s at the data sheet's
// rate): each operand splits into big = tf32(x) (round to nearest) and
// small = tf32(x - big); small.big, big.small and big.big keep ~2^-21 of
// relative error, fp32's level.  .tf32 wgmma takes K-major operands only
// and W is N-major, so the product is swapped, outT (N, m) = WT X^T: W's
// TMA tile (the same boxes as f32's) is the register A operand, split in
// registers (fragment rows permuted over the tile's columns so each read
// is free of bank conflicts); X^T is the K-major B operand, and X (m, K)
// row-major already is K-major: a split pass in this file (x_split_kernel,
// part of the design's launch) writes X big and small (2 x m x K fp32, a
// scratch the caller allocates) and the ring loads both 32 k deep.  W is
// never copied.  One or two consumer warpgroups own 64 W columns each over
// a row tile of up to 128 X rows (m padded to 8).  Few rows give few
// tiles, so each tile's k range is split over a cluster as f32's: every
// rank writes its tile to its own drained ring and the rank that owns a
// share of it sums the ranks' copies in rank order (distributed shared
// memory) and runs the epilogue.  The tensor cores' fp32
// accumulation truncates, so each 32-deep stage's sums start afresh and
// are added to running register sums with round-to-nearest (one
// accumulator over K drifted past the tolerance at K = 25600 in the tall
// kernel).  The tile goes out transposed through shared memory, as (m, N)
// rows of 16-byte stores.
//
// Both fp32 designs take W packed or natural through one tensor map and
// one load path, so a packed W costs no address arithmetic; bias in fp32,
// then the activation, then one store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };
enum { MODE_EPILOGUE = 0, MODE_PARTIAL = 1 };
enum { DESIGN_F32 = 0, DESIGN_WGMMA = 1, DESIGN_STREAM = 2, DESIGN_TF32X3 = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v * (1.f / (1.f + expf(-v)));
  if (act == ACT_GELU)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

// ---- bf16: the TMA ring both designs share --------------------------------

constexpr int BK = 64;                       // k depth of a stage (one 128-byte swizzle row)
constexpr int NT = 128;                      // columns of a CTA tile (two 64-column W boxes)
constexpr uint32_t W_BYTES = BK * NT * 2;    // W's part of a stage
constexpr int LD = NT + 8;                   // row stride (floats) of the fp32 tile
constexpr int STREAM_ROWS = 8;               // X rows of the stream design (wgmma N = 8)

// The shared-memory layout: a 1024-aligned ring of `stages` (X, W) stages,
// then a full and an empty mbarrier per stage.  The fp32 output tile
// reuses the drained ring.
struct Ring {
  uint32_t base, bars, stage, xbytes;
  int stages;
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (stages + s); }
  __device__ uint32_t x(int s) const { return base + s * stage; }
  __device__ uint32_t w(int s) const { return base + s * stage + xbytes; }
};

inline size_t ring_bytes(uint32_t stage, int stages) {
  return 1024 + (size_t)stages * (stage + 16);
}

__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw, uint32_t xbytes, int stages,
                                          float** tile) {
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Ring r;
  r.base = (raw + 1023u) & ~1023u;
  r.xbytes = xbytes;
  r.stage = xbytes + W_BYTES;
  r.stages = stages;
  r.bars = r.base + stages * r.stage;
  *tile = reinterpret_cast<float*>(smem_raw + (r.base - raw));
  return r;
}

__device__ __forceinline__ void init_ring(const Ring& r, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      hopper::mbar_init(r.full(s), 1);
      hopper::mbar_init(r.empty(s), consumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// The producer (one thread): TMA loads of `ktiles` stages from k = kstart,
// each X rows [r0, r0 + rows) and W columns [n0, n0 + NT).  A packed W's
// stage lies in one (bk, bn) block: row (kb*nn + nb)*bk + (k - kb*bk) of
// the (nk*nn*bk, bn) view, column n0 - nb*bn.
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                        const Ring& r, int ktiles, int kstart, int r0, int n0,
                                        int natural, int bk, int bn, int nn) {
  const int nb = natural ? 0 : n0 / bn;
  const int c0 = n0 - nb * bn;
  for (int t = 0; t < ktiles; ++t) {
    const int s = t % r.stages;
    if (t >= r.stages) hopper::mbar_wait(r.empty(s), ((t / r.stages) - 1) & 1);
    hopper::mbar_expect_tx(r.full(s), r.stage);
    const int k = kstart + t * BK;
    int wrow = k;
    if (!natural) {
      const int kb = k / bk;
      wrow = (kb * nn + nb) * bk + (k - kb * bk);
    }
    hopper::tma_load_2d(r.x(s), xmap, r.full(s), k, r0);
#pragma unroll
    for (int j = 0; j < NT / 64; ++j)
      hopper::tma_load_2d(r.w(s) + j * BK * 128, wmap, r.full(s), c0 + 64 * j, wrow);
  }
}

// Sum `slots` fp32 partial tiles of `rows` x NT (row stride LD, slot
// stride rows*LD) in shared memory and store rows [r0, min(r0 + rows, m))
// in the launch's mode.  Each thread owns 8 columns (the bias read once)
// and walks rows: one 16-byte store of bf16, or two of fp32, per row.
__device__ __forceinline__ void store_tile(const float* tile, int slots, int rows, int r0,
                                           int n0, int m, int N, int split, int mode, int act,
                                           const __nv_bfloat16* __restrict__ bias, void* out) {
  constexpr int G = NT / 8;
  const int lanes = blockDim.x / G;
  if ((int)threadIdx.x >= lanes * G) return;
  const int c8 = 8 * (threadIdx.x % G);
  const int col = n0 + c8;
  float bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bv[i] = (bias != nullptr && mode == MODE_EPILOGUE) ? __bfloat162float(bias[col + i]) : 0.f;
  for (int lr = threadIdx.x / G; lr < rows; lr += lanes) {
    const int row = r0 + lr;
    if (row >= m) break;
    const float* p = tile + (size_t)lr * LD + c8;
    const float4 a0 = *reinterpret_cast<const float4*>(p);
    const float4 b0 = *reinterpret_cast<const float4*>(p + 4);
    float v[8] = {a0.x, a0.y, a0.z, a0.w, b0.x, b0.y, b0.z, b0.w};
    for (int q = 1; q < slots; ++q) {
      p += (size_t)rows * LD;
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
    }
    if (mode == MODE_PARTIAL) {
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) +
                                            ((size_t)split * m + row) * N + col);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    uint4 pk;
    pk.x = hopper::pack_bf16(activate(v[0] + bv[0], act), activate(v[1] + bv[1], act));
    pk.y = hopper::pack_bf16(activate(v[2] + bv[2], act), activate(v[3] + bv[3], act));
    pk.z = hopper::pack_bf16(activate(v[4] + bv[4], act), activate(v[5] + bv[5], act));
    pk.w = hopper::pack_bf16(activate(v[6] + bv[6], act), activate(v[7] + bv[7], act));
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * N + col) = pk;
  }
}

// ---- bf16, m > 8: the wgmma kernel -------------------------------------------

// WG consumer warpgroups (bm = 64 * WG rows) and one producer warp.
template <int WG>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
skinny_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __nv_bfloat16* __restrict__ bias, void* __restrict__ out, int m,
                    int N, int natural, int bk, int bn, int kps, int stages, int mode,
                    int act) {
  constexpr int BM = 64 * WG;
  extern __shared__ uint8_t smem_raw[];
  float* tile;
  const Ring r = make_ring(smem_raw, BM * BK * 2, stages, &tile);

  // grid x: (column tile, row tile), the row tiles fastest, so the CTAs
  // that read one W column tile run together and share it through L2
  const int rtiles = (m + BM - 1) / BM;
  const int r0 = (blockIdx.x % rtiles) * BM;
  const int n0 = (blockIdx.x / rtiles) * NT;
  const int split = blockIdx.z;
  const int ktiles = kps / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(r, WG * 128);

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  if (warp == 4 * WG) {
    if (lane == 0)
      produce(&xmap, &wmap, r, ktiles, split * kps, r0, n0, natural, bk, bn, N / bn);
  } else {
    // consumer warpgroup g: rows [64g, 64g + 64) of the tile; one wgmma
    // group in flight, a stage released when the next group is issued
    const uint32_t xoff = (warp / 4) * 64 * 128;
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % stages;
      hopper::mbar_wait(r.full(s), (t / stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(r.x(s) + xoff + 32 * kk, 16, 1024);
        const uint64_t db = hopper::desc_sw128(r.w(s) + 2048 * kk, BK * 128, 1024);
        hopper::wgmma_ss_n128_t1(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (t > 0) hopper::mbar_arrive(r.empty((t - 1) % stages));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }
  __syncwarp();
  __syncthreads();   // every stage consumed: the ring holds the fp32 tile now
  if (warp < 4 * WG) {
    // accumulator layout: row 16*(warp%4) + lane/4 (+8), columns 8c + 2*(lane%4) (+1)
    const int row = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
    const int c2 = 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < NT / 8; ++c) {
      float* p = tile + (size_t)row * LD + 8 * c + c2;
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * c], acc[4 * c + 1]);
      *reinterpret_cast<float2*>(p + 8 * LD) = make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
  __syncthreads();
  store_tile(tile, 1, BM, r0, n0, m, N, split, mode, act, bias, out);
}

// ---- bf16, m <= 8: the byte-streaming kernel --------------------------------

// One consumer warpgroup and one producer warp.  grid x: (column tile,
// cluster rank), the rank fastest; rank q of a cluster of C takes stages
// [q*T/C, (q+1)*T/C) of its split's T = kps/64.
__global__ void __launch_bounds__(160, 1)
skinny_stream_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ bias, void* __restrict__ out, int m,
                     int N, int natural, int bk, int bn, int kps, int stages, int cluster,
                     int mode, int act) {
  extern __shared__ uint8_t smem_raw[];
  float* tile;
  const Ring r = make_ring(smem_raw, STREAM_ROWS * BK * 2, stages, &tile);

  const int rank = (int)hopper::cluster_rank();
  const int n0 = (blockIdx.x / cluster) * NT;
  const int split = blockIdx.z;
  const int T = kps / BK;
  const int t0 = rank * T / cluster, t1 = (rank + 1) * T / cluster;
  const int ktiles = t1 - t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(r, 128);

  // acc[h]: W columns [64h, 64h + 64) of the tile as the wgmma's 64 rows,
  // X's 8 rows as its columns
  float acc[NT / 64][4];
#pragma unroll
  for (int h = 0; h < NT / 64; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[h][i] = 0.f;

  if (warp == 4) {
    if (lane == 0)
      produce(&xmap, &wmap, r, ktiles, split * kps + t0 * BK, 0, n0, natural, bk, bn, N / bn);
  } else {
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % stages;
      hopper::mbar_wait(r.full(s), (t / stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int h = 0; h < NT / 64; ++h)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da =
              hopper::desc_sw128(r.w(s) + h * BK * 128 + 2048 * kk, BK * 128, 1024);
          const uint64_t db = hopper::desc_sw128(r.x(s) + 32 * kk, 16, 1024);
          hopper::wgmma_ss_n8_ta(acc[h], da, db, 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (t > 0) hopper::mbar_arrive(r.empty((t - 1) % stages));
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NT / 64; ++h) hopper::fence_regs(acc[h]);
  }

  // every CTA's partial (8 rows x NT) goes to slot `rank` of the leader's
  // fp32 tile, through distributed shared memory; the leader sums the
  // slots and runs the epilogue
  __syncwarp();
  if (cluster > 1) hopper::cluster_sync(); else __syncthreads();   // rings drained
  if (warp < 4) {
    const int n = 16 * warp + lane / 4;
    const int x0 = 2 * (lane % 4);
    const uint32_t slot = hopper::smem_u32(tile + (size_t)rank * STREAM_ROWS * LD);
    const uint32_t to = cluster > 1 ? hopper::map_rank(slot, 0) : slot;
#pragma unroll
    for (int h = 0; h < NT / 64; ++h) {
      const uint32_t at = to + 4u * (x0 * LD + 64 * h + n);
      hopper::st_cluster_f32(at, acc[h][0]);
      hopper::st_cluster_f32(at + 4u * LD, acc[h][1]);
      hopper::st_cluster_f32(at + 32u, acc[h][2]);
      hopper::st_cluster_f32(at + 4u * LD + 32u, acc[h][3]);
    }
  }
  if (cluster > 1) hopper::cluster_sync(); else __syncthreads();   // partials landed
  if (rank != 0) return;
  store_tile(tile, cluster, STREAM_ROWS, 0, n0, m, N, split, mode, act, bias, out);
}

// X: a (K, m) map (K innermost) of `rows`-row boxes; W: natural (N, K) or
// packed (bn, nk*nn*bk), 64 x 64 boxes.  128-byte swizzle throughout.
bool make_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x, const void* w, int m,
               int K, int N, int ldx, int bn, int natural, int rows) {
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)m};
  const uint64_t xstrides[1] = {(uint64_t)ldx * 2};
  const uint32_t xbox[2] = {BK, (uint32_t)rows};
  const uint64_t wdims[2] = {natural ? (uint64_t)N : (uint64_t)bn,
                             natural ? (uint64_t)K : (uint64_t)K * (N / bn)};
  const uint64_t wstrides[1] = {(natural ? (uint64_t)N : (uint64_t)bn) * 2};
  const uint32_t wbox[2] = {64, BK};
  return hopper::make_map(xmap, x, 2, xdims, xstrides, xbox) &&
         hopper::make_map(wmap, w, 2, wdims, wstrides, wbox);
}

// The opt-in shared memory raised once per kernel to the most a CTA may
// take, and the L1 / shared split set to all shared, so the plan's
// smaller rings can share an SM.
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int WG>
cudaError_t launch_wgmma(const void* x, const void* w, const void* bias, void* out, int m,
                         int K, int N, int ldx, int bk, int bn, int natural, int splits,
                         int kps, int stages, int mode, int act, cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  const uint32_t stage = BM * BK * 2 + W_BYTES;
  if (stages < 2 || ring_bytes(stage, stages) > 232448 ||
      (size_t)stages * stage < (size_t)BM * LD * 4)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!make_maps(&xmap, &wmap, x, w, m, K, N, ldx, bn, natural, BM))
    return cudaErrorInvalidValue;
  static const cudaError_t raised = raise_smem(skinny_wgmma_kernel<WG>);
  if (raised != cudaSuccess) return raised;
  const dim3 grid(((m + BM - 1) / BM) * (N / NT), 1, splits);
  skinny_wgmma_kernel<WG><<<grid, WG * 128 + 32, ring_bytes(stage, stages), stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias), out, m, N, natural, bk, bn, kps,
      stages, mode, act);
  return cudaGetLastError();
}

cudaError_t launch_stream(const void* x, const void* w, const void* bias, void* out, int m,
                          int K, int N, int ldx, int bk, int bn, int natural, int splits,
                          int kps, int cluster, int stages, int mode, int act,
                          cudaStream_t stream) {
  const uint32_t stage = STREAM_ROWS * BK * 2 + W_BYTES;
  if (stages < 2 || ring_bytes(stage, stages) > 232448 ||
      (size_t)stages * stage < (size_t)cluster * STREAM_ROWS * LD * 4)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!make_maps(&xmap, &wmap, x, w, m, K, N, ldx, bn, natural, STREAM_ROWS))
    return cudaErrorInvalidValue;
  static const cudaError_t raised = raise_smem(skinny_stream_kernel);
  if (raised != cudaSuccess) return raised;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / NT) * cluster, 1, splits);
  cfg.blockDim = dim3(160);
  cfg.dynamicSmemBytes = ring_bytes(stage, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, skinny_stream_kernel, xmap, wmap, static_cast<const __nv_bfloat16*>(bias), out, m,
      N, natural, bk, bn, kps, stages, cluster, mode, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- fp32: both designs ------------------------------------------------------

constexpr int FBK = 32;                       // k depth of an fp32 stage (128 bytes)
constexpr uint32_t WBOX_BYTES = FBK * 128;    // one W box: 32 k rows x 32 columns
constexpr int F_CONSUMERS = 128;              // f32: four consumer warps

// Byte offset of W(k, c) in a stage's W tile: c / 32 TMA boxes of 32 k rows
// of 128 bytes (32 columns), 128-byte swizzle (16-byte chunk j of row k at
// chunk j ^ (k % 8)).
__device__ __forceinline__ uint32_t w_off(int k, int c) {
  return (c >> 5) * WBOX_BYTES + k * 128 + ((((c & 31) >> 2) ^ (k & 7)) << 4) + (c & 3) * 4;
}

// The TMA loads of one stage's W tile: `boxes` boxes of 32 columns x 32 k
// from column n0, row k of the natural (K, N) map, or of the packed
// (nk*nn*bk, bn) view: row (kb*nn + nb)*bk + (k - kb*bk), column n0 - nb*bn
// (the plan keeps a tile inside one (bk, bn) block).
__device__ __forceinline__ void load_w_f32(uint32_t dst, const CUtensorMap* wmap, uint32_t bar,
                                           int boxes, int k, int n0, int natural, int bk,
                                           int bn, int nn) {
  int row = k, col = n0;
  if (!natural) {
    const int kb = k / bk, nb = n0 / bn;
    row = (kb * nn + nb) * bk + (k - kb * bk);
    col = n0 - nb * bn;
  }
  for (int j = 0; j < boxes; ++j) hopper::tma_load_2d(dst + j * WBOX_BYTES, wmap, bar, col + 32 * j, row);
}

// Four consecutive fp32 sums of one output row in the launch's mode: mode
// 1 stores them raw into split `split`'s slab; mode 0 adds the bias, then
// the activation.
__device__ __forceinline__ void store4_f32(float* __restrict__ out, const float* __restrict__ bias,
                                           float4 v, int row, int col, int m, int N, int split,
                                           int mode, int act) {
  if (mode == MODE_PARTIAL) {
    *reinterpret_cast<float4*>(out + ((size_t)split * m + row) * N + col) = v;
    return;
  }
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) b = make_float4(bias[col], bias[col + 1], bias[col + 2], bias[col + 3]);
  *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
      make_float4(activate(v.x + b.x, act), activate(v.y + b.y, act), activate(v.z + b.z, act),
                  activate(v.w + b.w, act));
}

// ---- fp32, few rows: the TMA-fed FMA stream (skinny_f32_kernel) -------------

// Four consumer warps and one producer warp.  grid x: (column tile,
// cluster rank), the rank fastest; rank q of a cluster of C takes stages
// [q*T/C, (q+1)*T/C) of its split's T = kps/32.  A stage is X's 32-deep k
// slice (MT rows, zeros past m) and W's 32 k x NT columns.  Consumer
// thread (tc, tr) keeps rows tr + TR*i (i < R) x columns 4tc .. 4tc+3.
// (Two groups of four warps, each on half of a stage's k rows, measured
// ~5 % slower in launch/skinny_sweep.py --dtype float32.)
template <int MT, int NT>
__global__ void __launch_bounds__(F_CONSUMERS + 32, 1)
skinny_f32_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ bias, float* __restrict__ out, int m, int N,
                  int natural, int bk, int bn, int kps, int stages, int cluster, int mode,
                  int act) {
  constexpr int TC = NT / 4, TR = F_CONSUMERS / TC, R = MT / TR;
  static_assert(TC >= 8 && R >= 1 && MT % TR == 0, "a quarter warp shares one row");
  constexpr uint32_t X_BYTES = MT * 128, STAGE = X_BYTES + NT * 128;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + stages * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };

  const int rank = (int)hopper::cluster_rank();
  const int n0 = (blockIdx.x / cluster) * NT;
  const int split = blockIdx.z;
  const int T = kps / FBK;
  const int t0 = rank * T / cluster, ktiles = (rank + 1) * T / cluster - t0;
  const int kstart = split * kps + t0 * FBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), F_CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int tc = threadIdx.x % TC, tr = threadIdx.x / TC;
  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (warp == F_CONSUMERS / 32) {
    if (lane == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(empty(s), ((t / stages) - 1) & 1);
        hopper::mbar_expect_tx(full(s), STAGE);
        const int k = kstart + t * FBK;
        hopper::tma_load_2d(base + s * STAGE, &xmap, full(s), k, 0);
        load_w_f32(base + s * STAGE + X_BYTES, &wmap, full(s), NT / 32, k, n0, natural, bk, bn,
                   N / bn);
      }
    }
  } else {
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % stages;
      hopper::mbar_wait(full(s), (t / stages) & 1);
      const uint8_t* xs = sm + s * STAGE;
      const uint8_t* ws = xs + X_BYTES;
#pragma unroll
      for (int j = 0; j < FBK / 4; ++j) {
        // 4 k of each row: chunk j of the row, swizzled to j ^ (row % 8);
        // the lanes of a quarter warp read one row (a broadcast)
        float4 xv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = tr + TR * i;
          xv[i] = *reinterpret_cast<const float4*>(xs + r * 128 + ((j ^ (r & 7)) << 4));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // 4 columns of W's row: a quarter warp reads 8 distinct chunks
          const float4 wv = *reinterpret_cast<const float4*>(ws + w_off(4 * j + kk, 4 * tc));
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float a = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
            acc[i][0] = fmaf(a, wv.x, acc[i][0]);
            acc[i][1] = fmaf(a, wv.y, acc[i][1]);
            acc[i][2] = fmaf(a, wv.z, acc[i][2]);
            acc[i][3] = fmaf(a, wv.w, acc[i][3]);
          }
        }
      }
      hopper::mbar_arrive(empty(s));
    }
  }

  // Reduce-scatter over the cluster through distributed shared memory:
  // rank d owns elements [d*chunk, (d+1)*chunk) of the row-major MT x NT
  // tile and receives every rank's partial of them in slot (sender rank)
  // of red[cluster][chunk] (the drained ring); it sums the slots and runs
  // the epilogue on its elements.
  const int chunk = MT * NT / cluster;
  float* red = reinterpret_cast<float*>(sm);
  __syncwarp();
  if (cluster > 1) hopper::cluster_sync(); else __syncthreads();   // rings drained
  if (warp < F_CONSUMERS / 32) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = tr + TR * i;
      if (r >= m) break;
      const int e = r * NT + 4 * tc, dst = e / chunk;
      const uint32_t slot = hopper::smem_u32(red + (size_t)rank * chunk + (e - dst * chunk));
      hopper::st_cluster_f32x4(cluster > 1 ? hopper::map_rank(slot, dst) : slot, acc[i][0],
                               acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (cluster > 1) hopper::cluster_sync(); else __syncthreads();   // partials landed
  for (int e = 4 * threadIdx.x; e < chunk; e += 4 * blockDim.x) {
    const int flat = rank * chunk + e, row = flat / NT;
    if (row >= m) break;
    float4 v = *reinterpret_cast<const float4*>(red + e);
    for (int q = 1; q < cluster; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(red + (size_t)q * chunk + e);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    store4_f32(out, bias, v, row, n0 + flat % NT, m, N, split, mode, act);
  }
}

// ---- fp32, more rows: 3xTF32 on wgmma (skinny_tf32x3_kernel) -----------------

// The swapped product outT (N, m) = WT X^T: WGS consumer warpgroups each
// own 64 W columns (the wgmma's M) over the row tile `rt` (its N: X's
// rows, a multiple of 8 up to 128, as 64-wide pieces and a tail).  W's
// tile is the register A operand, split into big and small in registers;
// X^T is the K-major B operand: the caller's split pass has written X big
// and small as (2, mp, K) rows, which the producer loads 32 k deep.  A
// producer warpgroup (one thread issues the loads) hands its registers to
// two consumer warpgroups (setmaxnreg).
constexpr int X3_PRODUCER_REGS = 40, X3_CONSUMER_REGS = 232;
constexpr int X3_MAX_ROWS = 128;

template <int WGS>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
skinny_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                     float* __restrict__ out, int m, int N, int natural, int bk, int bn, int kps,
                     int stages, int cluster, int rtiles, int rt, int mp, int mode, int act) {
  constexpr int BN = 64 * WGS;             // W columns of the CTA tile
  constexpr uint32_t W_BYTES = BN * 128;
  constexpr int LDT = BN + 4;              // row stride (floats) of the output tile
  const uint32_t X_BYTES = rt * 128;       // one of big / small
  const uint32_t STAGE = W_BYTES + 2 * X_BYTES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + stages * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };

  // grid x: (column tile, row tile, cluster rank), the rank fastest and
  // the row tiles next, so the CTAs that read one W column tile run
  // together and share it through L2; rank q of a cluster of C takes
  // stages [q*T/C, (q+1)*T/C) of its split's T = kps/32
  const int rank = (int)hopper::cluster_rank();
  const int tile_id = blockIdx.x / cluster;
  const int r0 = (tile_id % rtiles) * rt;
  const int n0 = (tile_id / rtiles) * BN;
  const int split = blockIdx.z;
  const int T = kps / FBK;
  const int t0 = rank * T / cluster, ktiles = (rank + 1) * T / cluster - t0;
  const int kstart = split * kps + t0 * FBK;
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
    if constexpr (WGS == 2) hopper::setmaxnreg_dec<X3_PRODUCER_REGS>();
    if (warp == 4 * WGS && lane == 0) {
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(empty(s), ((t / stages) - 1) & 1);
        hopper::mbar_expect_tx(full(s), STAGE);
        const int k = kstart + t * FBK;
        const uint32_t st = base + s * STAGE;
        load_w_f32(st, &wmap, full(s), BN / 32, k, n0, natural, bk, bn, N / bn);
        hopper::tma_load_2d(st + W_BYTES, &xmap, full(s), k, r0);
        hopper::tma_load_2d(st + W_BYTES + X_BYTES, &xmap, full(s), k, mp + r0);
      }
    }
    // the producer warpgroup's part of the cluster's two barriers below
    __syncwarp();
    if (cluster > 1) {
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    return;
  }

  if constexpr (WGS == 2) hopper::setmaxnreg_inc<X3_CONSUMER_REGS>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, tq = lane % 4;
  // The W column (in the CTA tile) of fragment row 16w + g + 8h of
  // warpgroup wg: a permutation of the 64 columns chosen so that the 32
  // lanes of each fragment read hit 32 different banks of the swizzled
  // tile (lane (g, tq) reads k = tq (+4): chunk ((c % 32) / 4) ^ (k % 8)).
  auto wcol = [&](int h) {
    return 64 * wg + 32 * (w >> 1) + 8 * (w & 1) + 16 * (g >> 2) + (g & 3) + 4 * h;
  };
  const int c0 = wcol(0), c1 = wcol(1);
  const int q = rt / 64, tail = rt % 64;
  float acc[2][32];   // this stage's sums (the tensor cores truncate)
  float sum[2][32];   // the running sums, added with round-to-nearest
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = sum[c][i] = 0.f;

  // the k loop for one piece layout (Q pieces of 64 rows, then a TAIL-wide
  // one), chosen once below, as in tall_tf32x3_kernel
  auto mainloop = [&](auto q_c, auto tail_c) {
    constexpr int Q = decltype(q_c)::value, TAIL = decltype(tail_c)::value;
    for (int t = 0; t < ktiles; ++t) {
      const int s = t % stages;
      hopper::mbar_wait(full(s), (t / stages) & 1);
      const uint8_t* ws = sm + s * STAGE;
      const uint32_t big = base + s * STAGE + W_BYTES, small = big + X_BYTES;
      // the m64k8 fragments of the stage's 4 k8 steps, split in registers
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 8 * kk + tq + 4 * (e >> 1);
          const float x = *reinterpret_cast<const float*>(ws + w_off(k, (e & 1) ? c1 : c0));
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

  // The tile goes to shared memory transposed, as rt rows of X x BN W
  // columns (the drained ring).  Accumulator value i of piece c: fragment
  // row 16w + g + 8 ((i / 2) % 2) (a W column), column 64c + (i / 4) * 8 +
  // 2 tq + i % 2 (a row of X).  Then rank d of the cluster owns elements
  // [d*chunk, (d+1)*chunk) of the row-major tile: it adds every rank's
  // tile there (distributed shared memory, in rank order) and every
  // consumer thread stores 4 columns of a row.
  float* tile = reinterpret_cast<float*>(sm);
  hopper::named_sync(1, 128 * WGS);   // every stage consumed by both warpgroups
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int width = c < q ? 64 : c == q ? tail : 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < width / 2)
        tile[(64 * c + (i / 4) * 8 + 2 * tq + i % 2) * LDT + ((i / 2) % 2 ? c1 : c0)] = sum[c][i];
  }
  if (cluster > 1) hopper::cluster_sync(); else hopper::named_sync(1, 128 * WGS);
  const int chunk = rt * BN / cluster;
  for (int e = 4 * threadIdx.x; e < chunk; e += 4 * 128 * WGS) {
    const int flat = rank * chunk + e, lr = flat / BN, col = flat % BN;
    if (r0 + lr >= m) break;
    const float* at = tile + lr * LDT + col;
    float4 v = *reinterpret_cast<const float4*>(at);
    if (cluster > 1) {
      const uint32_t addr = hopper::smem_u32(at);
      v = hopper::ld_cluster_f32x4(hopper::map_rank(addr, 0));
      for (int r = 1; r < cluster; ++r) {
        const float4 w = hopper::ld_cluster_f32x4(hopper::map_rank(addr, r));
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
    }
    store4_f32(out, bias, v, r0 + lr, n0 + col, m, N, split, mode, act);
  }
  if (cluster > 1) hopper::cluster_sync();   // every rank's tile read
}

// X big and small for the 3xTF32 design: xs is (2, mp, K), xs[0][r][k] =
// tf32(X[r][k]) and xs[1][r][k] = tf32(X[r][k] - xs[0][r][k]), zeros for
// rows m .. mp.  One float4 a thread, coalesced both ways.
__global__ void __launch_bounds__(256)
x_split_kernel(const float* __restrict__ x, float* __restrict__ xs, int m, int mp, int K,
               int ldx) {
  const int k4 = K / 4;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)mp * k4) return;
  const int r = (int)(i / k4), c = 4 * (int)(i - (size_t)r * k4);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < m) v = *reinterpret_cast<const float4*>(x + (size_t)r * ldx + c);
  const float4 b = make_float4(hopper::to_tf32(v.x), hopper::to_tf32(v.y),
                               hopper::to_tf32(v.z), hopper::to_tf32(v.w));
  *reinterpret_cast<float4*>(xs + (size_t)r * K + c) = b;
  *reinterpret_cast<float4*>(xs + ((size_t)mp + r) * K + c) =
      make_float4(hopper::to_tf32(v.x - b.x), hopper::to_tf32(v.y - b.y),
                  hopper::to_tf32(v.z - b.z), hopper::to_tf32(v.w - b.w));
}

// An fp32 map of `rows` x K (row stride `ld` floats), boxes of 32 k x
// `box` rows, 128-byte swizzle.
bool map_rows_f32(CUtensorMap* map, const void* p, int rows, int K, int ld, int box) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 4};
  const uint32_t boxd[2] = {FBK, (uint32_t)box};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, 2, dims, strides, boxd,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// W's fp32 map: natural (K, N) or the packed (nk*nn*bk, bn) view, boxes of
// 32 columns x 32 k, 128-byte swizzle.
bool map_w_f32(CUtensorMap* map, const void* w, int K, int N, int bn, int natural) {
  const uint64_t dims[2] = {natural ? (uint64_t)N : (uint64_t)bn,
                            natural ? (uint64_t)K : (uint64_t)K * (N / bn)};
  const uint64_t strides[1] = {(natural ? (uint64_t)N : (uint64_t)bn) * 4};
  const uint32_t box[2] = {32, FBK};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, 2, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int MT, int NT>
cudaError_t launch_f32(const CUtensorMap& xmap, const CUtensorMap& wmap, const void* bias,
                       void* out, int m, int N, int natural, int bk, int bn, int splits, int kps,
                       int cluster, int stages, int mode, int act, cudaStream_t stream) {
  const uint32_t stage = (MT + NT) * 128;
  if (stages < 2 || ring_bytes(stage, stages) > 232448 ||
      (size_t)stages * stage < (size_t)MT * NT * 4)
    return cudaErrorInvalidValue;
  static const cudaError_t raised = raise_smem(skinny_f32_kernel<MT, NT>);
  if (raised != cudaSuccess) return raised;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / NT) * cluster, 1, splits);
  cfg.blockDim = dim3(F_CONSUMERS + 32);
  cfg.dynamicSmemBytes = ring_bytes(stage, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, skinny_f32_kernel<MT, NT>, xmap, wmap, static_cast<const float*>(bias),
      static_cast<float*>(out), m, N, natural, bk, bn, kps, stages, cluster, mode, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_f32_mt(int mt, const CUtensorMap& xmap, const CUtensorMap& wmap,
                          const void* bias, void* out, int m, int N, int natural, int bk, int bn,
                          int splits, int kps, int cluster, int stages, int mode, int act,
                          cudaStream_t s) {
  // rows of the tile: at least one a consumer thread row (128 / (NT / 4))
  switch (mt) {
    case 8:
      if constexpr (NT >= 64)
        return launch_f32<8, NT>(xmap, wmap, bias, out, m, N, natural, bk, bn, splits, kps,
                                 cluster, stages, mode, act, s);
      return cudaErrorInvalidValue;
    case 16: return launch_f32<16, NT>(xmap, wmap, bias, out, m, N, natural, bk, bn, splits, kps,
                                       cluster, stages, mode, act, s);
    case 32: return launch_f32<32, NT>(xmap, wmap, bias, out, m, N, natural, bk, bn, splits, kps,
                                       cluster, stages, mode, act, s);
    case 64: return launch_f32<64, NT>(xmap, wmap, bias, out, m, N, natural, bk, bn, splits, kps,
                                       cluster, stages, mode, act, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int WGS>
cudaError_t launch_tf32x3(const CUtensorMap& xmap, const CUtensorMap& wmap, const void* bias,
                          void* out, int m, int N, int natural, int bk, int bn, int splits,
                          int kps, int rt, int rtiles, int mp, int cluster, int stages, int mode,
                          int act, cudaStream_t stream) {
  const uint32_t stage = 64 * WGS * 128 + 2 * rt * 128;
  if (stages < 2 || ring_bytes(stage, stages) > 232448 ||
      (size_t)stages * stage < (size_t)rt * (64 * WGS + 4) * 4)
    return cudaErrorInvalidValue;
  static const cudaError_t raised = raise_smem(skinny_tf32x3_kernel<WGS>);
  if (raised != cudaSuccess) return raised;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / (64 * WGS)) * rtiles * cluster, 1, splits);
  cfg.blockDim = dim3(128 * (WGS + 1));
  cfg.dynamicSmemBytes = ring_bytes(stage, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, skinny_tf32x3_kernel<WGS>, xmap, wmap, static_cast<const float*>(bias),
      static_cast<float*>(out), m, N, natural, bk, bn, kps, stages, cluster, rtiles, rt, mp,
      mode, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The fp32 designs' launch: f32 (bm = the tile's rows, 8 .. 64, at least
// 512 / nt; nt 32, 64 or 128; the cluster) or tf32x3 (the X split pass into
// `scratch`, then the wgmma kernel: bm = the row tile, a multiple of 8 up
// to 128; nt 64 or 128 W columns, one or two consumer warpgroups).
cudaError_t launch_fp32(const void* x, const void* w, const void* bias, void* out, void* scratch,
                        int m, int K, int N, int ldx, int bk, int bn, int natural, int splits,
                        int kps, int design, int bm, int nt, int cluster, int stages, int mode,
                        int act, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  if (!map_w_f32(&wmap, w, K, N, bn, natural)) return cudaErrorInvalidValue;
  if (design == DESIGN_F32) {
    if (m > bm || !map_rows_f32(&xmap, x, m, K, ldx, bm)) return cudaErrorInvalidValue;
    switch (nt) {
      case 32: return launch_f32_mt<32>(bm, xmap, wmap, bias, out, m, N, natural, bk, bn, splits,
                                        kps, cluster, stages, mode, act, s);
      case 64: return launch_f32_mt<64>(bm, xmap, wmap, bias, out, m, N, natural, bk, bn, splits,
                                        kps, cluster, stages, mode, act, s);
      case 128: return launch_f32_mt<128>(bm, xmap, wmap, bias, out, m, N, natural, bk, bn,
                                          splits, kps, cluster, stages, mode, act, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (bm % 8 != 0 || bm > X3_MAX_ROWS || (nt != 64 && nt != 128) || scratch == nullptr ||
      (uintptr_t)scratch % 16 != 0)
    return cudaErrorInvalidValue;
  const int rtiles = (m + bm - 1) / bm, mp = rtiles * bm;
  const size_t n4 = (size_t)mp * (K / 4);
  x_split_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(scratch), m, mp, K, ldx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!map_rows_f32(&xmap, scratch, 2 * mp, K, K, bm)) return cudaErrorInvalidValue;
  if (nt == 128)
    return launch_tf32x3<2>(xmap, wmap, bias, out, m, N, natural, bk, bn, splits, kps, bm,
                            rtiles, mp, cluster, stages, mode, act, s);
  return launch_tf32x3<1>(xmap, wmap, bias, out, m, N, natural, bk, bn, splits, kps, bm, rtiles,
                          mp, cluster, stages, mode, act, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  K must split evenly into `splits`
// ranges (splits > 1 only in mode 1), N must be a multiple of the column
// tile `nt` and of bn (the wrapper pads it to bn); for a natural W, N is
// its row stride.  The launch plan comes from the caller
// (kernels/tsmm.py::skinny_plan).  fp32: design 0 (f32: bm, the rows of
// the tile, 8, 16, 32 or 64 and at least m and 512 / nt; nt 32, 64 or
// 128; a cluster of 1, 2, 4 or 8 CTAs, at most one per 32-deep stage of a
// split) or 3 (tf32x3: bm, the row tile, a multiple of 8 up to 128; nt 64
// or 128; no cluster; `scratch` holds 2 x ceil(m / bm) * bm x K fp32 for X
// big and small).  bf16: design 1 (wgmma: bm 64 or 128, nt 128, no
// cluster) or 2 (stream, m <= 8: bm 8, nt 128, a cluster of 1, 2, 4 or 8
// CTAs, at most one per 64-deep stage of a split).  stages, the ring
// depth.  Both dtypes need X and W 16-byte aligned, ldx a multiple of 16
// bytes, K / splits a whole number of stages (fp32 32 deep, bf16 64) and,
// for a packed W, whole stages and tiles in a block (fp32: 32 | bk, nt |
// bn; bf16: 64 | bk, 128 | bn), and a ring that fits shared memory and
// holds the fp32 tile.  Returns cudaGetLastError() after the launch
// (non-zero: the launch was refused).
extern "C" int tsmm_skinny_launch(const void* x, const void* w, const void* bias, void* out,
                                  void* scratch, int m, int K, int N, int ldx, int bk, int bn,
                                  int natural, int splits, int mode, int act, int dtype,
                                  int design, int bm, int nt, int cluster, int stages,
                                  void* stream) {
  if (m <= 0 || K <= 0 || N <= 0 || ldx < K || splits <= 0 || K % splits != 0 || bk <= 0 ||
      bn <= 0 || N % bn != 0 || nt <= 0 || N % nt != 0 || mode < 0 || mode > 1 || act < 0 ||
      act > 3 || (splits > 1 && mode != MODE_PARTIAL) || (!natural && K % bk != 0) ||
      ((uintptr_t)x | (uintptr_t)w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int kps = K / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (kps % FBK != 0 || ldx % 4 != 0 || (!natural && (bk % FBK != 0 || bn % nt != 0)))
      return (int)cudaErrorInvalidValue;
    if ((design == DESIGN_F32 || design == DESIGN_TF32X3) &&
        (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) && kps / FBK >= cluster)
      return (int)launch_fp32(x, w, bias, out, scratch, m, K, N, ldx, bk, bn, natural, splits,
                              kps, design, bm, nt, cluster, stages, mode, act, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1 || nt != NT || kps % BK != 0 || ldx % 8 != 0 ||
      (!natural && (bk % BK != 0 || bn % NT != 0)))
    return (int)cudaErrorInvalidValue;
  if (design == DESIGN_WGMMA && cluster == 1 && (bm == 64 || bm == 128)) {
    return (int)(bm == 128
        ? launch_wgmma<2>(x, w, bias, out, m, K, N, ldx, bk, bn, natural, splits, kps, stages,
                          mode, act, s)
        : launch_wgmma<1>(x, w, bias, out, m, K, N, ldx, bk, bn, natural, splits, kps, stages,
                          mode, act, s));
  }
  if (design == DESIGN_STREAM && bm == STREAM_ROWS && m <= STREAM_ROWS &&
      (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) && kps / BK >= cluster)
    return (int)launch_stream(x, w, bias, out, m, K, N, ldx, bk, bn, natural, splits, kps,
                              cluster, stages, mode, act, s);
  return (int)cudaErrorInvalidValue;
}
