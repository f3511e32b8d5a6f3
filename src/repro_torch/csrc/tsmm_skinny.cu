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
// caller, kernels/tsmm.py::skinny_plan.  Three designs:
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
// fp32 (skinny_small, skinny_large): SIMT.  wgmma has no fp32 path and
// TF32 would break the fp32 card-vs-CPU parity, so fp32 keeps the simple
// kernels: m <= 8 a CTA owns 64 columns and the split's k range, its 8
// warps striding over k; larger m a 64 x 64 tile with 16-deep k slices in
// shared memory, 4 x 4 outputs a thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };
enum { MODE_EPILOGUE = 0, MODE_PARTIAL = 1 };
enum { DESIGN_SIMT = 0, DESIGN_WGMMA = 1, DESIGN_STREAM = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v * (1.f / (1.f + expf(-v)));
  if (act == ACT_GELU)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

// ---- fp32: the SIMT kernels ------------------------------------------------

// Write one output element in the requested mode.
__device__ __forceinline__ void store_out(float* out, const float* bias, float v, int row,
                                          int col, int m, int N, int split, int mode,
                                          int act) {
  if (mode == MODE_PARTIAL) {
    out[((size_t)split * m + row) * N + col] = v;
    return;
  }
  if (bias != nullptr) v += bias[col];
  out[(size_t)row * N + col] = activate(v, act);
}

// Address of W(k, col): natural (K, N) row-major, or packed block-major
// (nk, nn, bk, bn) with each (bk, bn) block row-major.
__device__ __forceinline__ const float* w_at(const float* w, int k, int col, int N, int bk,
                                             int bn, int natural) {
  if (natural) return w + (size_t)k * N + col;
  int nn = N / bn;
  int kb = k / bk, nb = col / bn;
  return w + (((size_t)kb * nn + nb) * bk + (k - kb * bk)) * bn + (col - nb * bn);
}

constexpr int SM_MT = 8, SM_NT = 64, SM_KC = 512, SM_WARPS = 8;

__global__ void __launch_bounds__(256)
skinny_small(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out, int m, int N, int ldx,
             int bk, int bn, int natural, int kps, int mode, int act) {
  __shared__ float xs[SM_MT][SM_KC];
  __shared__ float red[SM_WARPS][SM_MT][SM_NT];
  const int n0 = blockIdx.x * SM_NT;
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
      xs[r][kk] = (r < m && kk < klen) ? x[(size_t)r * ldx + kc + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = warp; kk < klen; kk += SM_WARPS) {
      const float2 wv = __ldg(reinterpret_cast<const float2*>(
          w_at(w, kc + kk, col, N, bk, bn, natural)));
#pragma unroll
      for (int r = 0; r < SM_MT; ++r) {
        const float xv = xs[r][kk];
        acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
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
    if (r >= m) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < SM_WARPS; ++wi) v += red[wi][r][c];
    store_out(out, bias, v, r, n0 + c, m, N, split, mode, act);
  }
}

constexpr int LG_MT = 64, LG_NT = 64, LG_KT = 16;

__global__ void __launch_bounds__(256)
skinny_large(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out, int m, int N, int ldx,
             int bk, int bn, int natural, int kps, int mode, int act) {
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
      xs[kk][r] = (r0 + r < m && kt + kk < kend) ? x[(size_t)(r0 + r) * ldx + kt + kk] : 0.f;
      const int wk = idx / LG_NT, c = idx - wk * LG_NT;
      ws[wk][c] = kt + wk < kend ? *w_at(w, kt + wk, n0 + c, N, bk, bn, natural) : 0.f;
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
      store_out(out, bias, acc[i][j], row, n0 + tx * 4 + j, m, N, split, mode, act);
  }
}

cudaError_t launch_simt(const void* x, const void* w, const void* bias, void* out, int m,
                        int N, int ldx, int bk, int bn, int natural, int splits, int kps,
                        int bm, int mode, int act, cudaStream_t stream) {
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  if (bm == SM_MT) {
    skinny_small<<<dim3(N / SM_NT, 1, splits), 256, 0, stream>>>(
        xp, wp, bp, op, m, N, ldx, bk, bn, natural, kps, mode, act);
  } else {
    skinny_large<<<dim3(N / LG_NT, (m + LG_MT - 1) / LG_MT, splits), 256, 0, stream>>>(
        xp, wp, bp, op, m, N, ldx, bk, bn, natural, kps, mode, act);
  }
  return cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  K must split evenly into `splits`
// ranges (splits > 1 only in mode 1), N must be a multiple of the column
// tile `nt` and of bn (the wrapper pads it to bn); for a natural W, N is
// its row stride.  The launch plan comes from the caller
// (kernels/tsmm.py::skinny_plan): design 0 (SIMT, fp32 only: bm 8 for
// m <= 8, else 64; nt 64), 1 (wgmma, bf16: bm 64 or 128, nt 128, no
// cluster) or 2 (stream, bf16, m <= 8: bm 8, nt 128, a cluster of 1, 2, 4
// or 8 CTAs, at most one per 64-deep stage of a split); stages, the ring
// depth of the bf16 designs.  bf16 also needs X and W 16-byte aligned,
// ldx % 8 == 0, K / splits a multiple of 64 and, for a packed W, 64 | bk
// and 128 | bn (TMA boxes), and a ring that fits shared memory and holds
// the fp32 tile.  Returns cudaGetLastError() after the launch (non-zero:
// the launch was refused).
extern "C" int tsmm_skinny_launch(const void* x, const void* w, const void* bias, void* out,
                                  int m, int K, int N, int ldx, int bk, int bn, int natural,
                                  int splits, int mode, int act, int dtype, int design, int bm,
                                  int nt, int cluster, int stages, void* stream) {
  if (m <= 0 || K <= 0 || N <= 0 || ldx < K || splits <= 0 || K % splits != 0 || bk <= 0 ||
      bn <= 0 || N % bn != 0 || nt <= 0 || N % nt != 0 || mode < 0 || mode > 1 || act < 0 ||
      act > 3 || (splits > 1 && mode != MODE_PARTIAL) || (!natural && K % bk != 0))
    return (int)cudaErrorInvalidValue;
  const int kps = K / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (design != DESIGN_SIMT || cluster != 1 || nt != 64 || (bm != SM_MT && bm != LG_MT) ||
        (bm == SM_MT && m > SM_MT))
      return (int)cudaErrorInvalidValue;
    return (int)launch_simt(x, w, bias, out, m, N, ldx, bk, bn, natural, splits, kps, bm,
                            mode, act, s);
  }
  if (dtype != 1 || nt != NT || kps % BK != 0 || ldx % 8 != 0 ||
      ((uintptr_t)x | (uintptr_t)w) % 16 != 0 || (!natural && (bk % BK != 0 || bn % NT != 0)))
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
