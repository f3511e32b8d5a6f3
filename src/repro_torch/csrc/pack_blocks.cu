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
// What bounds it.  No arithmetic to speak of: reading the operand once and
// writing the packed copy once over HBM bandwidth.  Both sides are runs of
// contiguous rows: a chunk of `rows` rows of one output block reads `rows`
// source row segments of bk elements (K apart) and writes one contiguous
// run of rows * bk elements.  Two designs, chosen by the launch plan
// (kernels/tsmm.py::pack_plan):
//
// * pack_tma_kernel (large packs: weights at load, the prefill A pack): a
//   persistent grid of a few CTAs per SM walks the chunks (chunk c, c +
//   grid, ...).  One thread moves everything through a ring of
//   mbarrier-guarded shared-memory stages: a TMA tile load of the chunk's
//   source box from a 3-D tensor map over (K, M, L), whose out-of-bounds
//   fill writes the padding rows and columns, then a TMA tile store through
//   a 3-D map over the output viewed as (bk, bm, L*nm*nk).  A stage is
//   reloaded once its store has read it (bulk wait_group.read), so loads of
//   the next stages and the previous store stay in flight.  A box is at
//   most 256 elements a side, so bk > 256 moves as bk / 256 boxes.  With
//   alpha != 1 every thread passes the stage through registers in fp32
//   before the store (then fence.proxy.async orders those writes before
//   the TMA store reads them).  No registers carry the data at alpha = 1.
// * pack_vec_kernel (small packs, such as the per-call decode pack of an
//   unpacked weight, and every layout TMA refuses): one CTA per `rows` rows
//   of one output block, so a small pack still spreads over every SM.
//   Each thread owns one column vector of 16 bytes (or the widest access
//   that divides a block row) and moves it for up to four rows, all four
//   loads in flight before the stores.  Block coordinates are computed once
//   per CTA, the source offset once per vector.  A vector whose source is
//   misaligned (K * esize not a multiple of the access) or straddles the
//   edge of K takes a predicated element-wise path inside the kernel.

#include "hopper.cuh"

namespace {

constexpr int DESIGN_VEC = 0, DESIGN_TMA = 1;
constexpr int VEC_UNROLL = 4;          // rows a vec thread has in flight
constexpr int MAX_THREADS = 256;
constexpr int SMEM_MAX = 232448;       // opt-in shared memory of one CTA

// An element as its bits: uint16_t (bf16) or uint32_t (fp32).
__device__ __forceinline__ float to_f(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float to_f(uint16_t b) { return __uint_as_float((uint32_t)b << 16); }
template <typename E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ uint32_t from_f<uint32_t>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint16_t from_f<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));   // round to nearest even
}

template <int AW> struct Raw;
template <> struct Raw<16> { typedef uint4 type; };
template <> struct Raw<8> { typedef uint2 type; };
template <> struct Raw<4> { typedef uint32_t type; };
template <> struct Raw<2> { typedef uint16_t type; };

// one access of AW bytes, seen whole or element by element
template <typename E, int AW>
union Vec {
  typename Raw<AW>::type raw;
  E e[AW / sizeof(E)];
};

template <typename E, int AW>
__device__ __forceinline__ void scale(Vec<E, AW>& v, float alpha) {
#pragma unroll
  for (int e = 0; e < AW / (int)sizeof(E); ++e) v.e[e] = from_f<E>(to_f(v.e[e]) * alpha);
}

// ---- pack_vec ------------------------------------------------------------

// grid.x: (output block, chunk of `rows` rows), the chunks of a block
// adjacent; blockDim (column vectors, rows); each thread walks rows
// threadIdx.y, + blockDim.y, ... of its chunk, VEC_UNROLL at a time.
template <typename E, int AW, bool SCALE>
__global__ void __launch_bounds__(MAX_THREADS)
pack_vec_kernel(const E* __restrict__ a, E* __restrict__ out, int M, int K, int nm, int nk,
                int bm, int bk, int rows, int cpb, float alpha) {
  typedef typename Raw<AW>::type RawT;
  constexpr int V = AW / (int)sizeof(E);
  const int blk = blockIdx.x / cpb;
  const int g = blockIdx.x - blk * cpb;
  const int l = blk / (nm * nk);
  const int ij = blk - l * nm * nk;
  const int i = ij / nk, j = ij - i * nk;
  const E* src = a + (size_t)l * M * K;
  E* dst = out + (size_t)blk * bm * bk;
  const int r_beg = g * rows, r_end = min(bm, r_beg + rows);
  const int step = blockDim.y;
  for (int c = threadIdx.x * V; c < bk; c += blockDim.x * V) {
    const int col = j * bk + c;
    const bool cols_in = col + V <= K;
    for (int r0 = r_beg + threadIdx.y; r0 < r_end; r0 += VEC_UNROLL * step) {
      Vec<E, AW> v[VEC_UNROLL];
      bool whole[VEC_UNROLL];
#pragma unroll
      for (int u = 0; u < VEC_UNROLL; ++u) {
        const int r = r0 + u * step, row = i * bm + r;
        const E* p = src + (size_t)row * K + col;
        whole[u] = r < r_end && row < M && cols_in && (reinterpret_cast<uintptr_t>(p) % AW) == 0;
        if (whole[u]) v[u].raw = __ldg(reinterpret_cast<const RawT*>(p));
      }
#pragma unroll
      for (int u = 0; u < VEC_UNROLL; ++u) {
        const int r = r0 + u * step, row = i * bm + r;
        if (whole[u] || r >= r_end) continue;
        const E* p = src + (size_t)row * K + col;
#pragma unroll
        for (int e = 0; e < V; ++e) v[u].e[e] = (row < M && col + e < K) ? __ldg(p + e) : E(0);
      }
#pragma unroll
      for (int u = 0; u < VEC_UNROLL; ++u) {
        const int r = r0 + u * step;
        if (r >= r_end) continue;
        if (SCALE) scale(v[u], alpha);
        *reinterpret_cast<RawT*>(dst + (size_t)r * bk + c) = v[u].raw;
      }
    }
  }
}

template <typename E, int AW>
cudaError_t launch_vec_aw(const void* a, void* out, int M, int K, int nm, int nk, int bm, int bk,
                          float alpha, int rows, int grid, int threads, cudaStream_t s) {
  const int vpr = bk / (AW / (int)sizeof(E));
  const int tx = vpr < threads ? vpr : threads;
  const dim3 block(tx, threads / tx);
  const int cpb = (bm + rows - 1) / rows;
  const E* pa = static_cast<const E*>(a);
  E* po = static_cast<E*>(out);
  if (alpha != 1.f)
    pack_vec_kernel<E, AW, true><<<grid, block, 0, s>>>(pa, po, M, K, nm, nk, bm, bk, rows, cpb,
                                                       alpha);
  else
    pack_vec_kernel<E, AW, false><<<grid, block, 0, s>>>(pa, po, M, K, nm, nk, bm, bk, rows,
                                                        cpb, alpha);
  return cudaGetLastError();
}

// `box`: the elements of one access (AW = box * esize bytes)
template <typename E>
cudaError_t launch_vec(const void* a, void* out, int L, int M, int K, int nm, int nk, int bm,
                       int bk, float alpha, int rows, int grid, int threads, int box,
                       cudaStream_t s) {
  const int aw = box * (int)sizeof(E);
  if (rows <= 0 || threads <= 0 || threads > MAX_THREADS || box <= 0 || bk % box != 0 ||
      (aw != 16 && aw != 8 && aw != 4 && aw != 2) || aw < (int)sizeof(E) ||
      (reinterpret_cast<uintptr_t>(out) % aw) != 0 ||
      (long long)grid != (long long)L * nm * nk * ((bm + rows - 1) / rows))
    return cudaErrorInvalidValue;
  switch (aw) {
    case 16: return launch_vec_aw<E, 16>(a, out, M, K, nm, nk, bm, bk, alpha, rows, grid,
                                         threads, s);
    case 8: return launch_vec_aw<E, 8>(a, out, M, K, nm, nk, bm, bk, alpha, rows, grid,
                                       threads, s);
    case 4: return launch_vec_aw<E, 4>(a, out, M, K, nm, nk, bm, bk, alpha, rows, grid,
                                       threads, s);
    default:   // 2 bytes: bf16 alone (aw >= esize above)
      if constexpr (sizeof(E) == 2)
        return launch_vec_aw<E, 2>(a, out, M, K, nm, nk, bm, bk, alpha, rows, grid, threads, s);
      else
        return cudaErrorInvalidValue;
  }
}

// ---- pack_tma ------------------------------------------------------------

// Shared memory: a 128-aligned ring of `stages` stages, each a chunk of
// rows x bk elements as bk / box boxes of rows x box (box b holds the
// chunk's columns [b*box, (b+1)*box)), then one full mbarrier per stage.
inline size_t tma_smem(int rows, int bk, int stages, int esize) {
  return 128 + (size_t)stages * ((size_t)rows * bk * esize + 8);
}

template <typename E, bool SCALE>
__global__ void __launch_bounds__(MAX_THREADS)
pack_tma_kernel(const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap dmap,
                int chunks, int cpb, int nm, int nk, int bm, int bk, int rows, int box,
                int boxes, int stages, float alpha) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  const uint32_t sub = (uint32_t)rows * box * sizeof(E);     // one box: a multiple of 128
  const uint32_t stage = sub * boxes;
  const uint32_t bars = base + stages * stage;
  const int mine = (int)blockIdx.x < chunks ? (chunks - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(bars + 8u * s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (!SCALE && threadIdx.x != 0) return;
  const CUtensorMap* sm = &smap;
  const CUtensorMap* dm = &dmap;

  // chunk t of this CTA: output block blk = (l, i, j) and rows [g*rows, +rows)
  auto load = [&](int t) {
    const int chunk = blockIdx.x + t * gridDim.x;
    const int blk = chunk / cpb, g = chunk - blk * cpb;
    const int l = blk / (nm * nk), ij = blk - l * nm * nk;
    const int i = ij / nk, j = ij - i * nk;
    const int s = t % stages;
    hopper::mbar_expect_tx(bars + 8u * s, stage);
    for (int b = 0; b < boxes; ++b)
      hopper::tma_load_3d(base + s * stage + b * sub, sm, bars + 8u * s, j * bk + b * box,
                          i * bm + g * rows, l);
  };
  auto store = [&](int t) {
    const int chunk = blockIdx.x + t * gridDim.x;
    const int blk = chunk / cpb, g = chunk - blk * cpb;
    const int s = t % stages;
    for (int b = 0; b < boxes; ++b)
      hopper::tma_store_3d(dm, base + s * stage + b * sub, b * box, g * rows, blk);
    hopper::bulk_commit();
  };

  if (threadIdx.x == 0)
    for (int t = 0; t < min(stages, mine); ++t) load(t);
  for (int t = 0; t < mine; ++t) {
    const int s = t % stages;
    hopper::mbar_wait(bars + 8u * s, (t / stages) & 1);
    if (SCALE) {
      uint4* v = reinterpret_cast<uint4*>(smem_raw + (base - raw) + s * stage);
      for (uint32_t x = threadIdx.x; x < stage / 16; x += blockDim.x) {
        Vec<E, 16> w;
        w.raw = v[x];
        scale(w, alpha);
        v[x] = w.raw;
      }
      hopper::fence_proxy_async();
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      store(t);
      // refill the stage the previous chunk's store has finished reading,
      // leaving this chunk's store in flight
      if (t >= 1 && t - 1 + stages < mine) {
        hopper::bulk_wait_read<1>();
        load(t - 1 + stages);
      }
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<0>();
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

// `rows` | bm, `box` | bk (box <= 256, box * esize a multiple of 16), the
// source 16-byte aligned with K * esize a multiple of 16, a ring of at
// least 2 stages (a stage is refilled only after the next chunk's store
// is issued); `grid` CTAs walk the L * nm * nk * (bm / rows) chunks.
template <typename E>
cudaError_t launch_tma(const void* a, void* out, int L, int M, int K, int nm, int nk, int bm,
                       int bk, float alpha, int rows, int grid, int threads, int stages, int box,
                       cudaStream_t s) {
  const int es = (int)sizeof(E);
  const long long chunks = (long long)L * nm * nk * (bm / (rows > 0 ? rows : 1));
  if (rows <= 0 || rows > 256 || bm % rows != 0 || box <= 0 || box > 256 || bk % box != 0 ||
      (box * es) % 16 != 0 || ((long long)rows * box * es) % 128 != 0 ||
      ((long long)K * es) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out)) % 16 != 0 ||
      stages < 2 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || grid <= 0 ||
      grid > chunks || chunks > 0x7fffffffLL ||
      tma_smem(rows, bk, stages, es) > (size_t)SMEM_MAX)
    return cudaErrorInvalidValue;
  const CUtensorMapDataType dt =
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap smap, dmap;
  const uint64_t sdims[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)L};
  const uint64_t sstrides[2] = {(uint64_t)K * es, (uint64_t)M * K * es};
  const uint64_t ddims[3] = {(uint64_t)bk, (uint64_t)bm, (uint64_t)L * nm * nk};
  const uint64_t dstrides[2] = {(uint64_t)bk * es, (uint64_t)bm * bk * es};
  const uint32_t tbox[3] = {(uint32_t)box, (uint32_t)rows, 1};
  if (!hopper::make_map(&smap, dt, a, 3, sdims, sstrides, tbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::make_map(&dmap, dt, out, 3, ddims, dstrides, tbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const size_t smem = tma_smem(rows, bk, stages, es);
  const int cpb = bm / rows;
  if (alpha != 1.f) {
    static const cudaError_t raised = raise_smem(pack_tma_kernel<E, true>);
    if (raised != cudaSuccess) return raised;
    pack_tma_kernel<E, true><<<grid, threads, smem, s>>>(smap, dmap, (int)chunks, cpb, nm, nk,
                                                         bm, bk, rows, box, bk / box, stages,
                                                         alpha);
  } else {
    static const cudaError_t raised = raise_smem(pack_tma_kernel<E, false>);
    if (raised != cudaSuccess) return raised;
    pack_tma_kernel<E, false><<<grid, threads, smem, s>>>(smap, dmap, (int)chunks, cpb, nm, nk,
                                                          bm, bk, rows, box, bk / box, stages,
                                                          alpha);
  }
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const void* a, void* out, int L, int M, int K, int bm, int bk, float alpha,
                   int design, int rows, int grid, int threads, int stages, int box,
                   cudaStream_t s) {
  const int nm = (M + bm - 1) / bm, nk = (K + bk - 1) / bk;
  if (design == DESIGN_TMA)
    return launch_tma<E>(a, out, L, M, K, nm, nk, bm, bk, alpha, rows, grid, threads, stages,
                         box, s);
  if (design == DESIGN_VEC)
    return launch_vec<E>(a, out, L, M, K, nm, nk, bm, bk, alpha, rows, grid, threads, box, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a: L contiguous (M, K) matrices; out:
// L contiguous (nm, nk, bm, bk) blocks with nm = ceil(M / bm), nk =
// ceil(K / bk), 16-byte aligned.  The launch plan comes from the caller
// (kernels/tsmm.py::pack_plan): design 0 (vec: `rows` rows of a block per
// CTA, `grid` = L * nm * nk * ceil(bm / rows) CTAs of `threads` threads,
// `box` elements an access) or 1 (TMA: chunks of `rows` rows, `grid`
// persistent CTAs, a ring of `stages` stages, boxes of `box` columns).
// Returns cudaGetLastError() after the launch (non-zero: the launch was
// refused, or the plan does not fit the sizes).
extern "C" int pack_blocks_launch(const void* a, void* out, int L, int M, int K, int bm, int bk,
                                  float alpha, int dtype, int design, int rows, int grid,
                                  int threads, int stages, int box, void* stream) {
  if (L <= 0 || M <= 0 || K <= 0 || bm <= 0 || bk <= 0 || grid <= 0 ||
      (long long)bm * bk > 0x7fffffffLL ||
      (long long)L * ((M + bm - 1) / bm) * ((K + bk - 1) / bk) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? launch<uint16_t>(a, out, L, M, K, bm, bk, alpha, design, rows, grid, threads, stages,
                             box, s)
          : dtype == 0 ? launch<uint32_t>(a, out, L, M, K, bm, bk, alpha, design, rows, grid,
                                          threads, stages, box, s)
                       : cudaErrorInvalidValue;
  return (int)err;
}
