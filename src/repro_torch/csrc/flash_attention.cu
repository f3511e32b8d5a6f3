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
// memory.  D is 32, 64, 80 or 128.
//
// What bounds it.  At GLM-4-9B's prefill (B 1, S 2048, 32 heads on 2 KV
// heads, D 128, causal) attention does 34 GFLOP over the causal triangle
// and reads ~18 MB: its bound is the flops of QK^T and PV over the
// tensor-core rate (~35 us).
//
// bf16 with D in {64, 80, 128}: a FlashAttention-3-style forward kernel
// (flash_wgmma).
//   * Tensor cores: a CTA takes 128 queries as two consumer warpgroups of
//     64 rows.  S = Q.K^T is wgmma m64n128k16 with Q and K from shared
//     memory (both K-major); the online softmax runs on the fp32
//     accumulator registers (exp2 with the scale folded in); P is cast to
//     bf16 in registers and is the register-A operand of P.V, V the
//     MN-major B operand from shared memory.
//   * Copies: a producer warp loads Q once and 128-key K/V tiles by TMA
//     into a two-stage ring with full / empty mbarriers, 128-byte swizzle.
//     The (B, S, KH, D) tensors are read through 4-D tensor maps built
//     from their strides: nothing is transposed or repeated.
//   * GQA reuse: CTAs are numbered so the G = H / KH query heads of one KV
//     head and q tile are neighbours in launch order and run together,
//     so each K/V tile is read from HBM about once and served to the
//     others from L2.
//   * Causal work: key tiles wholly above the diagonal are never loaded;
//     only tiles that cross the diagonal (or the ragged end of the keys)
//     are masked; the longest q tiles launch first.
//   * D = 80 (Zamba2's shared block) runs the D = 128 layout: its tensor
//     maps are 80 wide, so TMA zero-fills columns 80-127 of every Q, K and
//     V tile.  Q.K^T stops after the 5 16-deep steps that hold data; P.V
//     runs 128 wide (its columns 80-127 are zeros) and the store keeps the
//     first 80.  The scale is 80^-0.5.
//
// fp32, and D = 32: the SIMT kernel (flash_fwd): one CTA of 4 warps per
// (batch*head, 16-query tile); 32-key K/V tiles staged in shared memory as
// fp32; each warp owns 4 query rows, each lane one key of the tile for the
// scores and up to ceil(D/32) output dims for P.V (lane + 32 i < D), with
// warp shuffles for the row max and sum.  The wrapper picks the kernel by dtype and D
// (kernels/flash_attention.py::flash_design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

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
  constexpr int DPL = (D + 31) / 32;
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
        for (int i = 0; i < DPL; ++i)
          if (D % 32 == 0 || lane + 32 * i < D)
            acc[rr][i] = fmaf(pj, vs[j][lane + 32 * i], acc[rr][i]);
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
    for (int i = 0; i < DPL; ++i)
      if (D % 32 == 0 || lane + 32 * i < D) ob[lane + 32 * i] = from_f<T>(acc[rr][i] * inv);
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
    case 80: return launch<T, 80>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16, D 64 / 80 / 128: the wgmma kernel ---------------------------

constexpr int WBQ = 128, WBKV = 128;     // queries per CTA, keys per K/V tile
constexpr int WTHREADS = 288;            // consumer warpgroups 0, 1 + producer warp 8

template <int D>
struct FlashSmem {
  static constexpr uint32_t Q_BYTES = WBQ * D * 2;
  static constexpr uint32_t KV_BYTES = WBKV * D * 2;       // one of K or V
  static constexpr int STAGES = 2;
  static constexpr size_t BYTES = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 64;
};

// D: the shared-memory tile width (64 or 128); DR <= D: the head dim of the
// tensors (80 runs the 128-wide tiles, columns DR..D-1 zero-filled by TMA)
template <int D, int DR>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int B,
            int Sq, int Sk, int H, int KH, Strides os_, int causal, float scale_log2) {
  using L = FlashSmem<D>;
  constexpr int NCH = D / 64;            // 64-wide head-dim chunks (one TMA box each)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t skv = sq + L::Q_BYTES;
  const uint32_t bars = skv + L::STAGES * 2 * L::KV_BYTES;
  const uint32_t qbar = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + L::STAGES + s); };
  auto stage_k = [&](int s) { return skv + s * 2 * L::KV_BYTES; };
  auto stage_v = [&](int s) { return skv + s * 2 * L::KV_BYTES + L::KV_BYTES; };

  // launch order: the G query heads of one KV head are neighbours, then KV
  // heads, batches, and q tiles (longest first when causal)
  const int G = H / KH;
  int x = blockIdx.x;
  const int g = x % G;
  x /= G;
  const int kh = x % KH;
  x /= KH;
  const int b = x % B;
  const int nq = (Sq + WBQ - 1) / WBQ;
  const int qt = causal ? nq - 1 - x / B : x / B;
  const int h = kh * G + g;
  const int q0 = qt * WBQ;
  int ntiles = (Sk + WBKV - 1) / WBKV;
  if (causal) ntiles = min(ntiles, (min(q0 + WBQ, Sq) + WBKV - 1) / WBKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      hopper::mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        hopper::tma_load_4d(sq + c * WBQ * 128, &qmap, qbar, 64 * c, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % L::STAGES;
        if (t >= L::STAGES) hopper::mbar_wait(empty(s), ((t / L::STAGES) - 1) & 1);
        hopper::mbar_expect_tx(full(s), 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          hopper::tma_load_4d(stage_k(s) + c * WBKV * 128, &kmap, full(s), 64 * c, kh,
                              t * WBKV, b);
          hopper::tma_load_4d(stage_v(s) + c * WBKV * 128, &vmap, full(s), 64 * c, kh,
                              t * WBKV, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns query rows q0 + 64*wg .. +63; this thread
  // rows ra and ra + 8 (the wgmma accumulator layout)
  const int wg = warp / 4;
  const int ra = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int rb = ra + 8;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;   // m in the log2 domain
  hopper::mbar_wait(qbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::STAGES;
    hopper::mbar_wait(full(s), (t / L::STAGES) & 1);
    float sc[WBKV / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DR / 16; ++kk) {   // the zero-filled columns add nothing
      const int c = kk / 4;
      const uint64_t da = hopper::desc_sw128(
          sq + c * WBQ * 128 + wg * 64 * 128 + 32 * (kk % 4), 16, 1024);
      const uint64_t db = hopper::desc_sw128(stage_k(s) + c * WBKV * 128 + 32 * (kk % 4), 16,
                                             1024);
      hopper::wgmma_ss_n128_t0(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scores to the log2 domain; mask only tiles that cross the diagonal
    // or the end of the keys (masked scores are NEG_INF, as the reference)
    const int k0 = t * WBKV;
    const bool mask = k0 + WBKV > Sk || (causal && k0 + WBKV - 1 > q0 + 64 * wg);
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < WBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[4 * j + e] * scale_log2;
        if (mask) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const int row = e < 2 ? ra : rb;
          if (key >= Sk || (causal && key > row)) v = NEG_INF;
        }
        sc[4 * j + e] = v;
        if (e < 2) mx_a = fmaxf(mx_a, v); else mx_b = fmaxf(mx_b, v);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = hopper::exp2_approx(m_a - mn_a);
    const float corr_b = hopper::exp2_approx(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < WBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hopper::exp2_approx(sc[4 * j + e] - (e < 2 ? mn_a : mn_b));
        sc[4 * j + e] = p;
        if (e < 2) sum_a += p; else sum_b += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr_a;
      o[4 * j + 1] *= corr_a;
      o[4 * j + 2] *= corr_b;
      o[4 * j + 3] *= corr_b;
    }
    // P (cast to bf16, as the reference casts before P.V) in the register-A
    // layout: for keys 16j..16j+15, pairs of the accumulator of j
    uint32_t pr[WBKV / 16][4];
#pragma unroll
    for (int j = 0; j < WBKV / 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[j][i] = hopper::pack_bf16(sc[8 * j + 2 * i], sc[8 * j + 2 * i + 1]);

    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < WBKV / 16; ++j) {
      const uint64_t db = hopper::desc_sw128(stage_v(s) + 2048 * j, WBKV * 128, 1024);
      if constexpr (D == 128)
        hopper::wgmma_rs_n128_t1(o, pr[j], db, 1);
      else
        hopper::wgmma_rs_n64_t1(o, pr[j], db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(empty(s));
  }

  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int j = 0; j < DR / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ra * os_.s + col) =
          __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + rb * os_.s + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// a 4-D bf16 tensor map over (B, S, heads, D) read as {D, heads, S, B}
// (innermost first), box {64, 1, rows, 1}
bool map_bshd(CUtensorMap* map, const void* base, int B, int S, int Hn, int D, Strides st,
              int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)Hn, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)st.h * 2, (uint64_t)st.s * 2, (uint64_t)st.b * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

template <int D, int DR>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                         int Sk, int H, int KH, Strides qs_, Strides ks_, Strides vs_,
                         Strides os_, int causal, cudaStream_t stream) {
  using L = FlashSmem<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!map_bshd(&qmap, q, B, Sq, H, DR, qs_, WBQ) ||
      !map_bshd(&kmap, k, B, Sk, KH, DR, ks_, WBKV) ||
      !map_bshd(&vmap, v, B, Sk, KH, DR, vs_, WBKV))
    return cudaErrorInvalidValue;
  static const cudaError_t raised = cudaFuncSetAttribute(
      flash_wgmma<D, DR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (raised != cudaSuccess) return raised;
  const int nq = (Sq + WBQ - 1) / WBQ;
  flash_wgmma<D, DR><<<nq * B * H, WTHREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H, KH, os_, causal,
      1.4426950408889634f / sqrtf((float)DR));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = the SIMT kernel (any
// dtype, D 32 / 64 / 80 / 128), 1 = the wgmma kernel (bf16, D 64 / 80 / 128; every
// tensor 16-byte aligned with strides of a multiple of 8 elements, the TMA
// rule).  Strides are in elements; the last dim of every tensor is
// contiguous.  Returns cudaGetLastError() after the launch (non-zero:
// refused, or an unsupported D / design).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int KH, int D,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      long long osb, long long oss, long long osh,
                                      int causal, int dtype, int design, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  Strides qs_{qsb, qss, qsh}, ks_{ksb, kss, ksh}, vs_{vsb, vss, vsh}, os_{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D == 128)
      return (int)launch_wgmma<128, 128>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal,
                                         s);
    if (D == 80)
      return (int)launch_wgmma<128, 80>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal,
                                        s);
    if (D == 64)
      return (int)launch_wgmma<64, 64>(q, k, v, out, B, Sq, Sk, H, KH, qs_, ks_, vs_, os_, causal,
                                       s);
    return (int)cudaErrorInvalidValue;
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtype == 1
      ? dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, D, qs_, ks_, vs_, os_, causal, s)
      : dispatch_d<float>(q, k, v, out, B, Sq, Sk, H, KH, D, qs_, ks_, vs_, os_, causal, s);
  return (int)err;
}
