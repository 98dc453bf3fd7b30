// The pieces the MLP forward (mlp_fwd.cuh, rows 1 and 6) and backward
// (mlp_bwd.cuh, rows 2 and 7) are both built from: row passes over [n, d]
// rows for any d, one bf16 GEMM kernel on wgmma with TMA operands
// (namespace wg), one f32 GEMM kernel on SIMT FMA (namespace simt), and the
// elementwise epilogues both GEMMs apply in their own register layouts.
//
// Shapes: d and f are multiples of 64 (the wrappers zero-pad any other
// width to the next multiple, ops/fused_mlp.py); n, the rows, is any
// positive count. The LN forms normalize over the first d_ln <= d columns
// (the true width; the padded columns of x, gamma and beta are zero). The
// products are
//   forward   fc1 = y W1   ([n, d] x [d, f]) -> GELU, keep bit -> g
//             fc2 = g W2   ([n, f] x [f, d]) -> bias, keep bit, residual
//   backward  dg = df W2^T, dy = dh W1^T, dW1 = y^T dh, dW2 = g^T df
// with y = LN(x) (rows 1, 2) or x (rows 6, 7).
#pragma once

#include "hopper.cuh"
#include "vit_common.cuh"

namespace vit {
namespace mlp {

constexpr int kRowThreads = 256;  // row passes: 8 warps, a warp per row
constexpr int kRowBM = 32;        // rows per CTA of the row passes

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int row_tiles(int n) { return cdiv(n, kRowBM); }

// Argument checks shared by every MLP entry point.
inline bool valid_shape(int dtype, int n, int d, int f, int d_ln) {
  return (dtype == 0 || dtype == 1) && n > 0 && d > 0 && f > 0 &&
         d % 64 == 0 && f % 64 == 0 && d_ln > 0 && d_ln <= d;
}

// A warp walks a row of d columns in chunks of kChunk * 32: lane j holds
// columns c0 + j, c0 + j + 32, ... of the chunk in registers (zero past
// d), so a chunk's loads are in flight together whatever d is (one chunk
// up to D = 768, two at 1024 and 1280).
constexpr int kChunk = 24;

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int c0,
                                           int d, float (&v)[kChunk]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int c = c0 + 32 * j + lane;
    v[j] = c < d ? to_f32(row[c]) : 0.0f;
  }
}

// LN statistics of one row xr[0..d) (one warp; d is the true width d_ln):
// f32, a two-pass mean and centred variance, lane j summing columns j,
// j + 32, ... in order.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int d,
                                          float& mu, float& rstd, float eps) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f, v[kChunk];
  for (int c0 = 0; c0 < d; c0 += 32 * kChunk) {
    load_chunk(xr, c0, d, v);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s += v[j];
  }
  mu = warp_sum(s) / static_cast<float>(d);
  float s2 = 0.0f;
  for (int c0 = 0; c0 < d; c0 += 32 * kChunk) {
    load_chunk(xr, c0, d, v);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float c = v[j] - mu;
      if (c0 + 32 * j + lane < d) s2 += c * c;
    }
  }
  rstd = rsqrtf(warp_sum(s2) / static_cast<float>(d) + eps);
}

// y_c = cast(LN(x)) for 32 rows per CTA, one warp per row, statistics over
// the first d_ln columns of the d-wide rows (y_c is 0 past d_ln, where gamma
// and beta are 0); with DF also df_c = cast(keep1 dO / keep) (the
// backward's fc2 output gradient).
template <typename T, bool DF>
__global__ void __launch_bounds__(kRowThreads)
    ln_rows_pre(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ dout,
                T* __restrict__ y_c, T* __restrict__ df_c, int n, int d,
                int d_ln, float eps, uint32_t seed, int threshold,
                float inv_keep) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRowBM; r += kRowThreads / 32) {
    const int grow = blockIdx.x * kRowBM + r;
    if (grow >= n) break;
    const size_t base = static_cast<size_t>(grow) * d;
    float mu, rstd;
    row_stats(x + base, d_ln, mu, rstd, eps);
    for (int c0 = 0; c0 < d; c0 += 32 * kChunk) {
      float v[kChunk], g[kChunk];
      load_chunk(x + base, c0, d, v);
      if constexpr (DF) load_chunk(dout + base, c0, d, g);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int col = c0 + 32 * j + lane;
        if (col >= d) continue;
        y_c[base + col] =
            from_f32<T>((v[j] - mu) * rstd * gamma[col] + beta[col]);
        if constexpr (DF) {
          float df = g[j];
          if (threshold)
            df = positional_keep(seed, 1u, grow, col, threshold)
                     ? df * inv_keep
                     : 0.0f;
          df_c[base + col] = from_f32<T>(df);
        }
      }
    }
  }
}

// ------------------------------------------------------------- epilogues
// The GEMMs' epilogues, by kind. Forward: kFc1 (h = acc + b1, h saved in
// the compute dtype when h_out is set, g = keep0 gelu(h) / keep stored in
// the compute dtype), kFc2Res (out = x + keep1 (acc + b2) / keep, LN
// forms), kFc2 (out = acc + b2, core forms). Backward: kStoreF32 (f32
// store, split z at c32 + z m n), kStoreOut (cast and store to out),
// kHiddenGrad (dh, g_drop from the saved h: dh_c and g_c stored in the
// compute dtype, the f32 dh summed over the tile's rows into p_db1).
enum Epi {
  kStoreF32 = 0,
  kStoreOut = 1,
  kHiddenGrad = 2,
  kFc1 = 3,
  kFc2Res = 4,
  kFc2 = 5
};

template <typename T>
struct EpiArgs {
  float* c32;       // kStoreF32
  T* out;           // kStoreOut, kFc1 (g), kFc2Res, kFc2
  const T* bias;    // kFc1 (b1), kFc2Res / kFc2 (b2)
  const T* x;       // kFc2Res: the residual [m, n]
  T* h_out;         // kFc1: the saved h, or null
  const T* h;       // kHiddenGrad: the saved pre-activation [m, n]
  T* dh_c;          // kHiddenGrad
  T* g_c;           // kHiddenGrad
  float* p_db1;     // kHiddenGrad: column sums of dh per row tile
  uint32_t seed;
  int threshold;
  float inv_keep;
};

// dh, g_drop for one hidden element from the saved h and the f32 dg.
// GELU (gelu_exact) and GELU' = Phi(h) + h phi(h) in one pass: erf_as's
// exp(-a^2) at a = |h| / sqrt(2) is phi's exp(-h^2 / 2), so one expf and
// one division serve both.
__device__ __forceinline__ void hidden_grad(float hv, float dg, int grow,
                                            int col, uint32_t seed,
                                            int threshold, float inv_keep,
                                            float& dh, float& g_drop) {
  const bool keep =
      threshold == 0 || positional_keep(seed, 0u, grow, col, threshold);
  const float x = hv * 0.70710678118654752f;
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = expf(-a * a);
  const float y = 1.0f - poly * e;
  const float cdf = 0.5f * (1.0f + (x < 0.0f ? -y : y));
  dh = keep ? dg * inv_keep * (cdf + hv * e * 0.3989422804014327f) : 0.0f;
  g_drop = keep ? hv * cdf * inv_keep : 0.0f;
}

// fc1's element: g = keep0 gelu(h) / keep from h = acc + b1 (f32).
__device__ __forceinline__ float fc1_g(float h, int row, int col,
                                       uint32_t seed, int threshold,
                                       float inv_keep) {
  const float g = gelu_exact(h);
  if (threshold == 0) return g;
  return positional_keep(seed, 0u, row, col, threshold) ? g * inv_keep : 0.0f;
}

// fc2's element with the residual: x + keep1 f / keep, f = acc + b2 (f32).
__device__ __forceinline__ float fc2_res(float f, float xv, int row, int col,
                                         uint32_t seed, int threshold,
                                         float inv_keep) {
  if (threshold)
    f = positional_keep(seed, 1u, row, col, threshold) ? f * inv_keep : 0.0f;
  return xv + f;
}

// ---------------------------------------------------- bf16: wgmma GEMM
// C[m, n] = sum_k A[m, k] B[k, n] with f32 accumulators: CTA tile 128 x
// 128, two consumer warpgroups of 64 rows each (m64n128k16 wgmma, both
// operands from shared memory), one producer warp keeping TMA loads of
// 64-deep stages in flight through a 4-stage ring on full/empty
// mbarriers. Operands are row-major bf16 matrices read either K-major
// (stored [m or n][k]: one box of [128 rows][64]) or MN-major (stored
// [k][m or n]: two boxes of [64 rows][64 columns]); TMA zero-fills rows
// and columns past the matrix, so ragged m, n and k need no masking in the
// main loop. The epilogue works in the accumulator layout: thread
// (warpgroup wg, warp w, g = lane / 4, tq = lane % 4) holds rows
// 64 wg + 16 w + g + 8 (e / 2) and columns 8 j + 2 tq + e % 2 in element
// 4 j + e.
namespace wg {

constexpr int kM = 128, kN = 128, kK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kGemmThreads = kConsumers + 32;
constexpr int kBox = 64 * 128;         // one [64][64] bf16 box, bytes
constexpr int kOpBytes = 2 * kBox;     // one operand of one stage
constexpr int kStageBytes = 2 * kOpBytes;
constexpr int kRedOff = kStages * kStageBytes;  // [8 warps][kN] f32
constexpr int kBarOff = kRedOff + 8 * kN * 4;
constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;

template <bool MN>
__device__ __forceinline__ void load_operand(unsigned char* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int mn0, int k0) {
  if (MN) {
    hopper::tma_load_2d(dst, map, bar, mn0, k0);
    hopper::tma_load_2d(dst + kBox, map, bar, mn0 + 64, k0);
  } else {
    hopper::tma_load_2d(dst, map, bar, k0, mn0);
  }
}

// A operand of warpgroup `half` (rows 64 half.. of the tile), k-step kk.
template <bool MN>
__device__ __forceinline__ uint64_t a_desc(uint32_t a, int half, int kk) {
  return MN ? hopper::rows_mnmajor_desc(a + half * kBox + kk * 16 * 128, kBox)
            : hopper::rows_kmajor_desc(a + half * 64 * 128, kk * 32);
}

template <bool MN>
__device__ __forceinline__ uint64_t b_desc(uint32_t b, int kk) {
  return MN ? hopper::rows_mnmajor_desc(b + kk * 16 * 128, kBox)
            : hopper::rows_kmajor_desc(b, kk * 32);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int EPI, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_bf16(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, EpiArgs<bf16> e,
              int m, int n, int k_tiles, int k_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kN;
  const int kt0 = blockIdx.z * k_per_split;
  const int nk = max(0, min(k_tiles - kt0, k_per_split));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full.
    if (tid == kConsumers) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        const int k0 = (kt0 + i) * kK;
        hopper::mbar_expect_tx(&full[s], kStageBytes);
        load_operand<A_MN>(st, &map_a, &full[s], m0, k0);
        load_operand<B_MN>(st + kOpBytes, &map_b, &full[s], n0, k0);
      }
    }
    return;
  }

  const int half = tid / 128;
  const int w = (tid % 128) / 32, g = (tid % 32) / 4, tq = tid % 4;
  const int r0 = m0 + 64 * half + 16 * w + g;
  const int c0 = n0 + 2 * tq;
  // The epilogue's per-element inputs, loaded before the main loop so
  // their latency hides behind it (the epilogue's stores go through
  // pointers the compiler cannot tell apart from these, so loaded there
  // they would wait one by one): kHiddenGrad the h pairs, kFc2Res the
  // residual pairs (rows r0, r0 + 8), kFc1 / kFc2* the bias pairs.
  constexpr bool kRows = EPI == kHiddenGrad || EPI == kFc2Res;
  constexpr bool kBias = EPI == kFc1 || EPI == kFc2Res || EPI == kFc2;
  uint32_t pre[kRows ? 2 : 1][kN / 8];
  uint32_t bias[kBias ? kN / 8 : 1];
  if constexpr (kRows) {
    const bf16* src = EPI == kHiddenGrad ? e.h : e.x;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int row = r0 + 8 * hh, col = c0 + 8 * j;
        pre[hh][j] = row < m && col < n
                         ? load_pair(src + static_cast<size_t>(row) * n + col)
                         : 0u;
      }
  }
  if constexpr (kBias) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      bias[j] = c0 + 8 * j < n ? load_pair(e.bias + c0 + 8 * j) : 0u;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t a = hopper::smem_u32(smem + s * kStageBytes);
    const uint32_t b = a + kOpBytes;
    hopper::fence_regs(acc);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)
      hopper::Wgmma<128>::ss<A_MN, B_MN>(acc, a_desc<A_MN>(a, half, kk),
                                         b_desc<B_MN>(b, kk), 1);
    hopper::wg_commit();
    // Keep this stage's products in flight; the previous stage's are done.
    hopper::wg_wait<1>();
    hopper::fence_regs(acc);
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % kStages]);
  }
  hopper::wg_wait<0>();
  hopper::fence_regs(acc);

  if constexpr (EPI == kHiddenGrad) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = c0 + 8 * j;
        const int i = 4 * j + 2 * hh;
        float d0 = 0.0f, d1 = 0.0f;
        if (row < m && col < n) {
          const size_t o = static_cast<size_t>(row) * n + col;
          const float2 h2 = unpack(pre[hh][j]);
          float g0, g1;
          hidden_grad(h2.x, acc[i], row, col, e.seed, e.threshold,
                      e.inv_keep, d0, g0);
          hidden_grad(h2.y, acc[i + 1], row, col + 1, e.seed, e.threshold,
                      e.inv_keep, d1, g1);
          store_pair(e.dh_c + o, d0, d1);
          store_pair(e.g_c + o, g0, g1);
        }
        acc[i] = d0;
        acc[i + 1] = d1;
      }
    }
    // The f32 dh summed over the tile's rows into p_db1 (rows past m
    // hold 0), in a fixed order.
    float* red = reinterpret_cast<float*>(smem + kRedOff);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = acc[4 * j + c] + acc[4 * j + 2 + c];
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 16);
        if (g == 0) red[(tid / 32) * kN + 8 * j + 2 * tq + c] = v;
      }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (tid < kN && n0 + tid < n) {
      float sum = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kConsumers / 32; ++wp) sum += red[wp * kN + tid];
      e.p_db1[static_cast<size_t>(blockIdx.y) * n + n0 + tid] = sum;
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = c0 + 8 * j;
        if (col >= n) continue;
        const size_t o = static_cast<size_t>(row) * n + col;
        const int i = 4 * j + 2 * hh;
        float v0 = acc[i], v1 = acc[i + 1];
        if constexpr (kBias) {
          const float2 b2 = unpack(bias[j]);
          v0 += b2.x;
          v1 += b2.y;
        }
        if constexpr (EPI == kStoreF32) {
          *reinterpret_cast<float2*>(e.c32 + static_cast<size_t>(blockIdx.z) *
                                                 m * n + o) =
              make_float2(v0, v1);
        } else if constexpr (EPI == kFc1) {
          if (e.h_out != nullptr) store_pair(e.h_out + o, v0, v1);
          store_pair(e.out + o,
                     fc1_g(v0, row, col, e.seed, e.threshold, e.inv_keep),
                     fc1_g(v1, row, col + 1, e.seed, e.threshold,
                           e.inv_keep));
        } else if constexpr (EPI == kFc2Res) {
          const float2 x2 = unpack(pre[hh][j]);
          store_pair(e.out + o,
                     fc2_res(v0, x2.x, row, col, e.seed, e.threshold,
                             e.inv_keep),
                     fc2_res(v1, x2.y, row, col + 1, e.seed, e.threshold,
                             e.inv_keep));
        } else {  // kStoreOut, kFc2
          store_pair(e.out + o, v0, v1);
        }
      }
    }
  }
}

// C = A B on wgmma (see above). a / b: row-major bf16 with `inner`
// columns and `outer` rows; A_MN / B_MN say whether the reduction runs
// along their rows. `splits` > 1 cuts the reduction into that many
// contiguous ranges of 64-deep tiles, each CTA of split z writing its f32
// partial at e.c32 + z m n (kStoreF32 only).
template <int EPI, bool A_MN, bool B_MN>
cudaError_t gemm(const void* a, int a_inner, int a_outer, const void* b,
                 int b_inner, int b_outer, const EpiArgs<bf16>& e, int m,
                 int n, int k, int splits, cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!hopper::make_rows_map(&ma, a, a_inner, a_outer, A_MN ? 64 : kM) ||
      !hopper::make_rows_map(&mb, b, b_inner, b_outer, B_MN ? 64 : kN))
    return cudaErrorInvalidValue;
  auto kernel = gemm_bf16<EPI, A_MN, B_MN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int k_tiles = cdiv(k, kK);
  const dim3 grid(cdiv(n, kN), cdiv(m, kM), splits);
  kernel<<<grid, kGemmThreads, kSmem, s>>>(ma, mb, e, m, n, k_tiles,
                                           cdiv(k_tiles, splits));
  return cudaGetLastError();
}

// out[i] = part[0][i] + part[1][i] + ... in split order (count % 4 == 0).
__global__ void sum_splits(const float4* __restrict__ part,
                           float4* __restrict__ out, int splits,
                           size_t count4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  float4 v = part[i];
  for (int z = 1; z < splits; ++z) {
    const float4 u = part[static_cast<size_t>(z) * count4 + i];
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  out[i] = v;
}

// Splits of the weight GEMMs' reduction over the n rows: enough CTAs for
// two per SM of a 132-SM card (their 128 x 128 output tiles alone are 144
// at D = 768, F = 3072: 1.09 waves), at most 4, each split at least 4
// tiles deep. A function of the shapes only, so every card sums in the
// same order.
inline int weight_splits(int n, int d, int f) {
  const int tiles = cdiv(d, kM) * cdiv(f, kN);
  int s = cdiv(2 * 132, tiles);
  s = s < 4 ? s : 4;
  const int depth = cdiv(n, kK) / 4;
  s = s < depth ? s : depth;
  return s > 1 ? s : 1;
}

}  // namespace wg

// ------------------------------------------------------ f32: SIMT GEMM
// C[m, n] = sum_k A[m, k] B(k, n) in exact f32 (FMA, no TF32, which would
// break the 1e-4 bounds): A row-major [m][k]; B row-major [n][k] (B_NK,
// the fc weights read transposed) or [k][n]. One CTA of 256 threads per
// 64 x 64 tile of C, each thread 4 x 4 elements (rows 4 ty.., columns
// 4 tx..), k walked in 16-deep steps through shared memory; rows past m
// read as zero. n and k are multiples of 64, operands 16-byte aligned.
// The epilogues are the wgmma kernel's, element by element; kHiddenGrad's
// db1 partials are per 64-row tile.
namespace simt {

constexpr int kT = 64, kKs = 16;

template <int EPI, bool B_NK>
__global__ void __launch_bounds__(256)
    gemm_f32(const float* __restrict__ a, const float* __restrict__ b,
             EpiArgs<float> e, int m, int n, int k) {
  __shared__ __align__(16) float a_s[kKs][kT];  // A tile transposed
  __shared__ __align__(16) float b_s[kKs][kT];
  __shared__ float red[16][kT];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  // The loads: A rows m0 + tid / 4, columns k0 + 4 (tid % 4)..; B the same
  // for B_NK, else rows k0 + tid / 16, columns n0 + 4 (tid % 16)...
  const int lr = tid / 4, lc = 4 * (tid % 4);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kKs) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 av =
        m0 + lr < m ? *reinterpret_cast<const float4*>(
                          a + static_cast<size_t>(m0 + lr) * k + k0 + lc)
                    : zero;
    float4 bv;
    if (B_NK)
      bv = *reinterpret_cast<const float4*>(
          b + static_cast<size_t>(n0 + lr) * k + k0 + lc);
    else
      bv = *reinterpret_cast<const float4*>(
          b + static_cast<size_t>(k0 + ty) * n + n0 + 4 * tx);
    __syncthreads();  // the previous step is done with a_s / b_s
    a_s[lc + 0][lr] = av.x;
    a_s[lc + 1][lr] = av.y;
    a_s[lc + 2][lr] = av.z;
    a_s[lc + 3][lr] = av.w;
    if (B_NK) {
      b_s[lc + 0][lr] = bv.x;
      b_s[lc + 1][lr] = bv.y;
      b_s[lc + 2][lr] = bv.z;
      b_s[lc + 3][lr] = bv.w;
    } else {
      *reinterpret_cast<float4*>(&b_s[ty][4 * tx]) = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
      const float4 y = *reinterpret_cast<const float4*>(&b_s[kk][4 * tx]);
      const float ar[4] = {x.x, x.y, x.z, x.w};
      const float br[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      float v = acc[i][j];
      if (row >= m) {
        acc[i][j] = 0.0f;
        continue;
      }
      const size_t o = static_cast<size_t>(row) * n + col;
      if constexpr (EPI == kStoreF32 || EPI == kStoreOut) {
        (EPI == kStoreF32 ? e.c32 : e.out)[o] = v;
      } else if constexpr (EPI == kFc1) {
        v += e.bias[col];
        if (e.h_out != nullptr) e.h_out[o] = v;
        e.out[o] = fc1_g(v, row, col, e.seed, e.threshold, e.inv_keep);
      } else if constexpr (EPI == kFc2Res) {
        e.out[o] = fc2_res(v + e.bias[col], e.x[o], row, col, e.seed,
                           e.threshold, e.inv_keep);
      } else if constexpr (EPI == kFc2) {
        e.out[o] = v + e.bias[col];
      } else {  // kHiddenGrad
        float dh, g_drop;
        hidden_grad(e.h[o], v, row, col, e.seed, e.threshold, e.inv_keep, dh,
                    g_drop);
        e.dh_c[o] = dh;
        e.g_c[o] = g_drop;
        acc[i][j] = dh;
      }
    }
  }
  if constexpr (EPI == kHiddenGrad) {
    // Column sums of dh over the tile's 64 rows, in a fixed order.
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[ty][4 * tx + j] = acc[0][j] + acc[1][j] + acc[2][j] + acc[3][j];
    __syncthreads();
    if (tid < kT) {
      float s = 0.0f;
#pragma unroll
      for (int y = 0; y < 16; ++y) s += red[y][tid];
      e.p_db1[static_cast<size_t>(blockIdx.y) * n + n0 + tid] = s;
    }
  }
}

template <int EPI, bool B_NK>
cudaError_t gemm(const float* a, const float* b, const EpiArgs<float>& e,
                 int m, int n, int k, cudaStream_t s) {
  gemm_f32<EPI, B_NK><<<dim3(n / kT, cdiv(m, kT)), 256, 0, s>>>(a, b, e, m,
                                                                 n, k);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace mlp
}  // namespace vit
