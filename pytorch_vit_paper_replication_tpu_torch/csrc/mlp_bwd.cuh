// Backward kernels of the encoder block's MLP, in two forms selected by the
// template flag LN:
//   LN = true:  out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))
//               -> dx, dgamma, dbeta, dW1, db1, dW2, db2           (row 2)
//   LN = false: out = fc2(drop0(gelu(fc1(x)))) -> dx, dW1, db1, dW2, db2
//                                                                  (row 7)
// csrc/fused_mlp_bwd.cu instantiates the first, csrc/fused_mlp_core.cu the
// second. Both read h, the forward's pre-activation rounded to the compute
// dtype.
//
// The Pallas grids are sequential: one program carries the weight and bias
// gradients across all row blocks and adds into them. A CUDA grid runs in
// parallel, and per-CTA partial weight gradients would take
// ceil(N/32) x 2 x D x F floats (~3.7 GB at B/16). So the work is split into
// deterministic passes with no float atomics.
//
// bf16 (the training path) — every product on wgmma, operands brought in by
// TMA on mbarriers (wg::gemm_bf16, one kernel for the four GEMMs):
//   1. ln_rows_pre (LN only): the LN statistics recomputed from x, y_c =
//      cast(LN(x)) and df_c = cast(keep1 dO / keep) written out; without LN
//      the GEMM operands are x and dO themselves.
//   2. dg = df_c W2^T ([N, D] x [D, F], both K-major); its epilogue applies
//      hidden_grad (GELU' and the drop0 keep bit of the element's true
//      (row, hidden column)), writes dh_c and g_c in bf16 and the column
//      sums of the f32 dh per 128-row tile (db1 partials).
//   3. dy = dh_c W1^T ([N, F] x [F, D], both K-major) into an f32 [N, D]
//      buffer (LN; 19 MB at B/16), or cast straight to dx (no LN).
//   4. rows_post: the LN backward of 32 rows per CTA from the dy buffer into
//      dx = cast(dO + dx_ln) and the dgamma / dbeta column partials (LN);
//      the db2 column partials of the f32 df in both forms.
//   5. dW1 = y_c^T dh_c and dW2 = g_c^T df_c: both operands MN-major (the
//      reduction runs over the rows), ragged N zero-filled by TMA; the
//      reduction is cut into weight_splits() contiguous ranges whose f32
//      partials sum_splits adds in split order.
//   6. colsum: db1, db2 (and dgamma, dbeta) as fixed-order sums of the
//      partials.
// What bounds it on an H100: the four GEMMs, 2 N D F FLOP each (0.120 ms at
// 989 TFLOP/s for N = 6304, D = 768, F = 3072); the design spends extra
// bytes on dh_c / g_c (and, with LN, y_c, df_c and dy) written once and
// read once or twice, about 0.2 GB at B/16.
//
// f32 — SIMT FMA (exact f32, no TF32, which would break the 1e-4 bounds):
//   1. rows: one CTA per 32 rows, prologue as above, F walked in 32-column
//      chunks (dg, hidden_grad, dh_c / g_c written, dy += dh_c W1^T kept on
//      chip), then the LN backward (or dx = dy) and the column partials;
//   2. gemm_tn_f32: dW1 and dW2, one CTA per 64x64 output tile looping over
//      all N rows;
//   3. colsum.
// The rounding points are the Pallas kernels': df and dh are cast to the
// compute dtype before their products, every sum is f32, the bias (and LN)
// gradients sum f32 values, dx = dO + dx_ln in f32 then cast (LN). The
// weight gradients leave in f32; the wrappers cast them to the parameter
// dtypes.
#pragma once

#include "hopper.cuh"
#include "vit_common.cuh"

namespace vit {
namespace mlp_bwd {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 32;        // rows per CTA in the row kernel

struct Scratch {
  // Compute-dtype tensors written by the row passes, read by the GEMMs.
  void* y_c;   // [n, d] (LN only)
  void* df_c;  // [n, d] (LN only)
  void* g_c;   // [n, f]
  void* dh_c;  // [n, f]
  // f32 per-CTA column sums [tiles, width].
  float* p_dgamma;  // width d (LN only)
  float* p_dbeta;   // width d (LN only)
  float* p_db2;     // width d
  float* p_db1;     // width f
};

// LN statistics of row `grow` (one warp), as the forward computes them.
template <typename T, int D>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int grow,
                                          float* v, float& mu, float& rstd,
                                          float eps) {
  constexpr int NJ = D / 32;
  const int lane = threadIdx.x % 32;
  const T* xr = x + static_cast<size_t>(grow) * D;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    v[j] = to_f32(xr[lane + 32 * j]);
    s += v[j];
  }
  mu = warp_sum(s) / static_cast<float>(D);
  float s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float c = v[j] - mu;
    s2 += c * c;
  }
  rstd = rsqrtf(warp_sum(s2) / static_cast<float>(D) + eps);
}

// Phase A of the LN row kernel: statistics into mu_s/rstd_s, y_c and df_c
// to device memory, df_c (compute dtype) into df_s with row stride ldd.
template <typename T, int D>
__device__ __forceinline__ void rows_prologue(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ dout, T* df_s,
    int ldd, float* mu_s, float* rstd_s, T* y_c, T* df_c, int row0, int n,
    float eps, uint32_t seed, int threshold, float inv_keep) {
  constexpr int NJ = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int grow = row0 + r;
    if (grow < n) {
      float v[NJ], mu, rstd;
      row_stats<T, D>(x, grow, v, mu, rstd, eps);
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const size_t o = static_cast<size_t>(grow) * D + col;
        y_c[o] = from_f32<T>((v[j] - mu) * rstd * gamma[col] + beta[col]);
        float df = to_f32(dout[o]);
        if (threshold)
          df = positional_keep(seed, 1u, grow, col, threshold)
                   ? df * inv_keep
                   : 0.0f;
        const T dfc = from_f32<T>(df);
        df_c[o] = dfc;
        df_s[r * ldd + col] = dfc;
      }
    } else {
      if (lane == 0) {
        mu_s[r] = 0.0f;
        rstd_s[r] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        df_s[r * ldd + lane + 32 * j] = from_f32<T>(0.0f);
    }
  }
}

// Phase A without LN: this CTA's dO rows into df_s as they are (rows past
// n read as zero); there is no output dropout.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ dout, T* df_s,
                                          int ldd, int row0, int n) {
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int r = i / D, col = i % D;
    df_s[r * ldd + col] = row0 + r < n
                              ? dout[static_cast<size_t>(row0 + r) * D + col]
                              : from_f32<T>(0.0f);
  }
}

// Column sums of the f32 df over this CTA's rows -> p_db2[tile]
// (threshold 0: df = dO).
template <typename T, int D>
__device__ __forceinline__ void db2_partial(const T* __restrict__ dout,
                                            float* p_db2, int row0, int n,
                                            uint32_t seed, int threshold,
                                            float inv_keep) {
  for (int col = threadIdx.x; col < D; col += kThreads) {
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < kBM; ++r) {
      if (row0 + r >= n) continue;
      float df = to_f32(dout[static_cast<size_t>(row0 + r) * D + col]);
      if (threshold)
        df = positional_keep(seed, 1u, row0 + r, col, threshold)
                 ? df * inv_keep
                 : 0.0f;
      s += df;
    }
    p_db2[static_cast<size_t>(blockIdx.x) * D + col] = s;
  }
}

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

// Phase C with LN: the LN backward of this CTA's rows from dy_s (f32,
// stride D), then the dgamma/dbeta column partials.
template <typename T, int D>
__device__ __forceinline__ void rows_epilogue(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const T* __restrict__ dout, const float* dy_s, const float* mu_s,
    const float* rstd_s, T* __restrict__ dx, float* p_dgamma, float* p_dbeta,
    int row0, int n) {
  constexpr int NJ = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int grow = row0 + r;
    if (grow >= n) continue;
    const float mu = mu_s[r], rstd = rstd_s[r];
    float xh[NJ], dxh[NJ], s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      xh[j] = (to_f32(x[static_cast<size_t>(grow) * D + col]) - mu) * rstd;
      dxh[j] = dy_s[r * D + col] * gamma[col];
      s1 += dxh[j];
      s2 += dxh[j] * xh[j];
    }
    const float m1 = warp_sum(s1) / static_cast<float>(D);
    const float m2 = warp_sum(s2) / static_cast<float>(D);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t o = static_cast<size_t>(grow) * D + lane + 32 * j;
      dx[o] = from_f32<T>(to_f32(dout[o]) + rstd * (dxh[j] - m1 - xh[j] * m2));
    }
  }
  for (int col = threadIdx.x; col < D; col += kThreads) {
    float sg = 0.0f, sb = 0.0f;
#pragma unroll 8
    for (int r = 0; r < kBM; ++r) {
      if (row0 + r >= n) continue;
      const float xh =
          (to_f32(x[static_cast<size_t>(row0 + r) * D + col]) - mu_s[r]) *
          rstd_s[r];
      const float dy = dy_s[r * D + col];
      sg += dy * xh;
      sb += dy;
    }
    p_dgamma[static_cast<size_t>(blockIdx.x) * D + col] = sg;
    p_dbeta[static_cast<size_t>(blockIdx.x) * D + col] = sb;
  }
}

// Phase C without LN: dx = cast(dy) for this CTA's rows.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float* dy_s,
                                           T* __restrict__ dx, int row0,
                                           int n) {
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int r = i / D, col = i % D;
    if (row0 + r < n)
      dx[static_cast<size_t>(row0 + r) * D + col] = from_f32<T>(dy_s[i]);
  }
}

// Phase A of either form; df_s receives the compute-dtype df rows.
template <typename T, int D, bool LN>
__device__ __forceinline__ void prologue(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ dout, T* df_s,
    int ldd, float* mu_s, float* rstd_s, const Scratch& sc, int row0, int n,
    float eps, uint32_t seed, int threshold, float inv_keep) {
  if constexpr (LN) {
    rows_prologue<T, D>(x, gamma, beta, dout, df_s, ldd, mu_s, rstd_s,
                        static_cast<T*>(sc.y_c), static_cast<T*>(sc.df_c),
                        row0, n, eps, seed, threshold, inv_keep);
    db2_partial<T, D>(dout, sc.p_db2, row0, n, seed, threshold, inv_keep);
  } else {
    load_rows<T, D>(dout, df_s, ldd, row0, n);
    db2_partial<T, D>(dout, sc.p_db2, row0, n, seed, 0, 1.0f);
  }
}

// Phase C of either form, from dy_s (f32, stride D).
template <typename T, int D, bool LN>
__device__ __forceinline__ void epilogue(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const T* __restrict__ dout, const float* dy_s, const float* mu_s,
    const float* rstd_s, T* __restrict__ dx, const Scratch& sc, int row0,
    int n) {
  if constexpr (LN)
    rows_epilogue<T, D>(x, gamma, dout, dy_s, mu_s, rstd_s, dx, sc.p_dgamma,
                        sc.p_dbeta, row0, n);
  else
    store_rows<T, D>(dy_s, dx, row0, n);
}

// ------------------------------------------------------------ f32 rows
constexpr int kF32Chunk = 32;

template <int D>
struct RowsF32Smem {
  static constexpr int ldw = D + 1;  // W chunks [32][D + 1] (conflict-free)
  static constexpr int ldh = kF32Chunk + 1;
  static constexpr size_t df_off = 0;  // df_s [BM][D], later dy_s
  static constexpr size_t w_off = df_off + kBM * D * 4;
  static constexpr size_t h_off = w_off + kF32Chunk * ldw * 4;
  static constexpr size_t st_off = h_off + kBM * ldh * 4;
  static constexpr size_t bytes = st_off + 2 * kBM * 4;
};

template <int D, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_rows_f32(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ w1,
                     const float* __restrict__ w2,
                     const float* __restrict__ dout, float* __restrict__ dx,
                     Scratch sc, int n, int f, float eps, uint32_t seed,
                     int threshold, float inv_keep) {
  using L = RowsF32Smem<D>;
  constexpr int NC = D / 32;                  // dy columns per thread
  constexpr int RPW = kBM / (kThreads / 32);  // rows per warp = 4
  extern __shared__ __align__(128) unsigned char smem[];
  float* df_s = reinterpret_cast<float*>(smem + L::df_off);
  float* dy_s = df_s;  // epilogue only
  float* w_s = reinterpret_cast<float*>(smem + L::w_off);
  float* dh_s = reinterpret_cast<float*>(smem + L::h_off);
  float* mu_s = reinterpret_cast<float*>(smem + L::st_off);
  float* rstd_s = mu_s + kBM;
  float* g_c = static_cast<float*>(sc.g_c);
  float* dh_c = static_cast<float*>(sc.dh_c);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBM;
  prologue<float, D, LN>(x, gamma, beta, dout, df_s, D, mu_s, rstd_s, sc,
                         row0, n, eps, seed, threshold, inv_keep);

  float acc[RPW][NC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  for (int f0 = 0; f0 < f; f0 += kF32Chunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Chunk * D; i += kThreads) {
      const int k = i / D, c = i % D;
      w_s[k * L::ldw + c] = w2[static_cast<size_t>(f0 + k) * D + c];
    }
    __syncthreads();
    // dg[r, f0 + lane] = sum_d df[r, d] * W2[f0 + lane, d]
    float dg[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) dg[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float b = w_s[lane * L::ldw + d];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        dg[i] = fmaf(df_s[(warp * RPW + i) * D + d], b, dg[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i, grow = row0 + r;
      float dh = 0.0f;
      if (grow < n) {
        const size_t o = static_cast<size_t>(grow) * f + f0 + lane;
        float g_drop;
        hidden_grad(h[o], dg[i], grow, f0 + lane, seed, threshold, inv_keep,
                    dh, g_drop);
        g_c[o] = g_drop;
        dh_c[o] = dh;
      }
      dh_s[r * L::ldh + lane] = dh;
    }
    __syncthreads();  // dg product done with w_s; dh_s complete
    if (threadIdx.x < kF32Chunk) {
      float s = 0.0f;
      for (int r = 0; r < kBM; ++r) s += dh_s[r * L::ldh + threadIdx.x];
      sc.p_db1[static_cast<size_t>(blockIdx.x) * f + f0 + threadIdx.x] = s;
    }
    // W1[:, chunk] transposed into w_s[k][d].
    for (int i = threadIdx.x; i < D * kF32Chunk; i += kThreads) {
      const int d = i / kF32Chunk, k = i % kF32Chunk;
      w_s[k * L::ldw + d] = w1[static_cast<size_t>(d) * f + f0 + k];
    }
    __syncthreads();
    for (int k = 0; k < kF32Chunk; ++k) {
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = dh_s[(warp * RPW + i) * L::ldh + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float b = w_s[k * L::ldw + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
  }
  __syncthreads();  // df_s becomes dy_s
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dy_s[(warp * RPW + i) * D + lane + 32 * j] = acc[i][j];
  __syncthreads();
  epilogue<float, D, LN>(x, gamma, dout, dy_s, mu_s, rstd_s, dx, sc, row0, n);
}

// ---------------------------------------------------------- f32 gemm_tn
// C[M, P] = A[N, M]^T @ B[N, P], A and B row-major f32; one CTA per 64x64
// tile of C, looping over all N rows in 32-row steps (rows past N read as
// zero). M and P are multiples of 64.
constexpr int kTile = 64;
constexpr int kStep = 32;

__global__ void __launch_bounds__(256)
    gemm_tn_f32(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int n, int m, int p) {
  __shared__ __align__(16) float a_s[kStep * kTile];
  __shared__ __align__(16) float b_s[kStep * kTile];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.x * kTile, p0 = blockIdx.y * kTile;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < n; n0 += kStep) {
    __syncthreads();
    for (int i = threadIdx.x; i < kStep * (kTile / 4); i += 256) {
      const int r = i / (kTile / 4), c4 = i % (kTile / 4);
      const bool in = n0 + r < n;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(a_s + r * kTile + c4 * 4) =
          in ? *reinterpret_cast<const float4*>(
                   a + static_cast<size_t>(n0 + r) * m + m0 + c4 * 4)
             : zero;
      *reinterpret_cast<float4*>(b_s + r * kTile + c4 * 4) =
          in ? *reinterpret_cast<const float4*>(
                   b + static_cast<size_t>(n0 + r) * p + p0 + c4 * 4)
             : zero;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kStep; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a_s + k * kTile + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(b_s + k * kTile + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(c + static_cast<size_t>(m0 + ty * 4 + i) * p +
                               p0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// out[w] = the sum over tiles t of part[t, w] in a fixed order: warp y of
// a block of 32 columns sums tiles y, y + 8, y + 16, ..., then the 8 warp
// sums are added in warp order.
__global__ void __launch_bounds__(256)
    colsum(const float* __restrict__ part, float* __restrict__ out,
           int tiles, int width) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (col < width) {
#pragma unroll 4
    for (int t = warp; t < tiles; t += 8)
      s += part[static_cast<size_t>(t) * width + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < width) {
    float v = 0.0f;
#pragma unroll
    for (int y = 0; y < 8; ++y) v += red[y][lane];
    out[col] = v;
  }
}

// ---------------------------------------------------- bf16: wgmma passes
// One GEMM kernel for the four bf16 products, C[m, n] = sum_k A[m, k]
// B[k, n] with f32 accumulators: CTA tile 128 x 128, two consumer
// warpgroups of 64 rows each (m64n128k16 wgmma, both operands from shared
// memory), one producer warp keeping TMA loads of 64-deep stages in flight
// through a 4-stage ring on full/empty mbarriers. Operands are row-major
// bf16 matrices read either K-major (stored [m or n][k]: one box of
// [128 rows][64]) or MN-major (stored [k][m or n]: two boxes of
// [64 rows][64 columns]); TMA zero-fills rows and columns past the
// matrix, so ragged m, n and k need no masking in the main loop. The
// epilogue works in the accumulator layout: thread (warpgroup wg, warp w,
// g = lane / 4, tq = lane % 4) holds rows 64 wg + 16 w + g + 8 (e / 2) and
// columns 8 j + 2 tq + e % 2 in element 4 j + e.
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

enum Epi { kStoreF32 = 0, kStoreBf16 = 1, kHiddenGrad = 2 };

struct EpiArgs {
  float* c32;     // kStoreF32: [m, n] (split z at + z m n)
  bf16* c16;      // kStoreBf16: [m, n]
  const bf16* h;  // kHiddenGrad: the saved pre-activation [m, n]
  bf16* dh_c;     // kHiddenGrad: [m, n]
  bf16* g_c;      // kHiddenGrad: [m, n]
  float* p_db1;   // kHiddenGrad: column sums of dh per 128-row tile
  uint32_t seed;
  int threshold;
  float inv_keep;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

template <int EPI, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_bf16(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, EpiArgs e, int m,
              int n, int k_tiles, int k_per_split) {
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
  // kHiddenGrad: this thread's h pairs, loaded before the main loop so
  // their latency hides behind it (stored through e.dh_c / e.g_c, which
  // the compiler cannot tell apart from e.h, they would load one by one).
  uint32_t hv[2][kN / 8];
  if constexpr (EPI == kHiddenGrad) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int row = r0 + 8 * hh, col = c0 + 8 * j;
        hv[hh][j] = row < m && col < n
                        ? *reinterpret_cast<const uint32_t*>(
                              e.h + static_cast<size_t>(row) * n + col)
                        : 0u;
      }
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
    // dh = keep0 dg / keep * gelu'(h) and g_drop = keep0 gelu(h) / keep
    // (hidden_grad), dh_c and g_c written in bf16, then the f32 dh summed
    // over the tile's rows into p_db1 (rows past m hold 0).
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
          const __nv_bfloat162 h2 =
              *reinterpret_cast<const __nv_bfloat162*>(&hv[hh][j]);
          float g0, g1;
          hidden_grad(__low2float(h2), acc[i], row, col, e.seed, e.threshold,
                      e.inv_keep, d0, g0);
          hidden_grad(__high2float(h2), acc[i + 1], row, col + 1, e.seed,
                      e.threshold, e.inv_keep, d1, g1);
          *reinterpret_cast<__nv_bfloat162*>(e.dh_c + o) =
              __floats2bfloat162_rn(d0, d1);
          *reinterpret_cast<__nv_bfloat162*>(e.g_c + o) =
              __floats2bfloat162_rn(g0, g1);
        }
        acc[i] = d0;
        acc[i + 1] = d1;
      }
    }
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
        if constexpr (EPI == kStoreF32)
          *reinterpret_cast<float2*>(e.c32 + static_cast<size_t>(blockIdx.z) *
                                                 m * n + o) =
              make_float2(acc[i], acc[i + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(e.c16 + o) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
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
                 int b_inner, int b_outer, const EpiArgs& e, int m, int n,
                 int k, int splits, cudaStream_t s) {
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

// bf16, LN: y_c = cast(LN(x)) and df_c = cast(keep1 dO / keep), one warp
// per row, 32 rows per CTA (the statistics as the forward computes them).
template <int D>
__global__ void __launch_bounds__(kThreads)
    ln_rows_pre(const bf16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const bf16* __restrict__ dout,
                bf16* __restrict__ y_c, bf16* __restrict__ df_c, int n,
                float eps, uint32_t seed, int threshold, float inv_keep) {
  constexpr int NJ = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int grow = blockIdx.x * kBM + r;
    if (grow >= n) break;
    float v[NJ], mu, rstd;
    row_stats<bf16, D>(x, grow, v, mu, rstd, eps);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      const size_t o = static_cast<size_t>(grow) * D + col;
      y_c[o] = from_f32<bf16>((v[j] - mu) * rstd * gamma[col] + beta[col]);
      float df = to_f32(dout[o]);
      if (threshold)
        df = positional_keep(seed, 1u, grow, col, threshold) ? df * inv_keep
                                                             : 0.0f;
      df_c[o] = from_f32<bf16>(df);
    }
  }
}

// bf16, after the dy GEMM: with LN the LN backward of 32 rows from the f32
// dy buffer into dx (statistics recomputed from x) and the dgamma / dbeta
// column partials; the db2 column partials in both forms.
template <int D, bool LN>
__global__ void __launch_bounds__(kThreads)
    rows_post(const bf16* __restrict__ x, const float* __restrict__ gamma,
              const bf16* __restrict__ dout, const float* __restrict__ dy,
              bf16* __restrict__ dx, Scratch sc, int n, float eps,
              uint32_t seed, int threshold, float inv_keep) {
  const int row0 = blockIdx.x * kBM;
  if constexpr (LN) {
    __shared__ float mu_s[kBM], rstd_s[kBM];
    constexpr int NJ = D / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kBM; r += kThreads / 32) {
      float v[NJ], mu = 0.0f, rstd = 0.0f;
      if (row0 + r < n) row_stats<bf16, D>(x, row0 + r, v, mu, rstd, eps);
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
    rows_epilogue<bf16, D>(x, gamma, dout, dy + static_cast<size_t>(row0) * D,
                           mu_s, rstd_s, dx, sc.p_dgamma, sc.p_dbeta, row0,
                           n);
    db2_partial<bf16, D>(dout, sc.p_db2, row0, n, seed, threshold, inv_keep);
  } else {
    db2_partial<bf16, D>(dout, sc.p_db2, row0, n, seed, 0, 1.0f);
  }
}

inline int row_tiles(int n) { return (n + kBM - 1) / kBM; }

// ----------------------------------------------------------- workspace
// Everything the passes keep between them, carved from one workspace of
// plan()'s size (each region 1024-byte aligned). f32: y_c, df_c (LN), g_c,
// dh_c in f32 and per-32-row column partials of every bias / LN gradient.
// bf16: y_c, df_c (LN), g_c, dh_c in bf16, the f32 dy buffer [n, d] (LN),
// the weight GEMMs' split partials [splits, d, f] (splits > 1), the
// dgamma / dbeta (LN) and db2 partials per 32 rows and the db1 partials
// per 128-row GEMM tile.
struct Plan {
  Scratch sc;
  float* dy;
  float* split;
  int splits;
  int db1_tiles;
};

template <bool LN>
inline size_t plan(int dtype, int n, int d, int f, void* base, Plan* p) {
  const size_t es = dtype == 1 ? 2 : 4;
  const size_t nd = static_cast<size_t>(n) * d, nf = static_cast<size_t>(n) * f;
  const int t32 = row_tiles(n);
  const int splits = dtype == 1 ? wg::weight_splits(n, d, f) : 1;
  const int db1_tiles = dtype == 1 ? wg::cdiv(n, wg::kM) : t32;
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* ptr = base ? static_cast<unsigned char*>(base) + off : nullptr;
    off += (bytes + 1023) / 1024 * 1024;
    return bytes ? ptr : nullptr;
  };
  Plan q{};
  q.sc.y_c = LN ? take(nd * es) : nullptr;
  q.sc.df_c = LN ? take(nd * es) : nullptr;
  q.sc.g_c = take(nf * es);
  q.sc.dh_c = take(nf * es);
  q.dy = static_cast<float*>(LN && dtype == 1 ? take(nd * 4) : nullptr);
  q.split = static_cast<float*>(
      splits > 1 ? take(static_cast<size_t>(splits) * d * f * 4) : nullptr);
  q.sc.p_dgamma = static_cast<float*>(LN ? take(t32 * d * 4ull) : nullptr);
  q.sc.p_dbeta = static_cast<float*>(LN ? take(t32 * d * 4ull) : nullptr);
  q.sc.p_db2 = static_cast<float*>(take(t32 * d * 4ull));
  q.sc.p_db1 = static_cast<float*>(take(static_cast<size_t>(db1_tiles) * f * 4));
  q.splits = splits;
  q.db1_tiles = db1_tiles;
  if (p) *p = q;
  return off;
}

// ------------------------------------------------------------- f32 path
template <int D, bool LN>
cudaError_t rows_f32(const float* x, const float* h, const float* gamma,
                     const float* beta, const float* w1, const float* w2,
                     const float* dout, float* dx, const Scratch& sc, int n,
                     int f, float eps, uint32_t seed, int threshold,
                     float inv_keep, cudaStream_t s) {
  auto kernel = mlp_bwd_rows_f32<D, LN>;
  const int smem = static_cast<int>(RowsF32Smem<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<row_tiles(n), kThreads, smem, s>>>(x, h, gamma, beta, w1, w2, dout,
                                              dx, sc, n, f, eps, seed,
                                              threshold, inv_keep);
  return cudaGetLastError();
}

inline cudaError_t gemm_tn(const float* a, const float* b, float* c, int n,
                           int m, int p, cudaStream_t s) {
  gemm_tn_f32<<<dim3(m / kTile, p / kTile), 256, 0, s>>>(a, b, c, n, m, p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 path
template <int D, bool LN>
cudaError_t passes_bf16(const bf16* x, const bf16* h, const float* gamma,
                        const float* beta, const bf16* w1, const bf16* w2,
                        const bf16* dout, bf16* dx, float* dw1, float* dw2,
                        const Plan& p, int n, int f, float eps, uint32_t seed,
                        int threshold, float inv_keep, cudaStream_t s) {
  cudaError_t err;
  const int t32 = row_tiles(n);
  bf16* y_c = static_cast<bf16*>(p.sc.y_c);
  bf16* df_c = static_cast<bf16*>(p.sc.df_c);
  bf16* g_c = static_cast<bf16*>(p.sc.g_c);
  bf16* dh_c = static_cast<bf16*>(p.sc.dh_c);
  const bf16* y = LN ? y_c : x;      // fc1's input
  const bf16* df = LN ? df_c : dout;  // fc2's output gradient
  if constexpr (LN) {
    ln_rows_pre<D><<<t32, kThreads, 0, s>>>(x, gamma, beta, dout, y_c, df_c,
                                            n, eps, seed, threshold, inv_keep);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // dg = df_c W2^T, then dh_c, g_c and the db1 partials in its epilogue.
  wg::EpiArgs e{};
  e.h = h;
  e.dh_c = dh_c;
  e.g_c = g_c;
  e.p_db1 = p.sc.p_db1;
  e.seed = seed;
  e.threshold = threshold;
  e.inv_keep = inv_keep;
  err = wg::gemm<wg::kHiddenGrad, false, false>(df, D, n, w2, D, f, e, n, f,
                                                D, 1, s);
  if (err != cudaSuccess) return err;
  // dy = dh_c W1^T: into the f32 buffer (LN) or straight to dx.
  wg::EpiArgs ey{};
  ey.c32 = p.dy;
  ey.c16 = dx;
  err = LN ? wg::gemm<wg::kStoreF32, false, false>(dh_c, f, n, w1, f, D, ey,
                                                   n, D, f, 1, s)
           : wg::gemm<wg::kStoreBf16, false, false>(dh_c, f, n, w1, f, D, ey,
                                                    n, D, f, 1, s);
  if (err != cudaSuccess) return err;
  rows_post<D, LN><<<t32, kThreads, 0, s>>>(x, gamma, dout, p.dy, dx, p.sc, n,
                                            eps, seed, threshold, inv_keep);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dW1 = y_c^T dh_c and dW2 = g_c^T df_c, both operands MN-major.
  const size_t dfc = static_cast<size_t>(D) * f;
  wg::EpiArgs ew{};
  ew.c32 = p.splits > 1 ? p.split : dw1;
  err = wg::gemm<wg::kStoreF32, true, true>(y, D, n, dh_c, f, n, ew, D, f, n,
                                            p.splits, s);
  if (err != cudaSuccess) return err;
  if (p.splits > 1) {
    wg::sum_splits<<<wg::cdiv(static_cast<int>(dfc / 4), 256), 256, 0, s>>>(
        reinterpret_cast<const float4*>(p.split),
        reinterpret_cast<float4*>(dw1), p.splits, dfc / 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ew.c32 = p.splits > 1 ? p.split : dw2;
  err = wg::gemm<wg::kStoreF32, true, true>(g_c, f, n, df, D, n, ew, f, D, n,
                                            p.splits, s);
  if (err != cudaSuccess) return err;
  if (p.splits > 1) {
    wg::sum_splits<<<wg::cdiv(static_cast<int>(dfc / 4), 256), 256, 0, s>>>(
        reinterpret_cast<const float4*>(p.split),
        reinterpret_cast<float4*>(dw2), p.splits, dfc / 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

inline cudaError_t reduce(const float* part, float* out, int tiles, int width,
                          cudaStream_t s) {
  colsum<<<(width + 31) / 32, 256, 0, s>>>(part, out, tiles, width);
  return cudaGetLastError();
}

// The whole backward of either form on `stream`, scratch carved from
// `workspace` (plan()'s size). Without LN, gamma, beta, dgamma and dbeta
// are null. Returns the first cudaError_t that is not 0.
template <bool LN>
cudaError_t backward(int dtype, const void* x, const void* h,
                     const float* gamma, const float* beta, const void* w1,
                     const void* w2, const void* dout, void* dx,
                     float* dgamma, float* dbeta, float* dw1, float* db1,
                     float* dw2, float* db2, void* workspace, int n, int d,
                     int f, float eps, uint32_t seed, int threshold,
                     float inv_keep, cudaStream_t s) {
  Plan p;
  plan<LN>(dtype, n, d, f, workspace, &p);
  cudaError_t err;
  if (dtype == 1) {
    auto run = d == 384 ? passes_bf16<384, LN> : passes_bf16<768, LN>;
    err = run(static_cast<const bf16*>(x), static_cast<const bf16*>(h),
              gamma, beta, static_cast<const bf16*>(w1),
              static_cast<const bf16*>(w2), static_cast<const bf16*>(dout),
              static_cast<bf16*>(dx), dw1, dw2, p, n, f, eps, seed,
              threshold, inv_keep, s);
  } else {
    auto rows = d == 384 ? rows_f32<384, LN> : rows_f32<768, LN>;
    const float* xf = static_cast<const float*>(x);
    const float* doutf = static_cast<const float*>(dout);
    err = rows(xf, static_cast<const float*>(h), gamma, beta,
               static_cast<const float*>(w1), static_cast<const float*>(w2),
               doutf, static_cast<float*>(dx), p.sc, n, f, eps, seed,
               threshold, inv_keep, s);
    const float* y = LN ? static_cast<const float*>(p.sc.y_c) : xf;
    const float* df = LN ? static_cast<const float*>(p.sc.df_c) : doutf;
    if (err == cudaSuccess)
      err = gemm_tn(y, static_cast<const float*>(p.sc.dh_c), dw1, n, d, f, s);
    if (err == cudaSuccess)
      err = gemm_tn(static_cast<const float*>(p.sc.g_c), df, dw2, n, f, d, s);
  }
  if (err != cudaSuccess) return err;
  const int t32 = row_tiles(n);
  if (LN && ((err = reduce(p.sc.p_dgamma, dgamma, t32, d, s)) != cudaSuccess ||
             (err = reduce(p.sc.p_dbeta, dbeta, t32, d, s)) != cudaSuccess))
    return err;
  if ((err = reduce(p.sc.p_db2, db2, t32, d, s)) != cudaSuccess) return err;
  return reduce(p.sc.p_db1, db1, p.db1_tiles, f, s);
}

// Argument checks shared by both entry points.
inline bool valid_shape(int dtype, int n, int d, int f) {
  return (dtype == 0 || dtype == 1) && n > 0 && f > 0 && f % kTile == 0 &&
         (d == 384 || d == 768);
}

}  // namespace mlp_bwd
}  // namespace vit
