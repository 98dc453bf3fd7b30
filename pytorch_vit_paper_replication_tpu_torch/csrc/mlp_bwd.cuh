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
// three deterministic passes with no float atomics:
//   1. rows: one CTA per 32 rows. With LN, the statistics are recomputed
//      from x and y_c = cast(LN(x)), df_c = cast(keep1 * dO / keep) written
//      out; without LN the GEMM operands are x and dO themselves. F is
//      walked in 64 (bf16) / 32 (f32) column chunks: dg = df_c @ W2^T,
//      dh = keep0 * dg / keep * gelu'(h), dh_c and g_c = cast(keep0 *
//      gelu(h) / keep) written out, dy += dh_c @ W1^T kept on chip; then
//      the LN backward into dx (LN), or dx = cast(dy) (no LN). Per-CTA
//      column sums of the f32 df, dh (and, with LN, dy and dy * xhat) go to
//      [tiles, width] partials buffers.
//   2. gemm_tn: dW1 = y_c^T dh_c and dW2 = g_c^T df_c, one CTA per 64x64
//      output tile looping over all N rows (f32 accumulation).
//   3. colsum: db1, db2 (and dgamma, dbeta) as fixed-order sums of the
//      partials.
// The rounding points are the Pallas kernels': df and dh are cast to the
// compute dtype before their products, the bias (and LN) gradients sum f32
// values, dx = dO + dx_ln in f32 then cast (LN). The weight gradients
// leave in f32; the wrappers cast them to the parameter dtypes.
// bf16 products run on tensor cores through WMMA 16x16x16 (f32
// accumulate); f32 products are SIMT FMA (exact f32, no TF32).
#pragma once

#include <mma.h>

#include "vit_common.cuh"

namespace vit {
namespace mlp_bwd {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 32;        // rows per CTA in the row kernel

constexpr size_t round128(size_t b) { return (b + 127) / 128 * 128; }
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

struct Scratch {
  // Compute-dtype tensors written by the row kernel, read by gemm_tn.
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
    for (int r = 0; r < kBM && row0 + r < n; ++r) {
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
__device__ __forceinline__ void hidden_grad(float hv, float dg, int grow,
                                            int col, uint32_t seed,
                                            int threshold, float inv_keep,
                                            float& dh, float& g_drop) {
  const bool keep =
      threshold == 0 || positional_keep(seed, 0u, grow, col, threshold);
  const float dgm = keep ? dg * inv_keep : 0.0f;
  dh = dgm * gelu_grad(hv);
  g_drop = keep ? gelu_exact(hv) * inv_keep : 0.0f;
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
    for (int r = 0; r < kBM && row0 + r < n; ++r) {
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

// ----------------------------------------------------------- bf16 rows
constexpr int kChunk = 64;  // hidden columns per chunk
constexpr int kPad = 8;

template <int D>
struct RowsBf16Smem {
  static constexpr int ldd = D + kPad;       // df_s   [BM][ldd] bf16
  static constexpr int ldw1 = kChunk + kPad; // W1 chunk [D][ldw1] bf16
  static constexpr int ldw2 = D + kPad;      // W2 chunk [kChunk][ldw2] bf16
  static constexpr int ldh = kChunk + 4;     // dg / dh [BM][ldh] f32
  static constexpr int ldg = kChunk + kPad;  // dh_c   [BM][ldg] bf16
  static constexpr size_t w_bytes =
      cmax(cmax(D * ldw1 * 2, kChunk * ldw2 * 2), kBM * D * 4);
  static constexpr size_t df_off = 0;
  static constexpr size_t w_off = df_off + round128(kBM * ldd * 2);
  static constexpr size_t h_off = w_off + round128(w_bytes);
  static constexpr size_t g_off = h_off + round128(kBM * ldh * 4);
  static constexpr size_t st_off = g_off + round128(kBM * ldg * 2);
  static constexpr size_t bytes = st_off + 2 * kBM * 4;
};

template <int D, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_rows_bf16(const bf16* __restrict__ x, const bf16* __restrict__ h,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ dout, bf16* __restrict__ dx,
                      Scratch sc, int n, int f, float eps, uint32_t seed,
                      int threshold, float inv_keep) {
  using L = RowsBf16Smem<D>;
  constexpr int NF = D / 128;  // 16-wide dy column fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* df_s = reinterpret_cast<bf16*>(smem + L::df_off);
  bf16* w_s = reinterpret_cast<bf16*>(smem + L::w_off);
  float* dy_s = reinterpret_cast<float*>(smem + L::w_off);  // epilogue only
  float* h_s = reinterpret_cast<float*>(smem + L::h_off);
  bf16* g_s = reinterpret_cast<bf16*>(smem + L::g_off);
  float* mu_s = reinterpret_cast<float*>(smem + L::st_off);
  float* rstd_s = mu_s + kBM;
  bf16* g_c = static_cast<bf16*>(sc.g_c);
  bf16* dh_c = static_cast<bf16*>(sc.dh_c);

  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * kBM;
  prologue<bf16, D, LN>(x, gamma, beta, dout, df_s, L::ldd, mu_s, rstd_s, sc,
                        row0, n, eps, seed, threshold, inv_keep);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int hr = warp / 4, hc = warp % 4;  // this warp's dg tile
  for (int f0 = 0; f0 < f; f0 += kChunk) {
    __syncthreads();  // previous dy product done with w_s / g_s
    for (int i = threadIdx.x; i < kChunk * (D / 8); i += kThreads) {
      const int k = i / (D / 8), c8 = i % (D / 8);
      *reinterpret_cast<uint4*>(w_s + k * L::ldw2 + c8 * 8) =
          *reinterpret_cast<const uint4*>(
              w2 + static_cast<size_t>(f0 + k) * D + c8 * 8);
    }
    __syncthreads();
    {
      // dg[BM, chunk] = df_c @ W2[chunk, :]^T (W2 chunk read column-major).
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> dg;
      wmma::fill_fragment(dg, 0.0f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, df_s + hr * 16 * L::ldd + k, L::ldd);
        wmma::load_matrix_sync(b, w_s + hc * 16 * L::ldw2 + k, L::ldw2);
        wmma::mma_sync(dg, a, b, dg);
      }
      wmma::store_matrix_sync(h_s + hr * 16 * L::ldh + hc * 16, dg, L::ldh,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const int grow = row0 + r;
      float dh = 0.0f;
      if (grow < n) {
        const size_t o = static_cast<size_t>(grow) * f + f0 + c;
        float g_drop;
        hidden_grad(to_f32(h[o]), h_s[r * L::ldh + c], grow, f0 + c, seed,
                    threshold, inv_keep, dh, g_drop);
        g_c[o] = from_f32<bf16>(g_drop);
        dh_c[o] = from_f32<bf16>(dh);
      }
      h_s[r * L::ldh + c] = dh;
      g_s[r * L::ldg + c] = from_f32<bf16>(dh);
    }
    for (int i = threadIdx.x; i < D * (kChunk / 8); i += kThreads) {
      const int k = i / (kChunk / 8), c8 = i % (kChunk / 8);
      *reinterpret_cast<uint4*>(w_s + k * L::ldw1 + c8 * 8) =
          *reinterpret_cast<const uint4*>(w1 + static_cast<size_t>(k) * f +
                                          f0 + c8 * 8);
    }
    __syncthreads();
    if (threadIdx.x < kChunk) {
      float s = 0.0f;
      for (int r = 0; r < kBM; ++r) s += h_s[r * L::ldh + threadIdx.x];
      sc.p_db1[static_cast<size_t>(blockIdx.x) * f + f0 + threadIdx.x] = s;
    }
    // dy[BM, D] += dh_c[BM, chunk] @ W1[:, chunk]^T (W1 chunk column-major).
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, g_s + kk, L::ldg);
      wmma::load_matrix_sync(a1, g_s + 16 * L::ldg + kk, L::ldg);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w_s + (warp * NF + j) * 16 * L::ldw1 + kk,
                               L::ldw1);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
  }
  __syncthreads();  // w_s becomes dy_s
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(dy_s + i * 16 * D + (warp * NF + j) * 16,
                              acc[i][j], D, wmma::mem_row_major);
  __syncthreads();
  epilogue<bf16, D, LN>(x, gamma, dout, dy_s, mu_s, rstd_s, dx, sc, row0, n);
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

// -------------------------------------------------------------- gemm_tn
// C[M, P] (f32) = A[N, M]^T @ B[N, P], A and B row-major in the compute
// dtype; one CTA per 64x64 tile of C, looping over all N rows in 32-row
// steps (rows past N read as zero). M and P are multiples of 64.
constexpr int kTile = 64;
constexpr int kStep = 32;
constexpr int kLdt = kTile + kPad;

__global__ void __launch_bounds__(128)
    gemm_tn_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 float* __restrict__ c, int n, int m, int p) {
  __shared__ __align__(128) bf16 a_s[kStep * kLdt];
  __shared__ __align__(128) bf16 b_s[kStep * kLdt];
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;  // 32x32 quadrant of the tile
  const int m0 = blockIdx.x * kTile, p0 = blockIdx.y * kTile;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int n0 = 0; n0 < n; n0 += kStep) {
    __syncthreads();
    for (int i = threadIdx.x; i < kStep * (kTile / 8); i += 128) {
      const int r = i / (kTile / 8), c8 = i % (kTile / 8);
      const bool in = n0 + r < n;
      *reinterpret_cast<uint4*>(a_s + r * kLdt + c8 * 8) =
          in ? *reinterpret_cast<const uint4*>(
                   a + static_cast<size_t>(n0 + r) * m + m0 + c8 * 8)
             : zero;
      *reinterpret_cast<uint4*>(b_s + r * kLdt + c8 * 8) =
          in ? *reinterpret_cast<const uint4*>(
                   b + static_cast<size_t>(n0 + r) * p + p0 + c8 * 8)
             : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_s + kk * kLdt + wr * 32 + i * 16,
                               kLdt);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + kk * kLdt + wc * 32 + j * 16,
                               kLdt);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          c + static_cast<size_t>(m0 + wr * 32 + i * 16) * p + p0 + wc * 32 +
              j * 16,
          acc[i][j], p, wmma::mem_row_major);
}

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

// out[w] = sum over tiles t (in order) of part[t, w].
__global__ void colsum(const float* __restrict__ part, float* __restrict__ out,
                       int tiles, int width) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += part[static_cast<size_t>(t) * width + col];
  out[col] = s;
}

template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, size_t smem, int tiles,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<tiles, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, bool LN>
cudaError_t rows_d(int dtype, const void* x, const void* h,
                   const float* gamma, const float* beta, const void* w1,
                   const void* w2, const void* dout, void* dx,
                   const Scratch& sc, int n, int f, float eps, uint32_t seed,
                   int threshold, float inv_keep, int tiles, cudaStream_t s) {
  if (dtype == 1)
    return launch_rows(mlp_bwd_rows_bf16<D, LN>, RowsBf16Smem<D>::bytes,
                       tiles, s, static_cast<const bf16*>(x),
                       static_cast<const bf16*>(h), gamma, beta,
                       static_cast<const bf16*>(w1),
                       static_cast<const bf16*>(w2),
                       static_cast<const bf16*>(dout), static_cast<bf16*>(dx),
                       sc, n, f, eps, seed, threshold, inv_keep);
  return launch_rows(mlp_bwd_rows_f32<D, LN>, RowsF32Smem<D>::bytes, tiles, s,
                     static_cast<const float*>(x),
                     static_cast<const float*>(h), gamma, beta,
                     static_cast<const float*>(w1),
                     static_cast<const float*>(w2),
                     static_cast<const float*>(dout), static_cast<float*>(dx),
                     sc, n, f, eps, seed, threshold, inv_keep);
}

// The row kernel for d in {384, 768} (the caller validates d).
template <bool LN>
cudaError_t rows(int dtype, int d, const void* x, const void* h,
                 const float* gamma, const float* beta, const void* w1,
                 const void* w2, const void* dout, void* dx,
                 const Scratch& sc, int n, int f, float eps, uint32_t seed,
                 int threshold, float inv_keep, int tiles, cudaStream_t s) {
  return d == 384 ? rows_d<384, LN>(dtype, x, h, gamma, beta, w1, w2, dout,
                                    dx, sc, n, f, eps, seed, threshold,
                                    inv_keep, tiles, s)
                  : rows_d<768, LN>(dtype, x, h, gamma, beta, w1, w2, dout,
                                    dx, sc, n, f, eps, seed, threshold,
                                    inv_keep, tiles, s);
}

inline cudaError_t gemm_tn(int dtype, const void* a, const void* b, float* c,
                           int n, int m, int p, cudaStream_t s) {
  const dim3 grid(m / kTile, p / kTile);
  if (dtype == 1)
    gemm_tn_bf16<<<grid, 128, 0, s>>>(static_cast<const bf16*>(a),
                                      static_cast<const bf16*>(b), c, n, m, p);
  else
    gemm_tn_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                     static_cast<const float*>(b), c, n, m, p);
  return cudaGetLastError();
}

inline cudaError_t reduce(const float* part, float* out, int tiles, int width,
                          cudaStream_t s) {
  colsum<<<(width + 255) / 256, 256, 0, s>>>(part, out, tiles, width);
  return cudaGetLastError();
}

// Argument checks shared by both entry points.
inline bool valid_shape(int dtype, int n, int d, int f) {
  return (dtype == 0 || dtype == 1) && n > 0 && f > 0 && f % kTile == 0 &&
         (d == 384 || d == 768);
}

inline int row_tiles(int n) { return (n + kBM - 1) / kBM; }

}  // namespace mlp_bwd
}  // namespace vit
