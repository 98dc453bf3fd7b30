// Backward passes of the encoder block's MLP, in two forms selected by the
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
// deterministic passes with no float atomics, the same passes in both
// dtypes (bf16: the products on mlp_common.cuh's wg::gemm_bf16, wgmma with
// TMA operands; f32: on simt::gemm_f32 and gemm_tn_f32, exact f32 FMA, no
// TF32, which would break the 1e-4 bounds):
//   1. ln_rows_pre (LN only): the LN statistics recomputed from x (over the
//      true width d_ln) as the forward computes them, y_c = cast(LN(x)) and df_c = cast(keep1 dO /
//      keep) written out; without LN the GEMM operands are x and dO.
//   2. dg = df_c W2^T ([N, D] x [D, F], W2 read transposed) with the
//      hidden-gradient epilogue: GELU' and the drop0 keep bit of the
//      element's true (row, hidden column), dh_c and g_c written in the
//      compute dtype, the column sums of the f32 dh per row tile (db1
//      partials).
//   3. dy = dh_c W1^T ([N, F] x [F, D]) into an f32 [N, D] buffer (LN; 19
//      MB at B/16 in bf16), or cast straight to dx (no LN).
//   4. rows_post: the LN backward of 32 rows per CTA from the dy buffer into
//      dx = cast(dO + dx_ln) and the dgamma / dbeta column partials (LN);
//      the db2 column partials of the f32 df in both forms.
//   5. dW1 = y_c^T dh_c and dW2 = g_c^T df_c. bf16: both operands MN-major
//      (the reduction runs over the rows), ragged N zero-filled by TMA, the
//      reduction cut into weight_splits() contiguous ranges whose f32
//      partials sum_splits adds in split order. f32: gemm_tn_f32, one CTA
//      per 64 x 64 output tile looping over all rows.
//   6. colsum: db1, db2 (and dgamma, dbeta) as fixed-order sums of the
//      partials.
// Every row pass takes D at run time (a warp per row, walking it in
// register chunks of 768 columns, mlp_common.cuh's load_chunk), so every
// preset width runs the same code.
// What bounds it on an H100: the four GEMMs, 2 N D F FLOP each (0.120 ms at
// 989 TFLOP/s for N = 6304, D = 768, F = 3072); the design spends extra
// bytes on dh_c / g_c (and, with LN, y_c, df_c and dy) written once and
// read once or twice, about 0.2 GB at B/16.
// The rounding points are the Pallas kernels': df and dh are cast to the
// compute dtype before their products, every sum is f32, the bias (and LN)
// gradients sum f32 values, dx = dO + dx_ln in f32 then cast (LN). The
// weight gradients leave in f32; the wrappers cast them to the parameter
// dtypes.
#pragma once

#include "mlp_common.cuh"

namespace vit {
namespace mlp_bwd {

using namespace vit::mlp;

struct Scratch {
  // Compute-dtype tensors written by the passes, read by the GEMMs.
  void* y_c;   // [n, d] (LN only)
  void* df_c;  // [n, d] (LN only)
  void* g_c;   // [n, f]
  void* dh_c;  // [n, f]
  // f32 per-tile column sums [tiles, width].
  float* p_dgamma;  // width d (LN only), per 32 rows
  float* p_dbeta;   // width d (LN only), per 32 rows
  float* p_db2;     // width d, per 32 rows
  float* p_db1;     // width f, per GEMM row tile (128 bf16, 64 f32)
};

// The column-partial loops: a thread sums kCols columns, kRowThreads
// apart, over the CTA's rows at once, so their loads are in flight
// together whatever d is (every column of D <= 1024 in one pass).
constexpr int kCols = 4;

// Column sums of the f32 df over this CTA's 32 rows -> p_db2[tile]
// (threshold 0: df = dO).
template <typename T>
__device__ __forceinline__ void db2_partial(const T* __restrict__ dout,
                                            float* p_db2, int row0, int n,
                                            int d, uint32_t seed,
                                            int threshold, float inv_keep) {
  for (int c0 = threadIdx.x; c0 < d; c0 += kCols * kRowThreads) {
    float s[kCols] = {};
#pragma unroll 4
    for (int r = 0; r < kRowBM; ++r) {
      if (row0 + r >= n) break;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int col = c0 + q * kRowThreads;
        if (col >= d) continue;
        float df = to_f32(dout[static_cast<size_t>(row0 + r) * d + col]);
        if (threshold)
          df = positional_keep(seed, 1u, row0 + r, col, threshold)
                   ? df * inv_keep
                   : 0.0f;
        s[q] += df;
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      if (c0 + q * kRowThreads < d)
        p_db2[static_cast<size_t>(blockIdx.x) * d + c0 + q * kRowThreads] =
            s[q];
  }
}

// After the dy GEMM: with LN the LN backward of 32 rows from the f32 dy
// buffer into dx (statistics recomputed from x) and the dgamma / dbeta
// column partials; the db2 column partials in both forms.
template <typename T, bool LN>
__global__ void __launch_bounds__(kRowThreads)
    rows_post(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dout, const float* __restrict__ dy,
              T* __restrict__ dx, Scratch sc, int n, int d, int d_ln,
              float eps, uint32_t seed, int threshold, float inv_keep) {
  const int row0 = blockIdx.x * kRowBM;
  if constexpr (LN) {
    __shared__ float mu_s[kRowBM], rstd_s[kRowBM];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kRowBM; r += kRowThreads / 32) {
      const int grow = row0 + r;
      float mu = 0.0f, rstd = 0.0f;
      if (grow < n) {
        const size_t base = static_cast<size_t>(grow) * d;
        row_stats(x + base, d_ln, mu, rstd, eps);
        // dx = dO + rstd (dxh - mean(dxh) - xh mean(dxh xh)), dxh = dy g,
        // the means over d_ln columns (dxh is 0 past d_ln, where g is).
        float s1 = 0.0f, s2 = 0.0f, v[kChunk], g[kChunk];
        for (int c0 = 0; c0 < d; c0 += 32 * kChunk) {
          load_chunk(x + base, c0, d, v);
          load_chunk(dy + base, c0, d, g);
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int col = c0 + 32 * j + lane;
            if (col >= d) continue;
            const float dxh = g[j] * gamma[col];
            s1 += dxh;
            s2 += dxh * ((v[j] - mu) * rstd);
          }
        }
        const float m1 = warp_sum(s1) / static_cast<float>(d_ln);
        const float m2 = warp_sum(s2) / static_cast<float>(d_ln);
        for (int c0 = 0; c0 < d; c0 += 32 * kChunk) {
          float o_[kChunk];
          load_chunk(x + base, c0, d, v);
          load_chunk(dy + base, c0, d, g);
          load_chunk(dout + base, c0, d, o_);
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int col = c0 + 32 * j + lane;
            if (col >= d) continue;
            const float xh = (v[j] - mu) * rstd;
            const float dxh = g[j] * gamma[col];
            dx[base + col] = from_f32<T>(o_[j] + rstd * (dxh - m1 - xh * m2));
          }
        }
      }
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
    for (int c0 = threadIdx.x; c0 < d; c0 += kCols * kRowThreads) {
      float sg[kCols] = {}, sb[kCols] = {};
#pragma unroll 4
      for (int r = 0; r < kRowBM; ++r) {
        if (row0 + r >= n) break;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int col = c0 + q * kRowThreads;
          if (col >= d) continue;
          const size_t o = static_cast<size_t>(row0 + r) * d + col;
          const float g = dy[o];
          sg[q] += g * ((to_f32(x[o]) - mu_s[r]) * rstd_s[r]);
          sb[q] += g;
        }
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int col = c0 + q * kRowThreads;
        if (col >= d) continue;
        sc.p_dgamma[static_cast<size_t>(blockIdx.x) * d + col] = sg[q];
        sc.p_dbeta[static_cast<size_t>(blockIdx.x) * d + col] = sb[q];
      }
    }
    db2_partial<T>(dout, sc.p_db2, row0, n, d, seed, threshold, inv_keep);
  } else {
    db2_partial<T>(dout, sc.p_db2, row0, n, d, seed, 0, 1.0f);
  }
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

// ----------------------------------------------------------- workspace
// Everything the passes keep between them, carved from one workspace of
// plan()'s size (each region 1024-byte aligned): y_c, df_c (LN), g_c,
// dh_c in the compute dtype, the f32 dy buffer [n, d] (LN), the bf16
// weight GEMMs' split partials [splits, d, f] (splits > 1), the dgamma /
// dbeta (LN) and db2 partials per 32 rows and the db1 partials per GEMM
// row tile.
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
  const int db1_tiles = cdiv(n, dtype == 1 ? wg::kM : simt::kT);
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
  q.dy = static_cast<float*>(LN ? take(nd * 4) : nullptr);
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

// ------------------------------------------------------------- passes
// Steps 1-5 for compute type T (bf16: wgmma, float: SIMT).
template <typename T, bool LN>
cudaError_t passes(const T* x, const T* h, const float* gamma,
                   const float* beta, const T* w1, const T* w2, const T* dout,
                   T* dx, float* dw1, float* dw2, const Plan& p, int n, int d,
                   int f, int d_ln, float eps, uint32_t seed, int threshold,
                   float inv_keep, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cudaError_t err;
  const int t32 = row_tiles(n);
  T* y_c = static_cast<T*>(p.sc.y_c);
  T* df_c = static_cast<T*>(p.sc.df_c);
  T* g_c = static_cast<T*>(p.sc.g_c);
  T* dh_c = static_cast<T*>(p.sc.dh_c);
  const T* y = LN ? y_c : x;      // fc1's input
  const T* df = LN ? df_c : dout;  // fc2's output gradient
  if constexpr (LN) {
    ln_rows_pre<T, true><<<t32, kRowThreads, 0, s>>>(
        x, gamma, beta, dout, y_c, df_c, n, d, d_ln, eps, seed, threshold,
        inv_keep);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // dg = df_c W2^T, then dh_c, g_c and the db1 partials in its epilogue.
  EpiArgs<T> e{};
  e.h = h;
  e.dh_c = dh_c;
  e.g_c = g_c;
  e.p_db1 = p.sc.p_db1;
  e.seed = seed;
  e.threshold = threshold;
  e.inv_keep = inv_keep;
  // dy = dh_c W1^T: into the f32 buffer (LN) or straight to dx.
  EpiArgs<T> ey{};
  ey.c32 = p.dy;
  ey.out = dx;
  constexpr int kDy = LN ? kStoreF32 : kStoreOut;
  if constexpr (kBf16) {
    err = wg::gemm<kHiddenGrad, false, false>(df, d, n, w2, d, f, e, n, f, d,
                                              1, s);
    if (err != cudaSuccess) return err;
    err = wg::gemm<kDy, false, false>(dh_c, f, n, w1, f, d, ey, n, d, f, 1, s);
  } else {
    err = simt::gemm<kHiddenGrad, true>(df, w2, e, n, f, d, s);
    if (err != cudaSuccess) return err;
    err = simt::gemm<kDy, true>(dh_c, w1, ey, n, d, f, s);
  }
  if (err != cudaSuccess) return err;
  rows_post<T, LN><<<t32, kRowThreads, 0, s>>>(x, gamma, dout, p.dy, dx, p.sc,
                                               n, d, d_ln, eps, seed,
                                               threshold, inv_keep);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (!kBf16) {
    // dW1 = y^T dh_c and dW2 = g_c^T df.
    gemm_tn_f32<<<dim3(d / kTile, f / kTile), 256, 0, s>>>(y, dh_c, dw1, n, d,
                                                           f);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    gemm_tn_f32<<<dim3(f / kTile, d / kTile), 256, 0, s>>>(g_c, df, dw2, n, f,
                                                           d);
    return cudaGetLastError();
  } else {
    // dW1 = y_c^T dh_c and dW2 = g_c^T df_c, both operands MN-major.
    const size_t dfc = static_cast<size_t>(d) * f;
    EpiArgs<bf16> ew{};
    float* dws[2] = {dw1, dw2};
    for (int which = 0; which < 2; ++which) {
      ew.c32 = p.splits > 1 ? p.split : dws[which];
      err = which == 0 ? wg::gemm<kStoreF32, true, true>(
                             y, d, n, dh_c, f, n, ew, d, f, n, p.splits, s)
                       : wg::gemm<kStoreF32, true, true>(
                             g_c, f, n, df, d, n, ew, f, d, n, p.splits, s);
      if (err != cudaSuccess) return err;
      if (p.splits > 1) {
        wg::sum_splits<<<cdiv(static_cast<int>(dfc / 4), 256), 256, 0, s>>>(
            reinterpret_cast<const float4*>(p.split),
            reinterpret_cast<float4*>(dws[which]), p.splits, dfc / 4);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
    }
    return cudaSuccess;
  }
}

inline cudaError_t reduce(const float* part, float* out, int tiles, int width,
                          cudaStream_t s) {
  colsum<<<(width + 31) / 32, 256, 0, s>>>(part, out, tiles, width);
  return cudaGetLastError();
}

// The whole backward of either form on `stream`, scratch carved from
// `workspace` (plan()'s size). Without LN, gamma, beta, dgamma and dbeta
// are null; with LN the statistics run over the first d_ln columns.
// Returns the first cudaError_t that is not 0.
template <bool LN>
cudaError_t backward(int dtype, const void* x, const void* h,
                     const float* gamma, const float* beta, const void* w1,
                     const void* w2, const void* dout, void* dx,
                     float* dgamma, float* dbeta, float* dw1, float* db1,
                     float* dw2, float* db2, void* workspace,
                     long long workspace_bytes, int n, int d, int f, int d_ln,
                     float eps, uint32_t seed, int threshold, float inv_keep,
                     cudaStream_t s) {
  if (!valid_shape(dtype, n, d, f, d_ln)) return cudaErrorInvalidValue;
  Plan p;
  if (workspace_bytes <
      static_cast<long long>(plan<LN>(dtype, n, d, f, workspace, &p)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 1
          ? passes<bf16, LN>(
                static_cast<const bf16*>(x), static_cast<const bf16*>(h),
                gamma, beta, static_cast<const bf16*>(w1),
                static_cast<const bf16*>(w2), static_cast<const bf16*>(dout),
                static_cast<bf16*>(dx), dw1, dw2, p, n, d, f, d_ln, eps, seed,
                threshold, inv_keep, s)
          : passes<float, LN>(
                static_cast<const float*>(x), static_cast<const float*>(h),
                gamma, beta, static_cast<const float*>(w1),
                static_cast<const float*>(w2),
                static_cast<const float*>(dout), static_cast<float*>(dx), dw1,
                dw2, p, n, d, f, d_ln, eps, seed, threshold, inv_keep, s);
  if (err != cudaSuccess) return err;
  const int t32 = row_tiles(n);
  if (LN && ((err = reduce(p.sc.p_dgamma, dgamma, t32, d, s)) != cudaSuccess ||
             (err = reduce(p.sc.p_dbeta, dbeta, t32, d, s)) != cudaSuccess))
    return err;
  if ((err = reduce(p.sc.p_db2, db2, t32, d, s)) != cudaSuccess) return err;
  return reduce(p.sc.p_db1, db1, p.db1_tiles, f, s);
}

// Bytes of workspace backward<LN> needs for these shapes (-1: shapes it
// does not take).
template <bool LN>
long long workspace_bytes(int dtype, int n, int d, int f) {
  if (!valid_shape(dtype, n, d, f, d)) return -1;
  return static_cast<long long>(plan<LN>(dtype, n, d, f, nullptr, nullptr));
}

}  // namespace mlp_bwd
}  // namespace vit
