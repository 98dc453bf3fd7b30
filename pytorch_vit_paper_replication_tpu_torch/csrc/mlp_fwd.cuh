// Forward passes of the encoder block's MLP, in two forms selected by the
// template flag LN:
//   LN = true:  out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))   (row 1)
//   LN = false: out = fc2(drop0(gelu(fc1(x))))                  (row 6)
// csrc/fused_mlp.cu instantiates the first, csrc/fused_mlp_core.cu the
// second; both may also write h = fc1(.) + b1, rounded to the compute dtype,
// as the backward's residual (h_out non-null).
//
// The Pallas kernel keeps a [rows, F] hidden block in VMEM; a CTA's 227 KB
// of shared memory holds no such block at D >= 1024 (a [32, D] row block
// and one weight chunk already take 235 KB at D = 1024), so the hidden
// activation goes through device memory once, in the compute dtype, and
// each pass is a GEMM the card runs at its tensor-core rate:
//   1. (LN) ln_rows_pre: y_c = cast(LN(x)), f32 statistics (two-pass mean
//      and centred variance) over the true width d_ln, one warp per row;
//   2. fc1 = y W1 ([N, D] x [D, F]; y read K-major, W1 MN-major) with the
//      kFc1 epilogue: + b1 in f32, h saved in the compute dtype, A&S erf
//      GELU, hidden keep bit (tag 0, the element's (row, hidden column)),
//      g = cast(keep0 gelu(h) / keep) into the workspace;
//   3. fc2 = g W2 ([N, F] x [F, D]; g K-major, W2 MN-major) with the
//      kFc2Res epilogue (LN: + b2 in f32, output keep bit (tag 1), + x in
//      f32, cast) or kFc2 (core: + b2, cast); rows < N stored.
// These are the Pallas kernel's rounding points: y and g cast to the
// compute dtype before their products, every sum f32.
// bf16: the passes' GEMMs are mlp_common.cuh's wg::gemm_bf16 (wgmma, TMA
// operands on a 4-stage mbarrier ring, 128 x 128 CTA tiles; TMA zero-fills
// the ragged edges, so any N and D = 192's half-used column tile need no
// masking). f32: the same passes with simt::gemm_f32 (exact f32 FMA).
// What bounds it on an H100: 4 N D F FLOP (0.060 ms at 989 TFLOP/s for
// N = 6304, D = 768, F = 3072); the design adds the g (and y) round trip,
// 2 N F (+ 2 N D) bytes each way in bf16 (78 MB at B/16, 0.023 ms).
#pragma once

#include "mlp_common.cuh"

namespace vit {
namespace mlp_fwd {

using namespace vit::mlp;

// Everything the passes keep between them, carved from one workspace of
// plan()'s size (each region 1024-byte aligned): y_c [n, d] (LN only) and
// g [n, f] in the compute dtype.
struct Plan {
  void* y_c;
  void* g;
};

template <bool LN>
inline size_t plan(int dtype, int n, int d, int f, void* base, Plan* p) {
  const size_t es = dtype == 1 ? 2 : 4;
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* ptr = base ? static_cast<unsigned char*>(base) + off : nullptr;
    off += (bytes + 1023) / 1024 * 1024;
    return ptr;
  };
  Plan q{};
  q.y_c = LN ? take(static_cast<size_t>(n) * d * es) : nullptr;
  q.g = take(static_cast<size_t>(n) * f * es);
  if (p) *p = q;
  return off;
}

// The three passes on `s` for compute type T (bf16: wgmma, float: SIMT).
template <typename T, bool LN>
cudaError_t passes(const T* x, const float* gamma, const float* beta,
                   const T* w1, const T* b1, const T* w2, const T* b2, T* out,
                   T* h_out, const Plan& p, int n, int d, int f, int d_ln,
                   float eps, uint32_t seed, int threshold, float inv_keep,
                   cudaStream_t s) {
  cudaError_t err;
  T* y_c = static_cast<T*>(p.y_c);
  T* g = static_cast<T*>(p.g);
  if constexpr (LN) {
    ln_rows_pre<T, false><<<row_tiles(n), kRowThreads, 0, s>>>(
        x, gamma, beta, nullptr, y_c, nullptr, n, d, d_ln, eps, 0u, 0, 1.0f);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const T* y = LN ? y_c : x;
  EpiArgs<T> e1{};
  e1.out = g;
  e1.bias = b1;
  e1.h_out = h_out;
  e1.seed = seed;
  e1.threshold = threshold;
  e1.inv_keep = inv_keep;
  EpiArgs<T> e2{};
  e2.out = out;
  e2.bias = b2;
  e2.x = x;
  e2.seed = seed;
  e2.threshold = threshold;
  e2.inv_keep = inv_keep;
  constexpr int kOut = LN ? kFc2Res : kFc2;
  if constexpr (sizeof(T) == 2) {
    err = wg::gemm<kFc1, false, true>(y, d, n, w1, f, d, e1, n, f, d, 1, s);
    if (err != cudaSuccess) return err;
    return wg::gemm<kOut, false, true>(g, f, n, w2, d, f, e2, n, d, f, 1, s);
  } else {
    err = simt::gemm<kFc1, false>(y, w1, e1, n, f, d, s);
    if (err != cudaSuccess) return err;
    return simt::gemm<kOut, false>(g, w2, e2, n, d, f, s);
  }
}

// The whole forward of either form on `s`, scratch carved from
// `workspace` (plan()'s size). dtype: 0 = float32, 1 = bf16. gamma/beta
// are read only when LN, which normalizes over the first d_ln columns.
template <bool LN>
cudaError_t run(int dtype, const void* x, const float* gamma,
                const float* beta, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, void* h,
                void* workspace, long long workspace_bytes, int n, int d,
                int f, int d_ln, float eps, uint32_t seed, int threshold,
                float inv_keep, cudaStream_t s) {
  if (!valid_shape(dtype, n, d, f, d_ln)) return cudaErrorInvalidValue;
  Plan p;
  if (workspace_bytes <
      static_cast<long long>(plan<LN>(dtype, n, d, f, workspace, &p)))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return passes<bf16, LN>(
        static_cast<const bf16*>(x), gamma, beta, static_cast<const bf16*>(w1),
        static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
        static_cast<const bf16*>(b2), static_cast<bf16*>(out),
        static_cast<bf16*>(h), p, n, d, f, d_ln, eps, seed, threshold,
        inv_keep, s);
  return passes<float, LN>(
      static_cast<const float*>(x), gamma, beta,
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), static_cast<float*>(h), p, n, d, f, d_ln, eps,
      seed, threshold, inv_keep, s);
}

// Bytes of workspace run<LN> needs for these shapes (-1: shapes it does
// not take).
template <bool LN>
long long workspace_bytes(int dtype, int n, int d, int f) {
  if (!valid_shape(dtype, n, d, f, d)) return -1;
  return static_cast<long long>(plan<LN>(dtype, n, d, f, nullptr, nullptr));
}

}  // namespace mlp_fwd
}  // namespace vit
