// Forward kernels of the encoder block's MLP, in two forms selected by the
// template flag LN:
//   LN = true:  out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))   (row 1)
//   LN = false: out = fc2(drop0(gelu(fc1(x))))                  (row 6)
// csrc/fused_mlp.cu instantiates the first, csrc/fused_mlp_core.cu the
// second; both may also write h = fc1(.) + b1, rounded to the compute dtype,
// as the backward's residual (h_out non-null).
//
// Design (a first, simple kernel; no TMA/wgmma yet):
//   * One CTA owns BM = 32 rows and the whole output width D. Blocks are
//     independent: nothing is carried between CTAs (the Pallas grid was
//     sequential, a CUDA grid is not).
//   * LN: statistics in f32 (two-pass mean / centred variance, as the
//     Pallas _ln), y cast to the compute dtype into shared memory. Without
//     LN the x rows are copied there as they are.
//   * F is walked in chunks: h = y @ W1[:, chunk] (f32 accumulation) -> +b1
//     -> A&S 7.1.26 erf GELU -> hidden dropout (tag 0) -> cast -> g_s; then
//     acc += g_s @ W2[chunk, :]. F = 3072 never fits shared memory as a
//     whole hidden row block, so only one chunk of h/g is ever resident and
//     the fc2 partial sums stay in registers across chunks.
//   * bf16: tensor cores through WMMA 16x16x16 (f32 accumulate).
//     f32: SIMT FMA (exact f32, no TF32 rounding).
//   * Epilogue: +b2 in f32; with LN, output dropout (tag 1) and + x in f32;
//     cast, store.
//   * Weight chunks are re-read from L2 by every CTA; a later version
//     should stream them with TMA into a multi-stage ring and use wgmma.
#pragma once

#include <mma.h>

#include "vit_common.cuh"

namespace vit {
namespace mlp_fwd {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 32;        // rows per CTA

// LayerNorm of this CTA's rows into y_s (row stride ldy), one warp per row.
template <typename T, int D>
__device__ __forceinline__ void layernorm_rows(const T* __restrict__ x,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               T* y_s, int ldy, int row0,
                                               int n, float eps) {
  constexpr int NJ = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int grow = row0 + r;
    if (grow < n) {
      const T* xr = x + static_cast<size_t>(grow) * D;
      float v[NJ];
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        v[j] = to_f32(xr[lane + 32 * j]);
        s += v[j];
      }
      const float mu = warp_sum(s) / static_cast<float>(D);
      float s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float c = v[j] - mu;
        s2 += c * c;
      }
      const float var = warp_sum(s2) / static_cast<float>(D);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const float y = (v[j] - mu) * rstd * gamma[col] + beta[col];
        y_s[r * ldy + col] = from_f32<T>(y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        y_s[r * ldy + lane + 32 * j] = from_f32<T>(0.0f);
    }
  }
}

// This CTA's x rows into y_s as they are (rows past n read as zero).
template <typename T, int D>
__device__ __forceinline__ void copy_rows(const T* __restrict__ x, T* y_s,
                                          int ldy, int row0, int n) {
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int r = i / D, col = i % D;
    y_s[r * ldy + col] = row0 + r < n
                             ? x[static_cast<size_t>(row0 + r) * D + col]
                             : from_f32<T>(0.0f);
  }
}

// The fc1 operand rows: LN(x) with LN, else x.
template <typename T, int D, bool LN>
__device__ __forceinline__ void input_rows(const T* __restrict__ x,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           T* y_s, int ldy, int row0, int n,
                                           float eps) {
  if constexpr (LN)
    layernorm_rows<T, D>(x, gamma, beta, y_s, ldy, row0, n, eps);
  else
    copy_rows<T, D>(x, y_s, ldy, row0, n);
}

// The epilogue of one output element: fv = acc + b2 (f32); with LN the
// output dropout and the residual.
template <bool LN>
__device__ __forceinline__ float epilogue(float fv, float xv, int grow,
                                          int col, uint32_t seed,
                                          int threshold, float inv_keep) {
  if constexpr (LN) {
    if (threshold)
      fv = positional_keep(seed, 1u, grow, col, threshold) ? fv * inv_keep
                                                           : 0.0f;
    return xv + fv;
  } else {
    return fv;
  }
}

// ----------------------------------------------------------------- bf16
constexpr int kBF16Chunk = 64;  // hidden columns per chunk
constexpr int kPad = 8;         // bf16 row padding (keeps 32-byte alignment)

constexpr size_t round128(size_t b) { return (b + 127) / 128 * 128; }

template <int D>
struct Bf16Smem {
  static constexpr int ldy = D + kPad;
  static constexpr int ldw1 = kBF16Chunk + kPad;
  static constexpr int ldw2 = D + kPad;
  static constexpr int ldh = kBF16Chunk + 4;
  static constexpr int ldg = kBF16Chunk + kPad;
  static constexpr size_t w_elems =
      D * ldw1 > kBF16Chunk * ldw2 ? D * ldw1 : kBF16Chunk * ldw2;
  static constexpr size_t y_off = 0;
  static constexpr size_t w_off = y_off + round128(kBM * ldy * 2);
  static constexpr size_t h_off = w_off + round128(w_elems * 2);
  static constexpr size_t g_off = h_off + round128(kBM * ldh * 4);
  static constexpr size_t st_off = g_off + round128(kBM * ldg * 2);
  static constexpr size_t bytes = st_off + (kThreads / 32) * 256 * 4;
};

template <int D, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_fwd_bf16(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, bf16* __restrict__ out,
                 bf16* __restrict__ h_out, int n, int f, float eps,
                 uint32_t seed, int threshold, float inv_keep) {
  using L = Bf16Smem<D>;
  constexpr int NF = D / 128;  // 16-wide output column fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y_s = reinterpret_cast<bf16*>(smem + L::y_off);
  bf16* w_s = reinterpret_cast<bf16*>(smem + L::w_off);
  float* h_s = reinterpret_cast<float*>(smem + L::h_off);
  bf16* g_s = reinterpret_cast<bf16*>(smem + L::g_off);
  float* st_s = reinterpret_cast<float*>(smem + L::st_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBM;
  input_rows<bf16, D, LN>(x, gamma, beta, y_s, L::ldy, row0, n, eps);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int hr = warp / 4, hc = warp % 4;  // this warp's fc1 tile
  for (int f0 = 0; f0 < f; f0 += kBF16Chunk) {
    __syncthreads();  // previous fc2 done with w_s / g_s
    for (int i = threadIdx.x; i < D * (kBF16Chunk / 8); i += kThreads) {
      const int k = i / (kBF16Chunk / 8), c8 = i % (kBF16Chunk / 8);
      *reinterpret_cast<uint4*>(w_s + k * L::ldw1 + c8 * 8) =
          *reinterpret_cast<const uint4*>(w1 + static_cast<size_t>(k) * f +
                                          f0 + c8 * 8);
    }
    __syncthreads();
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
      wmma::fill_fragment(h, 0.0f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, y_s + hr * 16 * L::ldy + k, L::ldy);
        wmma::load_matrix_sync(b, w_s + k * L::ldw1 + hc * 16, L::ldw1);
        wmma::mma_sync(h, a, b, h);
      }
      wmma::store_matrix_sync(h_s + hr * 16 * L::ldh + hc * 16, h, L::ldh,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kBF16Chunk; i += kThreads) {
      const int r = i / kBF16Chunk, c = i % kBF16Chunk;
      const float hv = h_s[r * L::ldh + c] + to_f32(b1[f0 + c]);
      if (h_out != nullptr && row0 + r < n)
        h_out[static_cast<size_t>(row0 + r) * f + f0 + c] =
            from_f32<bf16>(hv);
      float g = gelu_exact(hv);
      if (threshold) {
        g = positional_keep(seed, 0u, row0 + r, f0 + c, threshold)
                ? g * inv_keep
                : 0.0f;
      }
      g_s[r * L::ldg + c] = from_f32<bf16>(g);
    }
    for (int i = threadIdx.x; i < kBF16Chunk * (D / 8); i += kThreads) {
      const int k = i / (D / 8), c8 = i % (D / 8);
      *reinterpret_cast<uint4*>(w_s + k * L::ldw2 + c8 * 8) =
          *reinterpret_cast<const uint4*>(
              w2 + static_cast<size_t>(f0 + k) * D + c8 * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBF16Chunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, g_s + kk, L::ldg);
      wmma::load_matrix_sync(a1, g_s + 16 * L::ldg + kk, L::ldg);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w_s + kk * L::ldw2 + (warp * NF + j) * 16,
                               L::ldw2);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
  }

  float* st = st_s + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int grow = row0 + i * 16 + e / 16;
        const int col = (warp * NF + j) * 16 + e % 16;
        if (grow < n) {
          const size_t o = static_cast<size_t>(grow) * D + col;
          const float xv = LN ? to_f32(x[o]) : 0.0f;
          out[o] = from_f32<bf16>(epilogue<LN>(st[e] + to_f32(b2[col]), xv,
                                               grow, col, seed, threshold,
                                               inv_keep));
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------------ f32
constexpr int kF32Chunk = 32;

template <int D>
struct F32Smem {
  static constexpr int ldg = kF32Chunk + 1;
  static constexpr size_t y_off = 0;
  static constexpr size_t w_off = y_off + kBM * D * 4;
  static constexpr size_t g_off = w_off + D * kF32Chunk * 4;
  static constexpr size_t bytes = g_off + kBM * ldg * 4;
};

template <int D, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_fwd_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out,
                float* __restrict__ h_out, int n, int f, float eps,
                uint32_t seed, int threshold, float inv_keep) {
  using L = F32Smem<D>;
  constexpr int NC = D / 32;  // output columns per thread (stride 32)
  constexpr int RPW = kBM / (kThreads / 32);  // rows per warp = 4
  extern __shared__ __align__(128) unsigned char smem[];
  float* y_s = reinterpret_cast<float*>(smem + L::y_off);
  float* w_s = reinterpret_cast<float*>(smem + L::w_off);
  float* g_s = reinterpret_cast<float*>(smem + L::g_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kBM;
  input_rows<float, D, LN>(x, gamma, beta, y_s, D, row0, n, eps);

  float acc[RPW][NC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  for (int f0 = 0; f0 < f; f0 += kF32Chunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < D * (kF32Chunk / 4); i += kThreads) {
      const int k = i / (kF32Chunk / 4), c4 = i % (kF32Chunk / 4);
      *reinterpret_cast<float4*>(w_s + k * kF32Chunk + c4 * 4) =
          *reinterpret_cast<const float4*>(w1 + static_cast<size_t>(k) * f +
                                           f0 + c4 * 4);
    }
    __syncthreads();
    float h[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) h[i] = 0.0f;
    for (int k = 0; k < D; ++k) {
      const float b = w_s[k * kF32Chunk + lane];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        h[i] = fmaf(y_s[(warp * RPW + i) * D + k], b, h[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const float hv = h[i] + b1[f0 + lane];
      if (h_out != nullptr && row0 + r < n)
        h_out[static_cast<size_t>(row0 + r) * f + f0 + lane] = hv;
      float g = gelu_exact(hv);
      if (threshold) {
        g = positional_keep(seed, 0u, row0 + r, f0 + lane, threshold)
                ? g * inv_keep
                : 0.0f;
      }
      g_s[r * L::ldg + lane] = g;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Chunk * (D / 4); i += kThreads) {
      const int k = i / (D / 4), c4 = i % (D / 4);
      *reinterpret_cast<float4*>(w_s + k * D + c4 * 4) =
          *reinterpret_cast<const float4*>(
              w2 + static_cast<size_t>(f0 + k) * D + c4 * 4);
    }
    __syncthreads();
    for (int k = 0; k < kF32Chunk; ++k) {
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = g_s[(warp * RPW + i) * L::ldg + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float b = w_s[k * D + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPW; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int grow = row0 + warp * RPW + i;
    if (grow >= n) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      const size_t o = static_cast<size_t>(grow) * D + col;
      out[o] = epilogue<LN>(acc[i][j] + b2[col], LN ? x[o] : 0.0f, grow, col,
                            seed, threshold, inv_keep);
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int n, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n + kBM - 1) / kBM;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bf16. gamma/beta are read only when LN.
template <int D, bool LN>
cudaError_t dispatch(int dtype, const void* x, const float* gamma,
                     const float* beta, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* out, void* h_out,
                     int n, int f, float eps, uint32_t seed, int threshold,
                     float inv_keep, cudaStream_t stream) {
  if (dtype == 1) {
    return launch(mlp_fwd_bf16<D, LN>, Bf16Smem<D>::bytes, n, stream,
                  static_cast<const bf16*>(x), gamma, beta,
                  static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                  static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                  static_cast<bf16*>(out), static_cast<bf16*>(h_out), n, f,
                  eps, seed, threshold, inv_keep);
  }
  return launch(mlp_fwd_f32<D, LN>, F32Smem<D>::bytes, n, stream,
                static_cast<const float*>(x), gamma, beta,
                static_cast<const float*>(w1), static_cast<const float*>(b1),
                static_cast<const float*>(w2), static_cast<const float*>(b2),
                static_cast<float*>(out), static_cast<float*>(h_out), n, f,
                eps, seed, threshold, inv_keep);
}

// Argument checks shared by both entry points: the dtype code, a positive
// n, and f a multiple of the dtype's hidden chunk.
inline bool valid_shape(int dtype, int n, int f) {
  return (dtype == 0 || dtype == 1) && n > 0 && f > 0 &&
         f % (dtype == 1 ? kBF16Chunk : kF32Chunk) == 0;
}

// Runs dispatch<D, LN> for D in {384, 768}; cudaErrorInvalidValue else.
template <bool LN>
cudaError_t run(int dtype, const void* x, const float* gamma,
                const float* beta, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, void* h, int n,
                int d, int f, float eps, uint32_t seed, int threshold,
                float inv_keep, cudaStream_t s) {
  if (!valid_shape(dtype, n, f)) return cudaErrorInvalidValue;
  switch (d) {
    case 384:
      return dispatch<384, LN>(dtype, x, gamma, beta, w1, b1, w2, b2, out, h,
                               n, f, eps, seed, threshold, inv_keep, s);
    case 768:
      return dispatch<768, LN>(dtype, x, gamma, beta, w1, b1, w2, b2, out, h,
                               n, f, eps, seed, threshold, inv_keep, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mlp_fwd
}  // namespace vit
