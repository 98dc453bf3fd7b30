// Encoder-block MLP half as one kernel:
//     out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))
//
// Replaces the JAX package's Pallas kernel
// ops/fused_mlp.py::_lnmlp_fwd_kernel (pallas_call in _lnmlp_call), in both
// its forms: save_h=False (serving) and save_h=True (training: h = y@W1 + b1
// is also written, rounded to the compute dtype, as the backward's residual;
// csrc/fused_mlp_bwd.cu reads it).
//
// What bounds it on an H100: at ViT-B/16 serving shapes (N = B*197 rows,
// D = 768, F = 3072) the two GEMMs are 4*N*D*F FLOP against ~2*N*D*2 bytes
// of activations plus the weights, i.e. compute-bound. The fused design
// point is that the [rows, F] hidden tile never goes to device memory.
//
// Design (a first, simple kernel; no TMA/wgmma yet):
//   * One CTA owns BM = 32 rows and the whole output width D. Blocks are
//     independent: nothing is carried between CTAs (the Pallas grid was
//     sequential, a CUDA grid is not).
//   * LayerNorm statistics in f32 (two-pass mean / centred variance, as the
//     Pallas _ln), y cast to the compute dtype into shared memory.
//   * F is walked in chunks: h = y @ W1[:, chunk] (f32 accumulation) -> +b1
//     -> A&S 7.1.26 erf GELU -> hidden dropout (tag 0) -> cast -> g_s; then
//     acc += g_s @ W2[chunk, :]. F = 3072 never fits shared memory as a
//     whole hidden row block, so only one chunk of h/g is ever resident and
//     the fc2 partial sums stay in registers across chunks.
//   * bf16: tensor cores through WMMA 16x16x16 (f32 accumulate).
//     f32: SIMT FMA (exact f32, no TF32 rounding).
//   * Epilogue: +b2, output dropout (tag 1), + x in f32, cast, store.
//   * Weight chunks are re-read from L2 by every CTA; a later version
//     should stream them with TMA into a multi-stage ring and use wgmma.
#include <mma.h>

#include "vit_common.cuh"

using namespace nvcuda;
using vit::bf16;

namespace {

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
        v[j] = vit::to_f32(xr[lane + 32 * j]);
        s += v[j];
      }
      const float mu = vit::warp_sum(s) / static_cast<float>(D);
      float s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float c = v[j] - mu;
        s2 += c * c;
      }
      const float var = vit::warp_sum(s2) / static_cast<float>(D);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const float y = (v[j] - mu) * rstd * gamma[col] + beta[col];
        y_s[r * ldy + col] = vit::from_f32<T>(y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        y_s[r * ldy + lane + 32 * j] = vit::from_f32<T>(0.0f);
    }
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    lnmlp_fwd_bf16(const bf16* __restrict__ x, const float* __restrict__ gamma,
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
  layernorm_rows<bf16, D>(x, gamma, beta, y_s, L::ldy, row0, n, eps);

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
      const float hv = h_s[r * L::ldh + c] + vit::to_f32(b1[f0 + c]);
      if (h_out != nullptr && row0 + r < n)
        h_out[static_cast<size_t>(row0 + r) * f + f0 + c] =
            vit::from_f32<bf16>(hv);
      float g = vit::gelu_exact(hv);
      if (threshold) {
        g = vit::positional_keep(seed, 0u, row0 + r, f0 + c, threshold)
                ? g * inv_keep
                : 0.0f;
      }
      g_s[r * L::ldg + c] = vit::from_f32<bf16>(g);
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
          float fv = st[e] + vit::to_f32(b2[col]);
          if (threshold) {
            fv = vit::positional_keep(seed, 1u, grow, col, threshold)
                     ? fv * inv_keep
                     : 0.0f;
          }
          const size_t o = static_cast<size_t>(grow) * D + col;
          out[o] = vit::from_f32<bf16>(vit::to_f32(x[o]) + fv);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    lnmlp_fwd_f32(const float* __restrict__ x, const float* __restrict__ gamma,
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
  layernorm_rows<float, D>(x, gamma, beta, y_s, D, row0, n, eps);

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
      float g = vit::gelu_exact(hv);
      if (threshold) {
        g = vit::positional_keep(seed, 0u, row0 + r, f0 + lane, threshold)
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
      float fv = acc[i][j] + b2[col];
      if (threshold) {
        fv = vit::positional_keep(seed, 1u, grow, col, threshold)
                 ? fv * inv_keep
                 : 0.0f;
      }
      const size_t o = static_cast<size_t>(grow) * D + col;
      out[o] = x[o] + fv;
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

template <int D>
cudaError_t dispatch(int dtype, const void* x, const float* gamma,
                     const float* beta, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* out, void* h_out,
                     int n, int f, float eps, uint32_t seed, int threshold,
                     float inv_keep, cudaStream_t stream) {
  if (dtype == 1) {
    return launch(lnmlp_fwd_bf16<D>, Bf16Smem<D>::bytes, n, stream,
                  static_cast<const bf16*>(x), gamma, beta,
                  static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                  static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                  static_cast<bf16*>(out), static_cast<bf16*>(h_out), n, f,
                  eps, seed, threshold, inv_keep);
  }
  return launch(lnmlp_fwd_f32<D>, F32Smem<D>::bytes, n, stream,
                static_cast<const float*>(x), gamma, beta,
                static_cast<const float*>(w1), static_cast<const float*>(b1),
                static_cast<const float*>(w2), static_cast<const float*>(b2),
                static_cast<float*>(out), static_cast<float*>(h_out), n, f,
                eps, seed, threshold, inv_keep);
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bf16.
// x, w1, b1, w2, b2, out and h (null: not saved) in that dtype; gamma, beta
// float32. Returns the cudaError_t of the attribute call / launch (0 on
// success).
extern "C" int vit_lnmlp_fwd(int dtype, const void* x, const float* gamma,
                             const float* beta, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* h, int n, int d, int f, float eps,
                             uint32_t seed, int threshold, float inv_keep,
                             void* stream) {
  if ((dtype != 0 && dtype != 1) || n <= 0 || f <= 0 ||
      f % (dtype == 1 ? kBF16Chunk : kF32Chunk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 384:
      return static_cast<int>(dispatch<384>(dtype, x, gamma, beta, w1, b1, w2,
                                            b2, out, h, n, f, eps, seed,
                                            threshold, inv_keep, s));
    case 768:
      return static_cast<int>(dispatch<768>(dtype, x, gamma, beta, w1, b1, w2,
                                            b2, out, h, n, f, eps, seed,
                                            threshold, inv_keep, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
