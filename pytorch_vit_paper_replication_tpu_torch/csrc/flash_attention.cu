// Flash-attention forward (no mask): online softmax over K/V blocks.
//
// Replaces the JAX package's Pallas kernel
// ops/flash_attention.py::_fwd_kernel (pallas_call in _fwd), in its
// mask=None form, including positional attention dropout.
//
// What bounds it on an H100: at ViT-B/16 shapes (B*H = 384, Dh = 64) the
// work is 4*BH*T^2*Dh FLOP against reading q, k, v and writing out + lse
// once; at T = 197 the bytes bound it, at T = 577 the two are close. The
// flash design point is that the [T, T] logits never go to device memory.
//
// Design (a first, simple kernel; all math in f32 like the Pallas kernel,
// which upcasts q, k and v before both products):
//   * One CTA of 256 threads per (b*h, 64-row query block); it streams
//     64-key blocks of K (stored transposed) and V through shared memory.
//   * Thread (rg, cg) owns query rows 4*rg..4*rg+3, logit columns
//     4*cg..4*cg+3 and output columns cg*Dh/16..; the row max and row sum
//     reduce across the 16 threads of a row group with shuffles.
//   * Ragged T: keys past T get logit -1e30 (as the Pallas kv padding);
//     query rows past T compute on zero q and are not stored.
//   * Dropout: keep bit from the positional hash on (seed, b*h, row, col)
//     after the undropped normalizer is updated; out = acc / (l * keep).
//   * l == 0 guard as in the Pallas kernel; lse = m + log(l) per row in
//     f32 for the training slice's backward.
// Tensor cores are not used yet: both products are SIMT f32 FMA.
#include "vit_common.cuh"

using vit::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kLdp = kBK + 4;
constexpr float kNegInf = -1e30f;

template <int DH>
struct FlashSmem {
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + kBQ * DH * 4;
  static constexpr size_t v_off = k_off + DH * kBK * 4;
  static constexpr size_t p_off = v_off + kBK * DH * 4;
  static constexpr size_t bytes = p_off + kBQ * kLdp * 4;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int t_len, float scale, uint32_t seed,
              int threshold, float keep_prob) {
  using L = FlashSmem<DH>;
  constexpr int CW = DH / 16;  // output columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);   // [BQ][DH]
  float* kt_s = reinterpret_cast<float*>(smem + L::k_off);  // [DH][BK]
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);   // [BK][DH]
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);   // [BQ][kLdp]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(bh) * t_len * DH;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_s[i] = (q0 + r < t_len)
                 ? vit::to_f32(q[base + static_cast<size_t>(q0 + r) * DH + d])
                 : 0.0f;
  }

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < t_len; k0 += kBK) {
    __syncthreads();  // previous block done with kt_s / v_s / p_s
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i % kBK, d = i / kBK;
      kt_s[d * kBK + c] =
          (k0 + c < t_len)
              ? vit::to_f32(k[base + static_cast<size_t>(k0 + c) * DH + d])
              : 0.0f;
    }
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      v_s[i] = (k0 + c < t_len)
                   ? vit::to_f32(v[base + static_cast<size_t>(k0 + c) * DH + d])
                   : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < DH; ++d) {
      const float4 kb = *reinterpret_cast<const float4*>(kt_s + d * kBK + 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qa = q_s[(4 * rg + i) * DH + d];
        s[i][0] = fmaf(qa, kb.x, s[i][0]);
        s[i][1] = fmaf(qa, kb.y, s[i][1]);
        s[i][2] = fmaf(qa, kb.z, s[i][2]);
        s[i][3] = fmaf(qa, kb.w, s[i][3]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + 4 * cg + j < t_len) ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xFFFFFFFFu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      float p[4], rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rsum += p[j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xFFFFFFFFu, rsum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
      if (threshold) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!vit::positional_keep(seed, bh, row, k0 + 4 * cg + j, threshold))
            p[j] = 0.0f;
      }
      *reinterpret_cast<float4*>(p_s + (4 * rg + i) * kLdp + 4 * cg) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(4 * rg + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vb = v_s[j * DH + cg * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= t_len) continue;
    const float l_safe = (l[i] == 0.0f) ? 1.0f : l[i];
    const float denom = l_safe * keep_prob;
    const size_t o = base + static_cast<size_t>(row) * DH + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) out[o + c] = vit::from_f32<T>(acc[i][c] / denom);
    if (cg == 0) lse[static_cast<size_t>(bh) * t_len + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int t_len, float scale, uint32_t seed,
                   int threshold, float keep_prob, cudaStream_t stream) {
  const size_t smem = FlashSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + kBQ - 1) / kBQ, bh);
  flash_fwd<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, t_len, scale, seed,
      threshold, keep_prob);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v,
                        void* out, float* lse, int bh, int t_len, float scale,
                        uint32_t seed, int threshold, float keep_prob,
                        cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, bh, t_len, scale, seed,
                           threshold, keep_prob, s);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, bh, t_len, scale, seed,
                           threshold, keep_prob, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, bh, t_len, scale, seed,
                            threshold, keep_prob, s);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, bh, t_len, scale, seed,
                            threshold, keep_prob, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v, out: [bh, t, dh]
// contiguous in dtype (0 = float32, 1 = bf16); lse: [bh, t] float32.
// Returns the cudaError_t of the attribute call / launch (0 on success).
extern "C" int vit_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* out, float* lse, int bh,
                             int t_len, int dh, float scale, uint32_t seed,
                             int threshold, float keep_prob, void* stream) {
  if (bh <= 0 || bh > 65535 || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dispatch_dh<bf16>(dh, q, k, v, out, lse, bh,
                                              t_len, scale, seed, threshold,
                                              keep_prob, s));
  if (dtype == 0)
    return static_cast<int>(dispatch_dh<float>(dh, q, k, v, out, lse, bh,
                                               t_len, scale, seed, threshold,
                                               keep_prob, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
