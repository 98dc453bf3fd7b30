// Shared device helpers for the port's hand-written Hopper kernels.
//
// positional_keep() is the CUDA form of ops/dropout.py::positional_keep_u8:
// the keep bit of an element is a pure hash of (seed, tag, row, col) in
// native uint32 arithmetic (wrapping multiplies), so every kernel and the
// plain PyTorch versions regenerate the identical mask. erf_as() and
// gelu_exact() are the fused MLP's GELU in the form the Pallas kernels
// evaluate (ops/fused_mlp.py::_erf, _gelu_exact); the backward evaluates
// it with its derivative (_gelu_grad) in mlp_bwd.cuh::hidden_grad.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vit {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t avalanche_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool positional_keep(uint32_t seed, uint32_t tag,
                                                uint32_t row, uint32_t col,
                                                int threshold) {
  uint32_t x = seed + row * 0x9E3779B1u + col * 0x85EBCA77u +
               (1u + tag) * 0xC2B2AE3Du;
  return static_cast<int>(avalanche_u32(x) & 0xFFu) >= threshold;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float erf_as(float x) {
  // Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7).
  float a = fabsf(x);
  float t = 1.0f / (1.0f + 0.3275911f * a);
  float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  float y = 1.0f - poly * expf(-a * a);
  return x < 0.0f ? -y : y;
}

__device__ __forceinline__ float gelu_exact(float h) {
  return h * 0.5f * (1.0f + erf_as(h * 0.70710678118654752f));
}

// An attention mask as ops/flash_attention.py::normalize_mask folds it
// ([G, Tq or 1, Tk], 1 = attend), packed by the wrapper into bits: query
// row r's keys are words = ceil(Tk / 64) little-endian 64-bit words, key c
// at bit c % 64 of word c / 64, keys past Tk 0. Folded head b*h reads group
// b*h (mode 0, "full"), b*h / H (1, "batch"), b*h % H (2, "head") or 0 (3,
// "one"); every query reads row 0 when q_bcast. A key tile of 64 is one
// word a row: the kernels load a word where they would load 64 bytes (a
// row of Tk = 197 bytes has no 16-byte pitch for TMA either). bits is null
// for mask=None, whose kernels are instantiated without the mask code.
struct FlashMask {
  const uint64_t* bits;
  int mode, heads, q_bcast;

  __device__ __forceinline__ int words(int kv_len) const {
    return (kv_len + 63) / 64;
  }
  // Head bh's rows: query row r's words start at r * stride().
  __device__ __forceinline__ const uint64_t* head(int bh, int q_len,
                                                  int kv_len) const {
    const int g = mode == 0   ? bh
                  : mode == 1 ? bh / heads
                  : mode == 2 ? bh % heads
                              : 0;
    return bits + static_cast<size_t>(g) * (q_bcast ? 1 : q_len) *
                      words(kv_len);
  }
  __device__ __forceinline__ int stride(int kv_len) const {
    return q_bcast ? 0 : words(kv_len);
  }
  // Query row `row`'s words in head bh (row < q_len).
  __device__ __forceinline__ const uint64_t* row_of(int bh, int row,
                                                    int q_len,
                                                    int kv_len) const {
    return head(bh, q_len, kv_len) + static_cast<size_t>(row) * stride(kv_len);
  }
};

__device__ __forceinline__ bool word_bit(uint64_t w, int b) {
  return (w >> b) & 1ull;
}

// The key bits a thread of a wgmma accumulator holds in a 64-key tile
// word: element i (row half (i / 2) % 2) is key 8 (i / 4) + 2 tq + i % 2,
// so with the word shifted right by 2 tq, element i's bit is bit
// 8 (i / 4 % 4) + i % 2 of the low (i < 16) or high half: a constant
// mask once the element loop is unrolled, one instruction a test.
struct TileBits {
  uint32_t lo, hi;
};

__device__ __forceinline__ TileBits tile_bits_of(uint64_t w, int tq) {
  w >>= 2 * tq;
  return {static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32)};
}

__device__ __forceinline__ bool tile_bit(const TileBits& t, int i) {
  const uint32_t half = i < 16 ? t.lo : t.hi;
  return (half & (1u << (8 * ((i / 4) % 4) + i % 2))) != 0u;
}

// Whether the row whose words start at `row` attends to key col.
__device__ __forceinline__ bool mask_bit(const uint64_t* row, int col) {
  return word_bit(__ldg(row + (col >> 6)), col & 63);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

}  // namespace vit
