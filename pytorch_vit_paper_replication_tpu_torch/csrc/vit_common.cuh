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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

}  // namespace vit
