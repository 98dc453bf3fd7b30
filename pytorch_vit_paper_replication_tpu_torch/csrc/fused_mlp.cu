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
// The kernels are mlp_fwd.cuh's with LN = true (the design is described
// there).
#include "mlp_fwd.cuh"

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
  return static_cast<int>(vit::mlp_fwd::run<true>(
      dtype, x, gamma, beta, w1, b1, w2, b2, out, h, n, d, f, eps, seed,
      threshold, inv_keep, static_cast<cudaStream_t>(stream)));
}
