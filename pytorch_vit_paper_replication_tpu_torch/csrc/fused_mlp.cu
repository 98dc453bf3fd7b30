// Encoder-block MLP half as one kernel:
//     out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))
//
// Replaces the JAX package's Pallas kernel
// ops/fused_mlp.py::_lnmlp_fwd_kernel (pallas_call in _lnmlp_call), in both
// its forms: save_h=False (serving) and save_h=True (training: h = y@W1 + b1
// is also written, rounded to the compute dtype, as the backward's residual;
// csrc/fused_mlp_bwd.cu reads it).
//
// What bounds it on an H100: at ViT-B/16 shapes (N = B*197 rows, D = 768,
// F = 3072) the two GEMMs, 4*N*D*F FLOP, against ~2*N*D*2 bytes of
// activations plus the weights: compute-bound. The passes are
// mlp_fwd.cuh's with LN = true (an LN row pass, then fc1 and fc2 on wgmma
// with TMA operands in bf16, SIMT in f32; the design is described there).
#include "mlp_fwd.cuh"

// Plain C entry points (loaded with ctypes). dtype: 0 = float32, 1 = bf16.

// Bytes of workspace vit_lnmlp_fwd needs for these shapes (-1: shapes it
// does not take: d and f must be multiples of 64).
extern "C" long long vit_lnmlp_fwd_workspace(int dtype, int n, int d, int f) {
  return vit::mlp_fwd::workspace_bytes<true>(dtype, n, d, f);
}

// x, w1, b1, w2, b2, out and h (null: not saved) in that dtype (16-byte
// aligned; bf16 is read through TMA); gamma, beta float32; LN over the
// first d_ln <= d columns (the wrapper zero-pads D and F to multiples of
// 64 and passes the true D here); workspace of
// workspace_bytes >= vit_lnmlp_fwd_workspace(...). Launches every pass on
// `stream`; returns the first cudaError_t that is not 0, else 0.
extern "C" int vit_lnmlp_fwd(int dtype, const void* x, const float* gamma,
                             const float* beta, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* h, void* workspace,
                             long long workspace_bytes, int n, int d, int f,
                             int d_ln, float eps, uint32_t seed,
                             int threshold, float inv_keep, void* stream) {
  return static_cast<int>(vit::mlp_fwd::run<true>(
      dtype, x, gamma, beta, w1, b1, w2, b2, out, h, workspace,
      workspace_bytes, n, d, f, d_ln, eps, seed, threshold, inv_keep,
      static_cast<cudaStream_t>(stream)));
}
