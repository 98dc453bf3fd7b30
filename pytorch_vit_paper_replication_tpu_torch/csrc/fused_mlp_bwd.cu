// Backward of the encoder-block MLP half
//     out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))
// -> dx, dgamma, dbeta, dW1, db1, dW2, db2.
//
// Replaces the JAX package's Pallas kernel
// ops/fused_mlp.py::_lnmlp_bwd_kernel (pallas_call in _lnmlp_bwd).
//
// What bounds it on an H100: four GEMMs of 2*N*D*F FLOP each (dg, dy, dW1,
// dW2), i.e. compute-bound at ViT-B/16 shapes (N = B*197, D = 768,
// F = 3072): 0.120 ms at 989 TFLOP/s. The passes are mlp_bwd.cuh's with
// LN = true: in bf16 every product runs on wgmma with TMA operands (one
// GEMM kernel, mlp_common.cuh's wg::gemm_bf16: two consumer warpgroups, a
// 4-stage mbarrier ring), in f32 on SIMT FMA.
#include "mlp_bwd.cuh"

using namespace vit::mlp_bwd;

// Plain C entry points (loaded with ctypes). dtype: 0 = float32, 1 = bf16.

// Bytes of workspace vit_lnmlp_bwd needs for these shapes (-1: shapes it
// does not take).
extern "C" long long vit_lnmlp_bwd_workspace(int dtype, int n, int d, int f) {
  return workspace_bytes<true>(dtype, n, d, f);
}

// x, dout, dx [n, d], h [n, f], w1 [d, f], w2 [f, d] in that dtype (16-byte
// aligned; bf16 is read through TMA); gamma, beta float32; LN over the
// first d_ln <= d columns (the true D of the zero-padded operands); workspace
// of workspace_bytes >= vit_lnmlp_bwd_workspace(...). The seven gradients
// leave in float32: dgamma, dbeta, db2 [d], db1 [f], dw1 [d, f],
// dw2 [f, d]. Launches every pass on `stream`; returns the first
// cudaError_t that is not 0, else 0.
extern "C" int vit_lnmlp_bwd(int dtype, const void* x, const void* h,
                             const float* gamma, const float* beta,
                             const void* w1, const void* w2, const void* dout,
                             void* dx, float* dgamma, float* dbeta, float* dw1,
                             float* db1, float* dw2, float* db2,
                             void* workspace, long long workspace_bytes, int n,
                             int d, int f, int d_ln, float eps, uint32_t seed,
                             int threshold, float inv_keep, void* stream) {
  return static_cast<int>(backward<true>(
      dtype, x, h, gamma, beta, w1, w2, dout, dx, dgamma, dbeta, dw1, db1,
      dw2, db2, workspace, workspace_bytes, n, d, f, d_ln, eps, seed, threshold,
      inv_keep,
      static_cast<cudaStream_t>(stream)));
}

// The bf16 GEMM kernel of the passes on its own, for its tests: c [m, n]
// float32 = a b with form 0 ("nt": a [m, k], b [n, k], both read K-major,
// c = a b^T) or form 1 ("tn": a [k, m], b [k, n], both read MN-major,
// c = a^T b). splits > 1 (form 1) cuts the reduction into that many
// ranges, their partials in workspace [splits, m, n] float32, summed in
// order into c. Returns the cudaError_t of the launches.
extern "C" int vit_gemm_bf16(int form, const void* a, const void* b,
                             float* c, int m, int n, int k, int splits,
                             float* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 || (form == 0 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  vit::mlp::EpiArgs<vit::bf16> e{};
  e.c32 = splits > 1 ? workspace : c;
  cudaError_t err =
      form == 0
          ? wg::gemm<kStoreF32, false, false>(a, k, m, b, k, n, e, m, n, k,
                                              1, s)
          : wg::gemm<kStoreF32, true, true>(a, m, k, b, n, k, e, m, n, k,
                                            splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t count4 = static_cast<size_t>(m) * n / 4;
  wg::sum_splits<<<static_cast<unsigned>((count4 + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(workspace),
      reinterpret_cast<float4*>(c), splits, count4);
  return static_cast<int>(cudaGetLastError());
}
