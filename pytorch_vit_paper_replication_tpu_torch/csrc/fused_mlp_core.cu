// The MLP core without LayerNorm and residual, forward and backward:
//     out = fc2(drop0(gelu(fc1(x))))          (D_out = D)
//
// Replaces the JAX package's Pallas kernels ops/fused_mlp.py::_fwd_kernel
// (pallas_call in _fused_call, with and without the saved h) and
// _bwd_kernel (pallas_call in _fused_bwd). The JAX package runs them for
// manual Megatron tensor parallelism: each rank's hidden slice (F / tp
// columns of fc1, rows of fc2) with the all-reduce of the fc2 partial sums
// outside the kernel, and for the standalone MLPBlock without residual.
// There is no output dropout here: under tensor parallelism it follows the
// all-reduce.
//
// What bounds it on an H100: forward 4*N*D*F FLOP, backward 8*N*D*F
// (dg, dx, dW1, dW2), compute-bound at ViT-B/16 shapes (N = B*197,
// D = 768, F = 3072 or its tensor-parallel slice 1536).
//
// The passes are those of rows 1 and 2 with LN and the residual switched
// off (mlp_fwd.cuh and mlp_bwd.cuh with LN = false): the forward is fc1
// with the GELU / keep-bit epilogue and fc2 with the bias epilogue; the
// backward is row 2's deterministic passes without the LN ones (dg with the
// hidden-gradient epilogue, dx = cast(dh_c W1^T), dW1 = x^T dh_c,
// dW2 = g_c^T dO, then the fixed-order column sums), with x and dO as the
// GEMM operands. bf16 runs every product on wgmma with TMA operands, f32
// on SIMT FMA.
#include "mlp_bwd.cuh"
#include "mlp_fwd.cuh"

// Bytes of workspace vit_mlp_fwd needs for these shapes (-1: shapes it
// does not take: d and f must be multiples of 64).
extern "C" long long vit_mlp_fwd_workspace(int dtype, int n, int d, int f) {
  return vit::mlp_fwd::workspace_bytes<false>(dtype, n, d, f);
}

// Forward. dtype: 0 = float32, 1 = bf16; x, w1, b1, w2, b2, out and h
// (null: not saved) in that dtype (16-byte aligned); workspace of
// workspace_bytes >= vit_mlp_fwd_workspace(...). Returns the first
// cudaError_t that is not 0, else 0.
extern "C" int vit_mlp_fwd(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, void* h, void* workspace,
                           long long workspace_bytes, int n, int d, int f,
                           uint32_t seed, int threshold, float inv_keep,
                           void* stream) {
  return static_cast<int>(vit::mlp_fwd::run<false>(
      dtype, x, nullptr, nullptr, w1, b1, w2, b2, out, h, workspace,
      workspace_bytes, n, d, f, d, 0.0f, seed, threshold, inv_keep,
      static_cast<cudaStream_t>(stream)));
}

// Bytes of workspace vit_mlp_bwd needs for these shapes (-1: shapes it
// does not take).
extern "C" long long vit_mlp_bwd_workspace(int dtype, int n, int d, int f) {
  return vit::mlp_bwd::workspace_bytes<false>(dtype, n, d, f);
}

// Backward. x, dout, dx [n, d], h [n, f], w1 [d, f], w2 [f, d] in the
// dtype (16-byte aligned; bf16 is read through TMA); workspace of
// workspace_bytes >= vit_mlp_bwd_workspace(...). dw1 [d, f], db1 [f],
// dw2 [f, d], db2 [d] leave in float32. Returns the first cudaError_t that
// is not 0, else 0.
extern "C" int vit_mlp_bwd(int dtype, const void* x, const void* h,
                           const void* w1, const void* w2, const void* dout,
                           void* dx, float* dw1, float* db1, float* dw2,
                           float* db2, void* workspace,
                           long long workspace_bytes, int n, int d, int f,
                           uint32_t seed, int threshold, float inv_keep,
                           void* stream) {
  using namespace vit::mlp_bwd;
  return static_cast<int>(backward<false>(
      dtype, x, h, nullptr, nullptr, w1, w2, dout, dx, nullptr, nullptr, dw1,
      db1, dw2, db2, workspace, workspace_bytes, n, d, f, d, 0.0f, seed,
      threshold, inv_keep,
      static_cast<cudaStream_t>(stream)));
}
