// Backward of the encoder-block MLP half
//     out = x + drop1(fc2(drop0(gelu(fc1(LN(x))))))
// -> dx, dgamma, dbeta, dW1, db1, dW2, db2.
//
// Replaces the JAX package's Pallas kernel
// ops/fused_mlp.py::_lnmlp_bwd_kernel (pallas_call in _lnmlp_bwd).
//
// What bounds it on an H100: four GEMMs of 2*N*D*F FLOP each (dg, dy, dW1,
// dW2), i.e. compute-bound at ViT-B/16 shapes (N = B*197, D = 768,
// F = 3072); the bytes are x, h, dO in and dx out plus the [N, F] dh/g
// tensors this design writes and re-reads once. The kernels are
// mlp_bwd.cuh's with LN = true (the three deterministic passes are
// described there).
#include "mlp_bwd.cuh"

using namespace vit::mlp_bwd;

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bf16.
// x, dout, dx [n, d], h [n, f], w1 [d, f], w2 [f, d] in that dtype; gamma,
// beta float32. work: 2*n*d + 2*n*f elements of the dtype (y_c, df_c, g_c,
// dh_c); partials: ceil(n/32) * (3*d + f) floats. The seven gradients leave
// in float32: dgamma, dbeta, db2 [d], db1 [f], dw1 [d, f], dw2 [f, d].
// Launches the row kernel, the two weight GEMMs and the four column sums
// on `stream`; returns the first cudaError_t that is not 0, else 0.
extern "C" int vit_lnmlp_bwd(int dtype, const void* x, const void* h,
                             const float* gamma, const float* beta,
                             const void* w1, const void* w2, const void* dout,
                             void* dx, float* dgamma, float* dbeta, float* dw1,
                             float* db1, float* dw2, float* db2, void* work,
                             float* partials, int n, int d, int f, float eps,
                             uint32_t seed, int threshold, float inv_keep,
                             void* stream) {
  if (!valid_shape(dtype, n, d, f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = row_tiles(n);
  const size_t es = dtype == 1 ? 2 : 4;
  unsigned char* wb = static_cast<unsigned char*>(work);
  const size_t nd = static_cast<size_t>(n) * d, nf = static_cast<size_t>(n) * f;
  Scratch sc;
  sc.y_c = wb;
  sc.df_c = wb + nd * es;
  sc.g_c = wb + 2 * nd * es;
  sc.dh_c = wb + (2 * nd + nf) * es;
  sc.p_dgamma = partials;
  sc.p_dbeta = partials + static_cast<size_t>(tiles) * d;
  sc.p_db2 = partials + 2 * static_cast<size_t>(tiles) * d;
  sc.p_db1 = partials + 3 * static_cast<size_t>(tiles) * d;
  cudaError_t err = rows<true>(dtype, d, x, h, gamma, beta, w1, w2, dout, dx,
                               sc, n, f, eps, seed, threshold, inv_keep,
                               tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = gemm_tn(dtype, sc.y_c, sc.dh_c, dw1, n, d, f, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = gemm_tn(dtype, sc.g_c, sc.df_c, dw2, n, f, d, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = reduce(sc.p_dgamma, dgamma, tiles, d, s)) != cudaSuccess ||
      (err = reduce(sc.p_dbeta, dbeta, tiles, d, s)) != cudaSuccess ||
      (err = reduce(sc.p_db2, db2, tiles, d, s)) != cudaSuccess ||
      (err = reduce(sc.p_db1, db1, tiles, f, s)) != cudaSuccess)
    return static_cast<int>(err);
  return 0;
}
