// The exact scan's scores: out[m, n] = sum_k q[m, k] * db[n, k], float32.
//
// Counterpart of the JAX package's search/scan.py local program
// ``(q @ db.T).astype(f32)`` (no Pallas kernel there: XLA's dot). The scan
// keeps a contract that a library GEMM does not: a row's scores do not
// depend on how many queries ride with it. cuBLAS picks its kernel, and so
// its summation order, by M, so a query scanned alone (M = 1) and the same
// query padded into a batch of 8 could differ in the last bit, and a tie at
// the k-th place could then fall the other way. Here every element is one
// accumulator that starts at 0.0f and takes fmaf(db[n][k], q[m][k], acc)
// for k = 0, 1, ..., K-1 in that order, whatever M, N, the tile, or the
// element's place in the tile: the same bits at every M. Plain FMA in the
// SIMT units also keeps TF32 out of it, whatever the process's matmul
// setting.
//
// What bounds it on an H100: 2*M*N*K FLOP against 4*(M + N)*K + 4*M*N
// bytes; at M = 1 the N x K matrix read (bytes), at M = 64 over
// 768-wide rows the FMAs (the 67 TF/s float32 rate).
//
// Layout: a CTA of 256 threads computes a BN = 128 (rows) x BQ (queries)
// tile, staging BK = 32 columns of both operands in shared memory at a
// time (rows transposed, so a warp reads 16 or 32 consecutive rows of one
// column without bank conflicts); each thread holds TN x TQ accumulators.
// BQ = 8 (TQ = 1) serves M <= 8, where the matrix read is all the work;
// BQ = 64 (TQ = 4) serves larger M.
#include <cuda_runtime.h>
#include <stdint.h>

// A named namespace (not an anonymous one) so profiler traces name the
// kernel.
namespace vit {
namespace scan {

constexpr int kThreads = 256;
constexpr int BN = 128;
constexpr int BK = 32;

template <int BQ, int TQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
scan_scores_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   float* __restrict__ out, int m, int n, int k) {
  constexpr int QT = BQ / TQ;          // threads along the queries
  constexpr int NT = kThreads / QT;    // threads along the rows
  constexpr int TN = BN / NT;          // rows per thread
  __shared__ float db_s[BK][BN + 1];
  __shared__ float q_s[BK][BQ + 1];

  const int t = threadIdx.x;
  const int tn = t % NT;
  const int tq = t / NT;
  const long long row0 = static_cast<long long>(blockIdx.x) * BN;
  const int q0 = blockIdx.y * BQ;

  float acc[TN][TQ];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < TQ; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Stage rows [row0, row0 + BN) x columns [k0, k0 + BK): zeros past the
    // matrix (fmaf(0, 0, acc) leaves acc's value).
    if (VEC) {
      // 8 threads a row, 16 bytes each: one 128-byte line per row.
#pragma unroll
      for (int it = 0; it < BN * BK / 4 / kThreads; ++it) {
        const int idx = t + it * kThreads;
        const int r = idx / (BK / 4);
        const int c = (idx % (BK / 4)) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row0 + r < n && k0 + c < k)
          v = *reinterpret_cast<const float4*>(db + (row0 + r) * k + k0 + c);
        db_s[c][r] = v.x;
        db_s[c + 1][r] = v.y;
        db_s[c + 2][r] = v.z;
        db_s[c + 3][r] = v.w;
      }
      for (int idx = t; idx < BQ * BK / 4; idx += kThreads) {
        const int r = idx / (BK / 4);
        const int c = (idx % (BK / 4)) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q0 + r < m && k0 + c < k)
          v = *reinterpret_cast<const float4*>(
              q + static_cast<long long>(q0 + r) * k + k0 + c);
        q_s[c][r] = v.x;
        q_s[c + 1][r] = v.y;
        q_s[c + 2][r] = v.z;
        q_s[c + 3][r] = v.w;
      }
    } else {
      for (int idx = t; idx < BN * BK; idx += kThreads) {
        const int r = idx / BK;
        const int c = idx % BK;
        db_s[c][r] = (row0 + r < n && k0 + c < k)
                         ? db[(row0 + r) * k + k0 + c] : 0.0f;
      }
      for (int idx = t; idx < BQ * BK; idx += kThreads) {
        const int r = idx / BK;
        const int c = idx % BK;
        q_s[c][r] = (q0 + r < m && k0 + c < k)
                        ? q[static_cast<long long>(q0 + r) * k + k0 + c]
                        : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TN], b[TQ];
#pragma unroll
      for (int i = 0; i < TN; ++i) a[i] = db_s[kk][tn + i * NT];
#pragma unroll
      for (int j = 0; j < TQ; ++j) b[j] = q_s[kk][tq + j * QT];
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TQ; ++j) {
    const int qi = q0 + tq + j * QT;
    if (qi >= m) continue;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const long long r = row0 + tn + i * NT;
      if (r < n) out[static_cast<long long>(qi) * n + r] = acc[i][j];
    }
  }
}

template <int BQ, int TQ>
cudaError_t launch(const float* q, const float* db, float* out, int m, int n,
                   int k, bool vec, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BQ - 1) / BQ);
  if (vec)
    scan_scores_kernel<BQ, TQ, true><<<grid, kThreads, 0, stream>>>(
        q, db, out, m, n, k);
  else
    scan_scores_kernel<BQ, TQ, false><<<grid, kThreads, 0, stream>>>(
        q, db, out, m, n, k);
  return cudaGetLastError();
}

}  // namespace scan
}  // namespace vit

// q [m, k], db [n, k], out [m, n], all float32, row-major and contiguous.
// Rows are read 16 bytes at a time when k is a multiple of 4 and q and db
// are 16-byte aligned, one float at a time otherwise (the same sums).
// Returns the launch's cudaError_t (0 when it was accepted).
extern "C" int vit_scan_scores(const float* q, const float* db, float* out,
                               int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (k % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(db) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = m <= 8
                        ? vit::scan::launch<8, 1>(q, db, out, m, n, k, vec, s)
                        : vit::scan::launch<64, 4>(q, db, out, m, n, k, vec,
                                                   s);
  return static_cast<int>(err);
}
