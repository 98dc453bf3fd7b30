// Flash-attention backward: the dq kernel and the dk/dv kernel.
//
// Replace the JAX package's Pallas kernels
// ops/flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel (the two
// pallas_calls in _flash_bwd): q and dO of q_len rows, k and v of kv_len
// rows, positional attention dropout and the attention mask in every form
// _normalize_mask folds (vit_common.cuh's FlashMask), for head dims 32, 64,
// 128 and 256 (the wrapper pads any other Dh up to the next of these).
//
// The mask is a template flag of every kernel (mask=None keeps its code
// and times): P is zeroed where the mask does not attend, as the Pallas
// kernels zero p there, so a query row that attends to no key (lse =
// -1e30 from the forward) gets dS = 0: zero dq, and nothing in dk or dv.
// The mask comes packed into bits (vit_common.cuh's FlashMask): a 64-key
// tile is one word a query row, loaded before the logit product completes
// (only P reads it).
//
// Both recompute P = exp(q.k * scale - lse) from the forward's row
// logsumexp; delta = rowsum(dO * O) is computed in f32 by the caller, as the
// JAX wrapper does. With dropout the keep bit of (seed, b*h, row, col) is
// the forward's: it enters through dP (dS = P * (M/keep * dP - delta) *
// scale) and, for dV, through P.
//
// What bounds them on an H100: at ViT-B/16 shapes (B*H = 384, Dh = 64,
// T = 197) 8*BH*T^2*Dh FLOP (dq: 2 products, dk/dv: 3, plus the recomputed
// logits in each) against reading q, k, v, dO once and writing dq, dk, dv:
// the bytes bound them at T = 197, the operations at T = 577.
//
// The Pallas grids are (bh, q-blocks) for dq and (bh, k-blocks) for dk/dv
// with an in-kernel loop over the other axis; nothing is carried between
// programs, so each maps to a CUDA grid directly: one CTA per (b*h, row
// block), no atomics, a fixed loop order: deterministic. The ragged edge:
// keys past kv_len give P = 0 in the dq kernel, queries past q_len give
// P = 0 in the dk/dv kernel, padded rows load as zeros and are never stored.
//
// bf16 — the Hopper designs (csrc/hopper.cuh): TMA tile loads of [64, Dh]
// tiles (3-D maps (Dh, T, B*H), rows past T load as zeros) on full/empty
// mbarrier rings fed by one producer warp, products on wgmma with f32
// accumulators in registers, two consumer warpgroups per CTA:
//
// * Dh <= 128, flash_bwd_dkv_wg2 / flash_bwd_dq_wg2. A CTA owns 128 rows
//   (keys for dk/dv, queries for dq): each warpgroup 64 of them, resident
//   (K and V, or Q and dO with their lse and delta), with its own f32
//   accumulators. The producer streams the other side's tiles of 64 rows
//   (q, dO, lse, delta for dk/dv; K, V for dq) through a 2-stage ring that
//   both warpgroups consume, so a streamed tile feeds twice the products
//   it fed with one warpgroup. Per streamed tile a warpgroup computes the
//   logits and dP (S^T = K Q^T and dP^T = V dO^T, or S = Q K^T and
//   dP = dO V^T, both operands K-major from shared memory), P, the keep
//   bit and dS elementwise in the accumulator layout, then its output
//   products with P_drop / dS from registers rounded to bf16 (dV +=
//   P_drop^T dO and dK += dS^T Q, or dQ += dS K; the B operands MN-major).
//   The two warpgroups take turns issuing their logit products (named
//   barriers 1 and 2, ping-pong): one issues while the other runs its
//   elementwise phase, so the tensor cores work under the exp, hash and
//   dS arithmetic. A last streamed tile with at most 16 rows below T runs a
//   narrow step (64 x 16 logits, one k-step of output products).
// * Dh = 256, flash_bwd_dkv_split / flash_bwd_dq_split. One 64 x 256 f32
//   accumulator is 128 registers a thread, so one warpgroup cannot hold two
//   (dK and dV, or dQ with S and dP): the CTA owns 64 rows and the two
//   warpgroups split the work. dk/dv: warpgroup 0 computes S^T and P,
//   hands P (f32) to warpgroup 1 through shared memory and owns dV;
//   warpgroup 1 computes dP^T, then dS^T from the P it was handed, and owns
//   dK. dq: warpgroup 0 computes S and P, warpgroup 1 dP and dS, handed
//   back as bf16 A fragments; each owns 128 of dQ's 256 columns. The
//   hand-offs are named barriers between the two warpgroups; the
//   exchanged values are the same f32 P and bf16 dS one warpgroup would
//   compute, so the results equal the one-warpgroup design's.
//
// dS (and P for dV) is rounded to bf16 before its product, where the Pallas
// kernels multiply upcast f32 operands; tests/test_torch_flash_rounding.py
// holds that rounding to the plain version's bound.
//
// dq and dk/dv, f32 — SIMT kernels: all math in f32 like the Pallas kernels
// (which upcast q, k, v and dO); 256 threads per block of BR rows (64, or
// 32 at Dh = 256 so six [BR, Dh] f32 tiles fit shared memory); thread
// (rg, cg) owns BR/16 rows x BR/16 columns of each BR x BR logit block and
// BR/16 rows x Dh/16 columns of the output; operands are staged in shared
// memory as f32, both transposed (for the logit products) and row-major
// (for the output products). f32 keeps them: TF32 would break the f32
// bounds.
#include "hopper.cuh"
#include "vit_common.cuh"

using vit::bf16;

namespace {

// ------------------------------------------------------------ f32 SIMT
constexpr int kThreads = 256;

// Rows of a q block and of a k block of the SIMT kernels.
template <int DH>
constexpr int simt_rows() {
  return DH > 128 ? 32 : 64;
}

template <int DH, int BR>
struct DqSmem {
  static constexpr size_t q_off = 0;                    // [BR][DH]
  static constexpr size_t do_off = q_off + BR * DH * 4;  // [BR][DH]
  static constexpr size_t kt_off = do_off + BR * DH * 4; // [DH][BR]
  static constexpr size_t vt_off = kt_off + DH * BR * 4; // [DH][BR]
  static constexpr size_t k_off = vt_off + DH * BR * 4;  // [BR][DH]
  static constexpr size_t ds_off = k_off + BR * DH * 4;  // [BR][BR + 4]
  static constexpr size_t bytes = ds_off + BR * (BR + 4) * 4;
};

template <int DH, int BR>
struct DkvSmem {
  static constexpr size_t k_off = 0;                     // [BR][DH]
  static constexpr size_t v_off = k_off + BR * DH * 4;    // [BR][DH]
  static constexpr size_t qt_off = v_off + BR * DH * 4;   // [DH][BR]
  static constexpr size_t dot_off = qt_off + DH * BR * 4; // [DH][BR]
  static constexpr size_t q_off = dot_off + DH * BR * 4;  // [BR][DH]
  static constexpr size_t do_off = q_off + BR * DH * 4;   // [BR][DH]
  static constexpr size_t p_off = do_off + BR * DH * 4;   // [BR][BR + 4]
  static constexpr size_t ds_off = p_off + BR * (BR + 4) * 4;
  static constexpr size_t bytes = ds_off + BR * (BR + 4) * 4;
};

// rows r0.. of src [t_len, DH] -> dst as [BR][DH] f32 (zero past t_len).
template <int DH, int BR>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* dst, int r0, int t_len) {
  for (int i = threadIdx.x; i < BR * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[i] = (r0 + r < t_len) ? src[static_cast<size_t>(r0 + r) * DH + d]
                              : 0.0f;
  }
}

// rows r0.. of src [t_len, DH] -> dst transposed as [DH][BR] f32.
template <int DH, int BR>
__device__ __forceinline__ void load_rows_t(const float* __restrict__ src,
                                            float* dst, int r0, int t_len) {
  for (int i = threadIdx.x; i < BR * DH; i += kThreads) {
    const int c = i % BR, d = i / BR;
    dst[d * BR + c] =
        (r0 + c < t_len) ? src[static_cast<size_t>(r0 + c) * DH + d] : 0.0f;
  }
}

// s[i][j] += a[R rg + i, :] . bt[:, R cg + j] over DH (a row-major, bt
// transposed, R = BR / 16), for two operand pairs at once.
template <int DH, int BR>
__device__ __forceinline__ void block_dots(const float* a0, const float* b0t,
                                           const float* a1, const float* b1t,
                                           int rg, int cg,
                                           float (&s0)[BR / 16][BR / 16],
                                           float (&s1)[BR / 16][BR / 16]) {
  constexpr int R = BR / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s0[i][j] = s1[i][j] = 0.0f;
  for (int d = 0; d < DH; ++d) {
    float b0[R], b1[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      b0[j] = b0t[d * BR + R * cg + j];
      b1[j] = b1t[d * BR + R * cg + j];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float x0 = a0[(R * rg + i) * DH + d];
      const float x1 = a1[(R * rg + i) * DH + d];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s0[i][j] = fmaf(x0, b0[j], s0[i][j]);
        s1[i][j] = fmaf(x1, b1[j], s1[i][j]);
      }
    }
  }
}

template <int DH, int BR, bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_simt(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      vit::FlashMask mask, int q_len, int kv_len, float scale,
                      uint32_t seed, int threshold, float inv_keep) {
  using L = DqSmem<DH, BR>;
  constexpr int R = BR / 16, CW = DH / 16, LDP = BR + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* do_s = reinterpret_cast<float*>(smem + L::do_off);
  float* kt_s = reinterpret_cast<float*>(smem + L::kt_off);
  float* vt_s = reinterpret_cast<float*>(smem + L::vt_off);
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const size_t qbase = static_cast<size_t>(bh) * q_len * DH;
  const size_t kbase = static_cast<size_t>(bh) * kv_len * DH;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  load_rows<DH, BR>(q + qbase, q_s, q0, q_len);
  load_rows<DH, BR>(dout + qbase, do_s, q0, q_len);
  float lse_r[R], dl_r[R], acc[R][CW];
  // The mask rows of the thread's R rows (rows past q_len, never stored,
  // read row q_len - 1).
  const uint64_t* mrow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * rg + i;
    const bool in = row < q_len;
    lse_r[i] = in ? lse[static_cast<size_t>(bh) * q_len + row] : 0.0f;
    dl_r[i] = in ? delta[static_cast<size_t>(bh) * q_len + row] : 0.0f;
    if constexpr (MASK)
      mrow[i] = mask.row_of(bh, min(row, q_len - 1), q_len, kv_len);
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += BR) {
    __syncthreads();  // previous block done with kt_s / vt_s / k_s / ds_s
    load_rows_t<DH, BR>(k + kbase, kt_s, k0, kv_len);
    load_rows_t<DH, BR>(v + kbase, vt_s, k0, kv_len);
    load_rows<DH, BR>(k + kbase, k_s, k0, kv_len);
    __syncthreads();
    float s[R][R], dp[R][R];
    block_dots<DH, BR>(q_s, kt_s, do_s, vt_s, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + R * rg + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + R * cg + j;
        const bool a = MASK ? vit::mask_bit(mrow[i], col) : col < kv_len;
        const float p = a ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        float dpv = dp[i][j];
        if (threshold)
          dpv = vit::positional_keep(seed, bh, row, col, threshold)
                    ? dpv * inv_keep
                    : 0.0f;
        ds_s[(R * rg + i) * LDP + R * cg + j] = p * (dpv - dl_r[i]) * scale;
      }
    }
    __syncthreads();
    for (int j = 0; j < BR; ++j) {
      float a[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = ds_s[(R * rg + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float kb = k_s[j * DH + cg * CW + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(a[i], kb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * rg + i;
    if (row >= q_len) continue;
    const size_t o = qbase + static_cast<size_t>(row) * DH + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) dq[o + c] = acc[i][c];
  }
}

template <int DH, int BR, bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_simt(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       vit::FlashMask mask, int q_len, int kv_len,
                       float scale, uint32_t seed, int threshold,
                       float inv_keep) {
  using L = DkvSmem<DH, BR>;
  constexpr int R = BR / 16, CW = DH / 16, LDP = BR + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);
  float* qt_s = reinterpret_cast<float*>(smem + L::qt_off);
  float* dot_s = reinterpret_cast<float*>(smem + L::dot_off);
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* do_s = reinterpret_cast<float*>(smem + L::do_off);
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds_off);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BR;
  const size_t qbase = static_cast<size_t>(bh) * q_len * DH;
  const size_t kbase = static_cast<size_t>(bh) * kv_len * DH;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;  // rg: keys
  // The head's mask rows, query row r's words at r * mstride.
  const uint64_t* mh = nullptr;
  const int mstride = mask.stride(kv_len);
  if constexpr (MASK) mh = mask.head(bh, q_len, kv_len);
  load_rows<DH, BR>(k + kbase, k_s, k0, kv_len);
  load_rows<DH, BR>(v + kbase, v_s, k0, kv_len);
  float dk_acc[R][CW], dv_acc[R][CW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int q0 = 0; q0 < q_len; q0 += BR) {
    __syncthreads();  // previous block done with the q-side tiles
    load_rows_t<DH, BR>(q + qbase, qt_s, q0, q_len);
    load_rows_t<DH, BR>(dout + qbase, dot_s, q0, q_len);
    load_rows<DH, BR>(q + qbase, q_s, q0, q_len);
    load_rows<DH, BR>(dout + qbase, do_s, q0, q_len);
    __syncthreads();
    // st[i][j] = k_i . q_j, dpt[i][j] = v_i . dO_j (i: key, j: query)
    float st[R][R], dpt[R][R];
    block_dots<DH, BR>(k_s, qt_s, v_s, dot_s, rg, cg, st, dpt);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + R * rg + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = q0 + R * cg + j;
        const bool in = row < q_len;
        bool a = in;
        if constexpr (MASK)
          a = a && vit::mask_bit(mh + static_cast<size_t>(row) * mstride,
                                 key);
        const size_t ri = static_cast<size_t>(bh) * q_len + row;
        const float p = a ? expf(st[i][j] * scale - lse[ri]) : 0.0f;
        const float dl = in ? delta[ri] : 0.0f;
        float dpv = dpt[i][j], pd = p;
        if (threshold) {
          const bool keep = vit::positional_keep(seed, bh, row, key, threshold);
          pd = keep ? p * inv_keep : 0.0f;
          dpv = keep ? dpv * inv_keep : 0.0f;
        }
        p_s[(R * rg + i) * LDP + R * cg + j] = pd;
        ds_s[(R * rg + i) * LDP + R * cg + j] = p * (dpv - dl) * scale;
      }
    }
    __syncthreads();
    for (int j = 0; j < BR; ++j) {
      float pa[R], sa[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pa[i] = p_s[(R * rg + i) * LDP + j];
        sa[i] = ds_s[(R * rg + i) * LDP + j];
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float dob = do_s[j * DH + cg * CW + c];
        const float qb = q_s[j * DH + cg * CW + c];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv_acc[i][c] = fmaf(pa[i], dob, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qb, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + R * rg + i;
    if (key >= kv_len) continue;
    const size_t o = kbase + static_cast<size_t>(key) * DH + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      dk[o + c] = dk_acc[i][c];
      dv[o + c] = dv_acc[i][c];
    }
  }
}

// ------------------------------------------------------ bf16: shared
// Warps 0-7: two consumer warpgroups; warps 8-11: the producer warpgroup,
// of which warp 8 works. ptxas budgets registers for 384 threads (168 a
// thread); the producer hands most of its share to the consumers
// (setmaxnreg: 40 and 232 a thread), whose two 64 x Dh f32 accumulators
// and two 64 x 64 logit tiles would spill at 168.
constexpr int kConsumers = 256;
constexpr int kWg2Threads = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Named barriers: the ping-pong turns of warpgroups 0 and 1 (Dh <= 128),
// the hand-offs between them (Dh = 256).
constexpr int kTurn0 = 1;
constexpr int kHandA = 1;
constexpr int kHandB = 2;


// P = exp(s scale - lse) as 2^(s scale log2(e) - lse log2(e)): one FMA and
// one ex2.approx (relative error about 2^-22) instead of expf's range
// reduction; P is rounded to bf16 before its products either way. The
// producers store lse in these log2 units.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float prob(float s, float scale_log2,
                                      float lse_log2) {
  return exp2_approx(fmaf(s, scale_log2, -lse_log2));
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Zero an accumulator before a product that overwrites it (scale_d = 0 on
// its first k-step): its old values are then dead across the wgmma, which
// reads and writes every register it is given.
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// acc = A B^T over DH: A a [64, DH] tile, B the first NT rows of one (both
// K-major in shared memory); acc is 64 x NT (NT / 2 registers a thread).
template <int DH, int NT>
__device__ __forceinline__ void logits(float (&acc)[NT / 2], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    hopper::Wgmma<NT>::template ss<0>(acc, hopper::kmajor_desc<DH>(a, kk),
                                      hopper::kmajor_desc<DH>(b, kk), kk > 0);
}

// acc[b] += A (from registers, 64 x 16 KS) B[:, boxes b0 + b] for NB boxes
// of a [64, DH] tile read MN-major, the reduction over its first 16 KS rows.
template <int DH, int NB, int KS>
__device__ __forceinline__ void out_product(
    float (&acc)[NB][hopper::Tile<DH>::C / 2], const uint32_t (&a)[KS][4],
    uint32_t tile, int b0) {
  using L = hopper::Tile<DH>;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::Wgmma<L::C>::template rs<1>(
          acc[b], a[kk], hopper::mnmajor_desc<DH>(tile, b0 + b, kk), 1);
}

// What the per-tile steps of the Dh <= 128 kernels read besides their
// operands: the head, the lengths, the scalars and the thread's place.
struct Step {
  int bh, q_len, kv_len, wgi, w, g, tq;
  float scale, scale_log2, inv_keep;
  uint32_t seed;
  int threshold;
};

// Streamed tiles hold 64 rows; a last tile with at most 16 rows below T
// (T = 197: 5, T = 577: 1) runs the narrow step, whose logits are 64 x 16
// (m64n16 wgmma) and whose output products take one k-step: a quarter of
// the full step's products and elementwise work.
constexpr int kTail = 16;

// Store the rows of an [NB boxes] accumulator held by thread (w, g, tq):
// row row0 + 16 w + g + 8 h, columns (b0 + b) C + 8 j + 2 tq.
template <int DH, int NB>
__device__ __forceinline__ void store_rows(
    const float (&acc)[NB][hopper::Tile<DH>::C / 2], bf16* __restrict__ out,
    int bh, int row0, int t_len, int w, int g, int tq, int b0) {
  using L = hopper::Tile<DH>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * w + g + 8 * h;
    if (row >= t_len) continue;
    bf16* o = out + (static_cast<size_t>(bh) * t_len + row) * DH;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < L::C / 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(o + (b0 + b) * L::C + 8 * j +
                                           2 * tq) =
            __floats2bfloat162_rn(acc[b][i], acc[b][i + 1]);
      }
  }
}

// The dk/dv kernels' mask bits of a streamed tile of NT query rows from q0:
// bit i of the result is element i's (accumulator layout: query row
// q0 + 8 (i / 4) + 2 tq + i % 2, key bit kbit[(i / 2) % 2] of the row's
// word at mw0 + row * mstride), 0 past q_len. The words of the thread's
// NT / 4 rows load together, each serving both of its keys.
template <int NT>
__device__ __forceinline__ uint32_t tile_bits(const uint64_t* mw0,
                                              int mstride, int q0, int q_len,
                                              int tq, const int (&kbit)[2]) {
  uint32_t att = 0;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + 8 * j + 2 * tq + e;
      const uint64_t w =
          row < q_len ? __ldg(mw0 + static_cast<size_t>(row) * mstride) : 0ull;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        att |= static_cast<uint32_t>(vit::word_bit(w, kbit[h]))
               << (4 * j + 2 * h + e);
    }
  return att;
}

// ------------------------------------------- dk/dv, bf16, Dh <= 128
// One streamed q tile (NT of its rows used) for warpgroup wgi's 64 keys
// from kb: its turn to issue S^T = K Q^T and dP^T = V dO^T, then the other
// warpgroup's while this one waits and turns them into P_drop^T and dS^T
// (s <- P_drop^T, dp <- dS^T in the accumulator layout), then dV +=
// P_drop^T dO and dK += dS^T Q with A from registers and B MN-major.
// With MASK, mw0 points at the word of the warpgroup's 64 keys in query
// row 0, query row r's at r * mstride; the thread's key h is bit kbit[h].
template <int DH, int NT, bool MASK>
__device__ __forceinline__ void dkv_tile(
    float (&dk_acc)[hopper::Tile<DH>::NBOX][hopper::Tile<DH>::C / 2],
    float (&dv_acc)[hopper::Tile<DH>::NBOX][hopper::Tile<DH>::C / 2],
    uint32_t k_s, uint32_t v_s, uint32_t q_s, uint32_t do_s,
    const float* lse_s, const float* dl_s, int kb, int q0, const Step& c,
    const uint64_t* mw0, int mstride, const int (&kbit)[2]) {
  using L = hopper::Tile<DH>;
  constexpr int KS = NT / 16;
  float s[NT / 2], dp[NT / 2];
  zero(s);
  zero(dp);
  hopper::named_sync<kConsumers>(kTurn0 + c.wgi);
  hopper::wg_fence();
  logits<DH, NT>(s, k_s, q_s);
  logits<DH, NT>(dp, v_s, do_s);
  hopper::wg_commit();
  hopper::named_arrive<kConsumers>(kTurn0 + 1 - c.wgi);
  // With a mask, bit i: element i attends. Element i's query row is
  // 8 (i / 4) + 2 tq + i % 2 (its word loaded while the products run, 0
  // past q_len), its key bit kbit[(i / 2) % 2].
  const uint32_t att = MASK ? tile_bits<NT>(mw0, mstride, q0, c.q_len, c.tq,
                                            kbit)
                            : 0u;
  hopper::wg_wait<0>();
  hopper::fence_regs(s);
  hopper::fence_regs(dp);

  // S^T element 4 j + e sits at key half e / 2, query column
  // 8 j + 2 tq + e % 2.
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int key = kb + 16 * c.w + c.g + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * c.tq + (i % 2);
    const int row = q0 + col;
    const bool a = MASK ? (att >> i) & 1u : row < c.q_len;
    const float p = a ? prob(s[i], c.scale_log2, lse_s[col]) : 0.0f;
    float pd = p, dpv = dp[i];
    if (c.threshold) {
      const bool keep =
          vit::positional_keep(c.seed, c.bh, row, key, c.threshold);
      pd = keep ? p * c.inv_keep : 0.0f;
      dpv = keep ? dpv * c.inv_keep : 0.0f;
    }
    s[i] = pd;
    dp[i] = p * (dpv - dl_s[col]) * c.scale;
  }

  uint32_t pa[KS][4], sa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    hopper::acc_to_a(s, kk, pa[kk]);
    hopper::acc_to_a(dp, kk, sa[kk]);
  }
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b) {
    hopper::fence_regs(dv_acc[b]);
    hopper::fence_regs(dk_acc[b]);
  }
  hopper::wg_fence();
  out_product<DH, L::NBOX, KS>(dv_acc, pa, do_s, 0);
  out_product<DH, L::NBOX, KS>(dk_acc, sa, q_s, 0);
  hopper::wg_commit();
  hopper::wg_wait<0>();
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b) {
    hopper::fence_regs(dv_acc[b]);
    hopper::fence_regs(dk_acc[b]);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    hopper::fence_regs(pa[kk]);
    hopper::fence_regs(sa[kk]);
  }
}

template <int DH>
struct DkvWg2Smem {
  using L = hopper::Tile<DH>;
  static constexpr int k_off = 0;                     // key tiles [2]
  static constexpr int v_off = k_off + 2 * L::BYTES;  // value tiles [2]
  // Stage s: q tile at q_off + 2 s BYTES, dO tile BYTES later; lse[64]
  // and delta[64] at vec_off + 512 s.
  static constexpr int q_off = v_off + 2 * L::BYTES;
  static constexpr int vec_off = q_off + 4 * L::BYTES;
  static constexpr int bar_off = vec_off + 2 * 512;
  // kv_full, qd_full[2], qd_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <int DH, bool MASK>
__global__ void __launch_bounds__(kWg2Threads, 1)
    flash_bwd_dkv_wg2(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, vit::FlashMask mask, int q_len,
                      int kv_len, float scale, uint32_t seed, int threshold,
                      float inv_keep) {
  using L = hopper::Tile<DH>;
  using S = DkvWg2Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* qd_full = bars + 1;
  uint64_t* qd_empty = bars + 3;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 128;
  const int nq = (q_len + 63) / 64;
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&qd_full[s], 1 + 32);
      hopper::mbar_init(&qd_empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp: lane 0 issues the TMA tile loads; every lane loads two
    // of the tile's 64 lse and delta values (zero past q_len) and arrives.
    const int lane = tid - kConsumers;
    const size_t head = static_cast<size_t>(bh) * q_len;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, 4 * L::BYTES);
      for (int half = 0; half < 2; ++half) {
        hopper::tma_load_tile<DH>(smem + S::k_off + half * L::BYTES, &map_k,
                                  kv_full, k0 + 64 * half, bh);
        hopper::tma_load_tile<DH>(smem + S::v_off + half * L::BYTES, &map_v,
                                  kv_full, k0 + 64 * half, bh);
      }
    }
    for (int it = 0; it < nq; ++it) {
      const int st = it & 1;
      hopper::mbar_wait(&qd_empty[st], ((it >> 1) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* tiles = smem + S::q_off + st * 2 * L::BYTES;
        hopper::mbar_expect_tx(&qd_full[st], 2 * L::BYTES);
        hopper::tma_load_tile<DH>(tiles, &map_q, &qd_full[st], it * 64, bh);
        hopper::tma_load_tile<DH>(tiles + L::BYTES, &map_do, &qd_full[st],
                                  it * 64, bh);
      }
      float* vec = reinterpret_cast<float*>(smem + S::vec_off + st * 512);
#pragma unroll
      for (int r = lane; r < 64; r += 32) {
        const int row = it * 64 + r;
        vec[r] = row < q_len ? lse[head + row] * kLog2e : 0.0f;
        vec[64 + r] = row < q_len ? delta[head + row] : 0.0f;
      }
      hopper::mbar_arrive(&qd_full[st]);
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup wgi owns keys k0 + 64 wgi..: thread (w, g, tq)
  // holds keys 16 w + g (h = 0) and 16 w + g + 8 (h = 1) of them.
  const int wgi = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int kb = k0 + 64 * wgi;
  const Step c{bh, q_len, kv_len, wgi, w, g, tq, scale, scale_log2,
               inv_keep, seed, threshold};
  // The word of the warpgroup's 64 keys in the head's query row 0, and
  // the thread's two keys' bits in it.
  const uint64_t* mw0 = nullptr;
  const int mstride = mask.stride(kv_len);
  const int kbit[2] = {16 * w + g, 16 * w + g + 8};
  if constexpr (MASK) mw0 = mask.head(bh, q_len, kv_len) + (kb >> 6);
  const uint32_t k_s = hopper::smem_u32(smem + S::k_off + wgi * L::BYTES);
  const uint32_t v_s = hopper::smem_u32(smem + S::v_off + wgi * L::BYTES);
  float dk_acc[L::NBOX][L::C / 2], dv_acc[L::NBOX][L::C / 2];
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int i = 0; i < L::C / 2; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.0f;

  hopper::mbar_wait(kv_full, 0);
  if (wgi == 1) hopper::named_arrive<kConsumers>(kTurn0);  // 0 goes first
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    const int q0 = it * 64;
    const uint32_t q_s =
        hopper::smem_u32(smem + S::q_off + st * 2 * L::BYTES);
    const uint32_t do_s = q_s + L::BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + S::vec_off + st * 512);
    hopper::mbar_wait(&qd_full[st], (it >> 1) & 1);
    if (q_len - q0 <= kTail)
      dkv_tile<DH, kTail, MASK>(dk_acc, dv_acc, k_s, v_s, q_s, do_s, lse_s,
                                lse_s + 64, kb, q0, c, mw0, mstride, kbit);
    else
      dkv_tile<DH, 64, MASK>(dk_acc, dv_acc, k_s, v_s, q_s, do_s, lse_s,
                             lse_s + 64, kb, q0, c, mw0, mstride, kbit);
    hopper::mbar_arrive(&qd_empty[st]);
  }
  if (wgi == 0) hopper::named_sync<kConsumers>(kTurn0);  // 1's last turn

  store_rows<DH, L::NBOX>(dk_acc, dk, bh, kb, kv_len, w, g, tq, 0);
  store_rows<DH, L::NBOX>(dv_acc, dv, bh, kb, kv_len, w, g, tq, 0);
}

// ---------------------------------------------- dq, bf16, Dh <= 128
// One streamed K/V tile (NT of its keys used) for warpgroup wgi's 64
// queries from qb: its turn to issue S = Q K^T and dP = dO V^T, then dS =
// P (keep dP / keep - delta) scale in the accumulator layout while the
// other warpgroup issues, then dQ += dS K (dS from registers rounded to
// bf16, K read MN-major).
// With MASK, mrow[h] points at the mask words of the thread's query h.
template <int DH, int NT, bool MASK>
__device__ __forceinline__ void dq_tile(
    float (&dq_acc)[hopper::Tile<DH>::NBOX][hopper::Tile<DH>::C / 2],
    uint32_t q_s, uint32_t do_s, uint32_t k_s, uint32_t v_s,
    const float (&lse_r)[2], const float (&dl_r)[2], int qb, int k0,
    const Step& c, const uint64_t* const (&mrow)[2]) {
  using L = hopper::Tile<DH>;
  constexpr int KS = NT / 16;
  float s[NT / 2], dp[NT / 2];
  zero(s);
  zero(dp);
  hopper::named_sync<kConsumers>(kTurn0 + c.wgi);
  hopper::wg_fence();
  logits<DH, NT>(s, q_s, k_s);
  logits<DH, NT>(dp, do_s, v_s);
  hopper::wg_commit();
  hopper::named_arrive<kConsumers>(kTurn0 + 1 - c.wgi);
  // With a mask, the tile's word of each of the two rows, loaded while the
  // products run; element i's key is bit 8 (i / 4) + 2 tq + i % 2.
  uint64_t mw[2] = {0, 0};
  if constexpr (MASK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) mw[h] = __ldg(mrow[h] + (k0 >> 6));
  }
  hopper::wg_wait<0>();
  hopper::fence_regs(s);
  hopper::fence_regs(dp);

  // S element 4 j + e sits at query half e / 2, key column 8 j + 2 tq +
  // e % 2.
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int h = (i / 2) % 2;
    const int row = qb + 16 * c.w + c.g + 8 * h;
    const int col = k0 + 8 * (i / 4) + 2 * c.tq + (i % 2);
    const bool a =
        MASK ? vit::tile_bit(vit::tile_bits_of(mw[h], c.tq), i) : col < c.kv_len;
    const float p = a ? prob(s[i], c.scale_log2, lse_r[h]) : 0.0f;
    float dpv = dp[i];
    if (c.threshold)
      dpv = vit::positional_keep(c.seed, c.bh, row, col, c.threshold)
                ? dpv * c.inv_keep
                : 0.0f;
    s[i] = p * (dpv - dl_r[h]) * c.scale;
  }

  uint32_t sa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) hopper::acc_to_a(s, kk, sa[kk]);
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
  hopper::wg_fence();
  out_product<DH, L::NBOX, KS>(dq_acc, sa, k_s, 0);
  hopper::wg_commit();
  hopper::wg_wait<0>();
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) hopper::fence_regs(sa[kk]);
}

template <int DH>
struct DqWg2Smem {
  using L = hopper::Tile<DH>;
  static constexpr int q_off = 0;                       // query tiles [2]
  static constexpr int do_off = q_off + 2 * L::BYTES;   // dO tiles [2]
  // Stage s: K tile at k_off + 2 s BYTES, V tile BYTES later.
  static constexpr int k_off = do_off + 2 * L::BYTES;
  static constexpr int vec_off = k_off + 4 * L::BYTES;  // lse[128], delta[128]
  static constexpr int bar_off = vec_off + 1024;
  // qd_full, kv_full[2], kv_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <int DH, bool MASK>
__global__ void __launch_bounds__(kWg2Threads, 1)
    flash_bwd_dq_wg2(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     vit::FlashMask mask, int q_len, int kv_len, float scale,
                     uint32_t seed, int threshold, float inv_keep) {
  using L = hopper::Tile<DH>;
  using S = DqWg2Smem<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* qd_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 3;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 128;
  const int nk = (kv_len + 63) / 64;
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;
  if (tid == 0) {
    hopper::mbar_init(qd_full, 1 + 32);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp: every lane copies four of the block's 128 lse and
    // delta values (zero past q_len) and arrives; lane 0 also loads the Q
    // and dO tiles, then streams the K and V tiles through the ring.
    const int lane = tid - kConsumers;
    const size_t head = static_cast<size_t>(bh) * q_len;
    if (lane == 0) {
      hopper::mbar_expect_tx(qd_full, 4 * L::BYTES);
      for (int half = 0; half < 2; ++half) {
        hopper::tma_load_tile<DH>(smem + S::q_off + half * L::BYTES, &map_q,
                                  qd_full, q0 + 64 * half, bh);
        hopper::tma_load_tile<DH>(smem + S::do_off + half * L::BYTES,
                                  &map_do, qd_full, q0 + 64 * half, bh);
      }
    }
    float* vec = reinterpret_cast<float*>(smem + S::vec_off);
#pragma unroll
    for (int r = lane; r < 128; r += 32) {
      const int row = q0 + r;
      vec[r] = row < q_len ? lse[head + row] * kLog2e : 0.0f;
      vec[128 + r] = row < q_len ? delta[head + row] : 0.0f;
    }
    hopper::mbar_arrive(qd_full);
    if (lane != 0) return;
    for (int it = 0; it < nk; ++it) {
      const int st = it & 1;
      hopper::mbar_wait(&kv_empty[st], ((it >> 1) & 1) ^ 1);
      unsigned char* tiles = smem + S::k_off + st * 2 * L::BYTES;
      hopper::mbar_expect_tx(&kv_full[st], 2 * L::BYTES);
      hopper::tma_load_tile<DH>(tiles, &map_k, &kv_full[st], it * 64, bh);
      hopper::tma_load_tile<DH>(tiles + L::BYTES, &map_v, &kv_full[st],
                                it * 64, bh);
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // Consumer warpgroup wgi owns queries q0 + 64 wgi..: thread (w, g, tq)
  // holds queries 16 w + g (h = 0) and 16 w + g + 8 (h = 1) of them.
  const int wgi = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int qb = q0 + 64 * wgi;
  const Step c{bh, q_len, kv_len, wgi, w, g, tq, scale, scale_log2,
               inv_keep, seed, threshold};
  // The mask rows of the thread's two queries (rows past q_len, never
  // stored, read row q_len - 1).
  const uint64_t* mrow[2] = {nullptr, nullptr};
  if constexpr (MASK) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mrow[h] = mask.row_of(bh, min(qb + 16 * w + g + 8 * h, q_len - 1),
                            q_len, kv_len);
  }
  const uint32_t q_s = hopper::smem_u32(smem + S::q_off + wgi * L::BYTES);
  const uint32_t do_s = hopper::smem_u32(smem + S::do_off + wgi * L::BYTES);
  float dq_acc[L::NBOX][L::C / 2];
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int i = 0; i < L::C / 2; ++i) dq_acc[b][i] = 0.0f;

  hopper::mbar_wait(qd_full, 0);
  float lse_r[2], dl_r[2];
  {
    const float* vec = reinterpret_cast<const float*>(smem + S::vec_off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = vec[64 * wgi + 16 * w + g + 8 * h];
      dl_r[h] = vec[128 + 64 * wgi + 16 * w + g + 8 * h];
    }
  }
  if (wgi == 1) hopper::named_arrive<kConsumers>(kTurn0);  // 0 goes first
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    const int k0 = it * 64;
    const uint32_t k_s =
        hopper::smem_u32(smem + S::k_off + st * 2 * L::BYTES);
    const uint32_t v_s = k_s + L::BYTES;
    hopper::mbar_wait(&kv_full[st], (it >> 1) & 1);
    if (kv_len - k0 <= kTail)
      dq_tile<DH, kTail, MASK>(dq_acc, q_s, do_s, k_s, v_s, lse_r, dl_r, qb,
                               k0, c, mrow);
    else
      dq_tile<DH, 64, MASK>(dq_acc, q_s, do_s, k_s, v_s, lse_r, dl_r, qb, k0,
                            c, mrow);
    hopper::mbar_arrive(&kv_empty[st]);
  }
  if (wgi == 0) hopper::named_sync<kConsumers>(kTurn0);  // 1's last turn

  store_rows<DH, L::NBOX>(dq_acc, dq, bh, qb, q_len, w, g, tq, 0);
}

// --------------------------------------------- dk/dv, bf16, Dh = 256
struct DkvSplitSmem {
  using L = hopper::Tile<256>;
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + L::BYTES;
  // Stage s: q tile at q_off + 2 s BYTES, dO tile BYTES later; lse[64]
  // and delta[64] at vec_off + 512 s.
  static constexpr int q_off = v_off + L::BYTES;
  static constexpr int vec_off = q_off + 4 * L::BYTES;
  // P handed from warpgroup 0 to 1: [32 elements][128 threads] f32.
  static constexpr int xch_off = vec_off + 2 * 512;
  static constexpr int bar_off = xch_off + 32 * 128 * 4;
  // kv_full, qd_full[2], qd_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <bool MASK>
__global__ void __launch_bounds__(kWg2Threads, 1)
    flash_bwd_dkv_split(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        vit::FlashMask mask, int q_len, int kv_len,
                        float scale, uint32_t seed, int threshold,
                        float inv_keep) {
  constexpr int DH = 256;
  using L = hopper::Tile<DH>;
  using S = DkvSplitSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* qd_full = bars + 1;
  uint64_t* qd_empty = bars + 3;
  float* xch = reinterpret_cast<float*>(smem + S::xch_off);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int nq = (q_len + 63) / 64;
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&qd_full[s], 1 + 32);
      hopper::mbar_init(&qd_empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp, as in flash_bwd_dkv_wg2 with one key tile.
    const int lane = tid - kConsumers;
    const size_t head = static_cast<size_t>(bh) * q_len;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * L::BYTES);
      hopper::tma_load_tile<DH>(smem + S::k_off, &map_k, kv_full, k0, bh);
      hopper::tma_load_tile<DH>(smem + S::v_off, &map_v, kv_full, k0, bh);
    }
    for (int it = 0; it < nq; ++it) {
      const int st = it & 1;
      hopper::mbar_wait(&qd_empty[st], ((it >> 1) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* tiles = smem + S::q_off + st * 2 * L::BYTES;
        hopper::mbar_expect_tx(&qd_full[st], 2 * L::BYTES);
        hopper::tma_load_tile<DH>(tiles, &map_q, &qd_full[st], it * 64, bh);
        hopper::tma_load_tile<DH>(tiles + L::BYTES, &map_do, &qd_full[st],
                                  it * 64, bh);
      }
      float* vec = reinterpret_cast<float*>(smem + S::vec_off + st * 512);
#pragma unroll
      for (int r = lane; r < 64; r += 32) {
        const int row = it * 64 + r;
        vec[r] = row < q_len ? lse[head + row] * kLog2e : 0.0f;
        vec[64 + r] = row < q_len ? delta[head + row] : 0.0f;
      }
      hopper::mbar_arrive(&qd_full[st]);
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // Both warpgroups hold keys 16 w + g + 8 h of the block in the same
  // accumulator layout. Warpgroup 0: x = S^T, P, dV += P_drop^T dO.
  // Warpgroup 1: x = dP^T, dS^T from warpgroup 0's P, dK += dS^T Q.
  const int wgi = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, tq = t % 4;
  // The word of the block's 64 keys in the head's query row 0, and the
  // thread's two keys' bits in it, as in flash_bwd_dkv_wg2.
  const uint64_t* mw0 = nullptr;
  const int mstride = mask.stride(kv_len);
  const int kbit[2] = {16 * w + g, 16 * w + g + 8};
  if constexpr (MASK) mw0 = mask.head(bh, q_len, kv_len) + (k0 >> 6);
  const uint32_t a_s = hopper::smem_u32(smem + (wgi ? S::v_off : S::k_off));
  float acc[L::NBOX][L::C / 2];
  float x[32];
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int i = 0; i < L::C / 2; ++i) acc[b][i] = 0.0f;

  hopper::mbar_wait(kv_full, 0);
  if (wgi == 1) hopper::named_arrive<kConsumers>(kHandB);  // P buffer free
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    const int q0 = it * 64;
    const uint32_t q_s =
        hopper::smem_u32(smem + S::q_off + st * 2 * L::BYTES);
    const uint32_t do_s = q_s + L::BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + S::vec_off + st * 512);
    const float* dl_s = lse_s + 64;
    hopper::mbar_wait(&qd_full[st], (it >> 1) & 1);

    zero(x);
    hopper::wg_fence();
    logits<DH, 64>(x, a_s, wgi ? do_s : q_s);
    hopper::wg_commit();
    // With a mask, warpgroup 0's bit i: element i attends, as in dkv_tile.
    uint32_t att = 0;
    if constexpr (MASK) {
      if (wgi == 0) att = tile_bits<64>(mw0, mstride, q0, q_len, tq, kbit);
    }
    hopper::wg_wait<0>();
    hopper::fence_regs(x);

    if (wgi == 0) {
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + 2 * tq + (i % 2);
        const bool a = MASK ? (att >> i) & 1u : q0 + c < q_len;
        p[i] = a ? prob(x[i], scale_log2, lse_s[c]) : 0.0f;
      }
      hopper::named_sync<kConsumers>(kHandB);  // 1 has read the last P
#pragma unroll
      for (int i = 0; i < 32; ++i) xch[i * 128 + t] = p[i];
      hopper::named_arrive<kConsumers>(kHandA);  // this P is ready
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 16 * w + g + 8 * ((i / 2) % 2);
        const int row = q0 + 8 * (i / 4) + 2 * tq + (i % 2);
        x[i] = threshold == 0 ? p[i]
               : vit::positional_keep(seed, bh, row, key, threshold)
                   ? p[i] * inv_keep
                   : 0.0f;
      }
    } else {
      hopper::named_sync<kConsumers>(kHandA);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 16 * w + g + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + 2 * tq + (i % 2);
        const int row = q0 + c;
        float dpv = x[i];
        if (threshold)
          dpv = vit::positional_keep(seed, bh, row, key, threshold)
                    ? dpv * inv_keep
                    : 0.0f;
        x[i] = xch[i * 128 + t] * (dpv - dl_s[c]) * scale;
      }
      hopper::named_arrive<kConsumers>(kHandB);
    }

    uint32_t xa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(x, kk, xa[kk]);
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(acc[b]);
    hopper::wg_fence();
    out_product<DH, L::NBOX, 4>(acc, xa, wgi ? q_s : do_s, 0);
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(acc[b]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(xa[kk]);
    hopper::mbar_arrive(&qd_empty[st]);
  }
  if (wgi == 0) hopper::named_sync<kConsumers>(kHandB);  // 1's last read

  store_rows<DH, L::NBOX>(acc, wgi ? dk : dv, bh, k0, kv_len, w, g, tq, 0);
}

// ------------------------------------------------ dq, bf16, Dh = 256
struct DqSplitSmem {
  using L = hopper::Tile<256>;
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + L::BYTES;
  // Stage s: K tile at k_off + 2 s BYTES, V tile BYTES later.
  static constexpr int k_off = do_off + L::BYTES;
  static constexpr int vec_off = k_off + 4 * L::BYTES;  // lse[64], delta[64]
  // P from warpgroup 0 to 1 ([32][128] f32), then dS back as bf16 A
  // fragments ([16][128] u32).
  static constexpr int xp_off = vec_off + 512;
  static constexpr int xs_off = xp_off + 32 * 128 * 4;
  static constexpr int bar_off = xs_off + 16 * 128 * 4;
  // qd_full, kv_full[2], kv_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <bool MASK>
__global__ void __launch_bounds__(kWg2Threads, 1)
    flash_bwd_dq_split(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       vit::FlashMask mask, int q_len, int kv_len,
                       float scale, uint32_t seed, int threshold,
                       float inv_keep) {
  constexpr int DH = 256;
  using L = hopper::Tile<DH>;
  using S = DqSplitSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* qd_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 3;
  float* xp = reinterpret_cast<float*>(smem + S::xp_off);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + S::xs_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int nk = (kv_len + 63) / 64;
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;
  if (tid == 0) {
    hopper::mbar_init(qd_full, 1 + 32);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid >= kConsumers + 32) return;
    // Producer warp, as in flash_bwd_dq_wg2 with one query tile.
    const int lane = tid - kConsumers;
    const size_t head = static_cast<size_t>(bh) * q_len;
    if (lane == 0) {
      hopper::mbar_expect_tx(qd_full, 2 * L::BYTES);
      hopper::tma_load_tile<DH>(smem + S::q_off, &map_q, qd_full, q0, bh);
      hopper::tma_load_tile<DH>(smem + S::do_off, &map_do, qd_full, q0, bh);
    }
    float* vec = reinterpret_cast<float*>(smem + S::vec_off);
#pragma unroll
    for (int r = lane; r < 64; r += 32) {
      const int row = q0 + r;
      vec[r] = row < q_len ? lse[head + row] * kLog2e : 0.0f;
      vec[64 + r] = row < q_len ? delta[head + row] : 0.0f;
    }
    hopper::mbar_arrive(qd_full);
    if (lane != 0) return;
    for (int it = 0; it < nk; ++it) {
      const int st = it & 1;
      hopper::mbar_wait(&kv_empty[st], ((it >> 1) & 1) ^ 1);
      unsigned char* tiles = smem + S::k_off + st * 2 * L::BYTES;
      hopper::mbar_expect_tx(&kv_full[st], 2 * L::BYTES);
      hopper::tma_load_tile<DH>(tiles, &map_k, &kv_full[st], it * 64, bh);
      hopper::tma_load_tile<DH>(tiles + L::BYTES, &map_v, &kv_full[st],
                                it * 64, bh);
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  // Both warpgroups hold queries 16 w + g + 8 h of the block in the same
  // accumulator layout. Warpgroup 0: x = S, P; warpgroup 1: x = dP, dS from
  // warpgroup 0's P, handed back as bf16 A fragments; warpgroup wgi owns
  // dQ's boxes 2 wgi and 2 wgi + 1 (columns 128 wgi..).
  const int wgi = tid / 128, t = tid % 128;
  const int w = t / 32, g = (t % 32) / 4, tq = t % 4;
  const uint32_t a_s = hopper::smem_u32(smem + (wgi ? S::do_off : S::q_off));
  // The mask rows of the thread's two queries, as in flash_bwd_dq_wg2.
  const uint64_t* mrow[2] = {nullptr, nullptr};
  if constexpr (MASK) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mrow[h] = mask.row_of(bh, min(q0 + 16 * w + g + 8 * h, q_len - 1),
                            q_len, kv_len);
  }
  float acc[2][L::C / 2];
  float x[32];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < L::C / 2; ++i) acc[b][i] = 0.0f;

  hopper::mbar_wait(qd_full, 0);
  float lse_r[2], dl_r[2];
  {
    const float* vec = reinterpret_cast<const float*>(smem + S::vec_off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = vec[16 * w + g + 8 * h];
      dl_r[h] = vec[64 + 16 * w + g + 8 * h];
    }
  }
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    const int k0 = it * 64;
    const uint32_t k_s =
        hopper::smem_u32(smem + S::k_off + st * 2 * L::BYTES);
    const uint32_t v_s = k_s + L::BYTES;
    hopper::mbar_wait(&kv_full[st], (it >> 1) & 1);

    zero(x);
    hopper::wg_fence();
    logits<DH, 64>(x, a_s, wgi ? v_s : k_s);
    hopper::wg_commit();
    // With a mask, warpgroup 0's tile word of each of its two rows, loaded
    // while the product runs.
    uint64_t mw[2] = {0, 0};
    if constexpr (MASK) {
      if (wgi == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) mw[h] = __ldg(mrow[h] + (k0 >> 6));
      }
    }
    hopper::wg_wait<0>();
    hopper::fence_regs(x);

    uint32_t sa[4][4];
    if (wgi == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
        const bool a = MASK ? vit::tile_bit(vit::tile_bits_of(mw[(i / 2) % 2],
                                                               tq),
                                            i)
                            : col < kv_len;
        xp[i * 128 + t] = a ? prob(x[i], scale_log2, lse_r[(i / 2) % 2]) : 0.0f;
      }
      hopper::named_arrive<kConsumers>(kHandA);  // P ready
      hopper::named_sync<kConsumers>(kHandB);    // dS ready
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) sa[kk][r] = xs[(4 * kk + r) * 128 + t];
    } else {
      hopper::named_sync<kConsumers>(kHandA);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        const int row = q0 + 16 * w + g + 8 * h;
        const int col = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
        float dpv = x[i];
        if (threshold)
          dpv = vit::positional_keep(seed, bh, row, col, threshold)
                    ? dpv * inv_keep
                    : 0.0f;
        x[i] = xp[i * 128 + t] * (dpv - dl_r[h]) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::acc_to_a(x, kk, sa[kk]);
#pragma unroll
        for (int r = 0; r < 4; ++r) xs[(4 * kk + r) * 128 + t] = sa[kk][r];
      }
      hopper::named_arrive<kConsumers>(kHandB);
    }

    // dQ[:, 128 wgi..] += dS K[:, 128 wgi..]: K read MN-major.
#pragma unroll
    for (int b = 0; b < 2; ++b) hopper::fence_regs(acc[b]);
    hopper::wg_fence();
    out_product<DH, 2, 4>(acc, sa, k_s, 2 * wgi);
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int b = 0; b < 2; ++b) hopper::fence_regs(acc[b]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(sa[kk]);
    hopper::mbar_arrive(&kv_empty[st]);
  }

  store_rows<DH, 2>(acc, dq, bh, q0, q_len, w, g, tq, 2 * wgi);
}

// -------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o0, *o1;  // dq (dq kernel) or dk, dv (dk/dv kernel)
  vit::FlashMask mask;
  int bh, q_len, kv_len;
  float scale;
  uint32_t seed;
  int threshold;
  float inv_keep;
};

// Set the kernel's shared memory and launch it.
template <typename Kernel, typename... Rest>
cudaError_t start(Kernel kernel, int smem, dim3 grid, int threads,
                  cudaStream_t s, Rest... rest) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(rest...);
  return cudaGetLastError();
}

template <int DH, bool MASK>
cudaError_t launch_simt(bool dkv, const Args& a, cudaStream_t s) {
  constexpr int BR = simt_rows<DH>();
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  float* o0 = static_cast<float*>(a.o0);
  if (dkv)
    return start(flash_bwd_dkv_simt<DH, BR, MASK>,
                 static_cast<int>(DkvSmem<DH, BR>::bytes),
                 dim3((a.kv_len + BR - 1) / BR, a.bh), kThreads, s, q, k, v,
                 dout, a.lse, a.delta, o0, static_cast<float*>(a.o1), a.mask,
                 a.q_len, a.kv_len, a.scale, a.seed, a.threshold, a.inv_keep);
  return start(flash_bwd_dq_simt<DH, BR, MASK>,
               static_cast<int>(DqSmem<DH, BR>::bytes),
               dim3((a.q_len + BR - 1) / BR, a.bh), kThreads, s, q, k, v,
               dout, a.lse, a.delta, o0, a.mask, a.q_len, a.kv_len, a.scale,
               a.seed, a.threshold, a.inv_keep);
}

// The bf16 kernels: the two-warpgroup row split for Dh <= 128 (128 rows a
// CTA), the work split for Dh = 256 (64 rows a CTA).
template <int DH, bool MASK>
cudaError_t launch_wgmma(bool dkv, const Args& a, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_tile_map<DH>(&mq, a.q, a.bh, a.q_len) ||
      !hopper::make_tile_map<DH>(&mk, a.k, a.bh, a.kv_len) ||
      !hopper::make_tile_map<DH>(&mv, a.v, a.bh, a.kv_len) ||
      !hopper::make_tile_map<DH>(&mdo, a.dout, a.bh, a.q_len))
    return cudaErrorInvalidValue;
  bf16* o0 = static_cast<bf16*>(a.o0);
  bf16* o1 = static_cast<bf16*>(a.o1);
  const int rows = DH == 256 ? 64 : 128;
  const dim3 grid(((dkv ? a.kv_len : a.q_len) + rows - 1) / rows, a.bh);
  if constexpr (DH == 256) {
    if (dkv)
      return start(flash_bwd_dkv_split<MASK>, DkvSplitSmem::bytes, grid,
                   kWg2Threads, s, mq, mk, mv, mdo, a.lse, a.delta, o0, o1,
                   a.mask, a.q_len, a.kv_len, a.scale, a.seed, a.threshold,
                   a.inv_keep);
    return start(flash_bwd_dq_split<MASK>, DqSplitSmem::bytes, grid,
                 kWg2Threads, s, mq, mk, mv, mdo, a.lse, a.delta, o0, a.mask,
                 a.q_len, a.kv_len, a.scale, a.seed, a.threshold, a.inv_keep);
  } else {
    if (dkv)
      return start(flash_bwd_dkv_wg2<DH, MASK>, DkvWg2Smem<DH>::bytes, grid,
                   kWg2Threads, s, mq, mk, mv, mdo, a.lse, a.delta, o0, o1,
                   a.mask, a.q_len, a.kv_len, a.scale, a.seed, a.threshold,
                   a.inv_keep);
    return start(flash_bwd_dq_wg2<DH, MASK>, DqWg2Smem<DH>::bytes, grid,
                 kWg2Threads, s, mq, mk, mv, mdo, a.lse, a.delta, o0, a.mask,
                 a.q_len, a.kv_len, a.scale, a.seed, a.threshold, a.inv_keep);
  }
}

// bf16: the wgmma kernels; f32: the SIMT kernels; each with and without
// the mask.
template <int DH, bool MASK>
cudaError_t launch(int dtype, bool dkv, const Args& a, cudaStream_t s) {
  if (dtype == 1) return launch_wgmma<DH, MASK>(dkv, a, s);
  if (dtype == 0) return launch_simt<DH, MASK>(dkv, a, s);
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(int dtype, bool dkv, const Args& a, cudaStream_t s) {
  return a.mask.bits ? launch<DH, true>(dtype, dkv, a, s)
                    : launch<DH, false>(dtype, dkv, a, s);
}

int run(int dtype, int dh, bool dkv, const Args& a, void* stream) {
  if (a.bh <= 0 || a.bh > 65535 || a.q_len <= 0 || a.kv_len <= 0 ||
      (a.mask.bits &&
       (a.mask.mode < 0 || a.mask.mode > 3 || a.mask.heads <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return static_cast<int>(launch<32>(dtype, dkv, a, s));
    case 64:
      return static_cast<int>(launch<64>(dtype, dkv, a, s));
    case 128:
      return static_cast<int>(launch<128>(dtype, dkv, a, s));
    case 256:
      return static_cast<int>(launch<256>(dtype, dkv, a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). q, dout, dq: [bh, q_len, dh];
// k, v, dk, dv: [bh, kv_len, dh]; contiguous in dtype (0 = float32, 1 =
// bf16; the bf16 kernels read q, k, v and dout through TMA, 16-byte
// aligned), dh in {32, 64, 128, 256}; lse, delta: [bh, q_len] float32;
// scale the logits' (Dh^-0.5 of the unpadded head dim when the caller
// padded). mask: null, or the folded mask's bits as vit_flash_fwd takes
// them.
// Return the cudaError_t of the map encoding, attribute call or launch (0
// on success).
extern "C" int vit_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq,
                                const void* mask, int mask_mode, int heads,
                                int q_bcast, int bh, int q_len, int kv_len,
                                int dh, float scale, uint32_t seed,
                                int threshold, float inv_keep, void* stream) {
  const vit::FlashMask m{static_cast<const uint64_t*>(mask), mask_mode, heads,
                         q_bcast};
  const Args a{q,  k,     v,      dout,  lse,  delta,     dq,      nullptr, m,
               bh, q_len, kv_len, scale, seed, threshold, inv_keep};
  return run(dtype, dh, false, a, stream);
}

extern "C" int vit_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk,
                                 void* dv, const void* mask, int mask_mode,
                                 int heads, int q_bcast, int bh, int q_len,
                                 int kv_len, int dh, float scale,
                                 uint32_t seed, int threshold, float inv_keep,
                                 void* stream) {
  const vit::FlashMask m{static_cast<const uint64_t*>(mask), mask_mode, heads,
                         q_bcast};
  const Args a{q,  k,     v,      dout,  lse,  delta,     dk,      dv, m,
               bh, q_len, kv_len, scale, seed, threshold, inv_keep};
  return run(dtype, dh, true, a, stream);
}
