// Flash-attention backward (no mask): the dq kernel and the dk/dv kernel.
//
// Replace the JAX package's Pallas kernels
// ops/flash_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel (the two
// pallas_calls in _flash_bwd), in their mask=None form, with positional
// attention dropout.
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
// programs, so each maps to a CUDA grid directly: one CTA per (b*h, 64-row
// block), no atomics, a fixed loop order: deterministic. The ragged edge:
// keys past T give P = 0 in the dq kernel, queries past T give P = 0 in the
// dk/dv kernel, padded rows load as zeros and are never stored.
//
// dk/dv, bf16 — flash_bwd_dkv_wgmma, the Hopper design (csrc/hopper.cuh):
// one consumer warpgroup owns the CTA's 64 keys, whose K and V tiles and
// f32 dK/dV accumulators stay resident; one producer warp streams q, dO,
// lse and delta tiles of 64 queries through a 2-stage ring (TMA, full/empty
// mbarriers; the warp's lanes copy the tile's 64 lse and delta values,
// whose row pitch T * 4 bytes is no TMA stride). Per q tile: S^T = K Q^T
// and dP^T = V dO^T (wgmma, both operands from shared memory, K-major), P,
// dropout and dS elementwise in the accumulator layout, then
// dV += P_drop^T dO and dK += dS^T Q (wgmma, P_drop^T and dS^T from
// registers rounded to bf16, dO and Q MN-major). The q/dO maps are 3-D
// (Dh, T, B*H) so rows past T load as zeros; queries past T get P = 0.
//
// dq, bf16 — flash_bwd_dq_wgmma, the same design with the roles swapped:
// one consumer warpgroup owns the CTA's 64 queries, whose Q and dO tiles
// stay resident (one TMA load each) and whose lse and delta it holds in
// registers (the producer lanes copy them, zero past T); one producer warp
// streams K and V tiles of 64 keys through a 2-stage ring. Per K tile:
// S = Q K^T and dP = dO V^T (wgmma, both operands K-major), P, dropout and
// dS = P (keep dP / keep - delta) scale elementwise in the accumulator
// layout, then dQ += dS K (wgmma, dS from registers rounded to bf16, K read
// MN-major). Keys past T load as zeros and get P = 0; dq leaves as bf16
// from the f32 accumulator, rows past T never stored. The rounding of dS
// before its product is new against the Pallas kernel, which multiplies
// upcast f32 operands; tests/test_torch_flash_rounding.py holds it to the
// plain version's bound.
//
// dq and dk/dv, f32 — SIMT kernels: all math in f32 like
// the Pallas kernels (which upcast q, k, v and dO);
// thread (rg, cg) owns 4 rows x 4 columns of each 64x64 logit block and 4
// rows x Dh/16 columns of the output; operands are staged in shared memory
// as f32, both transposed (for the logit products) and row-major (for the
// output products). f32 keeps them: TF32 would break the f32 bounds.
#include "hopper.cuh"
#include "vit_common.cuh"

using vit::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;  // rows of a q block and of a k block
constexpr int kLdp = kB + 4;

template <int DH>
struct DqSmem {
  static constexpr size_t q_off = 0;                    // [B][DH]
  static constexpr size_t do_off = q_off + kB * DH * 4;  // [B][DH]
  static constexpr size_t kt_off = do_off + kB * DH * 4; // [DH][B]
  static constexpr size_t vt_off = kt_off + DH * kB * 4; // [DH][B]
  static constexpr size_t k_off = vt_off + DH * kB * 4;  // [B][DH]
  static constexpr size_t ds_off = k_off + kB * DH * 4;  // [B][kLdp]
  static constexpr size_t bytes = ds_off + kB * kLdp * 4;
};

template <int DH>
struct DkvSmem {
  static constexpr size_t k_off = 0;                     // [B][DH]
  static constexpr size_t v_off = k_off + kB * DH * 4;    // [B][DH]
  static constexpr size_t qt_off = v_off + kB * DH * 4;   // [DH][B]
  static constexpr size_t dot_off = qt_off + DH * kB * 4; // [DH][B]
  static constexpr size_t q_off = dot_off + DH * kB * 4;  // [B][DH]
  static constexpr size_t do_off = q_off + kB * DH * 4;   // [B][DH]
  static constexpr size_t p_off = do_off + kB * DH * 4;   // [B][kLdp]
  static constexpr size_t ds_off = p_off + kB * kLdp * 4; // [B][kLdp]
  static constexpr size_t bytes = ds_off + kB * kLdp * 4;
};

// rows r0.. of src [t_len, DH] -> dst as [B][DH] f32 (zero past t_len).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* dst,
                                          int r0, int t_len) {
  for (int i = threadIdx.x; i < kB * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[i] = (r0 + r < t_len)
                 ? vit::to_f32(src[static_cast<size_t>(r0 + r) * DH + d])
                 : 0.0f;
  }
}

// rows r0.. of src [t_len, DH] -> dst transposed as [DH][B] f32.
template <typename T, int DH>
__device__ __forceinline__ void load_rows_t(const T* __restrict__ src,
                                            float* dst, int r0, int t_len) {
  for (int i = threadIdx.x; i < kB * DH; i += kThreads) {
    const int c = i % kB, d = i / kB;
    dst[d * kB + c] =
        (r0 + c < t_len)
            ? vit::to_f32(src[static_cast<size_t>(r0 + c) * DH + d])
            : 0.0f;
  }
}

// s[i][j] += a[4rg+i, :] . bt[:, 4cg+j] over DH (a row-major, bt
// transposed), for two operand pairs at once.
template <int DH>
__device__ __forceinline__ void block_dots(const float* a0, const float* b0t,
                                           const float* a1, const float* b1t,
                                           int rg, int cg, float (&s0)[4][4],
                                           float (&s1)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s0[i][j] = s1[i][j] = 0.0f;
  for (int d = 0; d < DH; ++d) {
    const float4 b0 = *reinterpret_cast<const float4*>(b0t + d * kB + 4 * cg);
    const float4 b1 = *reinterpret_cast<const float4*>(b1t + d * kB + 4 * cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = a0[(4 * rg + i) * DH + d];
      const float x1 = a1[(4 * rg + i) * DH + d];
      s0[i][0] = fmaf(x0, b0.x, s0[i][0]);
      s0[i][1] = fmaf(x0, b0.y, s0[i][1]);
      s0[i][2] = fmaf(x0, b0.z, s0[i][2]);
      s0[i][3] = fmaf(x0, b0.w, s0[i][3]);
      s1[i][0] = fmaf(x1, b1.x, s1[i][0]);
      s1[i][1] = fmaf(x1, b1.y, s1[i][1]);
      s1[i][2] = fmaf(x1, b1.z, s1[i][2]);
      s1[i][3] = fmaf(x1, b1.w, s1[i][3]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_simt(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int t_len, float scale, uint32_t seed, int threshold,
                      float inv_keep) {
  using L = DqSmem<DH>;
  constexpr int CW = DH / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);
  float* do_s = reinterpret_cast<float*>(smem + L::do_off);
  float* kt_s = reinterpret_cast<float*>(smem + L::kt_off);
  float* vt_s = reinterpret_cast<float*>(smem + L::vt_off);
  float* k_s = reinterpret_cast<float*>(smem + L::k_off);
  float* ds_s = reinterpret_cast<float*>(smem + L::ds_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const size_t base = static_cast<size_t>(bh) * t_len * DH;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  load_rows<float, DH>(q + base, q_s, q0, t_len);
  load_rows<float, DH>(dout + base, do_s, q0, t_len);
  float lse_r[4], dl_r[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    const bool in = row < t_len;
    lse_r[i] = in ? lse[static_cast<size_t>(bh) * t_len + row] : 0.0f;
    dl_r[i] = in ? delta[static_cast<size_t>(bh) * t_len + row] : 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < t_len; k0 += kB) {
    __syncthreads();  // previous block done with kt_s / vt_s / k_s / ds_s
    load_rows_t<float, DH>(k + base, kt_s, k0, t_len);
    load_rows_t<float, DH>(v + base, vt_s, k0, t_len);
    load_rows<float, DH>(k + base, k_s, k0, t_len);
    __syncthreads();
    float s[4][4], dp[4][4];
    block_dots<DH>(q_s, kt_s, do_s, vt_s, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * cg + j;
        const float p = col < t_len ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        float dpv = dp[i][j];
        if (threshold)
          dpv = vit::positional_keep(seed, bh, row, col, threshold)
                    ? dpv * inv_keep
                    : 0.0f;
        ds[j] = p * (dpv - dl_r[i]) * scale;
      }
      *reinterpret_cast<float4*>(ds_s + (4 * rg + i) * kLdp + 4 * cg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ds_s[(4 * rg + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float kb = k_s[j * DH + cg * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], kb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= t_len) continue;
    const size_t o = base + static_cast<size_t>(row) * DH + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) dq[o + c] = acc[i][c];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_simt(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int t_len, float scale, uint32_t seed, int threshold,
                       float inv_keep) {
  using L = DkvSmem<DH>;
  constexpr int CW = DH / 16;
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
  const int k0 = blockIdx.x * kB;
  const size_t base = static_cast<size_t>(bh) * t_len * DH;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;  // rg: keys
  load_rows<float, DH>(k + base, k_s, k0, t_len);
  load_rows<float, DH>(v + base, v_s, k0, t_len);
  float dk_acc[4][CW], dv_acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int q0 = 0; q0 < t_len; q0 += kB) {
    __syncthreads();  // previous block done with the q-side tiles
    load_rows_t<float, DH>(q + base, qt_s, q0, t_len);
    load_rows_t<float, DH>(dout + base, dot_s, q0, t_len);
    load_rows<float, DH>(q + base, q_s, q0, t_len);
    load_rows<float, DH>(dout + base, do_s, q0, t_len);
    __syncthreads();
    // st[i][j] = k_i . q_j, dpt[i][j] = v_i . dO_j (i: key, j: query)
    float st[4][4], dpt[4][4];
    block_dots<DH>(k_s, qt_s, v_s, dot_s, rg, cg, st, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * rg + i;
      float pd[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * cg + j;
        const bool in = row < t_len;
        const size_t ri = static_cast<size_t>(bh) * t_len + row;
        const float p = in ? expf(st[i][j] * scale - lse[ri]) : 0.0f;
        const float dl = in ? delta[ri] : 0.0f;
        float dpv = dpt[i][j];
        pd[j] = p;
        if (threshold) {
          const bool keep = vit::positional_keep(seed, bh, row, key, threshold);
          pd[j] = keep ? p * inv_keep : 0.0f;
          dpv = keep ? dpv * inv_keep : 0.0f;
        }
        ds[j] = p * (dpv - dl) * scale;
      }
      *reinterpret_cast<float4*>(p_s + (4 * rg + i) * kLdp + 4 * cg) =
          make_float4(pd[0], pd[1], pd[2], pd[3]);
      *reinterpret_cast<float4*>(ds_s + (4 * rg + i) * kLdp + 4 * cg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = p_s[(4 * rg + i) * kLdp + j];
        sa[i] = ds_s[(4 * rg + i) * kLdp + j];
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float dob = do_s[j * DH + cg * CW + c];
        const float qb = q_s[j * DH + cg * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pa[i], dob, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qb, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * rg + i;
    if (key >= t_len) continue;
    const size_t o = base + static_cast<size_t>(key) * DH + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      dk[o + c] = dk_acc[i][c];
      dv[o + c] = dv_acc[i][c];
    }
  }
}

// ------------------------------------------------- dk/dv, bf16 wgmma
constexpr int kWgThreads = 160;  // warps 0-3: consumers, warp 4: producer

template <int DH>
struct DkvWgSmem {
  using L = hopper::Tile<DH>;
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + L::BYTES;
  // Stage s: q tile at q_off + 2 s BYTES, dO tile BYTES later; lse[64]
  // and delta[64] at vec_off + 512 s.
  static constexpr int q_off = v_off + L::BYTES;
  static constexpr int vec_off = q_off + 4 * L::BYTES;
  static constexpr int bar_off = vec_off + 2 * 512;
  // kv_full, qd_full[2], qd_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int t_len, float scale, uint32_t seed, int threshold,
                        float inv_keep) {
  using L = hopper::Tile<DH>;
  using S = DkvWgSmem<DH>;
  constexpr int NC = L::C / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* qd_full = bars + 1;
  uint64_t* qd_empty = bars + 3;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int nq = (t_len + 63) / 64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&qd_full[s], 1 + 32);
      hopper::mbar_init(&qd_empty[s], 128);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // Producer warp: lane 0 issues the TMA tile loads; every lane loads two
    // of the tile's 64 lse and delta values (zero past T) and arrives.
    const int lane = tid - 128;
    const size_t head = static_cast<size_t>(bh) * t_len;
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
        vec[r] = row < t_len ? lse[head + row] : 0.0f;
        vec[64 + r] = row < t_len ? delta[head + row] : 0.0f;
      }
      hopper::mbar_arrive(&qd_full[st]);
    }
    return;
  }

  // Consumer warpgroup. Thread (w, g, tq) holds keys 16 w + g (h = 0) and
  // 16 w + g + 8 (h = 1) of the block; S^T element 4 j + e sits at key half
  // e / 2, query column 8 j + 2 tq + e % 2.
  const int w = tid / 32, g = (tid % 32) / 4, tq = tid % 4;
  const uint32_t k_s = hopper::smem_u32(smem + S::k_off);
  const uint32_t v_s = hopper::smem_u32(smem + S::v_off);
  float dk_acc[L::NBOX][NC], dv_acc[L::NBOX][NC];
  float s[32], dp[32];
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int i = 0; i < NC; ++i) dk_acc[b][i] = dv_acc[b][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;

  hopper::mbar_wait(kv_full, 0);
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

    // S^T = K Q^T and dP^T = V dO^T over DH.
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(s, hopper::kmajor_desc<DH>(k_s, kk),
                               hopper::kmajor_desc<DH>(q_s, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(dp, hopper::kmajor_desc<DH>(v_s, kk),
                               hopper::kmajor_desc<DH>(do_s, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // s <- P_drop^T, dp <- dS^T, elementwise in the accumulator layout.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 16 * w + g + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * tq + (i % 2);
      const int row = q0 + c;
      const float p = row < t_len ? expf(s[i] * scale - lse_s[c]) : 0.0f;
      const float dl = dl_s[c];
      float pd = p, dpv = dp[i];
      if (threshold) {
        const bool keep = vit::positional_keep(seed, bh, row, key, threshold);
        pd = keep ? p * inv_keep : 0.0f;
        dpv = keep ? dpv * inv_keep : 0.0f;
      }
      s[i] = pd;
      dp[i] = p * (dpv - dl) * scale;
    }

    // dV += P_drop^T dO and dK += dS^T Q, A from registers, B MN-major.
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::acc_to_a(s, kk, pa[kk]);
      hopper::acc_to_a(dp, kk, sa[kk]);
    }
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) {
      hopper::fence_regs(dv_acc[b]);
      hopper::fence_regs(dk_acc[b]);
    }
    hopper::wg_fence();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<L::C>::template rs<1>(dv_acc[b], pa[kk],
                                   hopper::mnmajor_desc<DH>(do_s, b, kk), 1);
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<L::C>::template rs<1>(dk_acc[b], sa[kk],
                                   hopper::mnmajor_desc<DH>(q_s, b, kk), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) {
      hopper::fence_regs(dv_acc[b]);
      hopper::fence_regs(dk_acc[b]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(sa[kk]);
    }
    hopper::mbar_arrive(&qd_empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * w + g + 8 * h;
    if (key >= t_len) continue;
    const size_t o = (static_cast<size_t>(bh) * t_len + key) * DH;
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int j = 0; j < L::C / 8; ++j) {
        const int col = b * L::C + 8 * j + 2 * tq;
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dk + o + col) =
            __floats2bfloat162_rn(dk_acc[b][i], dk_acc[b][i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + col) =
            __floats2bfloat162_rn(dv_acc[b][i], dv_acc[b][i + 1]);
      }
  }
}

// ----------------------------------------------------- dq, bf16 wgmma
template <int DH>
struct DqWgSmem {
  using L = hopper::Tile<DH>;
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + L::BYTES;
  // Stage s: K tile at k_off + 2 s BYTES, V tile BYTES later.
  static constexpr int k_off = do_off + L::BYTES;
  static constexpr int vec_off = k_off + 4 * L::BYTES;  // lse[64], delta[64]
  static constexpr int bar_off = vec_off + 512;
  // qd_full, kv_full[2], kv_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int t_len, float scale,
                       uint32_t seed, int threshold, float inv_keep) {
  using L = hopper::Tile<DH>;
  using S = DqWgSmem<DH>;
  constexpr int NC = L::C / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* qd_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 3;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int nk = (t_len + 63) / 64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(qd_full, 1 + 32);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], 128);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // Producer warp: every lane copies two of the block's 64 lse and delta
    // values (zero past T) and arrives; lane 0 also loads the Q and dO
    // tiles, then streams the K and V tiles through the ring.
    const int lane = tid - 128;
    const size_t head = static_cast<size_t>(bh) * t_len;
    if (lane == 0) {
      hopper::mbar_expect_tx(qd_full, 2 * L::BYTES);
      hopper::tma_load_tile<DH>(smem + S::q_off, &map_q, qd_full, q0, bh);
      hopper::tma_load_tile<DH>(smem + S::do_off, &map_do, qd_full, q0, bh);
    }
    float* vec = reinterpret_cast<float*>(smem + S::vec_off);
#pragma unroll
    for (int r = lane; r < 64; r += 32) {
      const int row = q0 + r;
      vec[r] = row < t_len ? lse[head + row] : 0.0f;
      vec[64 + r] = row < t_len ? delta[head + row] : 0.0f;
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

  // Consumer warpgroup. Thread (w, g, tq) holds queries 16 w + g (h = 0)
  // and 16 w + g + 8 (h = 1) of the block; S element 4 j + e sits at query
  // half e / 2, key column 8 j + 2 tq + e % 2.
  const int w = tid / 32, g = (tid % 32) / 4, tq = tid % 4;
  const uint32_t q_s = hopper::smem_u32(smem + S::q_off);
  const uint32_t do_s = hopper::smem_u32(smem + S::do_off);
  float dq_acc[L::NBOX][NC];
  float s[32], dp[32];
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int i = 0; i < NC; ++i) dq_acc[b][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;

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

    // S = Q K^T and dP = dO V^T over DH.
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(s, hopper::kmajor_desc<DH>(q_s, kk),
                               hopper::kmajor_desc<DH>(k_s, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(dp, hopper::kmajor_desc<DH>(do_s, kk),
                               hopper::kmajor_desc<DH>(v_s, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // s <- dS = P (keep dP / keep - delta) scale, in the accumulator layout.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const int row = q0 + 16 * w + g + 8 * h;
      const int col = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
      const float p = col < t_len ? expf(s[i] * scale - lse_r[h]) : 0.0f;
      float dpv = dp[i];
      if (threshold)
        dpv = vit::positional_keep(seed, bh, row, col, threshold)
                  ? dpv * inv_keep
                  : 0.0f;
      s[i] = p * (dpv - dl_r[h]) * scale;
    }

    // dQ += dS K: dS from registers rounded to bf16, K read MN-major.
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(s, kk, sa[kk]);
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
    hopper::wg_fence();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<L::C>::template rs<1>(dq_acc[b], sa[kk],
                                   hopper::mnmajor_desc<DH>(k_s, b, kk), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(dq_acc[b]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(sa[kk]);
    hopper::mbar_arrive(&kv_empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * w + g + 8 * h;
    if (row >= t_len) continue;
    const size_t o = (static_cast<size_t>(bh) * t_len + row) * DH;
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int j = 0; j < L::C / 8; ++j) {
        const int col = b * L::C + 8 * j + 2 * tq;
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dq + o + col) =
            __floats2bfloat162_rn(dq_acc[b][i], dq_acc[b][i + 1]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o0, *o1;  // dq (dq kernel) or dk, dv (dk/dv kernel)
  int bh, t_len;
  float scale;
  uint32_t seed;
  int threshold;
  float inv_keep;
};

template <int DH>
cudaError_t launch_dq_simt(const Args& a, cudaStream_t s) {
  const size_t smem = DqSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_simt<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_simt<DH><<<dim3((a.t_len + kB - 1) / kB, a.bh), kThreads,
                          smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.o0), a.t_len, a.scale, a.seed,
      a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_simt(const Args& a, cudaStream_t s) {
  const size_t smem = DkvSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_simt<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_simt<DH><<<dim3((a.t_len + kB - 1) / kB, a.bh), kThreads,
                             smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.o0), static_cast<float*>(a.o1),
      a.t_len, a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_wgmma(const Args& a, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_tile_map<DH>(&mq, a.q, a.bh, a.t_len) ||
      !hopper::make_tile_map<DH>(&mk, a.k, a.bh, a.t_len) ||
      !hopper::make_tile_map<DH>(&mv, a.v, a.bh, a.t_len) ||
      !hopper::make_tile_map<DH>(&mdo, a.dout, a.bh, a.t_len))
    return cudaErrorInvalidValue;
  const int smem = DkvWgSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + 63) / 64, a.bh);
  flash_bwd_dkv_wgmma<DH><<<grid, kWgThreads, smem, s>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<bf16*>(a.o0),
      static_cast<bf16*>(a.o1), a.t_len, a.scale, a.seed, a.threshold,
      a.inv_keep);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_tile_map<DH>(&mq, a.q, a.bh, a.t_len) ||
      !hopper::make_tile_map<DH>(&mk, a.k, a.bh, a.t_len) ||
      !hopper::make_tile_map<DH>(&mv, a.v, a.bh, a.t_len) ||
      !hopper::make_tile_map<DH>(&mdo, a.dout, a.bh, a.t_len))
    return cudaErrorInvalidValue;
  const int smem = DqWgSmem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + 63) / 64, a.bh);
  flash_bwd_dq_wgmma<DH><<<grid, kWgThreads, smem, s>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<bf16*>(a.o0), a.t_len,
      a.scale, a.seed, a.threshold, a.inv_keep);
  return cudaGetLastError();
}

// bf16: the wgmma kernels; f32: the SIMT kernels.
template <int DH>
cudaError_t launch(int dtype, bool dkv, const Args& a, cudaStream_t s) {
  if (dtype == 1)
    return dkv ? launch_dkv_wgmma<DH>(a, s) : launch_dq_wgmma<DH>(a, s);
  if (dtype == 0)
    return dkv ? launch_dkv_simt<DH>(a, s) : launch_dq_simt<DH>(a, s);
  return cudaErrorInvalidValue;
}

int run(int dtype, int dh, bool dkv, const Args& a, void* stream) {
  if (a.bh <= 0 || a.bh > 65535 || a.t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return static_cast<int>(launch<32>(dtype, dkv, a, s));
    case 64:
      return static_cast<int>(launch<64>(dtype, dkv, a, s));
    case 128:
      return static_cast<int>(launch<128>(dtype, dkv, a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). q, k, v, dout and the outputs:
// [bh, t, dh] contiguous in dtype (0 = float32, 1 = bf16; the bf16 kernels
// read q, k, v and dout through TMA, 16-byte aligned), dh in {32, 64,
// 128}; lse, delta: [bh, t] float32. Return the cudaError_t of the map
// encoding, attribute call or launch (0 on success).
extern "C" int vit_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq,
                                int bh, int t_len, int dh, float scale,
                                uint32_t seed, int threshold, float inv_keep,
                                void* stream) {
  const Args a{q,     k,    v,         dout,    lse, delta, dq, nullptr, bh,
               t_len, scale, seed, threshold, inv_keep};
  return run(dtype, dh, false, a, stream);
}

extern "C" int vit_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk,
                                 void* dv, int bh, int t_len, int dh,
                                 float scale, uint32_t seed, int threshold,
                                 float inv_keep, void* stream) {
  const Args a{q,     k,    v,         dout,    lse, delta, dk, dv, bh,
               t_len, scale, seed, threshold, inv_keep};
  return run(dtype, dh, true, a, stream);
}
