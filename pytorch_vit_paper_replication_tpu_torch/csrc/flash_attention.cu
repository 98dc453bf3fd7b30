// Flash-attention forward: online softmax over K/V blocks.
//
// Replaces the JAX package's Pallas kernel
// ops/flash_attention.py::_fwd_kernel (pallas_call in _fwd): q of q_len
// rows against k, v of kv_len rows, positional attention dropout, and the
// attention mask in every form _normalize_mask folds (vit_common.cuh's
// FlashMask).
//
// The mask is a template flag of both kernels, so mask=None keeps its code
// and times. With a mask, logits of masked keys take the fill -1e30 like
// keys past kv_len, and P is zeroed wherever the fill stands, as the Pallas
// kernel zeroes p where s carries it: a query row that attends to no key
// keeps l = 0, so the l == 0 guard gives it a zero output and lse = -1e30.
// The mask comes packed into bits (vit_common.cuh's FlashMask): a thread
// loads one 64-bit word per query row and key tile, a tile ahead, and
// tests its keys' bits with constant masks (vit::TileBits).
//
// What bounds it on an H100: at ViT-B/16 shapes (B*H = 384, Dh = 64) the
// work is 4*BH*T^2*Dh FLOP against reading q, k, v and writing out + lse
// once; at T = 197 the bytes bound it, at T = 577 the two are close. The
// flash design point is that the [T, T] logits never go to device memory.
//
// Two kernels, chosen by the operands' dtype (not a fallback: each dtype
// has exactly one kernel, and a kernel that fails raises):
//
// bf16 — flash_fwd_wgmma, the Hopper design (csrc/hopper.cuh):
//   * One CTA per (b*h, 64-row query block): one consumer warpgroup (4
//     warps) that owns the 64 rows and one producer warp that issues TMA
//     tile loads. Q is loaded once; K/V blocks of 64 keys stream through a
//     2-stage ring (full/empty mbarriers), so the next block is in flight
//     while the current one is multiplied.
//   * S = Q K^T and O += P V are wgmma (bf16 operands, f32 accumulators in
//     registers); Q, K from shared memory K-major, V MN-major, P from
//     registers (the S accumulator rounded to bf16: the one rounding point
//     the Pallas kernel, which multiplies in f32, does not have).
//   * Tiles use the 128-byte swizzle (64-byte for Dh = 32) named by both
//     the TMA map and the wgmma descriptors; the maps are 3-D (Dh, T, B*H)
//     so rows past T of a head load as zeros. Keys past kv_len (and masked
//     keys) get logit -1e30.
//   * Softmax in the accumulator layout: a row is spread over the 4
//     threads of a quad (2 shuffles). Dropout: the keep bit from the
//     positional hash on (seed, b*h, row, col) of each accumulator element,
//     after the undropped normalizer is updated; out = acc / (l * keep).
//   * l == 0 guard as in the Pallas kernel; lse = m + log(l) per row.
//
// f32 — flash_fwd_simt: all math in f32 like the Pallas kernel (which
// upcasts q, k and v before both products), SIMT FMA,
// 256 threads per 64-row block (thread (rg, cg) owns rows 4 rg.., logit
// columns 4 cg.. and output columns cg Dh/16..). TF32 would break the f32
// bounds, so f32 keeps it.
#include "hopper.cuh"
#include "vit_common.cuh"

using vit::bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kLdp = kBK + 4;
constexpr float kNegInf = -1e30f;

template <int DH>
struct FlashSmem {
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + kBQ * DH * 4;
  static constexpr size_t v_off = k_off + DH * kBK * 4;
  static constexpr size_t p_off = v_off + kBK * DH * 4;
  static constexpr size_t bytes = p_off + kBQ * kLdp * 4;
};

template <int DH, bool MASK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, vit::FlashMask mask, int q_len,
                   int kv_len, float scale, uint32_t seed, int threshold,
                   float keep_prob) {
  using L = FlashSmem<DH>;
  constexpr int CW = DH / 16;  // output columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q_off);   // [BQ][DH]
  float* kt_s = reinterpret_cast<float*>(smem + L::k_off);  // [DH][BK]
  float* v_s = reinterpret_cast<float*>(smem + L::v_off);   // [BK][DH]
  float* p_s = reinterpret_cast<float*>(smem + L::p_off);   // [BQ][kLdp]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * q_len * DH;
  const size_t kbase = static_cast<size_t>(bh) * kv_len * DH;
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  // The mask rows of this thread's 4 query rows (rows past q_len, never
  // stored, read row q_len - 1).
  const uint64_t* mrow[4];
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mrow[i] = mask.row_of(bh, min(q0 + 4 * rg + i, q_len - 1), q_len,
                            kv_len);
  }

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    q_s[i] = (q0 + r < q_len)
                 ? q[qbase + static_cast<size_t>(q0 + r) * DH + d]
                 : 0.0f;
  }

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBK) {
    __syncthreads();  // previous block done with kt_s / v_s / p_s
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i % kBK, d = i / kBK;
      kt_s[d * kBK + c] =
          (k0 + c < kv_len)
              ? k[kbase + static_cast<size_t>(k0 + c) * DH + d]
              : 0.0f;
    }
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      v_s[i] = (k0 + c < kv_len)
                   ? v[kbase + static_cast<size_t>(k0 + c) * DH + d]
                   : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < DH; ++d) {
      const float4 kb = *reinterpret_cast<const float4*>(kt_s + d * kBK + 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qa = q_s[(4 * rg + i) * DH + d];
        s[i][0] = fmaf(qa, kb.x, s[i][0]);
        s[i][1] = fmaf(qa, kb.y, s[i][1]);
        s[i][2] = fmaf(qa, kb.z, s[i][2]);
        s[i][3] = fmaf(qa, kb.w, s[i][3]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float rmax = kNegInf;
      bool att[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * cg + j;
        att[j] = MASK ? vit::mask_bit(mrow[i], col) : col < kv_len;
        s[i][j] = att[j] ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xFFFFFFFFu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      float p[4], rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        // Zero P where the fill stands (a fully masked row has m_new at
        // the fill, where exp gives 1).
        if constexpr (MASK) p[j] = att[j] ? p[j] : 0.0f;
        rsum += p[j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xFFFFFFFFu, rsum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
      if (threshold) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!vit::positional_keep(seed, bh, row, k0 + 4 * cg + j, threshold))
            p[j] = 0.0f;
      }
      *reinterpret_cast<float4*>(p_s + (4 * rg + i) * kLdp + 4 * cg) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(4 * rg + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vb = v_s[j * DH + cg * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= q_len) continue;
    const float l_safe = (l[i] == 0.0f) ? 1.0f : l[i];
    const float denom = l_safe * keep_prob;
    const size_t o = qbase + static_cast<size_t>(row) * DH + cg * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) out[o + c] = acc[i][c] / denom;
    if (cg == 0) lse[static_cast<size_t>(bh) * q_len + row] = m[i] + logf(l_safe);
  }
}


// ------------------------------------------------------------ bf16 wgmma
constexpr int kWgThreads = 160;  // warps 0-3: consumers, warp 4: producer

// CTAs an SM must hold: at Dh <= 64 the mask's words and bit tests take
// ptxas from 124 registers a thread to 158 (Dh = 64), from three CTAs of
// 160 threads an SM to two, so the masked instantiation asks for the
// unmasked one's three. Unmasked, and at wider Dh, the bound stays 1.
template <int DH, bool MASK>
constexpr int fwd_min_ctas() {
  return MASK && DH <= 64 ? 3 : 1;
}

template <int DH>
struct WgSmem {
  using L = hopper::Tile<DH>;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + L::BYTES;      // [2] stages
  static constexpr int v_off = k_off + 2 * L::BYTES;  // [2] stages
  static constexpr int bar_off = v_off + 2 * L::BYTES;
  // q_full, kv_full[2], kv_empty[2]; + 1024 to align the base.
  static constexpr int bytes = bar_off + 5 * 8 + 1024;
};

template <int DH, bool MASK>
__global__ void __launch_bounds__(kWgThreads, (fwd_min_ctas<DH, MASK>()))
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    vit::FlashMask mask, int q_len, int kv_len, float scale,
                    uint32_t seed, int threshold, float keep_prob) {
  using L = hopper::Tile<DH>;
  using S = WgSmem<DH>;
  constexpr int NC = L::C / 2;  // accumulator registers per output box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* q_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* kv_empty = bars + 3;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int nk = (kv_len + 63) / 64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], 128);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp: one thread issues every load
    if (tid == 128) {
      hopper::mbar_expect_tx(q_full, L::BYTES);
      hopper::tma_load_tile<DH>(smem + S::q_off, &map_q, q_full, q0, bh);
      for (int it = 0; it < nk; ++it) {
        const int st = it & 1;
        hopper::mbar_wait(&kv_empty[st], ((it >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&kv_full[st], 2 * L::BYTES);
        hopper::tma_load_tile<DH>(smem + S::k_off + st * L::BYTES, &map_k,
                                  &kv_full[st], it * 64, bh);
        hopper::tma_load_tile<DH>(smem + S::v_off + st * L::BYTES, &map_v,
                                  &kv_full[st], it * 64, bh);
      }
    }
    return;
  }

  // Consumer warpgroup. Thread (w, g, tq) holds rows 16 w + g (h = 0) and
  // 16 w + g + 8 (h = 1) of the block; accumulator element 4 j + e sits at
  // row half e / 2, column 8 j + 2 tq + e % 2.
  const int w = tid / 32, g = (tid % 32) / 4, tq = tid % 4;
  const uint32_t q_s = hopper::smem_u32(smem + S::q_off);
  // The mask rows of the thread's two query rows (rows past q_len, never
  // stored, read row q_len - 1).
  const uint64_t* mrow[2];
  if constexpr (MASK) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mrow[h] = mask.row_of(bh, min(q0 + 16 * w + g + 8 * h, q_len - 1),
                            q_len, kv_len);
  }
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  float o[L::NBOX][NC];
  float s[32];
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int i = 0; i < NC; ++i) o[b][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  // With a mask, the words of the two rows for the next key tile, loaded
  // one tile ahead so their latency hides behind a whole tile.
  uint64_t mw_next[2] = {0, 0};
  if constexpr (MASK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) mw_next[h] = __ldg(mrow[h]);
  }
  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    const int k0 = it * 64;
    const uint32_t k_s = hopper::smem_u32(smem + S::k_off + st * L::BYTES);
    const uint32_t v_s = hopper::smem_u32(smem + S::v_off + st * L::BYTES);
    hopper::mbar_wait(&kv_full[st], (it >> 1) & 1);

    // S = Q K^T over DH in k-steps of 16.
    hopper::fence_regs(s);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(s, hopper::kmajor_desc<DH>(q_s, kk),
                               hopper::kmajor_desc<DH>(k_s, kk), kk > 0);
    hopper::wg_commit();
    // With a mask, this tile's bits of the two rows, and the next tile's
    // words in flight.
    vit::TileBits tb[2];
    if constexpr (MASK) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tb[h] = vit::tile_bits_of(mw_next[h], tq);
        if (it + 1 < nk) mw_next[h] = __ldg(mrow[h] + it + 1);
      }
    }
    hopper::wg_wait<0>();
    hopper::fence_regs(s);

    // Online softmax on the two rows this thread holds.
    float rmax[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
      const bool a = MASK ? vit::tile_bit(tb[(i / 2) % 2], i) : col < kv_len;
      s[i] = a ? s[i] * scale : -1e30f;
      rmax[(i / 2) % 2] = fmaxf(rmax[(i / 2) % 2], s[i]);
    }
    float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xFFFFFFFFu, rmax[h], 1));
      rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xFFFFFFFFu, rmax[h], 2));
      rmax[h] = fmaxf(m[h], rmax[h]);
      corr[h] = expf(m[h] - rmax[h]);
      m[h] = rmax[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - m[(i / 2) % 2]);
      // Zero P where the fill stands (see the header).
      if constexpr (MASK) s[i] = vit::tile_bit(tb[(i / 2) % 2], i) ? s[i] : 0.0f;
      rsum[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xFFFFFFFFu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xFFFFFFFFu, rsum[h], 2);
      l[h] = l[h] * corr[h] + rsum[h];
    }
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int i = 0; i < NC; ++i) o[b][i] *= corr[(i / 2) % 2];
    if (threshold) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = q0 + 16 * w + g + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + 2 * tq + (i % 2);
        if (!vit::positional_keep(seed, bh, row, col, threshold)) s[i] = 0.0f;
      }
    }

    // O += P V: P from registers (bf16), V MN-major, one wgmma per box.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(s, kk, pa[kk]);
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(o[b]);
    hopper::wg_fence();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Wgmma<L::C>::template rs<1>(o[b], pa[kk],
                                   hopper::mnmajor_desc<DH>(v_s, b, kk), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b) hopper::fence_regs(o[b]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
    hopper::mbar_arrive(&kv_empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * w + g + 8 * h;
    if (row >= q_len) continue;
    const float l_safe = (l[h] == 0.0f) ? 1.0f : l[h];
    const float denom = l_safe * keep_prob;
    bf16* orow = out + (static_cast<size_t>(bh) * q_len + row) * DH;
#pragma unroll
    for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
      for (int j = 0; j < L::C / 8; ++j) {
        const int col = b * L::C + 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[b][4 * j + 2 * h] / denom, o[b][4 * j + 2 * h + 1] / denom);
      }
    if (tq == 0) lse[static_cast<size_t>(bh) * q_len + row] = m[h] + logf(l_safe);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  vit::FlashMask mask;
  int bh, q_len, kv_len;
  float scale;
  uint32_t seed;
  int threshold;
  float keep_prob;
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
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hopper::make_tile_map<DH>(&mq, a.q, a.bh, a.q_len) ||
      !hopper::make_tile_map<DH>(&mk, a.k, a.bh, a.kv_len) ||
      !hopper::make_tile_map<DH>(&mv, a.v, a.bh, a.kv_len))
    return cudaErrorInvalidValue;
  return start(flash_fwd_wgmma<DH, MASK>, WgSmem<DH>::bytes,
               dim3((a.q_len + 63) / 64, a.bh), kWgThreads, stream, mq, mk,
               mv, static_cast<bf16*>(a.out), a.lse, a.mask, a.q_len,
               a.kv_len, a.scale, a.seed, a.threshold, a.keep_prob);
}

// ------------------------------------------------------------- f32 SIMT
template <int DH, bool MASK>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  return start(flash_fwd_simt<DH, MASK>,
               static_cast<int>(FlashSmem<DH>::bytes),
               dim3((a.q_len + kBQ - 1) / kBQ, a.bh), kThreads, stream,
               static_cast<const float*>(a.q), static_cast<const float*>(a.k),
               static_cast<const float*>(a.v), static_cast<float*>(a.out),
               a.lse, a.mask, a.q_len, a.kv_len, a.scale, a.seed, a.threshold,
               a.keep_prob);
}

template <int DH, bool MASK>
cudaError_t launch(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 1) return launch_wgmma<DH, MASK>(a, s);
  if (dtype == 0) return launch_simt<DH, MASK>(a, s);
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(int dtype, const Args& a, cudaStream_t s) {
  return a.mask.bits ? launch<DH, true>(dtype, a, s)
                    : launch<DH, false>(dtype, a, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, out: [bh, q_len, dh]; k, v:
// [bh, kv_len, dh], contiguous in dtype (0 = float32: the SIMT kernel; 1 =
// bf16: the wgmma kernel, operands 16-byte aligned for TMA), dh in {32, 64,
// 128, 256}; lse: [bh, q_len] float32. mask: null, or the folded mask's
// bits [G, q_len or 1, ceil(kv_len / 64)] uint64 of vit::FlashMask with its
// mode (0 full, 1 batch, 2 head, 3 one), the head count and q_bcast (8-byte
// aligned). Returns the cudaError_t of
// the map encoding, attribute call or launch (0 on success).
extern "C" int vit_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* out, float* lse,
                             const void* mask, int mask_mode, int heads,
                             int q_bcast, int bh, int q_len, int kv_len,
                             int dh, float scale, uint32_t seed,
                             int threshold, float keep_prob, void* stream) {
  if (bh <= 0 || bh > 65535 || q_len <= 0 || kv_len <= 0 ||
      (mask && (mask_mode < 0 || mask_mode > 3 || heads <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const vit::FlashMask m{static_cast<const uint64_t*>(mask), mask_mode, heads,
                         q_bcast};
  const Args a{q,  k,      v,     out,       lse,      m,
               bh, q_len, kv_len, scale, seed, threshold, keep_prob};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return static_cast<int>(launch<32>(dtype, a, s));
    case 64:
      return static_cast<int>(launch<64>(dtype, a, s));
    case 128:
      return static_cast<int>(launch<128>(dtype, a, s));
    case 256:
      return static_cast<int>(launch<256>(dtype, a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
