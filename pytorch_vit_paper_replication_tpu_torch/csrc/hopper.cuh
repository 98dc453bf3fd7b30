// Hopper (sm_90a) building blocks for the port's tensor-core kernels:
// TMA tile loads completing on mbarriers, wgmma shared-memory descriptors
// for the 128- and 64-byte swizzles, and the bf16 wgmma instructions
// (f32 accumulators in registers) with A from shared memory or from
// registers, and 2-D TMA maps of row-major matrices. Inline PTX only, so a source that includes this header still
// builds in seconds with a plain C interface.
//
// Layout contract shared by the TMA maps (make_tile_map) and the wgmma
// descriptors (kmajor_desc, mnmajor_desc): a [64, DH] bf16 tile is stored
// as DH / C boxes of [64 rows][C columns], C = min(DH, 64), each box
// swizzled with an SW = 2 C byte pattern (128 bytes for DH >= 64, 64
// bytes for DH = 32) and boxes placed one after the other.
//
// Row-major 2-D matrices (make_rows_map, the GEMMs of the MLP backward)
// follow one contract too: boxes of [R rows][64 columns] bf16 with the
// 128-byte swizzle, so one row of a box is one 128-byte swizzle row and
// 8-row groups sit 1024 bytes apart. Read K-major (the 64 columns are the
// reduction) a box feeds rows_kmajor_desc; read MN-major (the rows are the
// reduction) consecutive boxes of 64 columns each feed rows_mnmajor_desc,
// whose leading-byte offset steps from one box to the next.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

// ------------------------------------------------------------ addresses
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that
// outlasts ~2^35 cycles (over 10 s) can only be a protocol fault: trap, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      if (t0 == 0)
        t0 = clock64();
      else if (clock64() - t0 > (1ll << 35))
        __trap();
    }
  }
}

// ------------------------------------------------------ named barriers
// Barrier `id` (1..15; 0 is __syncthreads) across N threads: sync waits
// until N threads have arrived (its own included), arrive counts without
// waiting. Shared-memory writes before an arrive are visible after the
// matching sync. Two warpgroups hand work to each other with N = 256.
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// Move registers between warpgroups (every thread of the warpgroup runs
// it, once, on a path that does not rejoin the other warpgroups'): a
// producer warpgroup gives up registers, the consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// A [64, DH] tile at rows y.. of head z: DH / C boxes, C columns each.
template <int DH>
struct Tile {
  static constexpr int C = DH < 64 ? DH : 64;  // columns per box
  static constexpr int SW = 2 * C;             // swizzle bytes: 128 or 64
  static constexpr int BOX = 64 * SW;          // bytes of one box
  static constexpr int NBOX = DH / C;
  static constexpr int BYTES = NBOX * BOX;     // = 64 * DH * 2
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma swizzle code
  static_assert(DH % 32 == 0 && DH <= 256, "DH in {32, 64, 128, 256}");
};

template <int DH>
__device__ __forceinline__ void tma_load_tile(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int y, int z) {
#pragma unroll
  for (int b = 0; b < Tile<DH>::NBOX; ++b)
    tma_load_3d(dst + b * Tile<DH>::BOX, map, bar, b * Tile<DH>::C, y, z);
}

// ------------------------------------------------------ wgmma operands
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// The 16 columns kk*16.. of a [64, DH] tile read K-major (rows are M or
// N, DH is the reduction): 8-row groups SBO = 8 SW bytes apart, a k-step
// moves 32 bytes inside the swizzled row.
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using L = Tile<DH>;
  const int col = kk * 16;
  return make_desc(tile + (col / L::C) * L::BOX + (col % L::C) * 2, 16,
                   8 * L::SW, L::LAYOUT);
}

// Rows kk*16.. (the reduction) and columns n*C.. (N) of a [64, DH] tile
// read MN-major (the transpose bf16 allows): box n, 8-row groups SBO =
// 8 SW bytes apart; one swizzle atom spans the instruction's N = C.
template <int DH>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int n,
                                                 int kk) {
  using L = Tile<DH>;
  return make_desc(tile + n * L::BOX + kk * 16 * L::SW, L::BOX, 8 * L::SW,
                   L::LAYOUT);
}

// Row-major boxes (128-byte swizzle, 128-byte rows). K-major: the 16
// reduction columns at byte `col_bytes` of rows starting at `rows`.
__device__ __forceinline__ uint64_t rows_kmajor_desc(uint32_t rows,
                                                     int col_bytes) {
  return make_desc(rows + col_bytes, 16, 1024, 1);
}
// MN-major: reduction rows starting at `rows` of a box whose next 64
// columns (the next swizzle atom along M or N) lie `box_bytes` further.
__device__ __forceinline__ uint64_t rows_mnmajor_desc(uint32_t rows,
                                                      uint32_t box_bytes) {
  return make_desc(rows, box_bytes, 1024, 1);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to accumulators or A fragments
// across an asynchronous wgmma (issue ... wait): fence them after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two f32 -> one bf16x2 register (lo = the lower column), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a k-step over columns 16 kk.. taken from an m64nN
// f32 accumulator (the register layouts line up: element 4j + e holds
// row g + 8 (e / 2), column 8 j + 2 tq + e % 2 of the warp's 16 rows).
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], int kk,
                                         uint32_t (&a)[4]) {
  const int j0 = 8 * kk;  // 4 * (2 kk)
  a[0] = pack_bf16(acc[j0 + 0], acc[j0 + 1]);
  a[1] = pack_bf16(acc[j0 + 2], acc[j0 + 3]);
  a[2] = pack_bf16(acc[j0 + 4], acc[j0 + 5]);
  a[3] = pack_bf16(acc[j0 + 6], acc[j0 + 7]);
}

// D (m64 x N, f32, N / 2 registers a thread) += A (m64 x k16, bf16) * B
// (k16 x N, bf16). ss: A and B by descriptor; rs: A from registers. TB = 1
// reads B MN-major (TA = 1, A). scale_d = 0 overwrites D. The flash kernels
// use ss at N = 64 (the logits; N = 16 for a ragged last tile of at most 16
// rows) and rs at N = C (the output boxes); the MLP GEMMs ss at N = 128,
// either operand K-major or MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // TA / TB = 1 read A / B MN-major (transposed), 0 K-major.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// ------------------------------------------------ host: tensor maps
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda at link time); nullptr when the driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a contiguous bf16 [bh, t, DH] tensor read in [64, C] boxes
// (Tile<DH>): 3-D (DH, t, bh), so rows past t inside a head read as zeros.
template <int DH>
inline bool make_tile_map(CUtensorMap* map, const void* ptr, int bh, int t) {
  using L = Tile<DH>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(t) * DH * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::C), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a contiguous row-major bf16 [outer, inner] matrix read in
// boxes of [box_rows][64] with the 128-byte swizzle; rows and columns past
// the matrix read as zeros. inner * 2 must be a multiple of 16 bytes.
inline bool make_rows_map(CUtensorMap* map, const void* ptr, int inner,
                          int outer, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
