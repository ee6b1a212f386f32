// Hopper (sm_90a) building blocks shared by the kernels that feed the
// tensor cores through the Tensor Memory Accelerator (qmm.cu's wgmma route,
// flash_bwd.cu's bf16 wgmma route): wgmma matrix descriptors for tiles in
// the 128-byte swizzle, wgmma issue and ordering, mbarriers, TMA and bulk
// copies, and the host-side tensor-map encoder.
//
// A tile in the 128-byte swizzle has rows of 128 bytes (64 bf16); 16-byte
// chunk c of row r is stored at chunk c ^ (r % 8); groups of 8 rows are
// 1024 bytes apart and the tile starts on a 1024-byte boundary. TMA writes
// this layout for a box whose inner extent is 128 bytes
// (CU_TENSOR_MAP_SWIZZLE_128B). The same bytes serve wgmma two ways: as a
// K-major operand (k runs along the row: `sw128_desc`, k steps of 16 add 2
// to the descriptor) and as an N-major operand of the transposed-B form (k
// runs down the rows: `sw128_n_desc`, k steps of 16 add 128).
//
// wgmma fragments (PTX ISA, "Matrix fragments for wgmma.mma_async
// m64nNk16"): warp w of the warpgroup owns rows 16 w .. 16 w + 15; with
// lane = 4 g + t, accumulator d[4 j + 2 r + e] is row 16 w + g + 8 r,
// column 8 j + 2 t + e. A from registers (four b32 of two bf16 each) for k
// columns 16 kk .. 16 kk + 15 is {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, so accumulator chunks 2 kk and 2 kk + 1, rounded to
// bf16 in pairs, are that A fragment as they stand (`acc_to_a`).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace msd {

// The descriptor of a K-major bf16 tile in the 128-byte swizzle (stride
// byte offset 1024 between 8-row groups; the leading offset is unused).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk c of row r in such a tile.
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The descriptor of an N-major bf16 tile in the 128-byte swizzle: atoms of
// 8 k rows x 64 columns (128 bytes a row, 16-byte chunk j of row r at
// j ^ r), 1024 bytes each; `n_stride` bytes between atoms along N (the
// leading byte offset), 1024 bytes between the 8-row groups along K (the
// stride byte offset).
__device__ __forceinline__ uint64_t sw128_n_desc(const void* tile, int n_stride) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(n_stride >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// Shared-memory writes of the threads become visible to the async proxy
// (wgmma, TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The warpgroup's registers a thread, raised or lowered (a multiple of 8 in
// 24..256; every warp of the warpgroup executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keeps the compiler from moving accesses to an accumulator across a
// wgmma issue or wait (the asm reads and writes every register).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MSD_WGMMA_D32                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),  \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define MSD_WGMMA_D32_REGS                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= a b for one m64n64k16 step, bf16 in, f32 sums: a a K-major tile
// in shared memory; b in shared memory, K-major (TRANS_B = 0) or N-major
// (TRANS_B = 1); d is overwritten when `accumulate` is 0.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MSD_WGMMA_D32_REGS
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : MSD_WGMMA_D32
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// d += a b for one m64n64k16 step with A in registers (the fragment named
// at the top of the file) and b in shared memory, K-major or N-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MSD_WGMMA_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : MSD_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
}

#undef MSD_WGMMA_D32
#undef MSD_WGMMA_D32_REGS

// The register A fragment of k step kk (columns 16 kk .. 16 kk + 15) of a
// 64 x N accumulator, each value rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// The initialized barriers become visible to the async proxy and the other
// threads (after the block's next barrier).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A 2-D box of `map` at (c0 innermost, c1) into shared memory; completion
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// A 4-D box of `map` at (c0 innermost, c1, c2, c3), as `tma_load`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      f = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A map of a `rank`-D tensor: dims[0] innermost (contiguous), strides[i]
// the bytes between steps of dimension i + 1, boxes of box[i] elements;
// elements out of bounds read as zero.
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map of a row-major [rows, cols] tensor, boxes of box_rows x
// box_cols elements.
inline bool make_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                        int elem_bytes, int rows, int cols, int box_rows, int box_cols,
                        CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return make_map(map, base, type, 2, dims, strides, box, swizzle);
}

}  // namespace msd
