// The warp-level tile engine of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) for NVIDIA Hopper (sm_90a): tensor-core products with
// mma.sync, 16-byte cp.async tile loads into shared memory, ldmatrix reads,
// and the 3xTF32 split that gives float32 products float32 accuracy on the
// TF32 tensor cores (ops/attention.py `split_tf32` and `einsum_3xtf32` are
// its plain versions).
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16 / m16n8k8"). In a
// warp, lane = 4 g + t (g = lane / 4 in 0..7, t = lane % 4 in 0..3).
//   bf16 m16n8k16: A (16 x 16, row-major) a0 = (g, 2t..2t+1),
//     a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..), two bf16 a
//     register, the lower column in the low half; B (16 x 8, k x n)
//     b0 = (2t..2t+1, g), b1 = (2t+8.., g).
//   tf32 m16n8k8: A (16 x 8) a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4),
//     a3 = (g+8, t+4); B (8 x 8) b0 = (t, g), b1 = (t+4, g).
//   f32 accumulators, both shapes: c0, c1 = (g, 2t..2t+1), c2, c3 =
//     (g+8, 2t..2t+1).
// An accumulator tile of scores (16 rows x 8 keys) feeds the A operand of
// the next product (p v, or dS k) without leaving registers. For bf16 two
// key tiles make one k16 step. For tf32 the thread holds keys 2t and 2t+1
// where A wants columns t and t+4, so the k index of that product is
// permuted: A column t is key 2t and column t+4 is key 2t+1, and the B
// operand reads rows 2t and 2t+1 (`tf32_p_fragment`, and the `2 t` row
// offsets in the kernels). A sum over k does not depend on the order of k,
// so this changes nothing but the order of the sums.
//
// Shared-memory rows of D float32 are padded to D + 4 floats, and of D
// bf16 to D + 8: rows then start 16 bytes apart modulo the 128-byte bank
// line, so the 32-bit fragment reads (row g, column t) and (row 2t, column
// g), and ldmatrix's eight 16-byte rows, touch 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msd {

constexpr float kLog2e = 1.4426950408889634f;

// exp(x) as the kernels take it: one ex2 on x log2(e), where x is already
// a difference s - m (so the scaling rounds a small number).
__device__ __forceinline__ float exp_diff(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero bytes are
// read (and 16 zero bytes written) when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b, bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, tf32 inputs, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// bit for bit what cvt.rna.tf32.f32 gives for every finite and infinite x
// (the carry of the half-ulp add rounds the magnitude, and runs into the
// exponent where it must), in two integer operations. The conversion
// instruction itself was the f32 kernels' bound on the card: the backward
// took 10.9 ms with it and 8.8 ms with this at 2048x2048, b=8 (PERF.md §6).
// Neither keeps every NaN: the instruction gives inf for a NaN whose payload
// lies in its low 13 bits, and the add carries the payload of the card's
// own NaN, 0x7fffffff, into the sign (-0). split_tf32 keeps NaN.
// msd_tf32_round_probe (flash_fwd.cu) holds both claims on the card.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An f32 operand as two TF32 terms, x ~ big + small: big = x rounded to
// TF32, small = the remainder (exact in f32) rounded the same way. big +
// small carries 22 of f32's 24 bits. The remainder is NaN exactly where x
// is NaN or inf, and then it is the card's NaN 0x7fffffff; clamped to
// 0x7fffefff (an integer min, which moves no finite remainder) it rounds
// to the NaN 0x7fffe000 instead of -0, so a NaN or inf operand makes every
// 3xTF32 product it enters NaN.
struct Tf32x2 {
  uint32_t big, small;
};

__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t big = round_tf32(x);
  const int rest = __float_as_int(x - __uint_as_float(big));
  return {big, round_tf32(__int_as_float(min(rest, 0x7fffefff)))};
}

// A 16 x 8 tf32 A fragment of f32 values, split.
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32x2 s = split_tf32(a[i]);
    f.big[i] = s.big;
    f.small[i] = s.small;
  }
  return f;
}

// The A fragment of p (one 16 x 8 accumulator tile of probabilities) for a
// product over keys, in the permuted key order named above.
__device__ __forceinline__ FragA tf32_p_fragment(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// c += a b with f32 accuracy from three TF32 products (3xTF32):
// small(a) big(b) + big(a) small(b) first, then big(a) big(b). The
// small x small term (below 2^-22 relative) is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, float b0, float b1) {
  const Tf32x2 s0 = split_tf32(b0), s1 = split_tf32(b1);
  mma_tf32(c, a.small, s0.big, s1.big);
  mma_tf32(c, a.big, s0.small, s1.small);
  mma_tf32(c, a.big, s0.big, s1.big);
}

// acc += part, element by element in f32 (N accumulator tiles).
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Whether a pointer allows 16-byte loads (host side, for `vec` below).
inline bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

// Stages rows [r0, r0 + ROWS) of a [len, head_dim] matrix (row stride `sl`
// elements) into shared memory with row stride LD; rows at or past len and
// columns at or past head_dim are zero. With `vec` (head_dim a multiple of
// 16 bytes, every row 16-byte aligned) as 16-byte cp.async copies that
// complete with the caller's next cp.async group; else element by element
// with plain loads, visible after the caller's next __syncthreads().
template <int ROWS, int D, int LD, int kThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int len, int head_dim,
                                          long long sl, bool vec) {
  constexpr int kChunk = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = D / kChunk;     // chunks per row
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kChunk;
      const bool ok = r0 + r < len && c < head_dim;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * sl + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * LD + c] = (r0 + r < len && c < head_dim) ? src[(long long)(r0 + r) * sl + c]
                                                      : from_f32<T>(0.f);
    }
  }
}

// A work item of the wgmma routes' persistent grids (flash_fwd_wgmma.cuh,
// flash_bwd_wgmma.cuh): `rows` rows from row0 of one (batch, head) over one
// range of key tiles (of all of them where a pass does not split the keys).
// Items are numbered with the row blocks fastest, then the key range, the
// head and the batch; block i of a grid of at most one block an SM takes
// items i, i + gridDim.x, ...
struct Item {
  int row0, split, h, b;
};

__device__ __forceinline__ Item item_of(int item, int rows, int row_blocks, int splits,
                                        int heads) {
  Item w;
  w.row0 = item % row_blocks * rows;
  const int rest = item / row_blocks;
  w.split = rest % splits;
  w.h = rest / splits % heads;
  w.b = rest / splits / heads;
  return w;
}

}  // namespace msd
