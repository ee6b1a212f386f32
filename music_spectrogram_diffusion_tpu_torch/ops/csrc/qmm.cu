// Weight-only int8 GEMM for NVIDIA Hopper (sm_90a), with a plain C entry point
// loaded through ctypes (no PyTorch headers, no CUTLASS, no cuBLAS).
//
// Replaces the TPU kernel in music_spectrogram_diffusion_tpu/ops/quantize.py:
// `_qmm_pallas` (the pallas_call) and `_qmm_kernel`. It computes
//
//     out[m, n] = cast_out( scale[n] * sum_k bf16(x[m, k]) * bf16(q[k, n]) )
//
// x is f32 or bf16 [M, K] and is rounded to bf16 (as `_qmm_kernel` does);
// q is int8 [K, N], row-major (the Flax layout), widened to bf16, which is
// exact for |q| <= 127; every product is exact in f32 and the sum is f32; the
// per-column scale multiplies the f32 sum once, in the epilogue; out is f32
// or bf16 [M, N]. K must be a multiple of 32 and N of 64 (the serving tree's
// quantized kernels have both multiples of 128); rows past M are masked.
//
// What bounds it on the card: at the serving shapes (M = 1-2 for the FiLM
// and time-embedding projections, 256-2304 for the rest; K, N in 768-3072)
// the weight is read once in int8, 1 byte an element. For M below ~300 the
// int8 weight bytes dominate and the bound is HBM (3.35 TB/s); above, the
// 2·M·K·N products at the bf16 tensor-core rate (989 TFLOP/s) are. What the
// design does about it: the weight never exists in bf16 outside shared
// memory (one 16-byte load per thread brings 16 int8 values of a 32x64 tile,
// widened in registers), x is staged once per K step in shared memory as
// bf16, the products run on the tensor cores through wmma bf16 16x16x16
// fragments with f32 accumulators, and the next K step's global loads are in
// flight (held in registers) while the current step's products run. The M
// tile is 16 rows for M <= 16, so a 1-2 row call wastes at most a 16-row
// tile, else 64. Most serving calls have too few output tiles to fill 132
// SMs (24 blocks for a FiLM projection at M <= 16), and each block's K loop
// is a chain of dependent loads, so the caller may split K: `splits` blocks
// share one output tile, each writes its unscaled f32 partial sum to a
// workspace, and a second kernel adds the partials in a fixed order (the
// result does not depend on scheduling), scales and casts. No wgmma, no
// TMA, no cp.async pipeline: those are later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBlockN = 64;    // output columns per block
constexpr int kBlockK = 32;    // K per shared-memory step
constexpr int kThreads = 128;  // four warps
constexpr int kPadA = 8;       // bf16 row padding of the x tile (16 bytes)
constexpr int kPadB = 8;       // bf16 row padding of the weight tile
constexpr int kPadC = 4;       // f32 row padding of the output tile
constexpr int kLdA = kBlockK + kPadA;
constexpr int kLdB = kBlockN + kPadB;
constexpr int kLdC = kBlockN + kPadC;

// Values of x in one 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };

// Store one 16-byte chunk of x as bf16 into shared memory.
__device__ __forceinline__ void stage_x(__nv_bfloat16* dst, const uint4& v, const float*) {
  const float* f = reinterpret_cast<const float*>(&v);
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(f[0], f[1]), __floats2bfloat162_rn(f[2], f[3])};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}
__device__ __forceinline__ void stage_x(__nv_bfloat16* dst, const uint4& v, const __nv_bfloat16*) {
  *reinterpret_cast<uint4*>(dst) = v;
}

// Store 16 int8 weights as 16 bf16 (exact) into shared memory.
__device__ __forceinline__ void stage_q(__nv_bfloat16* dst, const uint4& v) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  __nv_bfloat162 h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = __floats2bfloat162_rn(static_cast<float>(b[2 * j]), static_cast<float>(b[2 * j + 1]));
  }
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(h)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(h)[1];
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(a, b), __floats2bfloat162_rn(c, d)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <int BM, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, TOut* __restrict__ out,
           float* __restrict__ partial, int M, int K, int N, int k_per_split) {
  // Warps over the (BM, 64) output tile: 2x2 warps of 32x32 for BM = 64,
  // 1x4 warps of 16x16 for BM = 16.
  constexpr int kWarpsM = BM == 64 ? 2 : 1;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int kFragM = BM / kWarpsM / 16;
  constexpr int kFragN = kBlockN / kWarpsN / 16;
  constexpr int kXPerChunk = Vec<TIn>::kN;
  constexpr int kXChunksPerRow = kBlockK / kXPerChunk;
  constexpr int kXChunks = BM * kXChunksPerRow;
  constexpr int kXIters = (kXChunks + kThreads - 1) / kThreads;
  static_assert(kBlockK * kBlockN / 16 == kThreads, "one weight chunk per thread");

  __shared__ __align__(128) __nv_bfloat16 s_x[BM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 s_q[kBlockK * kLdB];
  __shared__ __align__(128) float s_out[BM * kLdC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;

  // This thread's weight chunk: 16 consecutive columns of one K row.
  const int q_row = tid / (kBlockN / 16);
  const int q_col = (tid % (kBlockN / 16)) * 16;
  const int8_t* q_src = q + static_cast<long long>(q_row) * N + n0 + q_col;

  uint4 x_reg[kXIters];
  uint4 q_reg;

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXIters; ++i) {
      const int v = tid + i * kThreads;
      x_reg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kXChunks) {
        const int m = m0 + v / kXChunksPerRow;
        if (m < M) {
          x_reg[i] = *reinterpret_cast<const uint4*>(
              x + static_cast<long long>(m) * K + k0 + (v % kXChunksPerRow) * kXPerChunk);
        }
      }
    }
    q_reg = *reinterpret_cast<const uint4*>(q_src + static_cast<long long>(k0) * N);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  const int num_k = k_per_split / kBlockK;
  load(k_begin);
  for (int kt = 0; kt < num_k; ++kt) {
#pragma unroll
    for (int i = 0; i < kXIters; ++i) {
      const int v = tid + i * kThreads;
      if (v < kXChunks) {
        stage_x(s_x + (v / kXChunksPerRow) * kLdA + (v % kXChunksPerRow) * kXPerChunk, x_reg[i],
                x);
      }
    }
    stage_q(s_q + q_row * kLdB + q_col, q_reg);
    __syncthreads();
    if (kt + 1 < num_k) load(k_begin + (kt + 1) * kBlockK);  // in flight during the products

#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i) {
        wmma::load_matrix_sync(a[i], s_x + (warp_m * kFragM * 16 + i * 16) * kLdA + kk, kLdA);
      }
#pragma unroll
      for (int j = 0; j < kFragN; ++j) {
        wmma::load_matrix_sync(b[j], s_q + kk * kLdB + warp_n * kFragN * 16 + j * 16, kLdB);
      }
#pragma unroll
      for (int i = 0; i < kFragM; ++i) {
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(
          s_out + (warp_m * kFragM * 16 + i * 16) * kLdC + warp_n * kFragN * 16 + j * 16,
          acc[i][j], kLdC, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Epilogue, four outputs per thread step: without a split, scale each
  // column once and store; with one, store this K range's f32 partial sum.
  constexpr int kOutVecsPerRow = kBlockN / 4;
  for (int v = tid; v < BM * kOutVecsPerRow; v += kThreads) {
    const int r = v / kOutVecsPerRow;
    const int c = (v % kOutVecsPerRow) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    const float* a = s_out + r * kLdC + c;
    const long long at = static_cast<long long>(m) * N + n0 + c;
    if (partial != nullptr) {
      store4(partial + static_cast<long long>(blockIdx.z) * M * N + at, a[0], a[1], a[2], a[3]);
    } else {
      const float4 s = *reinterpret_cast<const float4*>(scale + n0 + c);
      store4(out + at, a[0] * s.x, a[1] * s.y, a[2] * s.z, a[3] * s.w);
    }
  }
}

// out = cast(scale * sum of the split partials, in split order); four
// outputs per thread (N % 64 == 0, so four never cross a row).
template <typename TOut>
__global__ void __launch_bounds__(256)
qmm_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                  TOut* __restrict__ out, int M, int N, int splits) {
  const long long size = static_cast<long long>(M) * N;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= size) return;
  float4 acc = *reinterpret_cast<const float4*>(partial + i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(partial + z * size + i);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const float4 s = *reinterpret_cast<const float4*>(scale + i % N);
  store4(out + i, acc.x * s.x, acc.y * s.y, acc.z * s.z, acc.w * s.w);
}

template <int BM, typename TIn, typename TOut>
int launch(const void* x, const void* q, const float* scale, void* out, float* workspace, int M,
           int K, int N, int splits, cudaStream_t stream) {
  const dim3 grid(N / kBlockN, (M + BM - 1) / BM, splits);
  qmm_kernel<BM, TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(q), scale, static_cast<TOut*>(out),
      splits > 1 ? workspace : nullptr, M, K, N, K / splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long vecs = static_cast<long long>(M) * N / 4;
  qmm_reduce_kernel<TOut><<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
      workspace, scale, static_cast<TOut*>(out), M, N, splits);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int dispatch(const void* x, const void* q, const float* scale, void* out, float* workspace,
             int M, int K, int N, int splits, cudaStream_t stream) {
  return M <= 16
             ? launch<16, TIn, TOut>(x, q, scale, out, workspace, M, K, N, splits, stream)
             : launch<64, TIn, TOut>(x, q, scale, out, workspace, M, K, N, splits, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are 16-byte-aligned device pointers to contiguous
// row-major tensors: x [M, K], q int8 [K, N], scale f32 [N], out [M, N].
// x_dtype / out_dtype: 0 = float32, 1 = bfloat16. K % 32 == 0, N % 64 == 0.
// splits > 1 splits K into that many equal ranges (K % (32 * splits) == 0)
// and needs an f32 workspace of splits * M * N; with splits == 1 it may be
// null.
int msd_qmm(const void* x, const void* q, const void* scale, void* out, void* workspace, int M,
            int K, int N, int splits, int x_dtype, int out_dtype, void* stream) {
  if (M < 1 || K < kBlockK || N < kBlockN || K % kBlockK != 0 || N % kBlockN != 0 ||
      splits < 1 || K % (kBlockK * splits) != 0 || (splits > 1 && workspace == nullptr) ||
      (x_dtype != 0 && x_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* s = static_cast<const float*>(scale);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    return out_dtype == 0 ? dispatch<float, float>(x, q, s, out, ws, M, K, N, splits, st)
                          : dispatch<float, __nv_bfloat16>(x, q, s, out, ws, M, K, N, splits, st);
  }
  return out_dtype == 0
             ? dispatch<__nv_bfloat16, float>(x, q, s, out, ws, M, K, N, splits, st)
             : dispatch<__nv_bfloat16, __nv_bfloat16>(x, q, s, out, ws, M, K, N, splits, st);
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
