// Weight-only int8 GEMM for NVIDIA Hopper (sm_90a), with a plain C entry point
// loaded through ctypes (no PyTorch headers, no CUTLASS, no cuBLAS).
//
// Replaces the TPU kernel in music_spectrogram_diffusion_tpu/ops/quantize.py:
// `_qmm_pallas` (the pallas_call) and `_qmm_kernel`. It computes
//
//     out[m, n] = cast_out( scale[n] * sum_k bf16(x[m, k]) * q[k, n] )
//
// x is f32 or bf16 [M, K] and is rounded to bf16 (as `_qmm_kernel` does);
// q is int8 [K, N], row-major (the Flax layout), widened exactly; every
// product is exact in f32 and the sum is f32; the per-column scale
// multiplies the f32 sum once, in the epilogue; out is f32 or bf16 [M, N];
// rows past M are masked. K must be a multiple of 64 and N of 128 (the
// serving tree's quantized kernels have both multiples of 128).
//
// What bounds it on the card: the serving calls have M = 1-2 (FiLM, the
// time embedding) or 256-2304 rows, K and N 768-3072. The weight is read
// once, at one byte an element. Up to a few hundred rows the int8 weight
// bytes bound a call (HBM, 3.35 TB/s); above, the 2·M·K·N products at the
// bf16 tensor-core rate do. Most calls are too small to fill 132 SMs with
// output tiles, and at these sizes a call's fixed costs (launch, round
// trips to L2, the epilogue) weigh as much as its bytes. Two routes, picked
// per call by the wrapper's plan (ops/quantize.py `plan`, which mirrors
// kConfigs below):
//
// GEMV route (M <= 4; every M <= 2 call of the serving path). No tensor
//   cores. A block owns COLS columns (16 a thread) and one K range. Each
//   thread loads kGemvLoads<MR> 16-byte weight rows and their x values, widens
//   the int8 in registers and accumulates bf16(x)·q with f32 FMAs (each
//   product is exact); the column sums go through warp shuffles and shared
//   memory in a fixed order. With two or more rows, ptxas keeps only two of
//   a thread's loads in flight, so the thread first prefetches every weight
//   row of its range into L2.
//
// WGMMA route (the rest). 128 x 64 output tiles, two warpgroups. The Tensor
//   Memory Accelerator brings each K step of 64 into a ring of 4 stages
//   tracked by mbarriers: the x tile in bf16 with the 128-byte swizzle, and
//   the int8 weight tile as stored, so the weight crosses HBM and L2 at one
//   byte an element. While the tensor cores run step kt (wgmma m64n64k16,
//   bf16 in, f32 accumulators in registers), the threads widen step kt + 1's
//   weights to bf16 in shared memory once (8-byte reads, 16-byte stores),
//   N-major in the 128-byte swizzle that wgmma reads with its transposed-B
//   descriptor. The accumulators go straight from registers to the
//   epilogue: scale, cast, two-element stores. f32 x (not on the serving
//   path) is loaded and rounded by the threads instead of the TMA.
//
// int8 -> float without a conversion instruction: byte ^ 0x80 placed by
// one byte permute into the low byte of 0x4B000000 is the float 2^23 + b +
// 128; subtracting 2^23 + 128 leaves b exactly (for -128..127), and
// cvt.rn.bf16x2.f32 packs two of them exactly.
//
// Split-K in one launch, deterministic. Where a call's tiles cannot fill the
// card, the plan cuts K into `splits` (2, 4 or 8) equal ranges, and the
// blocks of one output tile form one thread-block cluster. Each leaves its
// f32 partial sum in its own shared memory; after a cluster barrier each
// block adds its share of the tile over the cluster's blocks in split order
// (0, 1, ...), reading their shared memory (DSMEM), then scales, casts and
// stores it; a last barrier keeps every block's shared memory until the
// others have read it. The result does not depend on scheduling; there are
// no atomics, no scratch memory and no second kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// Shared pieces.
// ---------------------------------------------------------------------------

struct Params {
  const void* x;
  const int8_t* q;
  const float* scale;
  void* out;
  int M, K, N, splits, k_per_split;
  bool out_bf16;
};

// Four int8 (one 32-bit word) as four exact floats.
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias;
}

__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store1(void* out, long long at, float v, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[at] = v;
  }
}

__device__ __forceinline__ void store2(void* out, long long at, float a, float b, bool bf16) {
  if (bf16) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + at) = msd::pack_bf16(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(a, b);
  }
}

constexpr int kMaxSplits = 8;  // K ranges a call may be split into: a portable cluster

// Split-K through a thread-block cluster (see the top of the file).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// The last barrier: every block of the cluster is done reading the others'
// shared memory (a relaxed arrive: nothing this block wrote need be seen).
__device__ __forceinline__ void cluster_done() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" ::);
}

// The shared-memory address of `local` in the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(msd::smem_addr(local)), "r"(rank));
  return remote;
}

// The sum over the cluster's first `splits` blocks, in that order, of the
// value at `local` in each block's shared memory.
__device__ __forceinline__ float cluster_sum(const float* local, int splits) {
  float v[kMaxSplits];
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z) {
    v[z] = 0.f;
    if (z < splits) {
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                   : "=f"(v[z])
                   : "r"(cluster_addr(local, z)));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z) {
    if (z < splits) sum += v[z];
  }
  return sum;
}

__device__ __forceinline__ float4 cluster_sum4(const float4* local, int splits) {
  float4 v[kMaxSplits];
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z) {
    v[z] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (z < splits) {
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[z].x), "=f"(v[z].y), "=f"(v[z].z), "=f"(v[z].w)
                   : "r"(cluster_addr(local, z)));
    }
  }
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z) {
    if (z < splits) {
      sum.x += v[z].x;
      sum.y += v[z].y;
      sum.z += v[z].z;
      sum.w += v[z].w;
    }
  }
  return sum;
}

// Launches `kernel` with clusters of `cluster` blocks.
template <typename... Params_, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params_...), dim3 grid, dim3 cluster, int threads,
                             int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster.x;
  attr.val.clusterDim.y = cluster.y;
  attr.val.clusterDim.z = cluster.z;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Sets a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev % 32);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// GEMV route.
// ---------------------------------------------------------------------------

constexpr int kNMultiple = 128;     // N: a multiple of the widest GEMV block
constexpr int kGemvMaxRows = 4;     // the route's cut-off: M <= 4
constexpr int kGemvThreads = 256;

// 16-byte weight loads a thread takes at a time: 8 for one row; with more,
// ptxas keeps only two in flight whatever the batch, and 4 measured best.
template <int MR>
constexpr int kGemvLoads = MR == 1 ? 8 : 4;

// MR rows (M <= MR, the rest masked); a block takes COLS columns, COLS / 16
// threads of 16 a K row, so kGemvLanes K rows at a time.
template <int MR, int COLS, typename TIn>
__global__ void __launch_bounds__(kGemvThreads) qmm_gemv_kernel(const Params p) {
  constexpr int kGemvLanes = kGemvThreads / (COLS / 16);
  __shared__ __align__(16) float s_red[kGemvThreads / 32][MR][COLS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = tid % (COLS / 16), kl = tid / (COLS / 16);
  const int n0 = blockIdx.x * COLS, split = blockIdx.y;
  const int kps = p.k_per_split, k_begin = split * kps;
  const int8_t* qp = p.q + static_cast<long long>(k_begin + kl) * p.N + n0 + cg * 16;
  const TIn* xp = static_cast<const TIn*>(p.x) + k_begin + kl;

  // With two or more rows, ptxas keeps only two of the loads below in flight
  // (they share register buffers), so every weight row of this thread's K
  // range is first sent for into L2. One row keeps them all in flight; there
  // the prefetches only cost time (tools/torch_qmm_times.py).
  if constexpr (MR > 1) {
    for (int k = 0; k + kl < kps; k += kGemvLanes) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(qp + static_cast<long long>(k) * p.N));
    }
  }

  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
  }
  for (int k0 = 0; k0 < kps; k0 += kGemvLanes * kGemvLoads<MR>) {
    // This thread's weights (16 columns of kGemvLoads<MR> K rows) and the x
    // values of those rows.
    uint4 w[kGemvLoads<MR>];
    float xv[kGemvLoads<MR>][MR];
#pragma unroll
    for (int j = 0; j < kGemvLoads<MR>; ++j) {
      const bool ok = k0 + kl + j * kGemvLanes < kps;
      const long long k = k0 + j * kGemvLanes;
      w[j] = ok ? __ldcs(reinterpret_cast<const uint4*>(qp + k * p.N)) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        xv[j][m] = ok && m < p.M ? bf16_value(xp[static_cast<long long>(m) * p.K + k]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kGemvLoads<MR>; ++j) {
      const uint32_t words[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float f[4];
        widen4(words[h], f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            acc[m][4 * h + e] = fmaf(xv[j][m], f[e], acc[m][4 * h + e]);
          }
        }
      }
    }
  }

  // The K rows of a warp that share columns (lanes l ^ COLS / 16, ...),
  // then the 8 warps, in a fixed order.
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[m][c];
#pragma unroll
      for (int d = COLS / 16; d < 32; d *= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
      acc[m][c] = v;
    }
  }
  if (lane < COLS / 16) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int c = 0; c < 16; c += 4) {
        *reinterpret_cast<float4*>(&s_red[warp][m][cg * 16 + c]) =
            make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
      }
    }
  }
  __syncthreads();

  constexpr int kOuts = (MR * COLS + kGemvThreads - 1) / kGemvThreads;
  float v[kOuts];
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int i = tid + o * kGemvThreads, m = i / COLS, c = i % COLS;
    v[o] = 0.f;
    if (i < MR * COLS && m < p.M) {
#pragma unroll
      for (int wp = 0; wp < kGemvThreads / 32; ++wp) v[o] += s_red[wp][m][c];
    }
  }
  if (p.splits > 1) {
    float* red = &s_red[0][0][0];
    __syncthreads();  // every thread has read s_red
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      const int i = tid + o * kGemvThreads;
      if (i < MR * COLS) red[i] = v[o];
    }
    cluster_sync();
    const int outs = p.M * COLS;
    for (int i = split * outs / p.splits + tid; i < (split + 1) * outs / p.splits;
         i += kGemvThreads) {
      const int m = i / COLS, c = i % COLS;
      store1(p.out, static_cast<long long>(m) * p.N + n0 + c,
             cluster_sum(red + i, p.splits) * __ldg(p.scale + n0 + c), p.out_bf16);
    }
    cluster_done();
    return;
  }
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    const int i = tid + o * kGemvThreads, m = i / COLS, c = i % COLS;
    if (i < MR * COLS && m < p.M) {
      store1(p.out, static_cast<long long>(m) * p.N + n0 + c, v[o] * __ldg(p.scale + n0 + c),
             p.out_bf16);
    }
  }
}

template <int COLS, typename TIn>
int launch_gemv(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.N / COLS, p.splits), cluster(1, p.splits, 1);
  auto kernel = p.M == 1   ? qmm_gemv_kernel<1, COLS, TIn>
                : p.M == 2 ? qmm_gemv_kernel<2, COLS, TIn>
                           : qmm_gemv_kernel<kGemvMaxRows, COLS, TIn>;
  return (int)launch_clustered(kernel, grid, cluster, kGemvThreads, 0, stream, p);
}

// ---------------------------------------------------------------------------
// WGMMA route.
// ---------------------------------------------------------------------------

constexpr int kBK = 64;  // K a pipeline stage

// The tile: WGS warpgroups, each 64 rows of a (64 WGS) x 64 output tile,
// a ring of STAGES stages.
template <int WGS, int STAGES, typename TIn_>
struct Wgmma {
  using TIn = TIn_;
  static constexpr int kBM = 64 * WGS, kBN = 64, kStages = STAGES;
  static constexpr int kThreads = 128 * WGS;
  static constexpr bool kTmaX = sizeof(TIn) == 2;  // f32 x is rounded on the way
  static constexpr int kXStage = kBM * 128;        // bf16 x rows of 128 bytes
  static constexpr int kQStage = kBK * kBN;        // int8 weight rows
  static constexpr int kBBuf = kBK * kBN * 2;      // widened weight, one N-major atom
  static constexpr int kBytes = 1024 + STAGES * (kXStage + kQStage) + 2 * kBBuf + 8 * STAGES;
  static_assert(STAGES >= 3, "two steps in flight");
};

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
    qmm_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_q) {
  using TIn = typename Cfg::TIn;
  constexpr int BM = Cfg::kBM, BN = Cfg::kBN, kStages = Cfg::kStages;
  constexpr int kThreads = Cfg::kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (msd::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* s_x = smem;
  int8_t* s_q = reinterpret_cast<int8_t*>(smem + kStages * Cfg::kXStage);
  unsigned char* s_b = smem + kStages * (Cfg::kXStage + Cfg::kQStage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_b + 2 * Cfg::kBBuf);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  const int k_begin = split * p.k_per_split, num_k = p.k_per_split / kBK;

  // Step kt into stage kt % kStages: the int8 weight tile [64][BN] (and,
  // for bf16 x, the x tile [BM][64], 128-byte swizzled) by one thread's TMA
  // requests; f32 x is loaded, rounded and stored swizzled by all threads.
  auto load_stage = [&](int kt) {
    const int stage = kt % kStages, k0 = k_begin + kt * kBK;
    unsigned char* dx = s_x + stage * Cfg::kXStage;
    if (tid == 0) {
      msd::fence_async_smem();
      msd::mbar_expect_tx(bar + stage, Cfg::kQStage + (Cfg::kTmaX ? Cfg::kXStage : 0));
      msd::tma_load(s_q + stage * Cfg::kQStage, &map_q, n0, k0, bar + stage);
      if constexpr (Cfg::kTmaX) msd::tma_load(dx, &map_x, k0, m0, bar + stage);
    }
    if constexpr (!Cfg::kTmaX) {
      const float* x = static_cast<const float*>(p.x);
#pragma unroll
      for (int j = 0; j < BM * 8 / kThreads; ++j) {
        const int i = tid + j * kThreads, r = i / 8, c = i % 8;
        uint4 h = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < p.M) {
          const float* src = x + static_cast<long long>(m0 + r) * p.K + k0 + 8 * c;
          const float4 a = *reinterpret_cast<const float4*>(src);
          const float4 b = *reinterpret_cast<const float4*>(src + 4);
          h = make_uint4(msd::pack_bf16(a.x, a.y), msd::pack_bf16(a.z, a.w),
                         msd::pack_bf16(b.x, b.y), msd::pack_bf16(b.z, b.w));
        }
        *reinterpret_cast<uint4*>(dx + msd::sw128(r, c)) = h;
      }
    }
  };

  // Step kt's int8 weights widened to bf16 in buffer kt % 2, N-major: 8
  // columns of one k row a thread (one 8-byte read, one 16-byte store).
  auto widen = [&](int kt) {
    const int8_t* sq = s_q + (kt % kStages) * Cfg::kQStage;
    unsigned char* sb = s_b + (kt % 2) * Cfg::kBBuf;
    constexpr int kUnits = kBK * BN / 8;
    static_assert(kUnits % kThreads == 0, "widening units per thread");
#pragma unroll
    for (int u = 0; u < kUnits / kThreads; ++u) {
      const int i = tid + u * kThreads, k = i / (BN / 8), nc = i % (BN / 8);
      const uint2 v = *reinterpret_cast<const uint2*>(sq + k * BN + 8 * nc);
      float lo[4], hi[4];
      widen4(v.x, lo);
      widen4(v.y, hi);
      // atom nc / 8 (columns 64 a), 8-row group k / 8, row k % 8, chunk nc % 8.
      *reinterpret_cast<uint4*>(sb + (nc / 8) * (kBK * 128) + (k / 8) * 1024 +
                                msd::sw128(k % 8, nc % 8)) =
          make_uint4(msd::pack_bf16(lo[0], lo[1]), msd::pack_bf16(lo[2], lo[3]),
                     msd::pack_bf16(hi[0], hi[1]), msd::pack_bf16(hi[2], hi[3]));
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) msd::mbar_init(bar + s, 1);
    msd::fence_mbar_init();
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid / 128;

  for (int s = 0; s < kStages - 1 && s < num_k; ++s) load_stage(s);
  msd::mbar_wait(bar, 0);
  widen(0);

  for (int kt = 0; kt < num_k; ++kt) {
    // Step kt + 1 has landed; step kt's widened weights (and f32 x) go to
    // the tensor cores' proxy; every thread is done with step kt - 1.
    if (kt + 1 < num_k) msd::mbar_wait(bar + (kt + 1) % kStages, ((kt + 1) / kStages) & 1);
    msd::fence_async_smem();
    __syncthreads();
    if (kt + kStages - 1 < num_k) load_stage(kt + kStages - 1);

    const uint64_t a = msd::sw128_desc(s_x + (kt % kStages) * Cfg::kXStage + wg * 64 * 128);
    const uint64_t b = msd::sw128_n_desc(s_b + (kt % 2) * Cfg::kBBuf, kBK * 128);
    msd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      msd::wgmma_m64n64_ss<1>(acc, a + 2 * kk, b + 128 * kk, 1);
    }
    msd::wgmma_commit();
    if (kt + 1 < num_k) widen(kt + 1);  // while the tensor cores run
    msd::wgmma_wait<0>();
  }

  if (p.splits > 1) {
    // Partials in register order in the x stages: position j * kThreads + t
    // holds thread t's accumulators 4j .. 4j + 3.
    constexpr int kVecs = BN / 8;
    static_assert(kVecs * kThreads * 16 <= kStages * Cfg::kXStage, "partials fit the x stages");
    float4* red = reinterpret_cast<float4*>(s_x);
    __syncthreads();  // every warpgroup is done with the x stages
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      red[j * kThreads + tid] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync();
    constexpr int kTotal = kVecs * kThreads;
    for (int pos = split * kTotal / p.splits + tid; pos < (split + 1) * kTotal / p.splits;
         pos += kThreads) {
      const float4 sum = cluster_sum4(red + pos, p.splits);
      const int j = pos / kThreads, t_ = pos % kThreads, l = t_ % 32;
      const int row = m0 + (t_ / 128) * 64 + 16 * ((t_ / 32) % 4) + l / 4;
      const int col = n0 + 8 * j + 2 * (l % 4);
      const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + col));
      if (row < p.M) {
        store2(p.out, static_cast<long long>(row) * p.N + col, sum.x * sc.x, sum.y * sc.y,
               p.out_bf16);
      }
      if (row + 8 < p.M) {
        store2(p.out, static_cast<long long>(row + 8) * p.N + col, sum.z * sc.x, sum.w * sc.y,
               p.out_bf16);
      }
    }
    cluster_done();
    return;
  }

  // Epilogue from registers: warp w of a warpgroup holds rows 16 w + g and
  // 16 w + g + 8, columns 8 j + 2t and 8 j + 2t + 1. The scales are all
  // loaded before the first store (a store may not pass a load it could
  // alias, so interleaved they would cost a round trip each).
  const int g = lane / 4, t = lane % 4;
  const int row0 = m0 + wg * 64 + 16 * (warp % 4) + g;
  float2 s[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[j] = __ldg(reinterpret_cast<const float2*>(p.scale + n0 + 8 * j + 2 * t));
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < p.M) {
        store2(p.out, static_cast<long long>(row) * p.N + col, acc[4 * j + 2 * h] * s[j].x,
               acc[4 * j + 2 * h + 1] * s[j].y, p.out_bf16);
      }
    }
  }
}

template <int WGS, int STAGES, typename TIn>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using Cfg = Wgmma<WGS, STAGES, TIn>;
  CUtensorMap map_x, map_q;
  std::memset(&map_x, 0, sizeof(map_x));
  if (!msd::make_map_2d(&map_q, p.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.K, p.N, kBK, Cfg::kBN,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (Cfg::kTmaX && !msd::make_map_2d(&map_x, p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.M, p.K,
                               Cfg::kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B))) {
    return (int)cudaErrorInvalidValue;
  }
  static std::atomic<unsigned> configured{0};
  auto kernel = qmm_wgmma_kernel<Cfg>;
  cudaError_t err = allow_smem(kernel, Cfg::kBytes, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.N / Cfg::kBN, (p.M + Cfg::kBM - 1) / Cfg::kBM, p.splits);
  const dim3 cluster(1, 1, p.splits);
  return (int)launch_clustered(kernel, grid, cluster, Cfg::kThreads, Cfg::kBytes, stream, p,
                               map_x, map_q);
}

// The tile configurations: {route (0 GEMV, 1 wgmma), rows, columns,
// threads, stages}. ops/quantize.py CONFIGS mirrors this table (checked
// when it loads).
constexpr int kNumConfigs = 3;
constexpr int kConfigs[kNumConfigs][5] = {
    {0, kGemvMaxRows, 128, kGemvThreads, 0},  // 0: GEMV, 128 columns a block
    {0, kGemvMaxRows, 32, kGemvThreads, 0},   // 1: GEMV, 32 columns a block
    {1, 128, 64, 256, 4},                     // 2: wgmma, two warpgroups
};

template <typename TIn>
int dispatch(int config, const Params& p, cudaStream_t stream) {
  switch (config) {
    case 0:
      return launch_gemv<128, TIn>(p, stream);
    case 1:
      return launch_gemv<32, TIn>(p, stream);
    default:
      return launch_wgmma<2, 4, TIn>(p, stream);
  }
}

}  // namespace

extern "C" {

// The tile table: writes kNumConfigs rows of 5 ints (see kConfigs) into
// `rows` if `capacity` allows; returns kNumConfigs.
int msd_qmm_configs(int* rows, int capacity) {
  if (rows != nullptr && capacity >= kNumConfigs * 5) {
    for (int i = 0; i < kNumConfigs; ++i) {
      for (int j = 0; j < 5; ++j) rows[5 * i + j] = kConfigs[i][j];
    }
  }
  return kNumConfigs;
}

// Launches one call on `stream` and returns its launch error (0 on
// success). Pointers are 16-byte-aligned device pointers to contiguous
// row-major tensors: x [M, K], q int8 [K, N], scale f32 [N], out [M, N].
// x_dtype / out_dtype: 0 = float32, 1 = bfloat16. K % 64 == 0, N % 128 ==
// 0. `config` indexes kConfigs (the GEMV configurations take M <= 4).
// `splits` (1 .. 8) cuts K into that many equal ranges, each a multiple of
// the configuration's K step: 64 on the tensor cores, on GEMV the K rows a
// block takes at a time (256 threads / (columns / 16)).
int msd_qmm(const void* x, const void* q, const void* scale, void* out, int M, int K, int N,
            int config, int splits, int x_dtype, int out_dtype, void* stream) {
  const bool known = config >= 0 && config < kNumConfigs;
  const bool gemv = known && kConfigs[config][0] == 0;
  const int k_step = gemv ? kGemvThreads / (kConfigs[config][2] / 16) : kBK;
  if (!known || M < 1 || K < kBK || K % kBK != 0 || N % kNMultiple != 0 ||
      (gemv && M > kGemvMaxRows) || splits < 1 || splits > kMaxSplits ||
      K % (k_step * splits) != 0 || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.splits = splits;
  p.k_per_split = K / splits;
  p.out_bf16 = out_dtype == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0 ? dispatch<float>(config, p, st) : dispatch<__nv_bfloat16>(config, p, st);
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
