// Flash-attention forward for NVIDIA Hopper (sm_90a) on the tensor cores,
// with a plain C entry point loaded through ctypes (no PyTorch headers, no
// CUTLASS).
//
// Replaces the TPU kernel in music_spectrogram_diffusion_tpu/ops/attention.py:
// `_flash_fwd_pallas` (the pallas_call), `_flash_kernel` and `_masked_scores`.
// It computes, per (batch, head),
//
//     out = softmax(q k^T + bias + (keep - 1) * 1e10) v
//
// T5-style, with NO 1/sqrt(d) scaling (the model folds it into the query
// projection). Keys at or past kv_len are never scored, which is what the TPU
// kernel's -2e10 padding bias achieves: a row whose real keys are all masked
// therefore averages the real keys evenly, as the XLA reference does.
//
// Layouts: q and out are [b, q, h, d]; k and v are [b, kv, h, d], or
// [b, h, kv, d] when kv_transposed (the decoder's cached cross-attention K/V);
// bias is an optional f32 [b, 1|h, q, kv]; the key mask an optional uint8
// [b, kv] (1 keeps the key). Inputs are all f32 or all bf16. bf16 products
// are mma.sync m16n8k16 bf16 with f32 sums, p rounded to bf16 before the p·v
// product (as the TPU kernel does with mxu_bf16); f32 products are 3xTF32
// (mma.sync m16n8k8 below, attention_mma.cuh; wgmma m64n64k8 on the wgmma
// route), accurate to f32's tolerance where plain TF32 is not. The running max, the running sum and the softmax are
// f32 in registers.
//
// What bounds it on the card: at the serving and training shapes (q 256 or
// 2048, kv up to 2304, d 64) the work is 4·q·kv·d operations for
// 2·(q + 2·kv)·d elements moved: in bf16 the tensor cores' 989 TFLOP/s, and
// in f32 three TF32 products each, 495 / 3 = 165 TFLOP/s. What the design
// does about it:
// - a warp owns 16 query rows and a block 8 warps (f32, 128 rows) or 4 (bf16,
//   64 rows), as measured best on the card (`Tile`); S = q k^T, the
//   online softmax and the p·v sums stay in mma accumulator registers, and
//   p goes from the S accumulators straight into the A fragment of p·v;
// - K/V tiles of 64 keys stay in the input's type in shared memory (bf16
//   stays bf16), arriving by 16-byte cp.async into a ring of 3 (bf16) or 2
//   (f32) stages, so the next tile loads while this one multiplies; bf16
//   fragments are read with ldmatrix, f32 ones with 32-bit loads, from rows
//   padded so that neither conflicts on a bank;
// - split-KV: where b·h·⌈q/rows⌉ blocks cannot fill the card (the b=1
//   cross-attention has 48 in bf16), each query tile's keys are cut into `splits`
//   ranges (ops/attention.py `kv_split`, every range holding a key below
//   kv_len); each block writes its range's (m, l, unnormalised p·v) to f32
//   scratch, and `flash_fwd_combine_kernel` sums the ranges in ascending
//   order. No atomics: two launches give the same bits.
//
// Two routes: calls at head_dim 64 without a bias, with q, k, v, out and
// the mask 16-byte aligned (every call of the models), take the wgmma route
// (`wgmma_route`, mirrored by ops/attention.py `fwd_route`; its key ranges
// planned by `fwd_key_split`): bf16 in flash_fwd_wgmma.cuh, f32 in
// flash_fwd_tf32.cuh (3xTF32 on tf32 wgmma, with a prologue that splits K
// and V into the scratch `split`); every other call takes the mma.sync
// kernel below.
//
// Softmax statistics (training): given a `stats` pointer (null when
// serving), the kernel also writes each row's max m over all keys and its
// sum l of exp(s - m), f32 [2, b, h, q] (m first). The backward kernel
// (flash_bwd.cu) rebuilds p = exp(s - m) / l from them. Keeping m and l
// apart, rather than lse = m + log l, keeps an all-masked row exact: its
// scores all round to -1e10 in f32, so lse = -1e10 + log(kv_len) rounds back
// to -1e10 and exp(s - lse) would give 1 where the forward used 1 / kv_len.

#include "attention_mma.cuh"
#include "flash_fwd_tf32.cuh"
#include "flash_fwd_wgmma.cuh"

namespace {

using msd::FragA;

constexpr int kBlockK = 64;         // keys per K/V tile (msd_flash_fwd_keys)
constexpr int kNT = kBlockK / 8;    // 8-key accumulator tiles of S
constexpr int kCombineRows = 4;     // rows per block of the combine, one warp each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const uint8_t* mask;
  void* out;
  float* stats;     // optional [2, b, h, q]: row max, then row sum
  float* part_acc;  // split-KV scratch [splits, b, h, q, head_dim]: unnormalised p·v
  float* part_ml;   // split-KV scratch [2, splits, b, h, q]: row max, then row sum
  int batch, heads, q_len, kv_len, head_dim;
  int splits, keys_per_split;  // splits == 1: one range, out written directly
  bool vec;                    // 16-byte cp.async loads (see msd::load_tile)
  long long q_sb, q_sl, q_sh;     // q and out strides (elements)
  long long kv_sb, kv_sl, kv_sh;  // k and v strides
  long long bias_sb, bias_sh;     // bias_sh == 0 broadcasts one bias over heads
};

// The block's shape by input type, chosen on the card (PERF.md §6): f32
// takes 8 warps (128 query rows), so that each K/V tile in shared memory
// serves twice the rows and two blocks (16 warps) fit an SM's shared memory;
// bf16 takes 4 warps (64 rows), so that four blocks fit its registers. A
// third f32 stage cost a block an SM and was slower.
template <int D, typename T>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWarps = kF32 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // query rows per block (msd_flash_fwd_rows)
  static constexpr int LD = D + (kF32 ? 4 : 8);  // padded row, elements
  static constexpr int kStages = kF32 ? 2 : 3;
  static constexpr int kKV = kBlockK * LD;  // elements of one K (or V) tile
  // [kStages] K tiles and [kStages] V tiles in T, [kStages][kBlockK] key
  // terms in f32, and for f32 the query tile [kRows][LD].
  static constexpr size_t kBytes = sizeof(T) * 2 * kStages * kKV +
                                   sizeof(float) * kStages * kBlockK +
                                   (kF32 ? sizeof(float) * kRows * LD : 0);
};

template <int D, typename T>
__global__ void __launch_bounds__(Tile<D, T>::kThreads) flash_fwd_kernel(const Params p) {
  using Cfg = Tile<D, T>;
  constexpr int LD = Cfg::LD, kStages = Cfg::kStages, kDT = D / 8;
  constexpr int kThreads = Cfg::kThreads, kRows = Cfg::kRows;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);                                // [kStages][kBlockK][LD]
  T* vs = ks + kStages * Cfg::kKV;                                    // [kStages][kBlockK][LD]
  float* kterm = reinterpret_cast<float*>(vs + kStages * Cfg::kKV);  // [kStages][kBlockK]
  float* qs = kterm + kStages * kBlockK;                              // [kRows][LD], f32 only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q_tile = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = q_tile * kRows;
  const int row0 = q0 + 16 * warp + g;  // the thread's rows: row0 and row0 + 8
  const int k_begin = split * p.keys_per_split;
  const int k_end = min(p.kv_len, k_begin + p.keys_per_split);
  const int n_tiles = (k_end - k_begin + kBlockK - 1) / kBlockK;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint8_t* mask = p.mask != nullptr ? p.mask + (long long)b * p.kv_len : nullptr;

  // K/V tile `tile` of this range into ring stage `stage`, with each key's
  // term: -inf at or past the range's end (never scored), the mask's -1e10,
  // else 0.
  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * kBlockK;
    msd::load_tile<kBlockK, D, LD, kThreads>(ks + stage * Cfg::kKV, k, k0, k_end, p.head_dim,
                                             p.kv_sl, p.vec);
    msd::load_tile<kBlockK, D, LD, kThreads>(vs + stage * Cfg::kKV, v, k0, k_end, p.head_dim,
                                             p.kv_sl, p.vec);
    for (int i = threadIdx.x; i < kBlockK; i += kThreads) {
      const int c = k0 + i;
      kterm[stage * kBlockK + i] =
          c >= k_end ? -INFINITY : (mask != nullptr && !mask[c] ? -1e10f : 0.f);
    }
  };

  if constexpr (Cfg::kF32) {
    msd::load_tile<kRows, D, LD, kThreads>(qs, q, q0, p.q_len, p.head_dim, p.q_sl, p.vec);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_kv(s, s);
    msd::cp_async_commit();
  }

  // bf16: the warp's query rows as A fragments, in registers for the whole
  // kernel (f32 reads them from `qs` per k step, to save registers).
  uint32_t qa[Cfg::kF32 ? 1 : D / 16][4];
  if constexpr (!Cfg::kF32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + 2 * t;
        const T* src = q + (long long)row * p.q_sl + col;
        const bool ok = row < p.q_len;
        const float lo = ok && col < p.head_dim ? __bfloat162float(src[0]) : 0.f;
        const float hi = ok && col + 1 < p.head_dim ? __bfloat162float(src[1]) : 0.f;
        qa[kk][i] = msd::pack_bf16(lo, hi);
      }
    }
  }

  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share; the quad's sum at the end

  for (int it = 0; it < n_tiles; ++it) {
    msd::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed, and every warp is done with tile it - 1
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1, (it + kStages - 1) % kStages);
    msd::cp_async_commit();

    const int stage = it % kStages;
    const T* kt = ks + stage * Cfg::kKV;
    const T* vt = vs + stage * Cfg::kKV;
    const float* kterm_t = kterm + stage * kBlockK;
    const int k0 = k_begin + it * kBlockK;

    // S = q k^T for the warp's 16 rows by the tile's 64 keys.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (Cfg::kF32) {
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        const float* qr = qs + (16 * warp + g) * LD + 8 * kk + t;
        const FragA a = msd::split_a(qr[0], qr[8 * LD], qr[4], qr[8 * LD + 4]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = kt + (8 * j + g) * LD + 8 * kk + t;
          msd::mma_3xtf32(s[j], a, kr[0], kr[4]);
        }
      }
    } else {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int j2 = 0; j2 < kNT / 2; ++j2) {
          uint32_t bk[4];
          msd::ldmatrix_x4(bk, kt + (16 * j2 + 8 * (mi >> 1) + (lane & 7)) * LD + 16 * kk +
                                   8 * (mi & 1));
          msd::mma_bf16(s[2 * j2], qa[kk], bk[0], bk[1]);
          msd::mma_bf16(s[2 * j2 + 1], qa[kk], bk[2], bk[3]);
        }
      }
    }

    // Bias, then the key term, in the TPU kernel's order; then the online
    // softmax. Element e of tile j is row row0 + 8 (e / 2), key 8 j + 2 t +
    // e % 2. Every range holds a key below kv_len, so the first tile's max is
    // finite and its alpha is exp(-inf) = 0.
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        if (bias != nullptr) {
          const int row = row0 + 8 * (e >> 1);
          if (row < p.q_len && k0 + c < k_end) x += bias[(long long)row * p.kv_len + k0 + c];
        }
        x += kterm_t[c];
        s[j][e] = x;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      alpha[r] = msd::exp_diff(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = msd::exp_diff(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }

    // acc += p v over the tile; p goes from the S accumulators into A.
    if constexpr (Cfg::kF32) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const FragA a = msd::tf32_p_fragment(s[j]);
        const float* vr = vt + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < kDT; ++n) msd::mma_3xtf32(acc[n], a, vr[8 * n], vr[LD + 8 * n]);
      }
    } else {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        const uint32_t pa[4] = {msd::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                msd::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                msd::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                msd::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < kDT / 2; ++n2) {
          uint32_t bv[4];
          msd::ldmatrix_x4_trans(
              bv, vt + (16 * kk + 8 * (mi & 1) + (lane & 7)) * LD + 8 * (2 * n2 + (mi >> 1)));
          msd::mma_bf16(acc[2 * n2], pa, bv[0], bv[1]);
          msd::mma_bf16(acc[2 * n2 + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const long long rows = (long long)p.batch * p.heads * p.q_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.q_len) continue;
    const long long at = ((long long)b * p.heads + h) * p.q_len + row;  // in [b, h, q]
    if (p.splits == 1) {
      if (p.stats != nullptr && t == 0) {
        p.stats[at] = m_run[r];
        p.stats[rows + at] = l_run[r];
      }
      const float inv = 1.f / fmaxf(l_run[r], 1e-37f);
      T* o = static_cast<T*>(p.out) + b * p.q_sb + h * p.q_sh + (long long)row * p.q_sl;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < p.head_dim) o[col] = msd::from_f32<T>(acc[n][2 * r] * inv);
        if (col + 1 < p.head_dim) o[col + 1] = msd::from_f32<T>(acc[n][2 * r + 1] * inv);
      }
    } else {
      const long long part = split * rows + at;
      if (t == 0) {
        p.part_ml[part] = m_run[r];
        p.part_ml[(long long)p.splits * rows + part] = l_run[r];
      }
      float* o = p.part_acc + part * p.head_dim;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < p.head_dim) o[col] = acc[n][2 * r];
        if (col + 1 < p.head_dim) o[col + 1] = acc[n][2 * r + 1];
      }
    }
  }
}

// The split-KV combine: one warp per (b, h, q) row sums the ranges in
// ascending order, m = max m_s, l = sum exp(m_s - m) l_s, out = sum
// exp(m_s - m) acc_s / l, and writes the statistics when asked.
template <typename T>
__global__ void __launch_bounds__(32 * kCombineRows) flash_fwd_combine_kernel(const Params p) {
  const long long rows = (long long)p.batch * p.heads * p.q_len;
  const long long r = (long long)blockIdx.x * kCombineRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* m_s = p.part_ml + r;
  const float* l_s = m_s + (long long)p.splits * rows;
  float m = -INFINITY;
  for (int s = 0; s < p.splits; ++s) m = fmaxf(m, m_s[s * rows]);
  float l = 0.f;
  for (int s = 0; s < p.splits; ++s) l += msd::exp_diff(m_s[s * rows] - m) * l_s[s * rows];
  const float inv = 1.f / fmaxf(l, 1e-37f);
  const int qi = (int)(r % p.q_len);
  const long long bh = r / p.q_len;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  T* o = static_cast<T*>(p.out) + b * p.q_sb + h * p.q_sh + (long long)qi * p.q_sl;
  for (int col = lane; col < p.head_dim; col += 32) {
    float a = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      a += msd::exp_diff(m_s[s * rows] - m) * p.part_acc[(s * rows + r) * p.head_dim + col];
    }
    o[col] = msd::from_f32<T>(a * inv);
  }
  if (p.stats != nullptr && lane == 0) {
    p.stats[r] = m;
    p.stats[rows + r] = l;
  }
}

template <int D, typename T>
int launch(const Params& p, cudaStream_t stream) {
  using Cfg = Tile<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((p.q_len + Cfg::kRows - 1) / Cfg::kRows) * p.splits, p.heads, p.batch);
  flash_fwd_kernel<D, T><<<grid, Cfg::kThreads, Cfg::kBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long rows = (long long)p.batch * p.heads * p.q_len;
  flash_fwd_combine_kernel<T><<<(unsigned)((rows + kCombineRows - 1) / kCombineRows),
                                32 * kCombineRows, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// Each of n f32 bit patterns rounded to TF32 by the kernels' round_tf32 and
// by the instruction it stands in for, and the small term of the kernels'
// split, for the checks that hold round_tf32 to the instruction and the
// split to keeping NaN.
__global__ void tf32_round_probe_kernel(const uint32_t* in, uint32_t* ours, uint32_t* cvt,
                                        uint32_t* small, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __uint_as_float(in[i]);
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  ours[i] = msd::round_tf32(x);
  cvt[i] = r;
  small[i] = msd::split_tf32(x).small;
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.head_dim <= 16) return launch<16, T>(p, stream);
  if (p.head_dim <= 32) return launch<32, T>(p, stream);
  if (p.head_dim <= 64) return launch<64, T>(p, stream);
  return launch<128, T>(p, stream);
}

// Whether calls at head_dim 64 take the wgmma route, bf16 and f32 (false:
// the mma.sync route, as before the routes existed;
// tools/torch_attention_variants.py fwd_old_route and fwd_f32_old_route
// time the two).
constexpr bool kFwdWgmmaRoute = true;
constexpr bool kFwdTf32Route = true;

// The rule: the wgmma route takes bf16 and f32 at head_dim 64 without a
// bias, with q, k, v, out and the key mask 16-byte aligned (TMA's loads);
// the mma.sync route every other call. A call with a bias takes mma.sync,
// which adds the bias tile to S.
bool wgmma_route(int dtype, int head_dim, bool aligned, bool has_bias) {
  return kFwdWgmmaRoute && (dtype == 1 || kFwdTf32Route) && head_dim == fwd_wgmma::kTile &&
         aligned && !has_bias;
}

}  // namespace

extern "C" {

// Launches the kernel (and, with splits > 1, the combine) on `stream` and
// returns cudaGetLastError() (0 on success). Pointers are device pointers;
// bias, mask and stats may be null (stats: f32 [2, b, h, q], written only
// when given); part_acc (f32 [splits, b, h, q, head_dim]) and part_ml (f32
// [2, splits, b, h, q]) are the split-KV scratch, null when splits == 1.
// Split s takes keys [s keys_per_split, (s + 1) keys_per_split); with
// splits > 1 every split must start below kv_len and keys_per_split be a
// multiple of 64 (ignored when splits == 1); on the wgmma route the splits
// must also cover kv_len (ops/attention.py `fwd_key_split` plans them, the
// mma.sync route's by `kv_split`). The f32 wgmma route takes f32 scratch
// `split` of msd_flash_fwd_split_floats floats (ignored elsewhere).
// dtype: 0 = float32, 1 = bfloat16. bias_heads: 1 or `heads` (ignored
// without a bias). Tensors are contiguous in the layouts named above.
int msd_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, void* out, void* stats, void* part_acc, void* part_ml,
                  void* split, int batch, int heads, int q_len, int kv_len, int head_dim,
                  int kv_transposed, int bias_heads, int dtype, int splits, int keys_per_split,
                  void* stream) {
  if (batch < 1 || heads < 1 || q_len < 1 || kv_len < 1 || head_dim < 1 || head_dim > 128 ||
      (dtype != 0 && dtype != 1) || splits < 1 ||
      (splits > 1 && (keys_per_split < 1 || keys_per_split % kBlockK != 0 ||
                      (long long)(splits - 1) * keys_per_split >= kv_len ||
                      part_acc == nullptr || part_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = out;
  p.stats = static_cast<float*>(stats);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.batch = batch;
  p.heads = heads;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.head_dim = head_dim;
  p.splits = splits;
  p.keys_per_split = splits == 1 ? kv_len : keys_per_split;
  const int elt = dtype == 0 ? 4 : 2;
  p.vec = (head_dim * elt) % 16 == 0 && msd::aligned16(q) && msd::aligned16(k) &&
          msd::aligned16(v);
  p.q_sh = head_dim;
  p.q_sl = (long long)heads * head_dim;
  p.q_sb = (long long)q_len * heads * head_dim;
  if (kv_transposed) {
    p.kv_sl = head_dim;
    p.kv_sh = (long long)kv_len * head_dim;
  } else {
    p.kv_sl = (long long)heads * head_dim;
    p.kv_sh = head_dim;
  }
  p.kv_sb = (long long)kv_len * heads * head_dim;
  p.bias_sh = bias_heads == 1 ? 0 : (long long)q_len * kv_len;
  p.bias_sb = (long long)bias_heads * q_len * kv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = msd::aligned16(q) && msd::aligned16(k) && msd::aligned16(v) &&
                       msd::aligned16(out) && (mask == nullptr || msd::aligned16(mask));
  if (wgmma_route(dtype, head_dim, aligned, bias != nullptr)) {
    if (splits > 1 && (long long)splits * keys_per_split < kv_len) {
      return (int)cudaErrorInvalidValue;
    }
    const int tiles_per_split =
        splits == 1 ? (kv_len + kBlockK - 1) / kBlockK : keys_per_split / kBlockK;
    const long long rows = (long long)batch * heads * q_len;
    const unsigned combine_blocks = (unsigned)((rows + kCombineRows - 1) / kCombineRows);
    if (dtype == 0) {
      if (split == nullptr) return (int)cudaErrorInvalidValue;
      fwd_tf32::Params w;
      w.out = static_cast<float*>(out);
      w.stats = p.stats;
      w.part_acc = p.part_acc;
      w.part_ml = p.part_ml;
      w.batch = batch;
      w.heads = heads;
      w.q_len = q_len;
      w.kv_len = kv_len;
      w.kv_pad = (kv_len + kBlockK - 1) / kBlockK * kBlockK;
      w.splits = splits;
      w.tiles_per_split = tiles_per_split;
      w.masked = mask != nullptr;
      w.q_sb = p.q_sb;
      w.q_sl = p.q_sl;
      w.q_sh = p.q_sh;
      const long long n = (long long)batch * heads * w.kv_pad * 64;
      float* sp = static_cast<float*>(split);
      const fwd_tf32::Split parts = {sp, sp + n, sp + 2 * n, sp + 3 * n};
      const int err = fwd_tf32::launch(w, parts, static_cast<const float*>(q),
                                       static_cast<const float*>(k), static_cast<const float*>(v),
                                       p.mask, p.kv_sb, p.kv_sl, p.kv_sh, s);
      if (err != 0 || splits == 1) return err;
      flash_fwd_combine_kernel<float><<<combine_blocks, 32 * kCombineRows, 0, s>>>(p);
      return (int)cudaGetLastError();
    }
    fwd_wgmma::Params w;
    w.out = out;
    w.stats = p.stats;
    w.part_acc = p.part_acc;
    w.part_ml = p.part_ml;
    w.batch = batch;
    w.heads = heads;
    w.q_len = q_len;
    w.kv_len = kv_len;
    w.splits = splits;
    w.tiles_per_split = tiles_per_split;
    w.masked = mask != nullptr;
    w.q_sb = p.q_sb;
    w.q_sl = p.q_sl;
    w.q_sh = p.q_sh;
    const int err = fwd_wgmma::launch(w, q, k, v, p.mask, p.kv_sb, p.kv_sl, p.kv_sh, s);
    if (err != 0 || splits == 1) return err;
    flash_fwd_combine_kernel<__nv_bfloat16><<<combine_blocks, 32 * kCombineRows, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  return dtype == 0 ? dispatch<float>(p, s) : dispatch<__nv_bfloat16>(p, s);
}

// 1 when a call of this dtype code (0 = float32, 1 = bfloat16) and
// head_dim, with q, k, v, out and the mask 16-byte aligned (`aligned`) and
// a bias or not, takes the wgmma route; 0 for the mma.sync route.
int msd_flash_fwd_route(int dtype, int head_dim, int aligned, int has_bias) {
  return wgmma_route(dtype, head_dim, aligned != 0, has_bias != 0) ? 1 : 0;
}

// The wgmma route's block shape for q_len queries of `dtype` (0 =
// float32, 1 = bfloat16), which ops/attention.py fwd_key_split plans the
// key ranges by: 0, the queries a work item owns; 1, the keys a K/V tile.
int msd_flash_fwd_tile(int which, int q_len, int dtype) {
  if (which == 1) return dtype == 0 ? fwd_tf32::kTile : fwd_wgmma::kTile;
  return dtype == 0 ? fwd_tf32::kRows : 64 * fwd_wgmma::wgs_for(q_len);
}

// The f32 wgmma route's scratch, in floats: K's split terms ([b h, kv_pad,
// 64], big then small) and V's transposed ([b h, 64, kv_pad], big then
// small), kv_pad = kv_len rounded up to 64.
long long msd_flash_fwd_split_floats(int batch, int heads, int kv_len) {
  return 4LL * batch * heads * ((kv_len + kBlockK - 1) / kBlockK * kBlockK) * 64;
}

// The mma.sync route's block shape, which ops/attention.py kv_split plans
// the split-KV ranges by: query rows a block for `dtype` (0 = float32,
// 1 = bfloat16), and keys a K/V tile.
int msd_flash_fwd_rows(int dtype) {
  return dtype == 0 ? Tile<64, float>::kRows : Tile<64, __nv_bfloat16>::kRows;
}

int msd_flash_fwd_keys() { return kBlockK; }

// round_tf32, cvt.rna.tf32.f32 and split_tf32's small term on n f32 bit
// patterns `in`, written to `ours`, `cvt` and `small` (device pointers,
// uint32 [n]), on `stream`.
int msd_tf32_round_probe(const void* in, void* ours, void* cvt, void* small, int n,
                         void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  tf32_round_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(ours),
      static_cast<uint32_t*>(cvt), static_cast<uint32_t*>(small), n);
  return (int)cudaGetLastError();
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
