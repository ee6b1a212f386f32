// The bf16 route of flash_fwd.cu on Hopper's warpgroup tensor-core products
// (wgmma) fed by the Tensor Memory Accelerator (TMA). Included by
// flash_fwd.cu, whose `msd_flash_fwd` sends a call here by `wgmma_route`.
//
// Replaces, for bf16 inputs at head_dim 64 without a bias, the TPU kernel
// in music_spectrogram_diffusion_tpu/ops/attention.py: `_flash_fwd_pallas`
// (:368, its pallas_call at :441), `_flash_kernel` and `_masked_scores`
// (mxu_bf16). The arithmetic is flash_fwd.cu's bf16 route: per (batch, head)
// out = softmax(q k^T + (keep - 1) 1e10) v with no 1/sqrt(d); S from bf16
// operands summed in f32, the key mask's -1e10 added to it, keys at or past
// kv_len never scored (so an all-masked row averages the real keys evenly);
// the running max, the running sum and the softmax in f32 registers; p
// rounded to bf16 as it becomes the A operand of p v; out rounded to bf16
// once. With statistics it writes each row's max m and sum l apart (f32
// [2, b, h, q]), which the backward reads; with splits > 1, each key
// range's (m, l, unnormalised p v) for flash_fwd.cu's ordered combine.
//
// What bounds it on the card: 4 q kv d operations a (batch, head) for
// 2 (q + kv) d bf16 elements moved (q, out, k, v). At 2048x2048 that is
// 1024 FLOP a byte, far above the card's 295, so the tensor cores' 989
// TFLOP/s bound it (26.1 us at b = 2, 12 heads) and, at d = 64, equally the
// exps: one ex2 a score at 16 a clock an SM takes as long as the score's
// 4 d = 256 products. At 256x2304 (the decoder's cross-attention) a head's
// K/V (590 KB) serves 256 queries: 230 FLOP a byte, so the bytes bound it
// (4.7 us at b = 2), and a short grid's fixed costs. What the mma.sync
// route lost that to, and what this design does about each (PERF.md §6):
// - mma.sync m16n8k16 cannot reach the tensor cores' rate: here S = Q K^T
//   is wgmma m64n64k16 on a warpgroup's 64 query rows, Q as register A
//   fragments (read once an item from its swizzled tile by ldmatrix) and
//   the K tile in shared memory, K-major in the 128-byte swizzle (d = 64 is
//   one 128-byte row); O += P V takes p straight from the S accumulators
//   (the register-A form, `acc_to_a`) with the V tile read N-major by
//   wgmma's transposed B: one TMA copy of each tile, no transpose, and
//   only the B operands read from shared memory (Q read from there too cost
//   7% at 2048x2048, PERF.md §6).
// - cp.async by every thread and a block-wide barrier each tile: here one
//   producer thread keeps a ring of kStages = 6 tiles full with TMA loads
//   (K, V and the tile's key-mask bytes), tracked by a full and an
//   empty mbarrier a stage; TMA's zero fill covers the ragged ends (rows
//   past q_len or kv_len) and a 4-D tensor map with the layout's strides
//   covers both K/V layouts without a copy. The producer warpgroup gives
//   its registers to the consumers (setmaxnreg).
// - The exps and the products in turn: each warpgroup issues a tile's S,
//   then the last tile's P V, and waits only for S, so the tensor cores run
//   P V while the CUDA cores compute this tile's softmax; two or three
//   consumer warpgroups a block keep the tensor cores fed between them.
//   (Issuing the next tile's S before this tile's softmax, into a second
//   accumulator, made ptxas serialize the wgmmas and lost 17%, PERF.md §6.)
//   The scores are taken in log2 units (one FMA adds the mask's term), so
//   p = 2^(x - m) costs a subtraction and an ex2, and each row's max is a
//   tree of fmaxf rather than a chain.
// - Every 64-row query tile streamed the whole K/V, and a block's start
//   (its rows in, the ring filled) cost as much as its few tiles at
//   q = 256: here a work item owns 64 WGS query rows (`wgs_for`: 192 at
//   q = 2048, where 11 items a head fill 132 SMs in whole waves at b = 2;
//   128 at q = 256, which beat one 256-row item a head, PERF.md §6); the
//   grid is persistent (at most one block an SM, each taking items in a
//   fixed order, two buffers of query rows so the next item's arrive while
//   this one's products run), and where the items cannot fill the card
//   the keys are cut into ranges (ops/attention.py `fwd_key_split`)
//   combined in range order.
// No atomics: every output is summed in a fixed order, so two launches
// give the same bits.

#pragma once

#include <string.h>

#include "hopper.cuh"

namespace fwd_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;   // keys a streamed K/V tile; rows a query tile; the head_dim taken
constexpr int kStages = 6;  // the TMA ring of K/V tiles
constexpr int kTileBytes = kTile * 128;  // a 64 x 64 bf16 tile in the 128-byte swizzle
// A tile's 64 key-mask bytes arrive in a box of kMaskBox from the 16-byte
// boundary at or below them (TMA takes a box only from such a boundary; a
// row of the mask starts anywhere when kv_len is not a multiple of 16); a
// stage's box is kMaskBytes apart, 128-byte aligned.
constexpr int kMaskBox = kTile + 16;
constexpr int kMaskBytes = 128;
// own_full[2], own_empty[2], full[kStages], empty[kStages].
constexpr int kBars = 4 + 2 * kStages;
// The mask's -1e10 in log2 units, and back: kMaskedLog2 * kLn2 rounds to
// -1e10 exactly, so an all-masked row's max comes out as the reference's.
constexpr float kMaskedLog2 = -1e10f * msd::kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

// A block: WGS consumer warpgroups of 64 query rows each, then one producer
// warpgroup, which keeps 24 registers a thread and gives the rest to the
// consumers (kRegs each). The block starts with the registers that
// __launch_bounds__ allows a thread (kLaunchRegs: the SM's 65536 over the
// threads, in steps of 8), and setmaxnreg only moves them between its
// warpgroups: the consumers' increase must fit what the producer frees, or
// it waits for ever. A consumer holds O, S, the last tile's p and its Q
// rows as A fragments (96 registers) and its row statistics.
template <int WGS>
struct Shape {
  static constexpr int kRows = 64 * WGS;  // a work item's query rows
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kOwnBytes = WGS * kTileBytes;  // a work item's Q tiles
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kRegs = WGS == 2 ? 240 : 160;
  static_assert(128 * 24 + kConsumers * kRegs <= kThreads * kLaunchRegs,
                "the block's registers");
  // Two buffers of query rows, the ring (a K and a V tile a stage), the
  // key masks, the barriers, and 1024 bytes to align the tiles.
  static constexpr int kSmemBytes =
      1024 + 2 * kOwnBytes + kStages * (2 * kTileBytes + kMaskBytes) + kBars * 8;
};

// The consumer warpgroups of a call with q_len queries: three (192-row
// items) where they waste at most an eighth of the rows to padding (q =
// 2048: 11 items a head, 264 at b = 2 fill 132 SMs in two whole waves),
// else two (q = 256: two items a head).
inline int wgs_for(int q_len) { return (q_len + 191) / 192 * 192 * 8 <= 9 * q_len ? 3 : 2; }

struct Params {
  void* out;        // bf16 like q (splits == 1)
  float* stats;     // optional f32 [2, b, h, q]: row max, then row sum (splits == 1)
  float* part_acc;  // splits > 1: f32 [splits, b, h, q, 64], unnormalised p v
  float* part_ml;   // splits > 1: f32 [2, splits, b, h, q], row max, then row sum
  int batch, heads, q_len, kv_len, splits, tiles_per_split;
  int masked;                 // the key-mask bytes arrive with each tile
  long long q_sb, q_sl, q_sh;  // q and out strides (elements)
};

struct Smem {
  unsigned char* own;   // [2][WGS][kTileBytes]: an item's Q tiles, two buffers
  unsigned char* ring;  // [kStages][2][kTileBytes]: K, then V
  unsigned char* mask;  // [kStages][kMaskBytes]
  uint64_t* bar;        // [kBars]

  __device__ uint64_t* own_full(int buf) const { return bar + buf; }
  __device__ uint64_t* own_empty(int buf) const { return bar + 2 + buf; }
  __device__ uint64_t* full(int s) const { return bar + 4 + s; }
  __device__ uint64_t* empty(int s) const { return bar + 4 + kStages + s; }
  __device__ unsigned char* stage(int s) const { return ring + s * 2 * kTileBytes; }
};

// The attention of the items of one launch (see the top of the file).
template <int WGS>
__global__ void __launch_bounds__(Shape<WGS>::kThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_mask) {
  using S = Shape<WGS>;
  extern __shared__ unsigned char smem_raw[];
  Smem sm;
  sm.own = smem_raw + ((1024 - (msd::smem_addr(smem_raw) & 1023)) & 1023);
  sm.ring = sm.own + 2 * S::kOwnBytes;
  sm.mask = sm.ring + kStages * 2 * kTileBytes;
  sm.bar = reinterpret_cast<uint64_t*>(sm.mask + kStages * kMaskBytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      msd::mbar_init(sm.own_full(i), 1);
      msd::mbar_init(sm.own_empty(i), S::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      msd::mbar_init(sm.full(s), 1);
      msd::mbar_init(sm.empty(s), S::kConsumers);
    }
    msd::fence_mbar_init();
  }
  __syncthreads();
  const int kv_tiles = (p.kv_len + kTile - 1) / kTile;
  const int row_blocks = (p.q_len + S::kRows - 1) / S::kRows;
  const int items = row_blocks * p.splits * p.heads * p.batch;
  const int wg = threadIdx.x / 128;

  if (wg == WGS) {
    // The producer: for each item its query rows (the 64-row tiles that
    // hold a query; the rest stay unread), then its key range's K, V and
    // mask tiles into the ring.
    msd::setmaxnreg_dec<24>();
    if (threadIdx.x == S::kConsumers) {
      int ring_it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const msd::Item w = msd::item_of(item, S::kRows, row_blocks, p.splits, p.heads);
        const int buf = n % 2;
        const int parts = min(WGS, (p.q_len - w.row0 + kTile - 1) / kTile);
        msd::mbar_wait(sm.own_empty(buf), ((n / 2) & 1) ^ 1);
        msd::mbar_expect_tx(sm.own_full(buf), parts * kTileBytes);
        for (int part = 0; part < parts; ++part) {
          msd::tma_load_4d(sm.own + buf * S::kOwnBytes + part * kTileBytes, &map_q, 0,
                           w.row0 + part * kTile, w.h, w.b, sm.own_full(buf));
        }
        const int tile0 = w.split * p.tiles_per_split;
        const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
        for (int i = 0; i < n_tiles; ++i, ++ring_it) {
          const int s = ring_it % kStages, key0 = (tile0 + i) * kTile;
          msd::mbar_wait(sm.empty(s), ((ring_it / kStages) & 1) ^ 1);
          msd::mbar_expect_tx(sm.full(s), 2 * kTileBytes + (p.masked ? kMaskBox : 0));
          msd::tma_load_4d(sm.stage(s), &map_k, 0, key0, w.h, w.b, sm.full(s));
          msd::tma_load_4d(sm.stage(s) + kTileBytes, &map_v, 0, key0, w.h, w.b, sm.full(s));
          if (p.masked) {
            msd::tma_load_1d(sm.mask + s * kMaskBytes, &map_mask,
                             (w.b * p.kv_len + key0) & ~15, sm.full(s));
          }
        }
      }
    }
    return;
  }
  msd::setmaxnreg_inc<S::kRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long rows_total = (long long)p.batch * p.heads * p.q_len;
  float o[32];
  uint32_t pa[4][4], qa[4][4];
  // O += p V for the tile in `pa` (its V at `stage` + kTileBytes).
  auto pv_product = [&](const unsigned char* stage) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      msd::wgmma_m64n64_rs<1>(o, pa[kk],
                              msd::sw128_n_desc(stage + kTileBytes, kTileBytes) + 128 * kk);
    }
  };
  int ring_it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const msd::Item w = msd::item_of(item, S::kRows, row_blocks, p.splits, p.heads);
    const int buf = n % 2;
    const int tile0 = w.split * p.tiles_per_split;
    const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
    const int row0 = w.row0 + wg * 64 + 16 * warp + g;  // the thread's queries: row0 and row0 + 8
    const unsigned char* q_tile = sm.own + buf * S::kOwnBytes + wg * kTileBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // in log2 units
    float l_run[2] = {0.f, 0.f};  // this thread's share; the quad's sum at the end
    msd::mbar_wait(sm.own_full(buf), (n / 2) & 1);
    {
      // The warp's 16 query rows as A fragments, read from the swizzled
      // tile by ldmatrix; the buffer is then free for the item after next.
      const int mi = lane >> 3, r = 16 * warp + (lane & 7) + 8 * (mi & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::ldmatrix_x4(qa[kk], q_tile + msd::sw128(r, 2 * kk + (mi >> 1)));
      }
      msd::mbar_arrive(sm.own_empty(buf));
    }

    const int base = ring_it;  // the ring's count at the item's first tile
    ring_it += n_tiles;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = (base + it) % kStages, prev = (base + it + kStages - 1) % kStages;
      msd::mbar_wait(sm.full(s), ((base + it) / kStages) & 1);

      // This tile's S = q K^T (64 queries by 64 keys), then the last tile's
      // P V, which runs on the tensor cores while this tile's softmax runs
      // on the CUDA cores.
      float sc[32];
      msd::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::wgmma_m64n64_rs<0>(sc, qa[kk], msd::sw128_desc(sm.stage(s)) + 2 * kk, kk);
      }
      msd::wgmma_commit();
      if (it > 0) pv_product(sm.stage(prev));
      msd::wgmma_commit();
      msd::wgmma_wait<1>();  // this tile's S
      msd::fence_regs(sc);

      // The scores in log2 units with the key terms, in the TPU kernel's
      // order: s log2 e plus the mask's -1e10 log2 e in one rounding, then
      // -inf at or past kv_len (never scored). Every masked score of a row
      // rounds to the same -1e10 log2 e (|s| < 355), as s - 1e10 rounds to
      // -1e10 in the reference, so an all-masked row's p are all 1.
      // Element 4 j + 2 r + e is query row0 + 8 r, key key0 + 8 j + 2 t + e.
      // Every range holds a key below kv_len, so every tile's row max is
      // finite and the first tile's alpha is 2^-inf = 0.
      const int key0 = (tile0 + it) * kTile;
      if (p.masked) {
        const unsigned char* mk =
            sm.mask + s * kMaskBytes + ((w.b * p.kv_len + key0) & 15) + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float term = mk[8 * j + e] ? 0.f : kMaskedLog2;
            sc[4 * j + e] = fmaf(sc[4 * j + e], msd::kLog2e, term);
            sc[4 * j + 2 + e] = fmaf(sc[4 * j + 2 + e], msd::kLog2e, term);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= msd::kLog2e;
      }
      if (key0 + kTile > p.kv_len) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (key0 + 8 * j + 2 * t + e >= p.kv_len) {
              sc[4 * j + e] = -INFINITY;
              sc[4 * j + 2 + e] = -INFINITY;
            }
          }
        }
      }
      // The online softmax: p = exp(s - m) = 2^(x - m) in log2 units. Each
      // row's max over the thread's 16 keys as a tree (fmaxf's result does
      // not depend on the order).
      float mt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
#pragma unroll
        for (int w2 = 4; w2 > 0; w2 /= 2) {
#pragma unroll
          for (int j = 0; j < w2; ++j) v[j] = fmaxf(v[j], v[j + w2]);
        }
        mt[r] = v[0];
      }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m_run[r], mt[r]);
        alpha[r] = msd::exp2_ftz(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = msd::exp2_ftz(sc[i] - m_run[r]);
        ls[r] += sc[i];
      }
      msd::wgmma_wait<0>();  // the last tile's P V, which reads pa and o
      msd::fence_regs(o);
      msd::fence_regs(pa);
      if (it > 0) msd::mbar_arrive(sm.empty(prev));
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) msd::acc_to_a(pa[kk], sc, kk);
    }
    // The last tile's P V; then its stage is free.
    const int last = (base + n_tiles - 1) % kStages;
    msd::wgmma_fence();
    pv_product(sm.stage(last));
    msd::wgmma_commit();
    msd::wgmma_wait<0>();
    msd::fence_regs(o);
    msd::mbar_arrive(sm.empty(last));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.q_len) continue;
      const long long at = ((long long)w.b * p.heads + w.h) * p.q_len + row;  // in [b, h, q]
      const float m = m_run[r] * kLn2;  // an all-masked row's: -1e10 exactly
      if (p.splits == 1) {
        if (p.stats != nullptr && t == 0) {
          p.stats[at] = m;
          p.stats[rows_total + at] = l_run[r];
        }
        const float inv = 1.f / fmaxf(l_run[r], 1e-37f);
        bf16* dst = static_cast<bf16*>(p.out) + w.b * p.q_sb + w.h * p.q_sh + row * p.q_sl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
              msd::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
      } else {
        const long long part = w.split * rows_total + at;
        if (t == 0) {
          p.part_ml[part] = m;
          p.part_ml[p.splits * rows_total + part] = l_run[r];
        }
        float* dst = p.part_acc + part * kTile;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// The kernel with WGS consumer warpgroups, a persistent grid.
template <int WGS>
cudaError_t launch_wgs(const Params& p, const CUtensorMap& map_q, const CUtensorMap& map_k,
                       const CUtensorMap& map_v, const CUtensorMap& map_mask, int sms,
                       cudaStream_t stream) {
  using S = Shape<WGS>;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wgmma_kernel<WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  // The registers the block starts with must cover the consumers' raise
  // (see Shape), or the raise would wait for ever: refuse the launch.
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fwd_wgmma_kernel<WGS>);
  if (err != cudaSuccess) return err;
  if (128 * 24 + S::kConsumers * S::kRegs > S::kThreads * attr.numRegs) {
    return cudaErrorInvalidConfiguration;
  }
  const int items = (p.q_len + S::kRows - 1) / S::kRows * p.splits * p.heads * p.batch;
  fwd_wgmma_kernel<WGS><<<min(items, sms), S::kThreads, S::kSmemBytes, stream>>>(
      p, map_q, map_k, map_v, map_mask);
  return cudaGetLastError();
}

// The route's kernel on `stream` (flash_fwd.cu combines the key ranges
// when p.splits > 1): q in the layout of p's strides, k and v in theirs,
// the key mask uint8 [b, kv] or null. Returns a CUDA error code (0 on
// success).
inline int launch(const Params& p, const void* q, const void* k, const void* v,
                  const uint8_t* mask, long long kv_sb, long long kv_sl, long long kv_sh,
                  cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_mask;
  memset(&map_mask, 0, sizeof(map_mask));
  if (!msd::head_tile_map(&map_q, q, p.batch, p.heads, p.q_len, p.q_sb, p.q_sl, p.q_sh) ||
      !msd::head_tile_map(&map_k, k, p.batch, p.heads, p.kv_len, kv_sb, kv_sl, kv_sh) ||
      !msd::head_tile_map(&map_v, v, p.batch, p.heads, p.kv_len, kv_sb, kv_sl, kv_sh)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mask != nullptr && !msd::key_mask_map(&map_mask, mask, p.batch, p.kv_len, kMaskBox)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)(wgs_for(p.q_len) == 3
                   ? launch_wgs<3>(p, map_q, map_k, map_v, map_mask, sms, stream)
                   : launch_wgs<2>(p, map_q, map_k, map_v, map_mask, sms, stream));
}

}  // namespace fwd_wgmma
