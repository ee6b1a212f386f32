// The float32 route of flash_fwd.cu on Hopper's warpgroup tensor-core
// products (wgmma, tf32) fed by the Tensor Memory Accelerator (TMA).
// Included by flash_fwd.cu, whose `msd_flash_fwd` sends a call here by
// `wgmma_route`.
//
// Replaces, for f32 inputs at head_dim 64 without a bias, the TPU kernel in
// music_spectrogram_diffusion_tpu/ops/attention.py: `_flash_fwd_pallas`
// (:368, its pallas_call at :441), `_flash_kernel` and `_masked_scores`.
// The arithmetic is flash_fwd.cu's f32 mma.sync route: per (batch, head)
// out = softmax(q k^T + (keep - 1) 1e10) v with no 1/sqrt(d); every product
// 3xTF32 (small(a) big(b), big(a) small(b), then big(a) big(b), each term
// `split_tf32`'s, into one f32 sum: ops/attention.py `einsum_3xtf32`); keys
// at or past kv_len never scored; the online softmax in f32 registers, in
// natural units as the mma.sync route takes it (p = 2^((s - m) log2 e),
// the difference taken first), so that the row max m it writes is the
// scores' own, from which flash_bwd_tf32.cuh rebuilds p the same way; out
// written once in f32.
// With statistics each row's max m and sum l apart (f32 [2, b, h, q]);
// with splits > 1, each key range's (m, l, unnormalised p v) for
// flash_fwd.cu's ordered combine.
//
// What bounds it on the card: 4 q kv d operations a (batch, head), each a
// 3xTF32 product, so 495 / 3 = 165 TFLOP/s: 0.156 ms at 2048x2048, b = 2,
// 12 heads; at 256x2304 0.022 ms. What the f32 mma.sync route lost that to,
// and what this design does about each (PERF.md §6):
// - mma.sync m16n8k8 cannot reach the tensor cores' rate: here S = Q K^T
//   and O += P V are wgmma m64n64k8 on a warpgroup's 64 query rows, Q and p
//   as register A fragments (split in registers: Q once an item, p once a
//   tile) and K and V from shared memory.
// - tf32 wgmma reads B from shared memory K-major only, and the f32
//   accumulator is not an A fragment as it stands. So a prologue kernel
//   (tf32_split.cuh `tf32_split_kernel`, one launch a call) writes K's split
//   terms as [b h, kv_pad, 64] and V's transposed, [b h, 64, kv_pad], with
//   the keys of each 8 in the order p's A fragment takes them
//   (`tf32_acc_frag`, as attention_mma.cuh `tf32_p_fragment`); each tile's
//   four operands then arrive by TMA, split once a call rather than once a
//   use by every warp (the mma.sync route split each B value at each of its
//   8 warps' uses).
// - cp.async by every thread and a block-wide barrier each tile: here one
//   producer thread keeps a ring of kStages tiles (K big and small, V^T big
//   and small, the key mask's bytes) full, tracked by a full and an empty
//   mbarrier a stage, and gives its warpgroup's registers to the consumers
//   (setmaxnreg); TMA's zero fill covers q past q_len.
// - The exps and the products in turn: each warpgroup issues a tile's S,
//   then the last tile's P V, and waits only for S (flash_fwd_wgmma.cuh's
//   order); two consumer warpgroups a block.
// - Sums: the tensor cores' adds drop low bits, so O summed over every key
//   tile in one accumulator drifts (at 256 keys a training step's gradients
//   moved 1.1e-4 relative RMS from plain attention's; the mma.sync route
//   summed 64 keys a range there, PERF.md §6). Each tile's P V is summed
//   into a fresh accumulator and added to the running O in f32 as it is
//   rescaled; the running O lives in shared memory (a thread's 32 values
//   kConsumers apart: no bank conflict), which the registers cannot hold
//   beside Q and p (64 each, big and small terms), S and the tile's sum.
// - A persistent grid of at most one block an SM takes 128-query items in a
//   fixed order, two buffers of query rows; where the items cannot fill the
//   card the keys are cut into ranges (ops/attention.py `fwd_key_split`).
// No atomics: every output is summed in a fixed order, so two launches
// give the same bits.

#pragma once

#include <string.h>

#include "hopper.cuh"
#include "tf32_split.cuh"

namespace fwd_tf32 {

constexpr int kTile = 64;                // keys a streamed tile; query rows a warpgroup; head_dim
constexpr int kStages = 2;               // the TMA ring
constexpr int kWgs = 2;                  // consumer warpgroups
constexpr int kRows = 64 * kWgs;         // a work item's query rows
constexpr int kThreads = 128 * (kWgs + 1);
constexpr int kConsumers = 128 * kWgs;
constexpr int kRegs = 240;               // a consumer thread's registers; the producer's 24
constexpr int kTileBytes = kTile * 256;  // a 64 x 64 f32 tile: two swizzle atoms
constexpr int kStageBytes = 4 * kTileBytes;  // K big, K small, V^T big, V^T small
constexpr int kOwnBytes = kWgs * kTileBytes;
// The key mask's bytes as flash_fwd_wgmma.cuh loads them.
constexpr int kMaskBox = kTile + 16;
constexpr int kMaskBytes = 128;
constexpr int kBars = 4 + 2 * kStages;  // own_full[2], own_empty[2], full, empty
constexpr int kSumBytes = kConsumers * 32 * 4;  // the running O, 32 values a consumer thread
constexpr int kSmemBytes =
    1024 + 2 * kOwnBytes + kStages * (kStageBytes + kMaskBytes) + kSumBytes + kBars * 8;
static_assert(128 * 24 + kConsumers * kRegs <= kThreads * (65536 / kThreads / 8 * 8),
              "the block's registers");

// The scratch of a call: K's and V's split terms.
struct Split {
  float *k_big, *k_small, *vt_big, *vt_small;
};

struct Params {
  float* out;       // like q (splits == 1)
  float* stats;     // optional f32 [2, b, h, q]
  float* part_acc;  // splits > 1: f32 [splits, b, h, q, 64]
  float* part_ml;   // splits > 1: f32 [2, splits, b, h, q]
  int batch, heads, q_len, kv_len, kv_pad, splits, tiles_per_split;
  int masked;
  long long q_sb, q_sl, q_sh;
};

struct Maps {
  CUtensorMap q, k_big, k_small, vt_big, vt_small, mask;
};

__global__ void __launch_bounds__(kThreads, 1)
    fwd_tf32_kernel(const __grid_constant__ Params p, const __grid_constant__ Maps maps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* own = smem_raw + ((1024 - (msd::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = own + 2 * kOwnBytes;
  unsigned char* mask = ring + kStages * kStageBytes;
  float* sums = reinterpret_cast<float*>(mask + kStages * kMaskBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sums + kConsumers * 32);
  uint64_t* own_full = bar;
  uint64_t* own_empty = bar + 2;
  uint64_t* full = bar + 4;
  uint64_t* empty = bar + 4 + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      msd::mbar_init(own_full + i, 1);
      msd::mbar_init(own_empty + i, kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      msd::mbar_init(full + s, 1);
      msd::mbar_init(empty + s, kConsumers);
    }
    msd::fence_mbar_init();
  }
  __syncthreads();
  const int kv_tiles = (p.kv_len + kTile - 1) / kTile;
  const int row_blocks = (p.q_len + kRows - 1) / kRows;
  const int items = row_blocks * p.splits * p.heads * p.batch;
  const int wg = threadIdx.x / 128;

  if (wg == kWgs) {
    msd::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int ring_it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const msd::Item w = msd::item_of(item, kRows, row_blocks, p.splits, p.heads);
        const int buf = n % 2;
        const int parts = min(kWgs, (p.q_len - w.row0 + kTile - 1) / kTile);
        msd::mbar_wait(own_empty + buf, ((n / 2) & 1) ^ 1);
        msd::mbar_expect_tx(own_full + buf, parts * kTileBytes);
        for (int part = 0; part < parts; ++part) {
          unsigned char* dst = own + buf * kOwnBytes + part * kTileBytes;
          for (int half = 0; half < 2; ++half) {
            msd::tma_load_4d(dst + half * (kTileBytes / 2), &maps.q, 32 * half,
                             w.row0 + part * kTile, w.h, w.b, own_full + buf);
          }
        }
        const int tile0 = w.split * p.tiles_per_split;
        const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
        const int bh = w.b * p.heads + w.h;
        for (int i = 0; i < n_tiles; ++i, ++ring_it) {
          const int s = ring_it % kStages, key0 = (tile0 + i) * kTile;
          unsigned char* st = ring + s * kStageBytes;
          msd::mbar_wait(empty + s, ((ring_it / kStages) & 1) ^ 1);
          msd::mbar_expect_tx(full + s, kStageBytes + (p.masked ? kMaskBox : 0));
          for (int half = 0; half < 2; ++half) {
            const int off = half * (kTileBytes / 2);
            msd::tma_load_3d(st + off, &maps.k_big, 32 * half, key0, bh, full + s);
            msd::tma_load_3d(st + kTileBytes + off, &maps.k_small, 32 * half, key0, bh, full + s);
            msd::tma_load_3d(st + 2 * kTileBytes + off, &maps.vt_big, key0 + 32 * half, 0, bh,
                             full + s);
            msd::tma_load_3d(st + 3 * kTileBytes + off, &maps.vt_small, key0 + 32 * half, 0, bh,
                             full + s);
          }
          if (p.masked) {
            msd::tma_load_1d(mask + s * kMaskBytes, &maps.mask, (w.b * p.kv_len + key0) & ~15,
                             full + s);
          }
        }
      }
    }
    return;
  }
  msd::setmaxnreg_inc<kRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long rows_total = (long long)p.batch * p.heads * p.q_len;
  float* o_run = sums + (threadIdx.x % kConsumers);  // the running O: value i at kConsumers i
  float o[32];                  // a tile's p V^T
  uint32_t pb[8][4], ps[8][4];  // the last tile's p: big and small terms
  uint32_t qb[8][4], qs[8][4];  // the warp's query rows: big and small terms
  // o = p V^T for the tile in pb, ps (its V^T at `st`): 3xTF32.
  auto pv_product = [&](const unsigned char* st) {
    const unsigned char* vb = st + 2 * kTileBytes;
    const unsigned char* vs = st + 3 * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      msd::wgmma_tf32_rs(o, ps[kk], msd::tf32_desc(vb, kTile, kk), kk);
      msd::wgmma_tf32_rs(o, pb[kk], msd::tf32_desc(vs, kTile, kk));
      msd::wgmma_tf32_rs(o, pb[kk], msd::tf32_desc(vb, kTile, kk));
    }
  };
  int ring_it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const msd::Item w = msd::item_of(item, kRows, row_blocks, p.splits, p.heads);
    const int buf = n % 2;
    const int tile0 = w.split * p.tiles_per_split;
    const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
    const int row0 = w.row0 + wg * 64 + 16 * warp + g;  // the thread's queries: row0 and row0 + 8
#pragma unroll
    for (int i = 0; i < 32; ++i) o_run[kConsumers * i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    msd::mbar_wait(own_full + buf, (n / 2) & 1);
    {
      const unsigned char* q_tile = own + buf * kOwnBytes + wg * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        msd::tf32_frag_from_tile(qb[kk], qs[kk], q_tile, kTile, 16 * warp, kk, g, t);
      }
      msd::mbar_arrive(own_empty + buf);
    }

    const int base = ring_it;
    ring_it += n_tiles;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = (base + it) % kStages, prev = (base + it + kStages - 1) % kStages;
      const unsigned char* st = ring + s * kStageBytes;
      msd::mbar_wait(full + s, ((base + it) / kStages) & 1);

      // This tile's S = q K^T (3xTF32), then the last tile's P V.
      float sc[32];
      msd::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t kb = msd::tf32_desc(st, kTile, kk);
        msd::wgmma_tf32_rs(sc, qs[kk], kb, kk);
        msd::wgmma_tf32_rs(sc, qb[kk], msd::tf32_desc(st + kTileBytes, kTile, kk));
        msd::wgmma_tf32_rs(sc, qb[kk], kb);
      }
      msd::wgmma_commit();
      if (it > 0) pv_product(ring + prev * kStageBytes);
      msd::wgmma_commit();
      msd::wgmma_wait<1>();
      msd::fence_regs(sc);

      // The scores with the key terms, in the TPU kernel's order: s plus
      // the mask's -1e10 (which every masked score of a row rounds to, |s|
      // < 512: an all-masked row's p are all 1), then -inf at or past kv_len.
      // Element 4 j + 2 r + e is query row0 + 8 r, key key0 + 8 j + 2 t + e.
      const int key0 = (tile0 + it) * kTile;
      if (p.masked) {
        const unsigned char* mk = mask + s * kMaskBytes + ((w.b * p.kv_len + key0) & 15) + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!mk[8 * j + e]) {
              sc[4 * j + e] += -1e10f;
              sc[4 * j + 2 + e] += -1e10f;
            }
          }
        }
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
        alpha[r] = msd::exp2_ftz((m_run[r] - m_new) * msd::kLog2e);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = msd::exp2_ftz((sc[i] - m_run[r]) * msd::kLog2e);
        ls[r] += sc[i];
      }
      msd::wgmma_wait<0>();  // the last tile's P V, which reads pb, ps and writes o
      msd::fence_regs(o);
      msd::fence_regs(pb);
      msd::fence_regs(ps);
      if (it > 0) msd::mbar_arrive(empty + prev);
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
      // The running O (to the last tile's max) plus the last tile's sum,
      // rescaled to this tile's max.
      if (it > 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float& run = o_run[kConsumers * i];
          run = (run + o[i]) * alpha[(i >> 1) & 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) msd::tf32_acc_frag(pb[kk], ps[kk], sc, kk);
    }
    const int last = (base + n_tiles - 1) % kStages;
    msd::wgmma_fence();
    pv_product(ring + last * kStageBytes);
    msd::wgmma_commit();
    msd::wgmma_wait<0>();
    msd::fence_regs(o);
    msd::mbar_arrive(empty + last);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += o_run[kConsumers * i];

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.q_len) continue;
      const long long at = ((long long)w.b * p.heads + w.h) * p.q_len + row;
      const float m = m_run[r];
      float* dst;
      float scale = 1.f;
      if (p.splits == 1) {
        if (p.stats != nullptr && t == 0) {
          p.stats[at] = m;
          p.stats[rows_total + at] = l_run[r];
        }
        scale = 1.f / fmaxf(l_run[r], 1e-37f);
        dst = p.out + w.b * p.q_sb + w.h * p.q_sh + row * p.q_sl;
      } else {
        const long long part = w.split * rows_total + at;
        if (t == 0) {
          p.part_ml[part] = m;
          p.part_ml[p.splits * rows_total + part] = l_run[r];
        }
        dst = p.part_acc + part * kTile;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r] * scale, o[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

// The route's launches on `stream` (flash_fwd.cu combines the key ranges
// when p.splits > 1): the split of K and V into `split`, then the kernel on
// a persistent grid. q in the layout of p's strides, k and v in theirs, the
// key mask uint8 [b, kv] or null. Returns a CUDA error code (0 on success).
inline int launch(const Params& p, const Split& split, const float* q, const float* k,
                  const float* v, const uint8_t* mask, long long kv_sb, long long kv_sl,
                  long long kv_sh, cudaStream_t stream) {
  const int bh = p.batch * p.heads;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!msd::f32_head_tile_map(&maps.q, q, p.batch, p.heads, p.q_len, p.q_sb, p.q_sl, p.q_sh) ||
      !msd::f32_rows_map(&maps.k_big, split.k_big, bh, p.kv_pad, kTile) ||
      !msd::f32_rows_map(&maps.k_small, split.k_small, bh, p.kv_pad, kTile) ||
      !msd::f32_cols_map(&maps.vt_big, split.vt_big, bh, p.kv_pad) ||
      !msd::f32_cols_map(&maps.vt_small, split.vt_small, bh, p.kv_pad)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mask != nullptr && !msd::key_mask_map(&maps.mask, mask, p.batch, p.kv_len, kMaskBox)) {
    return (int)cudaErrorInvalidValue;
  }
  msd::SplitJobs jobs;
  memset(&jobs, 0, sizeof(jobs));
  jobs.heads = p.heads;
  jobs.job[0] = {k, kv_sb, kv_sl, kv_sh, split.k_big, split.k_small, nullptr, nullptr,
                 p.kv_len, p.kv_pad};
  jobs.job[1] = {v, kv_sb, kv_sl, kv_sh, nullptr, nullptr, split.vt_big, split.vt_small,
                 p.kv_len, p.kv_pad};
  cudaError_t err = msd::launch_split(jobs, 2, p.batch, stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  }
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fwd_tf32_kernel);
  if (err != cudaSuccess) return (int)err;
  if (128 * 24 + kConsumers * kRegs > kThreads * attr.numRegs) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int items = (p.q_len + kRows - 1) / kRows * p.splits * p.heads * p.batch;
  fwd_tf32_kernel<<<min(items, sms), kThreads, kSmemBytes, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

}  // namespace fwd_tf32
