// The float32 route of flash_bwd.cu on Hopper's warpgroup tensor-core
// products (wgmma, tf32) fed by the Tensor Memory Accelerator (TMA).
// Included by flash_bwd.cu, whose `msd_flash_bwd` sends a call here by
// `wgmma_route`.
//
// Replaces, for f32 inputs at head_dim 64, the TPU kernel in
// music_spectrogram_diffusion_tpu/ops/attention.py: `_flash_bwd_pallas` and
// `_flash_bwd_kernel`. The arithmetic is flash_bwd.cu's f32 mma.sync
// route: p = exp(s - m) / l from the forward's row max and sum, dV = p^T
// dO, dP = dO V^T, dS = p (dP - delta), dK = dS^T q, dQ = dS k, every
// product 3xTF32 (small(a) big(b), big(a) small(b), then big(a) big(b),
// each term `split_tf32`'s: ops/attention.py `einsum_3xtf32`), every sum
// in f32; the key mask and the optional f32 bias enter as in flash_bwd.cu.
//
// What bounds it on the card: 10 q kv d multiply-adds a (batch, head), each
// a 3xTF32 product, at 495 / 3 = 165 TFLOP/s: 1.56 ms at 2048x2048, b = 8,
// 12 heads. What the mma.sync route lost that to, and what this design does
// about each (PERF.md §6):
// - mma.sync m16n8k8 cannot reach the tensor cores' rate: every product
//   here is wgmma m64nNk8 tf32 on a warpgroup's 64 own rows: S^T = K Q^T
//   and dP^T = V dO^T (dkdv) or S = Q K^T and dP = dO V^T (dq) at N = 32
//   streamed rows, and dV += P^T dO, dK += dS^T Q, dQ += dS K at N = 64.
// - tf32 wgmma reads B from shared memory K-major only, where the bf16
//   route reads dO, Q and K N-major; and the f32 accumulator is not an A
//   fragment as it stands. So a prologue (tf32_split.cuh `tf32_split_kernel`,
//   one launch a call) writes each operand's split terms once a call: q,
//   dO, k and v as [b h, len_pad, 64], and q, dO and k transposed, [b h,
//   64, len_pad], with the rows of each 8 in the order p's and dS's A
//   fragments take them (`tf32_acc_frag`). Every B tile then arrives by
//   TMA already split, where the mma.sync route split each B value at each
//   of its warps' uses.
// - Registers: a 3xTF32 A operand is two registers a value. The own rows'
//   big terms stay in shared memory (A read from there) and their small
//   terms in registers (dkdv: K's and V's, 64; dq: Q's and dO's, 64);
//   streamed tiles of 32 rows keep S, dP (16 each) and p's and dS's split
//   fragments (64) beside dK and dV (64) within 240 registers. A warpgroup
//   waits for its own products; the block's two consumer warpgroups
//   interleave on the tensor cores.
// - Sums: each tile's dV, dK or dQ is summed on the tensor cores into a
//   fresh accumulator, half the head_dim at a time, and added to the
//   running sum in f32 (`accumulate`), as the mma.sync route's `kTileSums`.
// - cp.async by every thread and a block-wide barrier each step: here one
//   producer thread keeps a ring of tiles (the 32 streamed rows' eight
//   split tiles in dkdv, six in dq, and their statistics or key terms)
//   full with TMA loads, tracked by a full and an empty mbarrier a stage,
//   and gives its warpgroup's registers to the consumers (setmaxnreg).
// - Persistent grids of at most one block an SM take 128-row items in a
//   fixed order; the dq pass's keys are cut into ranges where the queries
//   are few (ops/attention.py `dq_key_split`), their f32 partials summed in
//   range order by a last kernel.
// - delta = rowsum(dO out) took an eager einsum in the wrapper: the
//   prologue kernel computes it in f32 beside each row's m and 1 / l (laid
//   out per 32-row tile for one bulk copy a stage) and each key's mask
//   term, as flash_bwd_wgmma.cuh's does, but in natural units: p = 2^((s +
//   kt - m) log2 e) / l, the difference first, as flash_fwd_tf32.cuh summed
//   it.
// Every output is summed in a fixed order: two launches give the same bits.

#pragma once

#include <string.h>

#include "hopper.cuh"
#include "tf32_split.cuh"

namespace bwd_tf32 {

constexpr int kHead = 64;        // the head_dim taken
constexpr int kStream = 32;      // rows of a streamed tile: queries (dkdv), keys (dq)
constexpr int kWgs = 2;          // consumer warpgroups
constexpr int kRows = 64 * kWgs;  // a work item's own rows
constexpr int kThreads = 128 * (kWgs + 1);
constexpr int kConsumers = 128 * kWgs;
constexpr int kRegs = 240;  // a consumer thread's registers; the producer's 24
static_assert(128 * 24 + kConsumers * kRegs <= 65536, "the SM's registers");
constexpr int kOwnTile = 64 * 256;              // a warpgroup's 64 own rows of one tensor
constexpr int kOwnBytes = 2 * kWgs * kOwnTile;  // two tensors' own rows (big terms)
constexpr int kRowTile = kStream * 256;         // 32 streamed rows x 64, two swizzle atoms
constexpr int kColTile = kHead * kStream * 4;   // 64 x 32 streamed rows, one swizzle atom
constexpr int kStatFloats = 3 * kStream;        // a stage's row statistics (or key terms)

// A pass's ring: each stage holds the big and small terms of two tensors'
// streamed rows (rows layout), then NCOL tensors' transposed (cols layout).
template <int NCOL, int STAGES>
struct Shape {
  static constexpr int kStageBytes = 4 * kRowTile + 2 * NCOL * kColTile;
  static constexpr int kBars = 2 + 2 * STAGES;  // own_full, own_empty, full, empty
  static constexpr int kSmemBytes =
      1024 + kOwnBytes + STAGES * kStageBytes + STAGES * kStatFloats * 4 + kBars * 8;
};
constexpr int kDkdvStages = 2;  // q and dO, both transposed: 64 KB a stage
constexpr int kDqStages = 3;    // k and v, k transposed: 48 KB a stage
using DkdvShape = Shape<2, kDkdvStages>;
using DqShape = Shape<1, kDqStages>;

// The tensor maps of a pass: its two own tensors' big terms (boxes of 64
// rows), the streamed tiles' rows layout (tensor 0 big, small, tensor 1
// big, small; boxes of 32 rows) and cols layout (big, small of each).
struct Maps {
  CUtensorMap own[2], row[4], col[4];
};

struct Params {
  const float* bias;      // optional f32 [b, 1|h, q, kv]
  const float* rowstat;   // [b h][q_pad / 32][3][32]: m, 1 / l, delta
  const float* kterm;     // [b][kv_pad]: 0, -1e10 (masked) or -inf (past kv_len)
  const float* own_small[2];  // the pass's own tensors' small terms, rows layout
  float* dq;              // like q, or f32 partials [splits][like q]
  float* dk;              // like k
  float* dv;              // like v
  int q_len, kv_len, heads, q_pad, kv_pad, splits, tiles_per_split;
  long long q_sb, q_sl, q_sh;     // q, dO, dQ strides (elements)
  long long kv_sb, kv_sl, kv_sh;  // k, v, dK, dV strides
  long long bias_sb, bias_sh;
  long long part_stride;  // elements between two splits' dQ partials
};

struct Smem {
  unsigned char* own;   // [2][kWgs][kOwnTile]
  unsigned char* ring;  // [STAGES][kStageBytes]
  float* stat;          // [STAGES][kStatFloats]
  uint64_t* bar;
  int stage_bytes, stages;

  __device__ uint64_t* own_full() const { return bar; }
  __device__ uint64_t* own_empty() const { return bar + 1; }
  __device__ uint64_t* full(int s) const { return bar + 2 + s; }
  __device__ uint64_t* empty(int s) const { return bar + 2 + stages + s; }
  __device__ unsigned char* stage(int s) const { return ring + s * stage_bytes; }
  __device__ const unsigned char* own_tile(int tensor, int wg) const {
    return own + (tensor * kWgs + wg) * kOwnTile;
  }
};

template <class S, int STAGES>
__device__ __forceinline__ Smem setup(unsigned char* raw) {
  Smem sm;
  sm.own = raw + ((1024 - (msd::smem_addr(raw) & 1023)) & 1023);
  sm.ring = sm.own + kOwnBytes;
  sm.stat = reinterpret_cast<float*>(sm.ring + STAGES * S::kStageBytes);
  sm.bar = reinterpret_cast<uint64_t*>(sm.stat + STAGES * kStatFloats);
  sm.stage_bytes = S::kStageBytes;
  sm.stages = STAGES;
  if (threadIdx.x == 0) {
    msd::mbar_init(sm.own_full(), 1);
    msd::mbar_init(sm.own_empty(), kConsumers);
    for (int s = 0; s < STAGES; ++s) {
      msd::mbar_init(sm.full(s), 1);
      msd::mbar_init(sm.empty(s), kConsumers);
    }
    msd::fence_mbar_init();
  }
  __syncthreads();
  return sm;
}

// The producer's loads (one thread): work item n's own rows (row0 on, 64 a
// warpgroup, of both own tensors) once the consumers are done with item
// n - 1.
__device__ __forceinline__ void load_own(const Smem& sm, const Maps& maps, int n, int row0,
                                         int bh) {
  msd::mbar_wait(sm.own_empty(), (n & 1) ^ 1);
  msd::mbar_expect_tx(sm.own_full(), kOwnBytes);
  for (int tensor = 0; tensor < 2; ++tensor) {
    for (int part = 0; part < kWgs; ++part) {
      unsigned char* dst = sm.own + (tensor * kWgs + part) * kOwnTile;
      for (int half = 0; half < 2; ++half) {
        msd::tma_load_3d(dst + half * (kOwnTile / 2), &maps.own[tensor], 32 * half,
                         row0 + 64 * part, bh, sm.own_full());
      }
    }
  }
}

// Streamed tile number `ring_it` of the block (rows row .. row + 31 of each
// split tensor, and `stat_bytes` of per-row terms from `stat_src`) into its
// stage, once the consumers have freed it.
template <int NCOL>
__device__ __forceinline__ void load_stage(const Smem& sm, const Maps& maps, int ring_it, int row,
                                           int bh, const float* stat_src, int stat_bytes) {
  const int s = ring_it % sm.stages;
  unsigned char* st = sm.stage(s);
  msd::mbar_wait(sm.empty(s), ((ring_it / sm.stages) & 1) ^ 1);
  msd::mbar_expect_tx(sm.full(s), sm.stage_bytes + stat_bytes);
  for (int i = 0; i < 4; ++i) {
    for (int half = 0; half < 2; ++half) {
      msd::tma_load_3d(st + i * kRowTile + half * (kRowTile / 2), &maps.row[i], 32 * half, row,
                       bh, sm.full(s));
    }
  }
  for (int i = 0; i < 2 * NCOL; ++i) {
    msd::tma_load_3d(st + 4 * kRowTile + i * kColTile, &maps.col[i], row, 0, bh, sm.full(s));
  }
  msd::bulk_load(sm.stat + s * kStatFloats, stat_src, stat_bytes, sm.full(s));
}

// The small terms of the warp's 16 own rows (from row r0 of one head's
// [len_pad, 64] rows layout) as A fragments, one per k step of 8.
__device__ __forceinline__ void own_small_frags(uint32_t (&a)[8][4], const float* small, int r0,
                                                int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float* at = small + (long long)(r0 + g) * kHead + 8 * kk + t;
    a[kk][0] = __float_as_uint(__ldg(at));
    a[kk][1] = __float_as_uint(__ldg(at + 8 * kHead));
    a[kk][2] = __float_as_uint(__ldg(at + 4));
    a[kk][3] = __float_as_uint(__ldg(at + 8 * kHead + 4));
  }
}

// acc (+)= own rows x the streamed rows^T (64 x 32, k = the head_dim) in
// 3xTF32: the own tensor's small term from registers and big term from
// shared memory (`own`), the streamed tile's big and small terms (`big`,
// `small`, rows layout); acc is overwritten.
__device__ __forceinline__ void scores(float (&acc)[16], const uint32_t (&own_small)[8][4],
                                       const unsigned char* own, const unsigned char* big,
                                       const unsigned char* small) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t a = msd::tf32_desc(own, 64, kk), b = msd::tf32_desc(big, kStream, kk);
    msd::wgmma_tf32_rs(acc, own_small[kk], b, kk);
    msd::wgmma_tf32_ss(acc, a, msd::tf32_desc(small, kStream, kk), 1);
    msd::wgmma_tf32_ss(acc, a, b, 1);
  }
}

// acc += the split fragments of a 64 x 32 accumulator x a streamed tile's
// cols layout (k = the 32 streamed rows in `tf32_perm` order), in 3xTF32:
// each half of the head_dim's 64 columns summed on the tensor cores into a
// fresh accumulator (m64n32k8), then added to acc in f32. The tensor cores'
// adds drop low bits, so a sum over all of q or kv kept in one accumulator
// drifts: straight sums put a training step's gradients 1.1e-4 relative
// RMS from plain attention's (PERF.md §6); flash_bwd.cu's `kTileSums` is
// the same remedy on mma.sync.
__device__ __forceinline__ void accumulate(float (&acc)[32], const uint32_t (&big)[4][4],
                                           const uint32_t (&small)[4][4],
                                           const unsigned char* b_big,
                                           const unsigned char* b_small) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // Columns 32 half .. 32 half + 31: rows 32 half on of the cols tiles.
    const unsigned char* bb = b_big + half * 32 * 128;
    const unsigned char* bs = b_small + half * 32 * 128;
    float part[16];
    msd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b = msd::tf32_desc(bb, kHead, kk);
      msd::wgmma_tf32_rs(part, small[kk], b, kk);
      msd::wgmma_tf32_rs(part, big[kk], msd::tf32_desc(bs, kHead, kk));
      msd::wgmma_tf32_rs(part, big[kk], b);
    }
    msd::wgmma_commit();
    msd::wgmma_wait<0>();
    msd::fence_regs(part);
    // part[4 j + 2 r + e] is column 32 half + 8 j + 2 t + e of acc.
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[16 * half + i] += part[i];
  }
}

// dK and dV of work items of 128 keys, each walking the query tiles (with
// the f32 bias when BIAS).
template <bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_tf32_kernel(const __grid_constant__ Params p, const __grid_constant__ Maps maps,
                         int batch) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = setup<DkdvShape, kDkdvStages>(smem_raw);
  const int n_tiles = (p.q_len + kStream - 1) / kStream;
  const int q_tiles = p.q_pad / kStream;
  const int row_blocks = p.kv_pad / kRows, items = row_blocks * p.heads * batch;
  const int wg = threadIdx.x / 128;

  if (wg == kWgs) {
    msd::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int ring_it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const msd::Item w = msd::item_of(item, kRows, row_blocks, 1, p.heads);
        const int bh = w.b * p.heads + w.h;
        load_own(sm, maps, n, w.row0, bh);
        const float* rs = p.rowstat + (long long)bh * q_tiles * kStatFloats;
        for (int i = 0; i < n_tiles; ++i, ++ring_it) {
          load_stage<2>(sm, maps, ring_it, i * kStream, bh, rs + i * kStatFloats,
                        kStatFloats * 4);
        }
      }
    }
    return;
  }
  msd::setmaxnreg_inc<kRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float dk[32], dv[32];
  uint32_t ks[8][4], vs[8][4];
  int ring_it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const msd::Item w = msd::item_of(item, kRows, row_blocks, 1, p.heads);
    const long long bh = (long long)w.b * p.heads + w.h;
    const int key0 = w.row0 + wg * 64 + 16 * warp + g;  // the thread's keys: key0 and key0 + 8
    const float* kterm = p.kterm + (long long)w.b * p.kv_pad;
    const float kt[2] = {kterm[key0], kterm[key0 + 8]};
    const float* bias = BIAS ? p.bias + w.b * p.bias_sb + w.h * p.bias_sh : nullptr;
    own_small_frags(ks, p.own_small[0] + bh * p.kv_pad * kHead, key0 - g, g, t);
    own_small_frags(vs, p.own_small[1] + bh * p.kv_pad * kHead, key0 - g, g, t);
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    msd::mbar_wait(sm.own_full(), n & 1);
    const unsigned char* k_own = sm.own_tile(0, wg);
    const unsigned char* v_own = sm.own_tile(1, wg);

    for (int it = 0; it < n_tiles; ++it, ++ring_it) {
      const int s = ring_it % kDkdvStages;
      const unsigned char* st = sm.stage(s);
      msd::mbar_wait(sm.full(s), (ring_it / kDkdvStages) & 1);

      // S^T = K q^T and dP^T = V dO^T (64 keys by 32 queries).
      float sc[16], dp[16];
      msd::wgmma_fence();
      scores(sc, ks, k_own, st, st + kRowTile);
      scores(dp, vs, v_own, st + 2 * kRowTile, st + 3 * kRowTile);
      msd::wgmma_commit();
      msd::wgmma_wait<0>();
      msd::fence_regs(sc);
      msd::fence_regs(dp);

      // p^T and dS^T: p = 2^((s + bias + kt - m) log2 e) / l, in the
      // forward's natural units and order. Element 4 j + 2 r + e is key
      // key0 + 8 r, query q0 + 8 j + 2 t + e; padded queries have 1 / l = 0.
      const float* stat = sm.stat + s * kStatFloats;
      const int q0 = it * kStream;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 m = *reinterpret_cast<const float2*>(stat + c);
        const float2 il = *reinterpret_cast<const float2*>(stat + kStream + c);
        const float2 dl = *reinterpret_cast<const float2*>(stat + 2 * kStream + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float x = sc[i];
            if (BIAS && q0 + c + e < p.q_len && key0 + 8 * r < p.kv_len) {
              x += bias[(long long)(q0 + c + e) * p.kv_len + key0 + 8 * r];
            }
            x += kt[r];
            const float pv =
                msd::exp2_ftz((x - (e ? m.y : m.x)) * msd::kLog2e) * (e ? il.y : il.x);
            sc[i] = pv;
            dp[i] = pv * (dp[i] - (e ? dl.y : dl.x));
          }
        }
      }
      uint32_t pb[4][4], ps[4][4], db[4][4], ds[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::tf32_acc_frag(pb[kk], ps[kk], sc, kk);
        msd::tf32_acc_frag(db[kk], ds[kk], dp, kk);
      }
      // dV += p^T dO and dK += dS^T q over the tile's queries.
      const unsigned char* cols = st + 4 * kRowTile;
      accumulate(dv, pb, ps, cols + 2 * kColTile, cols + 3 * kColTile);
      accumulate(dk, db, ds, cols, cols + kColTile);
      msd::mbar_arrive(sm.empty(s));
    }
    msd::mbar_arrive(sm.own_empty());

    const long long off = w.b * p.kv_sb + w.h * p.kv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + 8 * r;
      if (row >= p.kv_len) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long at = off + row * p.kv_sl + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(p.dk + at) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(p.dv + at) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dQ of work items of 128 queries over one range of key tiles (the whole of
// kv when p.splits == 1), each walking its key tiles in order (with the f32
// bias when BIAS).
template <bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_tf32_kernel(const __grid_constant__ Params p, const __grid_constant__ Maps maps,
                       int batch) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = setup<DqShape, kDqStages>(smem_raw);
  const int kv_tiles = (p.kv_len + kStream - 1) / kStream;
  const int q_tiles = p.q_pad / kStream;
  const int row_blocks = p.q_pad / kRows;
  const int items = row_blocks * p.splits * p.heads * batch;
  const int wg = threadIdx.x / 128;

  if (wg == kWgs) {
    msd::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int ring_it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const msd::Item w = msd::item_of(item, kRows, row_blocks, p.splits, p.heads);
        const int bh = w.b * p.heads + w.h;
        load_own(sm, maps, n, w.row0, bh);
        const int tile0 = w.split * p.tiles_per_split;
        const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
        const float* kterm = p.kterm + (long long)w.b * p.kv_pad;
        for (int i = 0; i < n_tiles; ++i, ++ring_it) {
          load_stage<1>(sm, maps, ring_it, (tile0 + i) * kStream, bh,
                        kterm + (tile0 + i) * kStream, kStream * 4);
        }
      }
    }
    return;
  }
  msd::setmaxnreg_inc<kRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float dq[32];
  uint32_t qs[8][4], dos[8][4];
  int ring_it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const msd::Item w = msd::item_of(item, kRows, row_blocks, p.splits, p.heads);
    const long long bh = (long long)w.b * p.heads + w.h;
    const int tile0 = w.split * p.tiles_per_split;
    const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
    const int row0 = w.row0 + wg * 64 + 16 * warp + g;  // the thread's queries: row0 and row0 + 8
    float m[2], il[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      const float* rs = p.rowstat + (bh * q_tiles + qi / kStream) * kStatFloats + qi % kStream;
      m[r] = rs[0];
      il[r] = rs[kStream];
      dl[r] = rs[2 * kStream];
    }
    const float* bias = BIAS ? p.bias + w.b * p.bias_sb + w.h * p.bias_sh : nullptr;
    own_small_frags(qs, p.own_small[0] + bh * p.q_pad * kHead, row0 - g, g, t);
    own_small_frags(dos, p.own_small[1] + bh * p.q_pad * kHead, row0 - g, g, t);
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    msd::mbar_wait(sm.own_full(), n & 1);
    const unsigned char* q_own = sm.own_tile(0, wg);
    const unsigned char* do_own = sm.own_tile(1, wg);

    for (int it = 0; it < n_tiles; ++it, ++ring_it) {
      const int s = ring_it % kDqStages;
      const unsigned char* st = sm.stage(s);
      msd::mbar_wait(sm.full(s), (ring_it / kDqStages) & 1);

      // S = q K^T and dP = dO V^T (64 queries by 32 keys).
      float sc[16], dp[16];
      msd::wgmma_fence();
      scores(sc, qs, q_own, st, st + kRowTile);
      scores(dp, dos, do_own, st + 2 * kRowTile, st + 3 * kRowTile);
      msd::wgmma_commit();
      msd::wgmma_wait<0>();
      msd::fence_regs(sc);
      msd::fence_regs(dp);
      const int key0 = (tile0 + it) * kStream;

      // dS in place of S. Element 4 j + 2 r + e is query row0 + 8 r, key
      // key0 + 8 j + 2 t + e; keys past kv_len have the term -inf.
      const float* kts = sm.stat + s * kStatFloats;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 ktc = *reinterpret_cast<const float2*>(kts + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float x = sc[i];
            if (BIAS && row0 + 8 * r < p.q_len && key0 + c + e < p.kv_len) {
              x += bias[(long long)(row0 + 8 * r) * p.kv_len + key0 + c + e];
            }
            x += e ? ktc.y : ktc.x;
            const float pv = msd::exp2_ftz((x - m[r]) * msd::kLog2e) * il[r];
            sc[i] = pv * (dp[i] - dl[r]);
          }
        }
      }
      uint32_t db[4][4], ds[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) msd::tf32_acc_frag(db[kk], ds[kk], sc, kk);
      // dQ += dS k over the tile's keys.
      const unsigned char* cols = st + 4 * kRowTile;
      accumulate(dq, db, ds, cols, cols + kColTile);
      msd::mbar_arrive(sm.empty(s));
    }
    msd::mbar_arrive(sm.own_empty());

    const long long off = w.b * p.q_sb + w.h * p.q_sh + (long long)w.split * p.part_stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.q_len) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(p.dq + off + row * p.q_sl + 8 * j + 2 * t) =
            make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
      }
    }
  }
}

// Per row of q: m, 1 / l and delta = rowsum(dO out) (f32, each of 8 lanes
// summing 8 products in order, then the lanes' sums in a fixed butterfly),
// each 32-row tile's three rows of 32 in a row (rows past q_len 0); per
// key: its mask term (0, -1e10, or -inf past kv_len). An all-masked row's
// m is -1e10 exactly, as each of its keys' s - 1e10, so its p = 1 / l as
// the forward's. Rows run over (b, q_pad, h), h fastest.
__global__ void bwd_tf32_prologue_kernel(const Params p, const float* out, const float* dout,
                                         const float* stats, int batch, long long row_threads,
                                         const uint8_t* mask, float* rowstat, float* kterm) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < row_threads) {
    const long long row = idx / 8;
    const int lane8 = idx % 8, h = row % p.heads, qi = row / p.heads % p.q_pad;
    const int b = row / ((long long)p.heads * p.q_pad);
    const bool valid = b < batch && qi < p.q_len;
    float dl = 0.f;
    if (valid) {
      const long long at = b * p.q_sb + qi * p.q_sl + h * p.q_sh + 8 * lane8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 o = *reinterpret_cast<const float4*>(out + at + 4 * half);
        const float4 d = *reinterpret_cast<const float4*>(dout + at + 4 * half);
        dl = fmaf(d.x, o.x, dl);
        dl = fmaf(d.y, o.y, dl);
        dl = fmaf(d.z, o.z, dl);
        dl = fmaf(d.w, o.w, dl);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 4);
    dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (b < batch && lane8 == 0) {
      const long long bh = (long long)b * p.heads + h;
      float mv = 0.f, ilv = 0.f;
      if (valid) {
        const float* l = stats + (long long)batch * p.heads * p.q_len;
        mv = stats[bh * p.q_len + qi];
        ilv = 1.f / l[bh * p.q_len + qi];
      }
      float* dst = rowstat + (bh * (p.q_pad / kStream) + qi / kStream) * kStatFloats + qi % kStream;
      dst[0] = mv;
      dst[kStream] = ilv;
      dst[2 * kStream] = valid ? dl : 0.f;
    }
  } else if (idx < row_threads + (long long)batch * p.kv_pad) {
    const long long i = idx - row_threads;
    const int b = i / p.kv_pad, c = i % p.kv_pad;
    kterm[i] = c >= p.kv_len ? -INFINITY
                             : (mask != nullptr && !mask[(long long)b * p.kv_len + c] ? -1e10f
                                                                                       : 0.f);
  }
}

// dQ = the sum of the splits' f32 partials in split order; four elements a
// thread.
__global__ void bwd_tf32_dq_combine_kernel(const float* part, float* dq, long long n,
                                           int splits) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 sum = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(part + s * n + i);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  *reinterpret_cast<float4*>(dq + i) = sum;
}

// Floats of a call's split scratch (`launch`): q's and dO's terms (rows and
// cols layouts, big and small: 8 x q_pad rows of 64 a head) and k's (rows
// and cols) and v's (rows): 6 x kv_pad.
inline long long split_floats(int batch, int heads, int q_pad, int kv_pad) {
  return (long long)batch * heads * kHead * (8LL * q_pad + 6LL * kv_pad);
}

template <class K>
cudaError_t prepare(K kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// The route's launches on `stream`: the split, the prologue, dkdv, dq and,
// with splits, the combine. p's q_pad (q_len rounded up to kRows), kv_pad
// (kv_len rounded up to kRows), strides and dq (the output, or f32
// partials with splits) are set by the caller. Returns a CUDA error code
// (0 on success).
inline int launch(Params p, const float* q, const float* k, const float* v, const float* out,
                  const float* dout, const float* stats, const uint8_t* mask, float* rowstat,
                  float* kterm, float* split, float* dq_out, int batch, cudaStream_t stream) {
  const int bh = batch * p.heads;
  const long long nq = (long long)bh * p.q_pad * kHead, nk = (long long)bh * p.kv_pad * kHead;
  float* q_big = split;
  float* q_small = q_big + nq;
  float* do_big = q_small + nq;
  float* do_small = do_big + nq;
  float* qt_big = do_small + nq;
  float* qt_small = qt_big + nq;
  float* dot_big = qt_small + nq;
  float* dot_small = dot_big + nq;
  float* k_big = dot_small + nq;
  float* k_small = k_big + nk;
  float* v_big = k_small + nk;
  float* v_small = v_big + nk;
  float* kt_big = v_small + nk;
  float* kt_small = kt_big + nk;
  Maps dkdv_maps, dq_maps;
  memset(&dkdv_maps, 0, sizeof(dkdv_maps));
  memset(&dq_maps, 0, sizeof(dq_maps));
  const bool ok =
      msd::f32_rows_map(&dkdv_maps.own[0], k_big, bh, p.kv_pad, 64) &&
      msd::f32_rows_map(&dkdv_maps.own[1], v_big, bh, p.kv_pad, 64) &&
      msd::f32_rows_map(&dkdv_maps.row[0], q_big, bh, p.q_pad, kStream) &&
      msd::f32_rows_map(&dkdv_maps.row[1], q_small, bh, p.q_pad, kStream) &&
      msd::f32_rows_map(&dkdv_maps.row[2], do_big, bh, p.q_pad, kStream) &&
      msd::f32_rows_map(&dkdv_maps.row[3], do_small, bh, p.q_pad, kStream) &&
      msd::f32_cols_map(&dkdv_maps.col[0], qt_big, bh, p.q_pad) &&
      msd::f32_cols_map(&dkdv_maps.col[1], qt_small, bh, p.q_pad) &&
      msd::f32_cols_map(&dkdv_maps.col[2], dot_big, bh, p.q_pad) &&
      msd::f32_cols_map(&dkdv_maps.col[3], dot_small, bh, p.q_pad) &&
      msd::f32_rows_map(&dq_maps.own[0], q_big, bh, p.q_pad, 64) &&
      msd::f32_rows_map(&dq_maps.own[1], do_big, bh, p.q_pad, 64) &&
      msd::f32_rows_map(&dq_maps.row[0], k_big, bh, p.kv_pad, kStream) &&
      msd::f32_rows_map(&dq_maps.row[1], k_small, bh, p.kv_pad, kStream) &&
      msd::f32_rows_map(&dq_maps.row[2], v_big, bh, p.kv_pad, kStream) &&
      msd::f32_rows_map(&dq_maps.row[3], v_small, bh, p.kv_pad, kStream) &&
      msd::f32_cols_map(&dq_maps.col[0], kt_big, bh, p.kv_pad) &&
      msd::f32_cols_map(&dq_maps.col[1], kt_small, bh, p.kv_pad);
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  msd::SplitJobs jobs;
  memset(&jobs, 0, sizeof(jobs));
  jobs.heads = p.heads;
  jobs.job[0] = {q, p.q_sb, p.q_sl, p.q_sh, q_big, q_small, qt_big, qt_small, p.q_len, p.q_pad};
  jobs.job[1] = {dout, p.q_sb, p.q_sl, p.q_sh, do_big, do_small, dot_big, dot_small, p.q_len,
                 p.q_pad};
  jobs.job[2] = {k, p.kv_sb, p.kv_sl, p.kv_sh, k_big, k_small, kt_big, kt_small, p.kv_len,
                 p.kv_pad};
  jobs.job[3] = {v, p.kv_sb, p.kv_sl, p.kv_sh, v_big, v_small, nullptr, nullptr, p.kv_len,
                 p.kv_pad};
  err = msd::launch_split(jobs, 4, batch, stream);
  if (err != cudaSuccess) return (int)err;
  p.rowstat = rowstat;
  p.kterm = kterm;
  const long long rows = (long long)batch * p.q_pad * p.heads;
  const long long row_threads = (8 * rows + 31) / 32 * 32;
  const long long work = row_threads + (long long)batch * p.kv_pad;
  bwd_tf32_prologue_kernel<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      p, out, dout, stats, batch, row_threads, mask, rowstat, kterm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool bias = p.bias != nullptr;
  const auto dkdv = bias ? bwd_dkdv_tf32_kernel<true> : bwd_dkdv_tf32_kernel<false>;
  const auto dq = bias ? bwd_dq_tf32_kernel<true> : bwd_dq_tf32_kernel<false>;
  err = prepare(dkdv, DkdvShape::kSmemBytes);
  if (err == cudaSuccess) err = prepare(dq, DqShape::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  Params pk = p;
  pk.own_small[0] = k_small;
  pk.own_small[1] = v_small;
  const int kv_items = p.kv_pad / kRows * p.heads * batch;
  dkdv<<<min(kv_items, sms), kThreads, DkdvShape::kSmemBytes, stream>>>(pk, dkdv_maps, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params pq = p;
  pq.own_small[0] = q_small;
  pq.own_small[1] = do_small;
  const int q_items = p.q_pad / kRows * p.splits * p.heads * batch;
  dq<<<min(q_items, sms), kThreads, DqShape::kSmemBytes, stream>>>(pq, dq_maps, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long n = p.part_stride;
  bwd_tf32_dq_combine_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(p.dq, dq_out, n,
                                                                                 p.splits);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tf32
