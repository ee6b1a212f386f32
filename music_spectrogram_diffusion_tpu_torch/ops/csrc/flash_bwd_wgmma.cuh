// The bf16 route of flash_bwd.cu on Hopper's warpgroup tensor-core products
// (wgmma) fed by the Tensor Memory Accelerator (TMA). Included by
// flash_bwd.cu, whose `msd_flash_bwd` sends a call here by `wgmma_route`.
//
// Replaces, for bf16 inputs at head_dim 64, the TPU kernel in
// music_spectrogram_diffusion_tpu/ops/attention.py: `_flash_bwd_pallas` and
// `_flash_bwd_kernel` (mxu_bf16). The arithmetic is flash_bwd.cu's bf16
// route: p = exp(s - m) / l from the forward's row max and sum, dV = p^T dO,
// dP = dO V^T, dS = p (dP - delta), dK = dS^T q, dQ = dS k; S and dP from
// bf16 operands, p and dS rounded to bf16 as they become the A operand of
// the products that follow, every sum in f32, dQ, dK, dV rounded to bf16
// once. The key mask and the optional f32 bias enter as in flash_bwd.cu.
//
// What bounds it on the card: 10 q kv d multiply-adds a (batch, head)
// (2 q kv d for each of the 5 products) at the bf16 tensor cores' 989
// TFLOP/s, against 7 (q + kv) d bf16 elements moved (q, dO, dQ, out and k,
// v, dK, dV): about 46 FLOP a byte at 2048x2048, far above the card's 295,
// so the tensor cores and the exps bound it, not memory. At 2048x2048,
// b = 8, h = 12 the bound is 0.26 ms. What the mma.sync route lost that
// to, and what this design does about each (PERF.md §6):
// - mma.sync m16n8k16 cannot reach the tensor cores' rate; every product
//   here is wgmma m64n64k16 on a warpgroup's 64 rows: S^T = K Q^T and
//   dP^T = V dO^T (dkdv) or S = Q K^T and dP = dO V^T (dq) with both
//   operands in shared memory, K-major; dV += P^T dO, dK += dS^T Q and
//   dQ += dS K with p or dS straight from the accumulators into registers
//   (the register-A form; see hopper.cuh) and the streamed tile read
//   N-major by wgmma's transposed B, so no product needs a transpose in
//   memory and one TMA copy of a tile serves both of its products.
// - Small tiles and one tile in flight, with a block-wide barrier each step:
//   here a work item owns 64 rows per consumer warpgroup (two in dkdv, two
//   or three in dq: `Shape`, `dq_wgs`) and streams 64-row tiles through a
//   ring of kStages = 4 stages that one producer thread keeps full with TMA
//   loads, tracked by mbarriers (a full and an empty barrier a stage); the
//   consumers never wait on each other. The producer warpgroup gives its
//   registers to the consumers (setmaxnreg): dkdv keeps S, dP, dK, dV and
//   the last tile's p and dS in 160 of its 240 registers a thread.
// - The exps and the products in turn: each warpgroup issues a tile's S and
//   dP, then the last tile's register-A products, and waits only for S and
//   dP, so the tensor cores run those products while the CUDA cores compute
//   this tile's p and dS. p = 2^(s log2 e + kt - m) / l takes one FFMA, one
//   subtraction and ex2.approx.ftz (m and the key terms kt arrive in log2
//   units; an all-masked row keeps p = 1 / l exactly, see the prologue).
// - A block's start (own rows in, the ring filled) cost as much as its few
//   tiles at q = 256: the grid is persistent, at most one block an SM, each
//   taking work items in a fixed order, with two buffers of own rows so the
//   next item's arrive while this one's products run.
// - TMA's zero fill covers the ragged ends (rows past q or kv), and a 4-D
//   tensor map [b, h, len, d] with the layout's strides covers both K/V
//   layouts without a copy.
// - The per-tile f32 sums (`kTileSums`) doubled the mma.sync route's
//   accumulators for an accuracy bf16 does not need: straight sums there
//   moved its worst error from 0.178 to 0.196 of the limit (PERF.md §6);
//   here every output sums straight on the tensor cores.
// - delta = rowsum(dO out) took three eager launches and ~250 MB of f32
//   copies in the wrapper; a prologue kernel here computes it from the bf16
//   tensors in f32 with coalesced reads, beside each row's m and 1 / l
//   (laid out per 64-row tile for one bulk copy a stage) and each key's
//   mask term.
// - The dq pass at q = 256 had 192 blocks for 132 SMs walking 36 key tiles
//   each; the wrapper's plan (ops/attention.py `dq_key_split`) cuts the
//   keys into ranges whose f32 partials a last kernel sums in range order.
// Two passes, not one: a single pass would sum dQ across key-tile blocks
// and save 2 of 7 products and one exp a score, but keeping it
// deterministic means each key tile waits its turn on a per-query-tile
// counter (or partials that move 1.6 GB at 2048x2048, b = 8); two passes
// have no cross-block sum at all, and at the measured rates (PERF.md §6)
// they already beat PyTorch's SDPA backward. Every output is summed in a
// fixed order, so two launches give the same bits.

#pragma once

#include "hopper.cuh"

namespace bwd_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;   // rows of a streamed tile; the head_dim taken
constexpr int kStages = 4;  // the TMA ring of streamed tiles
constexpr int kTileBytes = kTile * 128;  // a 64 x 64 bf16 tile in the 128-byte swizzle
constexpr int kStatFloats = 3 * kTile;   // a stage's row statistics (or key terms)
// own_full[2], own_empty[2], full[kStages], empty[kStages].
constexpr int kBars = 4 + 2 * kStages;

// A pass's block: WGS consumer warpgroups of 64 own rows each, then one
// producer warpgroup. The producer gives its registers to the consumers:
// 24 a thread for it, kRegs for each consumer thread (the SM's 65536 in
// all). dkdv keeps S, dP, dK, dV and the last tile's p and dS (two
// warpgroups, 240 registers); dq keeps S, dP, dQ and the last tile's dS,
// which fits three warpgroups' 160, and a third warpgroup's exps hide more
// of the products' latency (dq at 2048x2048, b = 8: 0.356 ms with two,
// 0.309 with three, PERF.md §6) where the queries fill 192-row items
// (`dq_wgs`).
template <int WGS>
struct Shape {
  static constexpr int kRows = 64 * WGS;  // a work item's own rows
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kConsumers = 128 * WGS;
  static constexpr int kOwnBytes = 2 * WGS * kTileBytes;  // own rows of two tensors
  static constexpr int kRegs = WGS == 2 ? 240 : 160;
  static_assert(128 * 24 + kConsumers * kRegs <= 65536, "the SM's registers");
  // Two buffers of own rows (the next work item's arrive while this one's
  // products run), the ring (two tiles a stage), the statistics, the
  // barriers, and 1024 bytes to align the tiles.
  static constexpr int kSmemBytes = 1024 + 2 * kOwnBytes + kStages * 2 * kTileBytes +
                                    kStages * kStatFloats * 4 + kBars * 8;
};
constexpr int kDkdvWgs = 2;
using DkdvShape = Shape<kDkdvWgs>;

// The dq pass's consumer warpgroups for q_len queries: three where 192-row
// items waste at most an eighth of the rows to padding, else two (q = 256:
// three would spend a third of the pass on padding).
inline int dq_wgs(int q_len) {
  return (q_len + 191) / 192 * 192 * 8 <= 9 * q_len ? 3 : 2;
}

struct Params {
  const float* bias;     // optional f32 [b, 1|h, q, kv]
  const float* rowstat;  // [b h][q_pad / 64][3][64]: m log2 e, 1 / l, delta (prologue)
  const float* kterm;    // [b][kv_pad]: 0, -1e10 log2 e (masked) or -inf (past kv_len)
  void* dq;              // bf16 like q, or f32 partials [splits][like q]
  void* dk;              // bf16 like k
  void* dv;              // bf16 like v
  int q_len, kv_len, heads, q_tiles, kv_pad, splits, tiles_per_split;
  long long q_sb, q_sl, q_sh;     // q, dO, dQ strides (elements)
  long long kv_sb, kv_sl, kv_sh;  // k, v, dK, dV strides
  long long bias_sb, bias_sh;
  long long part_stride;          // elements between two splits' dQ partials
};

// Lengths padded to whole work items: q_pad (the dq pass's items) and
// kv_pad (dkdv's).
inline int q_padded(int len) {
  const int rows = 64 * dq_wgs(len);
  return (len + rows - 1) / rows * rows;
}
inline int kv_padded(int len) {
  return (len + DkdvShape::kRows - 1) / DkdvShape::kRows * DkdvShape::kRows;
}

struct Smem {
  unsigned char* own;   // [2][own bytes]: two tensors' own rows, two buffers
  unsigned char* ring;  // [kStages][2][kTileBytes]
  float* stat;          // [kStages][kStatFloats]
  uint64_t* bar;        // [kBars]

  __device__ uint64_t* own_full(int buf) const { return bar + buf; }
  __device__ uint64_t* own_empty(int buf) const { return bar + 2 + buf; }
  __device__ uint64_t* full(int s) const { return bar + 4 + s; }
  __device__ uint64_t* empty(int s) const { return bar + 4 + kStages + s; }
  __device__ unsigned char* stage(int s) const { return ring + s * 2 * kTileBytes; }
};

// The block's shared memory, its barriers initialized.
template <int WGS>
__device__ __forceinline__ Smem setup(unsigned char* raw) {
  using S = Shape<WGS>;
  unsigned char* base = raw + ((1024 - (msd::smem_addr(raw) & 1023)) & 1023);
  Smem sm;
  sm.own = base;
  sm.ring = base + 2 * S::kOwnBytes;
  sm.stat = reinterpret_cast<float*>(sm.ring + kStages * 2 * kTileBytes);
  sm.bar = reinterpret_cast<uint64_t*>(sm.stat + kStages * kStatFloats);
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
  return sm;
}

// The producer's loads (one thread). Work item n's own rows (WGS 64-row
// tiles of each of two tensors from row0) into buffer n % 2, once the
// consumers are done with item n - 2.
template <int WGS>
__device__ __forceinline__ void load_own(const Smem& sm, int n, const CUtensorMap* a,
                                         const CUtensorMap* b_, int row0, int h, int b) {
  const int buf = n % 2;
  msd::mbar_wait(sm.own_empty(buf), ((n / 2) & 1) ^ 1);
  msd::mbar_expect_tx(sm.own_full(buf), Shape<WGS>::kOwnBytes);
  unsigned char* own = sm.own + buf * Shape<WGS>::kOwnBytes;
  for (int part = 0; part < WGS; ++part) {
    msd::tma_load_4d(own + part * kTileBytes, a, 0, row0 + part * kTile, h, b, sm.own_full(buf));
    msd::tma_load_4d(own + (WGS + part) * kTileBytes, b_, 0, row0 + part * kTile, h, b,
                     sm.own_full(buf));
  }
}

// Streamed tile number `ring_it` of the block (rows `row` of two tensors,
// and `stat_bytes` of per-row terms from `stat_src`) into stage
// ring_it % kStages, once the consumers have freed it.
__device__ __forceinline__ void load_tile(const Smem& sm, int ring_it, const CUtensorMap* a,
                                          const CUtensorMap* b_, int row, int h, int b,
                                          const float* stat_src, int stat_bytes) {
  const int s = ring_it % kStages;
  msd::mbar_wait(sm.empty(s), ((ring_it / kStages) & 1) ^ 1);
  msd::mbar_expect_tx(sm.full(s), 2 * kTileBytes + stat_bytes);
  msd::tma_load_4d(sm.stage(s), a, 0, row, h, b, sm.full(s));
  msd::tma_load_4d(sm.stage(s) + kTileBytes, b_, 0, row, h, b, sm.full(s));
  msd::bulk_load(sm.stat + s * kStatFloats, stat_src, stat_bytes, sm.full(s));
}

// dK and dV of work items of 128 keys, each walking the query tiles (with
// the f32 bias when BIAS).
template <bool BIAS>
__global__ void __launch_bounds__(DkdvShape::kThreads, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, int batch) {
  extern __shared__ unsigned char smem_raw[];
  using S = DkdvShape;
  const Smem sm = setup<kDkdvWgs>(smem_raw);
  const int n_tiles = (p.q_len + kTile - 1) / kTile;
  const int row_blocks = p.kv_pad / S::kRows, items = row_blocks * p.heads * batch;
  const int wg = threadIdx.x / 128;

  if (wg == kDkdvWgs) {
    msd::setmaxnreg_dec<24>();
    if (threadIdx.x == S::kConsumers) {
      int ring_it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const msd::Item w = msd::item_of(item, S::kRows, row_blocks, 1, p.heads);
        load_own<kDkdvWgs>(sm, n, &map_k, &map_v, w.row0, w.h, w.b);
        const float* rs = p.rowstat + ((long long)w.b * p.heads + w.h) * p.q_tiles * kStatFloats;
        for (int i = 0; i < n_tiles; ++i, ++ring_it) {
          load_tile(sm, ring_it, &map_q, &map_do, i * kTile, w.h, w.b, rs + i * kStatFloats,
                    kStatFloats * 4);
        }
      }
    }
    return;
  }
  msd::setmaxnreg_inc<S::kRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float dk[32], dv[32];
  uint32_t pa[4][4], da[4][4];
  // dV += p^T dO and dK += dS^T q for the tile in `pa`, `da` (its q and dO
  // at `qt`).
  auto dkdv_products = [&](const unsigned char* qt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      msd::wgmma_m64n64_rs<1>(dv, pa[kk], msd::sw128_n_desc(qt + kTileBytes, kTileBytes) + 128 * kk);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      msd::wgmma_m64n64_rs<1>(dk, da[kk], msd::sw128_n_desc(qt, kTileBytes) + 128 * kk);
    }
  };
  int ring_it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const msd::Item w = msd::item_of(item, S::kRows, row_blocks, 1, p.heads);
    const int buf = n % 2;
    const int key0 = w.row0 + wg * 64 + 16 * warp + g;  // the thread's keys: key0 and key0 + 8
    const float* kterm = p.kterm + (long long)w.b * p.kv_pad;
    const float kt[2] = {kterm[key0], kterm[key0 + 8]};  // in log2 units
    const float* bias = BIAS ? p.bias + w.b * p.bias_sb + w.h * p.bias_sh : nullptr;
    const unsigned char* own = sm.own + buf * S::kOwnBytes;
    const uint64_t a_k = msd::sw128_desc(own + wg * kTileBytes);
    const uint64_t a_v = msd::sw128_desc(own + (kDkdvWgs + wg) * kTileBytes);
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    msd::mbar_wait(sm.own_full(buf), (n / 2) & 1);

    for (int it = 0; it < n_tiles; ++it, ++ring_it) {
      const int s = ring_it % kStages, prev = (ring_it + kStages - 1) % kStages;
      const unsigned char* qt = sm.stage(s);
      msd::mbar_wait(sm.full(s), (ring_it / kStages) & 1);

      // This tile's S^T = K q^T and dP^T = V dO^T (64 keys by 64 queries),
      // then the last tile's dV and dK, which run on the tensor cores while
      // this tile's exps run on the CUDA cores.
      float sc[32], dp[32];
      msd::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::wgmma_m64n64_ss<0>(sc, a_k + 2 * kk, msd::sw128_desc(qt) + 2 * kk, kk);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::wgmma_m64n64_ss<0>(dp, a_v + 2 * kk, msd::sw128_desc(qt + kTileBytes) + 2 * kk, kk);
      }
      msd::wgmma_commit();
      if (it > 0) dkdv_products(sm.stage(prev));
      msd::wgmma_commit();
      msd::wgmma_wait<1>();  // this tile's S and dP
      msd::fence_regs(sc);
      msd::fence_regs(dp);

      // p^T and dS^T in place: p = 2^((s + bias) log2 e + kt - m) / l with
      // kt and m in log2 units. Element 4 j + 2 r + e is key key0 + 8 r,
      // query q0 + 8 j + 2 t + e; padded queries have 1 / l = 0.
      const float* st = sm.stat + s * kStatFloats;
      const int q0 = it * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 m = *reinterpret_cast<const float2*>(st + c);
        const float2 il = *reinterpret_cast<const float2*>(st + kTile + c);
        const float2 dl = *reinterpret_cast<const float2*>(st + 2 * kTile + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float x = sc[i];
            if (BIAS && q0 + c + e < p.q_len && key0 + 8 * r < p.kv_len) {
              x += bias[(long long)(q0 + c + e) * p.kv_len + key0 + 8 * r];
            }
            const float y = fmaf(x, msd::kLog2e, kt[r]) - (e ? m.y : m.x);
            const float pv = msd::exp2_ftz(y) * (e ? il.y : il.x);
            sc[i] = pv;
            dp[i] = pv * (dp[i] - (e ? dl.y : dl.x));
          }
        }
      }
      msd::wgmma_wait<0>();  // the last tile's dV and dK, which read pa, da
      msd::fence_regs(dk);
      msd::fence_regs(dv);
      if (it > 0) msd::mbar_arrive(sm.empty(prev));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::acc_to_a(pa[kk], sc, kk);
        msd::acc_to_a(da[kk], dp, kk);
      }
    }
    // The last tile's dV and dK; then its stage and the own rows are free.
    const int last = (ring_it + kStages - 1) % kStages;
    msd::wgmma_fence();
    dkdv_products(sm.stage(last));
    msd::wgmma_commit();
    msd::wgmma_wait<0>();
    msd::fence_regs(dk);
    msd::fence_regs(dv);
    msd::mbar_arrive(sm.empty(last));
    msd::mbar_arrive(sm.own_empty(buf));

    const long long off = w.b * p.kv_sb + w.h * p.kv_sh;
    bf16* dk_out = static_cast<bf16*>(p.dk) + off;
    bf16* dv_out = static_cast<bf16*>(p.dv) + off;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + 8 * r;
      if (row >= p.kv_len) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long at = row * p.kv_sl + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk_out + at) =
            msd::pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + at) =
            msd::pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dQ of work items of 128 queries over one range of key tiles (the whole of
// kv when p.splits == 1), each walking its key tiles in order (with the f32
// bias when BIAS).
template <int WGS, bool BIAS>
__global__ void __launch_bounds__(Shape<WGS>::kThreads, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do, int batch) {
  extern __shared__ unsigned char smem_raw[];
  using S = Shape<WGS>;
  const Smem sm = setup<WGS>(smem_raw);
  const int kv_tiles = (p.kv_len + kTile - 1) / kTile;
  const int row_blocks = p.q_tiles * kTile / S::kRows;
  const int items = row_blocks * p.splits * p.heads * batch;
  const int wg = threadIdx.x / 128;

  if (wg == WGS) {
    msd::setmaxnreg_dec<24>();
    if (threadIdx.x == S::kConsumers) {
      int ring_it = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const msd::Item w = msd::item_of(item, S::kRows, row_blocks, p.splits, p.heads);
        load_own<WGS>(sm, n, &map_q, &map_do, w.row0, w.h, w.b);
        const int tile0 = w.split * p.tiles_per_split;
        const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
        const float* kterm = p.kterm + (long long)w.b * p.kv_pad;
        for (int i = 0; i < n_tiles; ++i, ++ring_it) {
          load_tile(sm, ring_it, &map_k, &map_v, (tile0 + i) * kTile, w.h, w.b,
                    kterm + (tile0 + i) * kTile, kTile * 4);
        }
      }
    }
    return;
  }
  msd::setmaxnreg_inc<S::kRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float dq[32];
  uint32_t da[4][4];
  // dQ += dS k for the tile in `da` (its keys at `kt`).
  auto dq_product = [&](const unsigned char* kt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      msd::wgmma_m64n64_rs<1>(dq, da[kk], msd::sw128_n_desc(kt, kTileBytes) + 128 * kk);
    }
  };
  int ring_it = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const msd::Item w = msd::item_of(item, S::kRows, row_blocks, p.splits, p.heads);
    const int buf = n % 2;
    const int tile0 = w.split * p.tiles_per_split;
    const int n_tiles = min(p.tiles_per_split, kv_tiles - tile0);
    const int row0 = w.row0 + wg * 64 + 16 * warp + g;  // the thread's queries: row0 and row0 + 8
    float m[2], il[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      const float* rs = p.rowstat +
                        (((long long)w.b * p.heads + w.h) * p.q_tiles + qi / kTile) * kStatFloats +
                        qi % kTile;
      m[r] = rs[0];
      il[r] = rs[kTile];
      dl[r] = rs[2 * kTile];
    }
    const float* bias = BIAS ? p.bias + w.b * p.bias_sb + w.h * p.bias_sh : nullptr;
    const unsigned char* own = sm.own + buf * S::kOwnBytes;
    const uint64_t a_q = msd::sw128_desc(own + wg * kTileBytes);
    const uint64_t a_do = msd::sw128_desc(own + (WGS + wg) * kTileBytes);
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    msd::mbar_wait(sm.own_full(buf), (n / 2) & 1);

    for (int it = 0; it < n_tiles; ++it, ++ring_it) {
      const int s = ring_it % kStages, prev = (ring_it + kStages - 1) % kStages;
      const unsigned char* kt = sm.stage(s);
      msd::mbar_wait(sm.full(s), (ring_it / kStages) & 1);

      // This tile's S = q K^T and dP = dO V^T (64 queries by 64 keys), then
      // the last tile's dQ, which runs on the tensor cores while this
      // tile's exps run on the CUDA cores.
      float sc[32], dp[32];
      msd::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::wgmma_m64n64_ss<0>(sc, a_q + 2 * kk, msd::sw128_desc(kt) + 2 * kk, kk);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        msd::wgmma_m64n64_ss<0>(dp, a_do + 2 * kk, msd::sw128_desc(kt + kTileBytes) + 2 * kk, kk);
      }
      msd::wgmma_commit();
      if (it > 0) dq_product(sm.stage(prev));
      msd::wgmma_commit();
      msd::wgmma_wait<1>();  // this tile's S and dP
      msd::fence_regs(sc);
      msd::fence_regs(dp);
      const int key0 = (tile0 + it) * kTile;

      // dS in place of S (p as in dkdv). Element 4 j + 2 r + e is query
      // row0 + 8 r, key key0 + 8 j + 2 t + e; keys past kv_len have the term
      // -inf.
      const float* kts = sm.stat + s * kStatFloats;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
            const float pv = msd::exp2_ftz(fmaf(x, msd::kLog2e, e ? ktc.y : ktc.x) - m[r]) * il[r];
            sc[i] = pv * (dp[i] - dl[r]);
          }
        }
      }
      msd::wgmma_wait<0>();  // the last tile's dQ, which reads da
      msd::fence_regs(dq);
      if (it > 0) msd::mbar_arrive(sm.empty(prev));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) msd::acc_to_a(da[kk], sc, kk);
    }
    // The last tile's dQ; then its stage and the own rows are free.
    const int last = (ring_it + kStages - 1) % kStages;
    msd::wgmma_fence();
    dq_product(sm.stage(last));
    msd::wgmma_commit();
    msd::wgmma_wait<0>();
    msd::fence_regs(dq);
    msd::mbar_arrive(sm.empty(last));
    msd::mbar_arrive(sm.own_empty(buf));

    const long long off = w.b * p.q_sb + w.h * p.q_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.q_len) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long at = off + row * p.q_sl + 8 * j + 2 * t;
        const float x = dq[4 * j + 2 * r], y = dq[4 * j + 2 * r + 1];
        if (p.splits == 1) {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dq) + at) = msd::pack_bf16(x, y);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.dq) + w.split * p.part_stride + at) =
              make_float2(x, y);
        }
      }
    }
  }
}

// Per row of q: m log2 e, 1 / l and delta = rowsum(dO out) (f32 products
// of the bf16 values, each of 8 lanes summing 8 of them in order, then the
// lanes' sums in a fixed butterfly), each 64-row tile's three rows of 64 in
// a row (rows past q_len 0); per key: its mask term times log2 e (0,
// -1e10 log2 e, or -inf past kv_len). An all-masked row's m is -1e10
// exactly, so there m log2 e equals every key's term and p = 1 / l, as the
// forward's. Rows run over (b, q_pad, h), h fastest, so that a warp's four
// rows read 512 contiguous bytes of out and of dO; `row_threads` (8 a row,
// rounded up to whole warps) come first, then one thread a key.
__global__ void bwd_prologue_kernel(const Params p, const bf16* out, const bf16* dout,
                                    const float* stats, int batch, long long row_threads,
                                    const uint8_t* mask, float* rowstat, float* kterm) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q_pad = p.q_tiles * kTile;
  if (idx < row_threads) {
    const long long row = idx / 8;
    const int lane8 = idx % 8, h = row % p.heads, qi = row / p.heads % q_pad;
    const int b = row / ((long long)p.heads * q_pad);
    const bool valid = b < batch && qi < p.q_len;
    float dl = 0.f;
    if (valid) {
      const long long at = b * p.q_sb + qi * p.q_sl + h * p.q_sh + 8 * lane8;
      const uint4 ov = *reinterpret_cast<const uint4*>(out + at);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + at);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 o2 = *reinterpret_cast<const __nv_bfloat162*>(&ow[i]);
        const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dw[i]);
        dl = fmaf(__bfloat162float(d2.x), __bfloat162float(o2.x), dl);
        dl = fmaf(__bfloat162float(d2.y), __bfloat162float(o2.y), dl);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 4);
    dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (b < batch && lane8 == 0) {
      const long long bh = (long long)b * p.heads + h;
      float mv = 0.f, ilv = 0.f;
      if (valid) {
        const float* m = stats;
        const float* l = stats + (long long)batch * p.heads * p.q_len;
        mv = m[bh * p.q_len + qi] * msd::kLog2e;
        ilv = 1.f / l[bh * p.q_len + qi];
      }
      float* dst = rowstat + (bh * p.q_tiles + qi / kTile) * kStatFloats + qi % kTile;
      dst[0] = mv;
      dst[kTile] = ilv;
      dst[2 * kTile] = valid ? dl : 0.f;
    }
  } else if (idx < row_threads + (long long)batch * p.kv_pad) {
    const long long i = idx - row_threads;
    const int b = i / p.kv_pad, c = i % p.kv_pad;
    kterm[i] = c >= p.kv_len ? -INFINITY
                             : (mask != nullptr && !mask[(long long)b * p.kv_len + c]
                                    ? -1e10f * msd::kLog2e
                                    : 0.f);
  }
}

// dQ = the sum of the splits' f32 partials in split order, rounded to bf16;
// four elements a thread.
__global__ void bwd_dq_combine_kernel(const float* part, bf16* dq, long long n, int splits) {
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
  *reinterpret_cast<uint2*>(dq + i) =
      make_uint2(msd::pack_bf16(sum.x, sum.y), msd::pack_bf16(sum.z, sum.w));
}

// The dq pass with WGS consumer warpgroups, a persistent grid.
template <int WGS>
cudaError_t launch_dq(const Params& p, const CUtensorMap& map_q, const CUtensorMap& map_k,
                      const CUtensorMap& map_v, const CUtensorMap& map_do, int batch, int sms,
                      cudaStream_t stream) {
  using S = Shape<WGS>;
  const auto dq = p.bias != nullptr ? bwd_dq_wgmma_kernel<WGS, true>
                                    : bwd_dq_wgmma_kernel<WGS, false>;
  cudaError_t err =
      cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int items = q_padded(p.q_len) / S::kRows * p.splits * p.heads * batch;
  dq<<<min(items, sms), S::kThreads, S::kSmemBytes, stream>>>(p, map_q, map_k, map_v, map_do,
                                                              batch);
  return cudaGetLastError();
}

// The route's launches on `stream`: prologue, dkdv, dq and, with splits,
// the combine. dkdv and dq run a persistent grid of at most one block an
// SM. Returns a CUDA error code (0 on success).
inline int launch(Params p, const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* stats, const uint8_t* mask, float* rowstat,
                  float* kterm, void* dq_out, int batch, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!msd::head_tile_map(&map_q, q, batch, p.heads, p.q_len, p.q_sb, p.q_sl, p.q_sh) ||
      !msd::head_tile_map(&map_do, dout, batch, p.heads, p.q_len, p.q_sb, p.q_sl, p.q_sh) ||
      !msd::head_tile_map(&map_k, k, batch, p.heads, p.kv_len, p.kv_sb, p.kv_sl, p.kv_sh) ||
      !msd::head_tile_map(&map_v, v, batch, p.heads, p.kv_len, p.kv_sb, p.kv_sl, p.kv_sh)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  p.rowstat = rowstat;
  p.kterm = kterm;
  const long long rows = (long long)batch * q_padded(p.q_len) * p.heads;
  const long long row_threads = (8 * rows + 31) / 32 * 32;
  const long long work = row_threads + (long long)batch * p.kv_pad;
  bwd_prologue_kernel<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      p, static_cast<const bf16*>(out), static_cast<const bf16*>(dout), stats, batch,
      row_threads, mask, rowstat, kterm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool bias = p.bias != nullptr;
  const auto dkdv = bias ? bwd_dkdv_wgmma_kernel<true> : bwd_dkdv_wgmma_kernel<false>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkdvShape::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int kv_items = p.kv_pad / DkdvShape::kRows * p.heads * batch;
  dkdv<<<min(kv_items, sms), DkdvShape::kThreads, DkdvShape::kSmemBytes, stream>>>(
      p, map_q, map_k, map_v, map_do, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = dq_wgs(p.q_len) == 3 ? launch_dq<3>(p, map_q, map_k, map_v, map_do, batch, sms, stream)
                             : launch_dq<2>(p, map_q, map_k, map_v, map_do, batch, sms, stream);
  if (err != cudaSuccess) return (int)err;
  if (p.splits == 1) return 0;
  const long long n = p.part_stride;
  bwd_dq_combine_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(p.dq), static_cast<bf16*>(dq_out), n, p.splits);
  return (int)cudaGetLastError();
}

}  // namespace bwd_wgmma
