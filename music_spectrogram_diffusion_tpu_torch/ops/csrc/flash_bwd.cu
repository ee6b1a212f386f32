// Flash-attention backward for NVIDIA Hopper (sm_90a), float32 or bfloat16,
// on the tensor cores, with a plain C entry point loaded through ctypes (no
// PyTorch headers, no CUTLASS).
//
// Replaces the TPU kernel in music_spectrogram_diffusion_tpu/ops/attention.py:
// `_flash_bwd_pallas` (the pallas_call) and `_flash_bwd_kernel`, reached
// through `flash_attention_diff`'s custom VJP. For the forward
//
//     out = softmax(s) v,   s = q k^T + bias + (keep - 1) * 1e10
//
// (no 1/sqrt(d), keys at or past kv_len never scored, as flash_fwd.cu) it
// computes, per (batch, head),
//
//     p  = exp(s - m) / l            (m, l: the forward's row max and sum)
//     dV = p^T dO,  dP = dO V^T,  dS = p (dP - delta),  delta = rowsum(dO out)
//     dK = dS^T q,  dQ = dS k
//
// Bias and mask are not differentiated. Rebuilding p from m and l, not
// from lse = m + log l, gives an all-masked row exactly the forward's even
// 1 / kv_len (its scores all round to -1e10, and so would lse), finite,
// with no special case.
//
// Layouts as the forward: q, dO and dQ [b, q, h, d]; k, v, dK, dV
// [b, kv, h, d], or [b, h, kv, d] when kv_transposed; bias an optional f32
// [b, 1|h, q, kv]; the key mask an optional uint8 [b, kv]; m, l, delta f32
// [b, h, q]. q, k, v, dO and the three gradients are all f32 or all bf16
// (the training path's type: bf16 when the model trains in bfloat16).
//
// Two routes, chosen per call by `wgmma_route` (mirrored by
// ops/attention.py `bwd_route`, which the CPU tests hold):
// - bf16 at head_dim 64 with 16-byte-aligned q, k, v, out and dO (every
//   training call of the model): the wgmma route of flash_bwd_wgmma.cuh,
//   TMA-fed warpgroup products, which computes delta itself;
// - every other call (f32; bf16 at another head_dim or misaligned): the
//   mma.sync route below, with delta from the wrapper.
// A route, not a fallback: nothing retries a call that fails on the other.
//
// The mma.sync route, as the TPU kernel computes it (mxu_bf16 on bf16
// inputs):
// - f32: every product is 3xTF32 mma.sync m16n8k8 (attention_mma.cuh),
//   accurate to f32's tolerance where plain TF32 is not;
// - bf16: S = q k^T and dP = dO V^T are mma.sync m16n8k16 on the bf16
//   operands with f32 sums; p and dS are computed in f32 and rounded to bf16
//   (round to nearest even) as they enter the A fragments of dV += p^T dO,
//   dK += dS^T q and dQ += dS k; every sum is f32, and dQ, dK, dV are
//   rounded to bf16 once, when they are written. Operand fragments are read
//   with ldmatrix (.trans where the product runs along the rows of dO, q
//   or k), from rows padded so that it touches every bank once.
//
// What bounds it on the card: 10·q·kv·d operations for about 7·(q + kv)·d
// elements moved, so arithmetic: bf16 at the tensor cores' 989 TFLOP/s, f32
// at 495 / 3 = 165 TFLOP/s (3xTF32; plain TF32 fails the training path's
// 1e-4 limits). The design. Blocks on the card run in parallel and in no
// order, where the TPU kernel adds each key block's dQ into an output block
// it revisits along a sequential grid; so this is two passes, neither with
// atomics, and every gradient is deterministic:
//   dkdv: a block per (64-key tile, head, batch), a warp per 16 keys, walks
//         the query tiles and keeps its keys' dK and dV in mma accumulators
//         (4 products: S^T = k q^T, dP^T = v dO^T, dV += p^T dO,
//         dK += dS^T q);
//   dq:   a block per (64-query tile, head, batch), a warp per 16 queries,
//         walks the key tiles in order and keeps its rows' dQ in mma
//         accumulators (3 products: S, dP, dQ += dS k).
// That is 7 products of q·kv·d where one pass would do 5; the other design,
// one pass writing per-key-tile dQ partials to scratch that a second kernel
// sums in order, moves 1.6 GB at the 2048x2048, b=8 training shape (f32).
// p and dS go from the accumulators straight into the A fragments of the
// products that follow, and each tile's dQ, dK, dV are summed apart and
// added in f32 (`kTileSums`).
// The streamed tiles (q and dO, or k and v) arrive by 16-byte cp.async into a
// two-stage ring, so the next tile loads while this one multiplies; the
// block's own rows are staged once. Every output is summed in a fixed order.

#include "attention_mma.cuh"
#include "flash_bwd_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using msd::FragA;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // the block's own rows (keys in dkdv, queries in dq)
constexpr int kStages = 2;

// The tensor cores' f32 sums lose low bits over a long sum (2048 keys or
// queries): summed straight, the f32 route's dQ, dK and dV were 1.7e-5
// relative RMS from the plain version at 2048x2048, 3e-6 at 256x256. So each
// streamed tile's products are summed on the tensor cores into a fresh
// accumulator and added to the running sum in f32: 1.75e-6 at 2048x2048, for
// 3.4% of the time there (PERF.md §6). dkdv at d = 128 has no registers for
// the tile's dK and dV beside the running ones, and sums straight. Both types
// take the same rule.
template <int D>
constexpr bool kTileSums = D <= 64;
// Rows of each streamed tile, so that the accumulators (dkdv: S^T, dP^T,
// dK, dV and the tile's dK, dV; dq: S, dP, dQ and the tile's dQ) stay in
// registers without spills.
template <int D>
constexpr int kDkdvRows = D <= 64 ? 32 : 16;
template <int D>
constexpr int kDqRows = D <= 32 ? 64 : (D <= 64 ? 32 : 16);
// A shared-memory row of D elements, padded (attention_mma.cuh): D + 4
// floats, D + 8 bf16.
template <int D, typename T>
constexpr int kLD = D + (sizeof(T) == 4 ? 4 : 8);

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const uint8_t* mask;
  const float* m;      // [b, h, q] row max
  const float* l;      // [b, h, q] row sum
  const float* delta;  // [b, h, q] rowsum(dO * out), f32
  const void* dout;    // like q
  void* dq;            // like q
  void* dk;            // like k
  void* dv;            // like v
  int q_len, kv_len, head_dim, heads;
  bool vec;                       // 16-byte cp.async loads (see msd::load_tile)
  long long q_sb, q_sl, q_sh;     // q, dO and dQ strides (elements)
  long long kv_sb, kv_sl, kv_sh;  // k, v, dK and dV strides
  long long bias_sb, bias_sh;     // bias_sh == 0 broadcasts one bias over heads
};

template <int D, typename T>
constexpr size_t dkdv_smem_bytes() {
  // Own K and V, [kStages] q and dO tiles, [kStages][3] statistics rows.
  constexpr int LD = kLD<D, T>;
  return sizeof(T) * (size_t)(2 * kRows * LD + 2 * kStages * kDkdvRows<D> * LD) +
         sizeof(float) * (size_t)(3 * kStages * kDkdvRows<D>);
}

template <int D, typename T>
constexpr size_t dq_smem_bytes() {
  // Own q and dO, [kStages] K and V tiles, [kStages] key terms.
  constexpr int LD = kLD<D, T>;
  return sizeof(T) * (size_t)(2 * kRows * LD + 2 * kStages * kDqRows<D> * LD) +
         sizeof(float) * (size_t)(kStages * kDqRows<D>);
}

// Stores a warp's 16 x D accumulator rows (rows row0 and row0 + 8 of the
// thread) into a [len, head_dim] output with row stride sl, rounded to T.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, long long sl, int row0, int len, int head_dim,
                                           int t, const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= len) continue;
    T* o = out + (long long)row * sl;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < head_dim) o[col] = msd::from_f32<T>(acc[n][2 * r]);
      if (col + 1 < head_dim) o[col + 1] = msd::from_f32<T>(acc[n][2 * r + 1]);
    }
  }
}

// bf16 fragments of m16n8k16 from a tile in shared memory (row stride LD):
// A of rows [r0, r0 + 16), columns [c0, c0 + 16).
template <int LD>
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0,
                                           int lane) {
  msd::ldmatrix_x4(a, tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + c0 + 8 * (lane >> 4));
}

// B of two 8-wide n tiles whose n index runs along rows [n0, n0 + 16) and k
// along columns [c0, c0 + 16) (as k in S = q k^T): b[0], b[1] the first tile,
// b[2], b[3] the second.
template <int LD>
__device__ __forceinline__ void ldmatrix_b_rows(uint32_t (&b)[4], const bf16* tile, int n0, int c0,
                                                int lane) {
  const int mi = lane >> 3;
  msd::ldmatrix_x4(b, tile + (n0 + 8 * (mi >> 1) + (lane & 7)) * LD + c0 + 8 * (mi & 1));
}

// B of two 8-wide n tiles whose k index runs along rows [k0, k0 + 16) and n
// along columns [n0, n0 + 16) (as dO in dV = p^T dO): transposed reads.
template <int LD>
__device__ __forceinline__ void ldmatrix_b_cols(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                                int lane) {
  const int mi = lane >> 3;
  msd::ldmatrix_x4_trans(b, tile + (k0 + 8 * (mi & 1) + (lane & 7)) * LD + n0 + 8 * (mi >> 1));
}

// The A fragment of two 16 x 8 accumulator tiles (k = 16 columns), each
// value rounded to bf16: how p and dS enter the products that follow.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = msd::pack_bf16(c0[0], c0[1]);
  a[1] = msd::pack_bf16(c0[2], c0[3]);
  a[2] = msd::pack_bf16(c1[0], c1[1]);
  a[3] = msd::pack_bf16(c1[2], c1[3]);
}

// dK and dV of one 64-key tile, walking the query tiles.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Params p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int LD = kLD<D, T>, kTQ = kDkdvRows<D>, kNT = kTQ / 8, kDT = D / 8;
  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);                              // [kRows][LD] the block's keys
  T* vs = ks + kRows * LD;                                          // [kRows][LD]
  T* qs = vs + kRows * LD;                                          // [kStages][kTQ][LD]
  T* dos = qs + kStages * kTQ * LD;                                 // [kStages][kTQ][LD]
  float* stat = reinterpret_cast<float*>(dos + kStages * kTQ * LD);  // [kStages][3][kTQ]: m, 1 / l, delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int key0 = k0 + 16 * warp + g;  // the thread's keys: key0 and key0 + 8

  const long long q_off = b * p.q_sb + h * p.q_sh;
  const long long kv_off = b * p.kv_sb + h * p.kv_sh;
  const long long stat_off = ((long long)b * p.heads + h) * p.q_len;
  const T* q = static_cast<const T*>(p.q) + q_off;
  const T* dout = static_cast<const T*>(p.dout) + q_off;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  float kterm[2];
  bool kvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    kvalid[r] = key < p.kv_len;
    kterm[r] = (p.mask != nullptr && kvalid[r] && !p.mask[(long long)b * p.kv_len + key])
                   ? -1e10f
                   : 0.f;
  }

  auto load_q = [&](int tile, int stage) {
    const int q0 = tile * kTQ;
    msd::load_tile<kTQ, D, LD, kThreads>(qs + stage * kTQ * LD, q, q0, p.q_len, p.head_dim,
                                         p.q_sl, p.vec);
    msd::load_tile<kTQ, D, LD, kThreads>(dos + stage * kTQ * LD, dout, q0, p.q_len, p.head_dim,
                                         p.q_sl, p.vec);
    float* st = stat + stage * 3 * kTQ;
    for (int i = threadIdx.x; i < kTQ; i += kThreads) {
      const int qi = q0 + i;
      const bool valid = qi < p.q_len;
      st[i] = valid ? p.m[stat_off + qi] : 0.f;
      st[kTQ + i] = valid ? 1.f / p.l[stat_off + qi] : 0.f;
      st[2 * kTQ + i] = valid ? p.delta[stat_off + qi] : 0.f;
    }
  };

  msd::load_tile<kRows, D, LD, kThreads>(ks, static_cast<const T*>(p.k) + kv_off, k0, p.kv_len,
                                         p.head_dim, p.kv_sl, p.vec);
  msd::load_tile<kRows, D, LD, kThreads>(vs, static_cast<const T*>(p.v) + kv_off, k0, p.kv_len,
                                         p.head_dim, p.kv_sl, p.vec);
  const int n_tiles = (p.q_len + kTQ - 1) / kTQ;
  load_q(0, 0);
  msd::cp_async_commit();

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    msd::cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed, and every warp is done with tile it - 1
    if (it + 1 < n_tiles) load_q(it + 1, (it + 1) % kStages);
    msd::cp_async_commit();

    const int stage = it % kStages;
    const T* qt = qs + stage * kTQ * LD;
    const T* dot = dos + stage * kTQ * LD;
    const float* st = stat + stage * 3 * kTQ;
    const int q0 = it * kTQ;

    // S^T = k q^T and dP^T = v dO^T for the warp's 16 keys by kTQ queries.
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        const float* kr = ks + (16 * warp + g) * LD + 8 * kk + t;
        const float* vr = vs + (16 * warp + g) * LD + 8 * kk + t;
        const FragA ak = msd::split_a(kr[0], kr[8 * LD], kr[4], kr[8 * LD + 4]);
        const FragA av = msd::split_a(vr[0], vr[8 * LD], vr[4], vr[8 * LD + 4]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* qr = qt + (8 * j + g) * LD + 8 * kk + t;
          const float* dr = dot + (8 * j + g) * LD + 8 * kk + t;
          msd::mma_3xtf32(s[j], ak, qr[0], qr[4]);
          msd::mma_3xtf32(dp[j], av, dr[0], dr[4]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldmatrix_a<LD>(ak, ks, 16 * warp, 16 * kk, lane);
        ldmatrix_a<LD>(av, vs, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int j2 = 0; j2 < kNT / 2; ++j2) {
          uint32_t bq[4], bo[4];
          ldmatrix_b_rows<LD>(bq, qt, 16 * j2, 16 * kk, lane);
          ldmatrix_b_rows<LD>(bo, dot, 16 * j2, 16 * kk, lane);
          msd::mma_bf16(s[2 * j2], ak, bq[0], bq[1]);
          msd::mma_bf16(s[2 * j2 + 1], ak, bq[2], bq[3]);
          msd::mma_bf16(dp[2 * j2], av, bo[0], bo[1]);
          msd::mma_bf16(dp[2 * j2 + 1], av, bo[2], bo[3]);
        }
      }
    }

    // p^T and dS^T in place of S^T and dP^T. Element e of tile j is key
    // key0 + 8 (e / 2), query q0 + 8 j + 2 t + e % 2; keys past kv_len and
    // queries past q_len weigh 0.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * j + 2 * t + (e & 1);
        float pv = 0.f, dsv = 0.f;
        if (kvalid[r] && q0 + c < p.q_len) {
          float x = s[j][e];
          if (bias != nullptr) x += bias[(long long)(q0 + c) * p.kv_len + key0 + 8 * r];
          x += kterm[r];
          pv = msd::exp_diff(x - st[c]) * st[kTQ + c];
          dsv = pv * (dp[j][e] - st[2 * kTQ + c]);
        }
        s[j][e] = pv;
        dp[j][e] = dsv;
      }
    }

    // dV += p^T dO and dK += dS^T q over the tile's queries (kTileSums: into
    // the tile's own accumulators, then added in f32).
    auto products = [&](float (&dv_acc)[kDT][4], float (&dk_acc)[kDT][4]) {
      if constexpr (kF32) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const FragA ap = msd::tf32_p_fragment(s[j]);
          const FragA ads = msd::tf32_p_fragment(dp[j]);
          const float* dr = dot + (8 * j + 2 * t) * LD + g;
          const float* qr = qt + (8 * j + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < kDT; ++n) {
            msd::mma_3xtf32(dv_acc[n], ap, dr[8 * n], dr[LD + 8 * n]);
            msd::mma_3xtf32(dk_acc[n], ads, qr[8 * n], qr[LD + 8 * n]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kNT / 2; ++kk) {
          uint32_t ap[4], ads[4];
          pack_a(ap, s[2 * kk], s[2 * kk + 1]);
          pack_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int n2 = 0; n2 < kDT / 2; ++n2) {
            uint32_t bo[4], bq[4];
            ldmatrix_b_cols<LD>(bo, dot, 16 * kk, 16 * n2, lane);
            ldmatrix_b_cols<LD>(bq, qt, 16 * kk, 16 * n2, lane);
            msd::mma_bf16(dv_acc[2 * n2], ap, bo[0], bo[1]);
            msd::mma_bf16(dv_acc[2 * n2 + 1], ap, bo[2], bo[3]);
            msd::mma_bf16(dk_acc[2 * n2], ads, bq[0], bq[1]);
            msd::mma_bf16(dk_acc[2 * n2 + 1], ads, bq[2], bq[3]);
          }
        }
      }
    };
    if constexpr (kTileSums<D>) {
      float dv_t[kDT][4] = {}, dk_t[kDT][4] = {};
      products(dv_t, dk_t);
      msd::add_to(dv, dv_t);
      msd::add_to(dk, dk_t);
    } else {
      products(dv, dk);
    }
  }

  store_rows<D>(static_cast<T*>(p.dk) + kv_off, p.kv_sl, key0, p.kv_len, p.head_dim, t, dk);
  store_rows<D>(static_cast<T*>(p.dv) + kv_off, p.kv_sl, key0, p.kv_len, p.head_dim, t, dv);
}

// dQ of one 64-query tile, walking the key tiles in order.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int LD = kLD<D, T>, kTK = kDqRows<D>, kNT = kTK / 8, kDT = D / 8;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);                               // [kRows][LD] the block's queries
  T* dos = qs + kRows * LD;                                          // [kRows][LD]
  T* ks = dos + kRows * LD;                                          // [kStages][kTK][LD]
  T* vs = ks + kStages * kTK * LD;                                   // [kStages][kTK][LD]
  float* kterm = reinterpret_cast<float*>(vs + kStages * kTK * LD);  // [kStages][kTK]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = q0 + 16 * warp + g;  // the thread's rows: row0 and row0 + 8

  const long long q_off = b * p.q_sb + h * p.q_sh;
  const long long kv_off = b * p.kv_sb + h * p.kv_sh;
  const long long stat_off = ((long long)b * p.heads + h) * p.q_len;
  const T* k = static_cast<const T*>(p.k) + kv_off;
  const T* v = static_cast<const T*>(p.v) + kv_off;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint8_t* mask = p.mask != nullptr ? p.mask + (long long)b * p.kv_len : nullptr;
  float m[2], il[2], delta[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    valid[r] = qi < p.q_len;
    m[r] = valid[r] ? p.m[stat_off + qi] : 0.f;
    il[r] = valid[r] ? 1.f / p.l[stat_off + qi] : 0.f;
    delta[r] = valid[r] ? p.delta[stat_off + qi] : 0.f;
  }

  // K/V tile `tile` into ring stage `stage`, with each key's term: -inf at or
  // past kv_len (never scored), the mask's -1e10, else 0.
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kTK;
    msd::load_tile<kTK, D, LD, kThreads>(ks + stage * kTK * LD, k, k0, p.kv_len, p.head_dim,
                                         p.kv_sl, p.vec);
    msd::load_tile<kTK, D, LD, kThreads>(vs + stage * kTK * LD, v, k0, p.kv_len, p.head_dim,
                                         p.kv_sl, p.vec);
    for (int i = threadIdx.x; i < kTK; i += kThreads) {
      const int c = k0 + i;
      kterm[stage * kTK + i] =
          c >= p.kv_len ? -INFINITY : (mask != nullptr && !mask[c] ? -1e10f : 0.f);
    }
  };

  msd::load_tile<kRows, D, LD, kThreads>(qs, static_cast<const T*>(p.q) + q_off, q0, p.q_len,
                                         p.head_dim, p.q_sl, p.vec);
  msd::load_tile<kRows, D, LD, kThreads>(dos, static_cast<const T*>(p.dout) + q_off, q0, p.q_len,
                                         p.head_dim, p.q_sl, p.vec);
  const int n_tiles = (p.kv_len + kTK - 1) / kTK;
  load_kv(0, 0);
  msd::cp_async_commit();

  float dq[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    msd::cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed, and every warp is done with tile it - 1
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) % kStages);
    msd::cp_async_commit();

    const int stage = it % kStages;
    const T* kt = ks + stage * kTK * LD;
    const T* vt = vs + stage * kTK * LD;
    const float* kterm_t = kterm + stage * kTK;
    const int k0 = it * kTK;

    // S = q k^T and dP = dO v^T for the warp's 16 queries by kTK keys.
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        const float* qr = qs + (16 * warp + g) * LD + 8 * kk + t;
        const float* dr = dos + (16 * warp + g) * LD + 8 * kk + t;
        const FragA aq = msd::split_a(qr[0], qr[8 * LD], qr[4], qr[8 * LD + 4]);
        const FragA ado = msd::split_a(dr[0], dr[8 * LD], dr[4], dr[8 * LD + 4]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = kt + (8 * j + g) * LD + 8 * kk + t;
          const float* vr = vt + (8 * j + g) * LD + 8 * kk + t;
          msd::mma_3xtf32(s[j], aq, kr[0], kr[4]);
          msd::mma_3xtf32(dp[j], ado, vr[0], vr[4]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ado[4];
        ldmatrix_a<LD>(aq, qs, 16 * warp, 16 * kk, lane);
        ldmatrix_a<LD>(ado, dos, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int j2 = 0; j2 < kNT / 2; ++j2) {
          uint32_t bk[4], bv[4];
          ldmatrix_b_rows<LD>(bk, kt, 16 * j2, 16 * kk, lane);
          ldmatrix_b_rows<LD>(bv, vt, 16 * j2, 16 * kk, lane);
          msd::mma_bf16(s[2 * j2], aq, bk[0], bk[1]);
          msd::mma_bf16(s[2 * j2 + 1], aq, bk[2], bk[3]);
          msd::mma_bf16(dp[2 * j2], ado, bv[0], bv[1]);
          msd::mma_bf16(dp[2 * j2 + 1], ado, bv[2], bv[3]);
        }
      }
    }

    // dS in place of S. Element e of tile j is row row0 + 8 (e / 2), key
    // k0 + 8 j + 2 t + e % 2.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * j + 2 * t + (e & 1);
        float dsv = 0.f;
        if (valid[r]) {
          float x = s[j][e];
          if (bias != nullptr && k0 + c < p.kv_len) {
            x += bias[(long long)(row0 + 8 * r) * p.kv_len + k0 + c];
          }
          x += kterm_t[c];
          const float pv = msd::exp_diff(x - m[r]) * il[r];
          dsv = pv * (dp[j][e] - delta[r]);
        }
        s[j][e] = dsv;
      }
    }

    // dQ += dS k over the tile's keys, into the tile's own accumulator, then
    // added in f32 (as kTileSums, at every d).
    float dq_t[kDT][4] = {};
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const FragA a = msd::tf32_p_fragment(s[j]);
        const float* kr = kt + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < kDT; ++n) msd::mma_3xtf32(dq_t[n], a, kr[8 * n], kr[LD + 8 * n]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < kDT / 2; ++n2) {
          uint32_t bk[4];
          ldmatrix_b_cols<LD>(bk, kt, 16 * kk, 16 * n2, lane);
          msd::mma_bf16(dq_t[2 * n2], a, bk[0], bk[1]);
          msd::mma_bf16(dq_t[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
    }
    msd::add_to(dq, dq_t);
  }

  store_rows<D>(static_cast<T*>(p.dq) + q_off, p.q_sl, row0, p.q_len, p.head_dim, t, dq);
}

template <int D, typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem_kv = dkdv_smem_bytes<D, T>();
  const size_t smem_q = dq_smem_bytes<D, T>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((p.kv_len + kRows - 1) / kRows, p.heads, batch);
  flash_bwd_dkdv_kernel<D, T><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((p.q_len + kRows - 1) / kRows, p.heads, batch);
  flash_bwd_dq_kernel<D, T><<<grid_q, kThreads, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.head_dim <= 32) return launch<32, T>(p, batch, stream);
  if (p.head_dim <= 64) return launch<64, T>(p, batch, stream);
  return launch<128, T>(p, batch, stream);
}

// Whether bf16 calls at head_dim 64 take the wgmma route (false: every
// call takes the mma.sync route, as before that route existed;
// tools/torch_attention_variants.py bwd_old_route times the two).
constexpr bool kWgmmaRoute = true;

// The rule: the wgmma route takes bf16 at head_dim 64 with q, k, v, out and
// dO 16-byte aligned (TMA's and the prologue's loads); the mma.sync route
// every other call.
bool wgmma_route(int dtype, int head_dim, bool aligned) {
  return kWgmmaRoute && dtype == 1 && head_dim == bwd_wgmma::kTile && aligned;
}

}  // namespace

extern "C" {

// Launches the route's kernels on `stream` and returns cudaGetLastError()
// (0 on success). Pointers are device pointers to contiguous tensors in
// the layouts named above; bias and mask may be null. q, k, v, out, dout,
// dq, dk and dv are all of `dtype` (0 = float32, 1 = bfloat16); stats is
// f32 [2, b, h, q] (row max, then row sum) as flash_fwd.cu writes it;
// bias_heads is 1 or `heads` (ignored without a bias). The mma.sync route
// reads delta, f32 [b, h, q], and ignores out, rowstat, kterm, dq_part,
// splits and keys_per_split. The wgmma route ignores delta and takes f32
// scratch: rowstat [b, h, q_pad / 64, 3, 64] and kterm [b, kv_pad] (q padded
// to msd_flash_bwd_tile(0, q_len) rows, kv to msd_flash_bwd_tile(2, .)), and with
// splits > 1 dq_part [splits, b,
// q, h, d]; its dq pass cuts the keys into `splits` ranges of
// keys_per_split (a multiple of msd_flash_bwd_tile(1)) that cover kv_len,
// each starting below it.
int msd_flash_bwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, const void* stats, const void* delta, const void* out,
                  const void* dout, void* dq, void* dk, void* dv, void* rowstat, void* kterm,
                  void* dq_part, int batch, int heads, int q_len, int kv_len, int head_dim,
                  int kv_transposed, int bias_heads, int dtype, int splits, int keys_per_split,
                  void* stream) {
  if (batch < 1 || heads < 1 || q_len < 1 || kv_len < 1 || head_dim < 1 || head_dim > 128 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const uint8_t*>(mask);
  p.m = static_cast<const float*>(stats);
  p.l = p.m + (long long)batch * heads * q_len;
  p.delta = static_cast<const float*>(delta);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.head_dim = head_dim;
  p.heads = heads;
  const int elt = dtype == 0 ? 4 : 2;
  p.vec = (head_dim * elt) % 16 == 0 && msd::aligned16(q) && msd::aligned16(k) &&
          msd::aligned16(v) && msd::aligned16(dout);
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
                       msd::aligned16(out) && msd::aligned16(dout);
  if (wgmma_route(dtype, head_dim, aligned)) {
    if (rowstat == nullptr || kterm == nullptr || splits < 1 || keys_per_split < 1 ||
        keys_per_split % bwd_wgmma::kTile != 0 || (long long)splits * keys_per_split < kv_len ||
        (long long)(splits - 1) * keys_per_split >= kv_len || (splits > 1 && dq_part == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    bwd_wgmma::Params w;
    w.bias = p.bias;
    w.dq = splits > 1 ? dq_part : dq;
    w.dk = dk;
    w.dv = dv;
    w.q_len = q_len;
    w.kv_len = kv_len;
    w.heads = heads;
    w.q_tiles = bwd_wgmma::q_padded(q_len) / bwd_wgmma::kTile;
    w.kv_pad = bwd_wgmma::kv_padded(kv_len);
    w.splits = splits;
    w.tiles_per_split = keys_per_split / bwd_wgmma::kTile;
    w.q_sb = p.q_sb;
    w.q_sl = p.q_sl;
    w.q_sh = p.q_sh;
    w.kv_sb = p.kv_sb;
    w.kv_sl = p.kv_sl;
    w.kv_sh = p.kv_sh;
    w.bias_sb = p.bias_sb;
    w.bias_sh = p.bias_sh;
    w.part_stride = (long long)batch * q_len * heads * head_dim;
    return bwd_wgmma::launch(w, q, k, v, out, dout, p.m, p.mask, static_cast<float*>(rowstat),
                             static_cast<float*>(kterm), dq, batch, s);
  }
  if (delta == nullptr) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? dispatch<float>(p, batch, s) : dispatch<bf16>(p, batch, s);
}

// 1 when a call of this dtype code and head_dim, with q, k, v, out and dO
// 16-byte aligned (`aligned`), takes the wgmma route; 0 for the mma.sync
// route.
int msd_flash_bwd_route(int dtype, int head_dim, int aligned) {
  return wgmma_route(dtype, head_dim, aligned != 0) ? 1 : 0;
}

// The wgmma route's block shape for q_len queries: 0, the queries a dq
// work item owns (the padding of q for the scratch, the dq key split's
// items); 1, the rows of a streamed tile (the unit of the dq key split); 2,
// the keys a dkdv work item owns (the padding of kv for the scratch).
int msd_flash_bwd_tile(int which, int q_len) {
  return which == 0 ? 64 * bwd_wgmma::dq_wgs(q_len)
                    : (which == 1 ? bwd_wgmma::kTile : bwd_wgmma::DkdvShape::kRows);
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
