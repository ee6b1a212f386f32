// Flash-attention backward for NVIDIA Hopper (sm_90a), float32, with a plain
// C entry point loaded through ctypes (no PyTorch headers, no CUTLASS).
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
// Bias and mask are not differentiated. delta is an input (the wrapper
// computes it, as the JAX package does outside its kernel). Rebuilding p
// from m and l, not from lse = m + log l, gives an all-masked row exactly the
// forward's even 1 / kv_len (its scores all round to -1e10, and so would
// lse), finite, with no special case.
//
// Layouts as the forward: q, dO and dQ [b, q, h, d]; k, v, dK, dV
// [b, kv, h, d], or [b, h, kv, d] when kv_transposed; bias an optional f32
// [b, 1|h, q, kv]; the key mask an optional uint8 [b, kv]; m, l, delta f32
// [b, h, q]. Everything is f32 (the training path's type).
//
// The design. The TPU kernel holds the whole query (<= ~2k rows) in VMEM and
// adds each key block's dQ into an output block it revisits along a
// sequential grid. Blocks on the card run in parallel and in no order, so
// this is two passes, neither with atomics, so every gradient is
// deterministic:
//   dkdv: one block per (64-key tile, head, batch) walks the query tiles and
//         keeps its keys' dK and dV in registers;
//   dq:   one block per (64-query tile, head, batch) walks the key tiles in
//         order and keeps its rows' dQ in registers.
// The dq pass recomputes s and dP, so the two passes do 8 products of
// q·kv·d where 5 are needed. What bounds it on the card: 10·q·kv·d FLOPs for
// about 7·(q + kv)·d floats moved, so arithmetic, not the 3.35 TB/s of HBM.
// This first version does that arithmetic with scalar f32 FMAs (67 TFLOP/s
// peak), off the tensor cores: scores and probabilities stay in registers
// and shared memory; each thread owns a register tile of 4 own rows by 8
// streamed rows (and 4 rows by head_dim / 8 output columns), so each
// 16-byte shared-memory read feeds 8-16 FMAs; rows are padded against bank
// conflicts. Every output is summed in a fixed order (d, then the streamed
// rows, ascending). The tensor cores (mma.sync, then wgmma with TMA loads)
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // the block's own rows (keys in dkdv, queries in dq)
constexpr int kTile = 64;      // rows of each streamed tile
constexpr int kThreads = 128;
constexpr int kPad = 4;        // floats of row padding: keeps float4 alignment, spreads banks
// Each thread owns a register tile of kTR own rows (rg + 16 i) by kTC
// streamed rows (cg + 8 j), with rg = tid / 8 and cg = tid % 8, and of its
// own rows the output columns 32 g + 4 cg + e.
constexpr int kTR = 4;
constexpr int kTC = 8;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const uint8_t* mask;
  const float* m;      // [b, h, q] row max
  const float* l;      // [b, h, q] row sum
  const float* delta;  // [b, h, q] rowsum(dO * out)
  const float* dout;   // like q
  float* dq;           // like q
  float* dk;           // like k
  float* dv;           // like v
  int q_len, kv_len, head_dim, heads;
  long long q_sb, q_sl, q_sh;     // q, dO and dQ strides (elements)
  long long kv_sb, kv_sl, kv_sh;  // k, v, dK and dV strides
  long long bias_sb, bias_sh;     // bias_sh == 0 broadcasts one bias over heads
};

// Stages rows [r0, r0 + kTile) of a [len, head_dim] matrix (row stride
// `sl`) into shared memory with row stride LD; rows past len and columns
// past head_dim are zero.
template <int D, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int len,
                                      int head_dim, long long sl) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (r0 + r < len && c < head_dim) x = src[(long long)(r0 + r) * sl + c];
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ float dot4(float acc, const float4& x, const float4& y) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// The thread's tiles of two products: a[i][j] = X[rg + 16 i] . Y[cg + 8 j]
// and b[i][j] = X2[rg + 16 i] . Y2[cg + 8 j], summed over d in order.
template <int D, int LD>
__device__ __forceinline__ void score_tiles(const float* xs, const float* x2s, const float* ys,
                                            const float* y2s, int rg, int cg,
                                            float (&a)[kTR][kTC], float (&b)[kTR][kTC]) {
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
#pragma unroll
    for (int j = 0; j < kTC; ++j) a[i][j] = b[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[kTR], x2[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      x[i] = *reinterpret_cast<const float4*>(xs + (rg + 16 * i) * LD + d);
      x2[i] = *reinterpret_cast<const float4*>(x2s + (rg + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(ys + (cg + 8 * j) * LD + d);
      const float4 y2 = *reinterpret_cast<const float4*>(y2s + (cg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        a[i][j] = dot4(a[i][j], x[i], y);
        b[i][j] = dot4(b[i][j], x2[i], y2);
      }
    }
  }
}

// acc[i][4 g + e] += sum over the tile's rows j, in order, of
// M[rg + 16 i][j] * Z[j][32 g + 4 cg + e]; M is [kRows][LDP] in shared
// memory, Z [kTile][LD].
template <int D, int LD, int LDP>
__device__ __forceinline__ void accumulate(const float* ms, const float* zs, int rg, int cg,
                                           float (&acc)[kTR][D / 8]) {
  constexpr int kG = D / 32;
#pragma unroll 2
  for (int j0 = 0; j0 < kTile; j0 += 4) {
    float mv[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float4 m4 = *reinterpret_cast<const float4*>(ms + (rg + 16 * i) * LDP + j0);
      mv[i][0] = m4.x;
      mv[i][1] = m4.y;
      mv[i][2] = m4.z;
      mv[i][3] = m4.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* zrow = zs + (j0 + jj) * LD + 4 * cg;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 z = *reinterpret_cast<const float4*>(zrow + 32 * g);
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          acc[i][4 * g + 0] = fmaf(mv[i][jj], z.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(mv[i][jj], z.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(mv[i][jj], z.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(mv[i][jj], z.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Stores the thread's rows of an accumulated [rows][head_dim] output.
template <int D>
__device__ __forceinline__ void store_rows(float* out, long long sl, int r0, int len, int head_dim,
                                           int rg, int cg, const float (&acc)[kTR][D / 8]) {
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + rg + 16 * i;
    if (r >= len) continue;
    float* row = out + (long long)r * sl;
#pragma unroll
    for (int g = 0; g < D / 32; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * g + 4 * cg + e;
        if (col < head_dim) row[col] = acc[i][4 * g + e];
      }
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * kRows * (D + kPad) + 2 * kTile * (D + kPad) + 2 * kRows * (kTile + kPad) +
                  3 * kTile);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * kRows * (D + kPad) + 2 * kTile * (D + kPad) + kRows * (kTile + kPad));
}

// dK and dV of one 64-key tile, walking the query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kPad;
  constexpr int LDP = kTile + kPad;
  float* ks = reinterpret_cast<float*>(smem4);  // [kRows][LD] this block's keys
  float* vs = ks + kRows * LD;                  // [kRows][LD]
  float* qs = vs + kRows * LD;                  // [kTile][LD]
  float* dos = qs + kTile * LD;                 // [kTile][LD]
  float* ps = dos + kTile * LD;                 // [kRows][LDP] p^T (key, query)
  float* dss = ps + kRows * LDP;                // [kRows][LDP] dS^T
  float* tm = dss + kRows * LDP;                // [kTile] m of the query tile
  float* til = tm + kTile;                      // [kTile] 1 / l
  float* tdelta = til + kTile;                  // [kTile] delta

  const int tid = threadIdx.x;
  const int rg = tid / kTC;
  const int cg = tid % kTC;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long long q_off = b * p.q_sb + h * p.q_sh;
  const long long kv_off = b * p.kv_sb + h * p.kv_sh;
  const long long stat_off = ((long long)b * p.heads + h) * p.q_len;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  // The thread's keys' mask terms.
  float mask_term[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int key = k0 + rg + 16 * i;
    mask_term[i] = 0.f;
    if (p.mask != nullptr && key < p.kv_len)
      mask_term[i] = p.mask[(long long)b * p.kv_len + key] ? 0.f : -1e10f;
  }

  stage<D, LD>(ks, p.k + kv_off, k0, p.kv_len, p.head_dim, p.kv_sl);
  stage<D, LD>(vs, p.v + kv_off, k0, p.kv_len, p.head_dim, p.kv_sl);

  float dk[kTR][D / 8], dv[kTR][D / 8];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < p.q_len; q0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and K/V are staged)
    stage<D, LD>(qs, p.q + q_off, q0, p.q_len, p.head_dim, p.q_sl);
    stage<D, LD>(dos, p.dout + q_off, q0, p.q_len, p.head_dim, p.q_sl);
    if (tid < kTile) {
      const bool valid = q0 + tid < p.q_len;
      tm[tid] = valid ? p.m[stat_off + q0 + tid] : 0.f;
      til[tid] = valid ? 1.f / p.l[stat_off + q0 + tid] : 0.f;
      tdelta[tid] = valid ? p.delta[stat_off + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s = k . q and dP = v . dO, then p and dS, into shared memory.
    float s[kTR][kTC], dp[kTR][kTC];
    score_tiles<D, LD>(ks, vs, qs, dos, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int key = k0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = cg + 8 * j;
        float pj = 0.f, dsj = 0.f;
        if (key < p.kv_len && q0 + c < p.q_len) {
          float x = s[i][j];
          if (bias != nullptr) x += bias[(long long)(q0 + c) * p.kv_len + key];
          x += mask_term[i];
          pj = expf(x - tm[c]) * til[c];
          dsj = pj * (dp[i][j] - tdelta[c]);
        }
        ps[(rg + 16 * i) * LDP + c] = pj;
        dss[(rg + 16 * i) * LDP + c] = dsj;
      }
    }
    __syncthreads();  // every thread's p and dS are written

    // dV += p^T dO and dK += dS^T q over this query tile, queries in order.
    accumulate<D, LD, LDP>(ps, dos, rg, cg, dv);
    accumulate<D, LD, LDP>(dss, qs, rg, cg, dk);
  }

  store_rows<D>(p.dk + kv_off, p.kv_sl, k0, p.kv_len, p.head_dim, rg, cg, dk);
  store_rows<D>(p.dv + kv_off, p.kv_sl, k0, p.kv_len, p.head_dim, rg, cg, dv);
}

// dQ of one 64-query tile, walking the key tiles in order.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kPad;
  constexpr int LDP = kTile + kPad;
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][LD] this block's queries
  float* dos = qs + kRows * LD;                 // [kRows][LD]
  float* ks = dos + kRows * LD;                 // [kTile][LD]
  float* vs = ks + kTile * LD;                  // [kTile][LD]
  float* dss = vs + kTile * LD;                 // [kRows][LDP] dS (query, key)

  const int tid = threadIdx.x;
  const int rg = tid / kTC;
  const int cg = tid % kTC;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const long long q_off = b * p.q_sb + h * p.q_sh;
  const long long kv_off = b * p.kv_sb + h * p.kv_sh;
  const long long stat_off = ((long long)b * p.heads + h) * p.q_len;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint8_t* mask = p.mask != nullptr ? p.mask + (long long)b * p.kv_len : nullptr;
  // The thread's rows' statistics.
  float m[kTR], il[kTR], delta[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int qi = q0 + rg + 16 * i;
    const bool valid = qi < p.q_len;
    m[i] = valid ? p.m[stat_off + qi] : 0.f;
    il[i] = valid ? 1.f / p.l[stat_off + qi] : 0.f;
    delta[i] = valid ? p.delta[stat_off + qi] : 0.f;
  }

  stage<D, LD>(qs, p.q + q_off, q0, p.q_len, p.head_dim, p.q_sl);
  stage<D, LD>(dos, p.dout + q_off, q0, p.q_len, p.head_dim, p.q_sl);

  float acc[kTR][D / 8];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.kv_len; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q/dO are staged)
    stage<D, LD>(ks, p.k + kv_off, k0, p.kv_len, p.head_dim, p.kv_sl);
    stage<D, LD>(vs, p.v + kv_off, k0, p.kv_len, p.head_dim, p.kv_sl);
    __syncthreads();

    // s = q . k and dP = dO . v, then dS, into shared memory.
    float s[kTR][kTC], dp[kTR][kTC];
    score_tiles<D, LD>(qs, dos, ks, vs, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int qi = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int key = k0 + cg + 8 * j;
        float dsj = 0.f;
        if (qi < p.q_len && key < p.kv_len) {
          float x = s[i][j];
          if (bias != nullptr) x += bias[(long long)qi * p.kv_len + key];
          if (mask != nullptr) x += mask[key] ? 0.f : -1e10f;
          const float pj = expf(x - m[i]) * il[i];
          dsj = pj * (dp[i][j] - delta[i]);
        }
        dss[(rg + 16 * i) * LDP + cg + 8 * j] = dsj;
      }
    }
    __syncthreads();  // every thread's dS is written

    // dQ += dS k over this key tile, keys in order.
    accumulate<D, LD, LDP>(dss, ks, rg, cg, acc);
  }

  store_rows<D>(p.dq + q_off, p.q_sl, q0, p.q_len, p.head_dim, rg, cg, acc);
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem_kv = dkdv_smem_bytes<D>();
  const size_t smem_q = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((p.kv_len + kRows - 1) / kRows, p.heads, batch);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((p.q_len + kRows - 1) / kRows, p.heads, batch);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_q, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous f32 tensors in the
// layouts named above; bias and mask may be null. stats is [2, b, h, q]
// (row max, then row sum) as flash_fwd.cu writes it; bias_heads is 1 or
// `heads` (ignored without a bias).
int msd_flash_bwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, const void* stats, const void* delta, const void* dout,
                  void* dq, void* dk, void* dv, int batch, int heads, int q_len, int kv_len,
                  int head_dim, int kv_transposed, int bias_heads, void* stream) {
  if (batch < 1 || heads < 1 || q_len < 1 || kv_len < 1 || head_dim < 1 || head_dim > 128) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const uint8_t*>(mask);
  p.m = static_cast<const float*>(stats);
  p.l = p.m + (long long)batch * heads * q_len;
  p.delta = static_cast<const float*>(delta);
  p.dout = static_cast<const float*>(dout);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.head_dim = head_dim;
  p.heads = heads;
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
  if (head_dim <= 32) return launch<32>(p, batch, s);
  if (head_dim <= 64) return launch<64>(p, batch, s);
  return launch<128>(p, batch, s);
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
