// Flash-attention forward for NVIDIA Hopper (sm_90a), with a plain C entry
// point loaded through ctypes (no PyTorch headers, no CUTLASS).
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
// [b, kv] (1 keeps the key). Inputs are all f32 or all bf16; products take
// the input type's values, p is rounded to bf16 before the p·v product when
// the inputs are bf16 (as the TPU kernel does with mxu_bf16), and every sum,
// the running max and the running denominator are f32.
//
// What bounds it on the card: at the serving shapes (q 256 or 2048, kv up to
// 2304, d 64) the work is 4·q·kv·d FLOPs for 2·(q + 2·kv)·d elements moved,
// so it is bound by arithmetic, not by the 3.35 TB/s of HBM. This first
// version does that arithmetic with scalar f32 FMAs (67 TFLOP/s peak) and not
// on the tensor cores: it is written to be right and simple. What the design
// does about the bound: scores never leave the SM (one block owns a 64-row
// query tile and streams 64-key K/V tiles through shared memory with an
// online softmax), each shared-memory read is a 16-byte vector feeding four
// FMAs, and rows are padded so the two threads of a query row and the eight
// rows of a quarter-warp hit distinct banks. wgmma on bf16 tiles with TMA
// loads is the next step and a later change.
//
// Softmax statistics (training): given a `stats` pointer (null when
// serving), the kernel also writes each row's final running max m and sum
// l, f32 [2, b, h, q] (m first). The backward kernel (flash_bwd.cu)
// rebuilds p = exp(s - m) / l from them. Keeping m and l apart, rather than
// lse = m + log l, keeps an all-masked row exact: its scores all round to
// -1e10 in f32, so lse = -1e10 + log(kv_len) rounds back to -1e10 and
// exp(s - lse) would give 1 where the forward used 1 / kv_len.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kThreads = 128;  // two threads per query row
constexpr int kPad = 4;        // floats of row padding: keeps float4 alignment, spreads banks

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The probability as the p·v product sees it: bf16 inputs round it to bf16.
__device__ __forceinline__ float product_p(float p, const float*) { return p; }
__device__ __forceinline__ float product_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const uint8_t* mask;
  void* out;
  float* stats;  // optional [2, b, h, q]: row max, then row sum
  int q_len, kv_len, head_dim, heads;
  long long q_sb, q_sl, q_sh;     // q and out strides (elements)
  long long kv_sb, kv_sl, kv_sh;  // k and v strides
  long long bias_sb, bias_sh;     // bias_sh == 0 broadcasts one bias over heads
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBlockQ * (D + kPad) + 2 * kBlockK * (D + kPad) +
                                  kBlockQ * (kBlockK + kPad));
}

// One block per (64-row query tile, head, batch). Thread t owns query row t/2;
// the two threads of a row split its scores (keys 2j + t%2) and its output
// columns (float4 groups 2g + t%2).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kPad;
  constexpr int LDP = kBlockK + kPad;
  constexpr int kCols = kBlockK / 2;  // scores per thread per tile
  constexpr int kGroups = D / 8;      // float4 output groups per thread
  float* qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;                // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;                // [kBlockK][LD]
  float* ps = vs + kBlockK * LD;                // [kBlockQ][LDP]

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool row_valid = q0 + row < p.q_len;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;
  const float* bias_row =
      (p.bias != nullptr && row_valid)
          ? p.bias + b * p.bias_sb + h * p.bias_sh + (long long)(q0 + row) * p.kv_len
          : nullptr;
  const uint8_t* mask = p.mask != nullptr ? p.mask + (long long)b * p.kv_len : nullptr;

  // Stage the query tile; rows past q_len and columns past head_dim are zero.
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < p.q_len && c < p.head_dim) x = load_f32(q + (q0 + r) * p.q_sl + c);
    qs[r * LD + c] = x;
  }

  float acc[4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4 * kGroups; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;
  const float* qrow = qs + row * LD;
  float* prow = ps + row * LDP;

  for (int k0 = 0; k0 < p.kv_len; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V are consumed (and q is staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.kv_len && c < p.head_dim) {
        const long long off = (long long)(k0 + r) * p.kv_sl + c;
        kx = load_f32(k + off);
        vx = load_f32(v + off);
      }
      ks[r * LD + c] = kx;
      vs[r * LD + c] = vx;
    }
    __syncthreads();

    // s = q k^T for this thread's keys 2j + half.
    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (2 * j + half) * LD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    // Bias, then the key mask, in the TPU kernel's order; keys past kv_len
    // get -inf and so weigh exactly 0.
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = k0 + 2 * j + half;
      float x = -INFINITY;
      if (c < p.kv_len) {
        x = s[j];
        if (bias_row != nullptr) x += bias_row[c];
        if (mask != nullptr) x += mask[c] ? 0.f : -1e10f;
      }
      s[j] = x;
      m_tile = fmaxf(m_tile, x);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    // Every tile holds at least one real key, so m_new is finite and the
    // first tile's alpha is exp(-inf) = 0.
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);

    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float pj = expf(s[j] - m_new);
      l_tile += pj;
      prow[2 * j + half] = product_p(pj, static_cast<const T*>(nullptr));
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_run = alpha * l_run + l_tile;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 4 * kGroups; ++i) acc[i] *= alpha;
    __syncwarp();  // both threads of the row have written its p

    // acc += p v over this tile.
#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + c);
      const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * LD + 4 * half;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 8 * g);
          acc[4 * g + 0] = fmaf(pc[cc], vv.x, acc[4 * g + 0]);
          acc[4 * g + 1] = fmaf(pc[cc], vv.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(pc[cc], vv.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(pc[cc], vv.w, acc[4 * g + 3]);
        }
      }
    }
  }

  if (!row_valid) return;
  if (p.stats != nullptr && half == 0) {
    const long long at = ((long long)b * p.heads + h) * p.q_len + q0 + row;
    const long long plane = (long long)gridDim.z * p.heads * p.q_len;
    p.stats[at] = m_run;
    p.stats[plane + at] = l_run;
  }
  const float denom = fmaxf(l_run, 1e-37f);
  T* out = static_cast<T*>(p.out) + b * p.q_sb + h * p.q_sh + (long long)(q0 + row) * p.q_sl;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * g + 4 * half + e;
      if (col < p.head_dim) store_f32(out + col, acc[4 * g + e] / denom);
    }
  }
}

template <int D, typename T>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.q_len + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (p.head_dim <= 16) return launch<16, T>(p, batch, heads, stream);
  if (p.head_dim <= 32) return launch<32, T>(p, batch, heads, stream);
  if (p.head_dim <= 64) return launch<64, T>(p, batch, heads, stream);
  return launch<128, T>(p, batch, heads, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers; bias, mask and stats may be null
// (stats: f32 [2, b, h, q], written only when given).
// dtype: 0 = float32, 1 = bfloat16. bias_heads: 1 or `heads` (ignored
// without a bias). Tensors are contiguous in the layouts named above.
int msd_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, void* out, void* stats, int batch, int heads, int q_len,
                  int kv_len, int head_dim, int kv_transposed, int bias_heads, int dtype,
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
  p.out = out;
  p.stats = static_cast<float*>(stats);
  p.heads = heads;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.head_dim = head_dim;
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
  return dtype == 0 ? dispatch<float>(p, batch, heads, s)
                    : dispatch<__nv_bfloat16>(p, batch, heads, s);
}

const char* msd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
