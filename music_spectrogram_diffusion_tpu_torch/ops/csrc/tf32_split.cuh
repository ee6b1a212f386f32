// The split of f32 operands for the tf32 wgmma routes (flash_fwd_tf32.cuh,
// flash_bwd_tf32.cuh): one prologue launch a call writes each operand's
// 3xTF32 terms (attention_mma.cuh `split_tf32`) in the K-major layouts that
// tf32 wgmma reads from shared memory, so that every tile arrives by TMA
// already split, once a call rather than once a use. No TPU kernel has a
// counterpart: the TPU's matrix unit takes f32 operands as they are. It
// moves each operand once in and twice (or four times) out, bound by the
// card's memory rate.

#pragma once

#include "hopper.cuh"

namespace msd {

// One f32 tensor's split for the tf32 routes: src is [b, len, h, 64] in
// the strides sb, sl, sh (elements); rows_* (K-major where len is N or M:
// [b h, len_pad, 64]) and cols_* (K-major where len is K: [b h, 64,
// len_pad], len in the order of `tf32_perm` within each 8) get the big and
// small terms of `split_tf32`, zero past len; either pair may be null.
struct SplitJob {
  const float* src;
  long long sb, sl, sh;
  float *rows_big, *rows_small, *cols_big, *cols_small;
  int len, len_pad;
};
struct SplitJobs {
  SplitJob job[4];
  int heads;
};

// Block (x, b h, job): 64 rows of one head of one job's tensor, through a
// padded tile in shared memory, so that every read and write is coalesced.
__global__ void __launch_bounds__(256) tf32_split_kernel(const __grid_constant__ SplitJobs jobs) {
  __shared__ float tile[64][65];
  const SplitJob& j = jobs.job[blockIdx.z];
  const int row0 = blockIdx.x * 64;
  if (row0 >= j.len_pad) return;
  const int bh = blockIdx.y, h = bh % jobs.heads, b = bh / jobs.heads;
  const float* src = j.src + b * j.sb + h * j.sh;
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int r = i >> 6, c = i & 63;
    tile[r][c] = row0 + r < j.len ? src[(long long)(row0 + r) * j.sl + c] : 0.f;
  }
  __syncthreads();
  if (j.rows_big != nullptr) {
    const long long base = ((long long)bh * j.len_pad + row0) * 64;
    for (int i = threadIdx.x; i < 64 * 64; i += 256) {
      const Tf32x2 s = split_tf32(tile[i >> 6][i & 63]);
      j.rows_big[base + i] = __uint_as_float(s.big);
      j.rows_small[base + i] = __uint_as_float(s.small);
    }
  }
  if (j.cols_big != nullptr) {
    for (int i = threadIdx.x; i < 64 * 64; i += 256) {
      const int c = i >> 6, p = i & 63;
      const Tf32x2 s = split_tf32(tile[tf32_perm(p)][c]);
      const long long at = ((long long)bh * 64 + c) * j.len_pad + row0 + p;
      j.cols_big[at] = __uint_as_float(s.big);
      j.cols_small[at] = __uint_as_float(s.small);
    }
  }
}

// Launches the split of `n` jobs on `stream` (lengths padded to multiples
// of 64).
inline cudaError_t launch_split(const SplitJobs& jobs, int n, int batch, cudaStream_t stream) {
  int blocks = 0;
  for (int i = 0; i < n; ++i) blocks = max(blocks, jobs.job[i].len_pad / 64);
  tf32_split_kernel<<<dim3(blocks, batch * jobs.heads, n), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

}  // namespace msd
