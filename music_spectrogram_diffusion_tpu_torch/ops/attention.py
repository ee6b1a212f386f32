"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

`flash_attention` computes softmax(q k^T + bias + (keep - 1) * 1e10) v,
T5-style with no 1/sqrt(d) scaling, as the TPU kernel
`music_spectrogram_diffusion_tpu/ops/attention.py:flash_attention` does. On
CUDA tensors it launches `csrc/flash_fwd.cu` (built by nvcc on first use,
see `_build.py`); on CPU tensors it runs `attention_reference`, the plain
PyTorch version. There is no fallback between the two: a CUDA call that
cannot launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def transpose_kv(key: torch.Tensor,
                 value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """[b, l, h, d] -> contiguous [b, h, l, d], the cached cross-attention
  layout; done once per segment instead of once per denoise step."""
  return (key.transpose(1, 2).contiguous(),
          value.transpose(1, 2).contiguous())


def attention_reference(query: torch.Tensor,
                        key: torch.Tensor,
                        value: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        kv_mask: Optional[torch.Tensor] = None,
                        *,
                        kv_transposed: bool = False) -> torch.Tensor:
  """The plain version: materialized f32 scores, then softmax, then p v.

  Same arguments and result as `flash_attention`; the output has the
  query's dtype.
  """
  k_sub = "bhkd" if kv_transposed else "bkhd"
  weights = torch.einsum(f"bqhd,{k_sub}->bhqk", query.float(), key.float())
  if bias is not None:
    weights = weights + bias.float()
  if kv_mask is not None:
    keep = kv_mask.float()
    weights = weights + ((keep - 1.0) * 1e10)[:, None, None, :]
  weights = torch.softmax(weights, dim=-1)
  return torch.einsum(f"bhqk,{k_sub}->bqhd", weights,
                      value.float()).to(query.dtype)


def _check(query, key, value, bias, kv_mask, kv_transposed):
  """Raise on anything the kernel does not take; returns kv_len."""
  if query.ndim != 4:
    raise ValueError(f"query must be [b, q, h, d], got {tuple(query.shape)}")
  batch, q_len, heads, head_dim = query.shape
  kv_shape = tuple(key.shape)
  if key.ndim != 4 or tuple(value.shape) != kv_shape:
    raise ValueError(f"key {kv_shape} and value {tuple(value.shape)} must "
                     "be equal 4-d shapes")
  if kv_transposed:
    kb, kh, kv_len, kd = kv_shape
  else:
    kb, kv_len, kh, kd = kv_shape
  if (kb, kh, kd) != (batch, heads, head_dim):
    raise ValueError(f"key/value {kv_shape} do not match query "
                     f"{tuple(query.shape)} (kv_transposed={kv_transposed})")
  if not 1 <= head_dim <= MAX_HEAD_DIM:
    raise ValueError(f"head_dim {head_dim} outside [1, {MAX_HEAD_DIM}]")
  if q_len < 1 or kv_len < 1:
    raise ValueError(f"empty attention: q_len={q_len}, kv_len={kv_len}")
  if query.dtype not in _DTYPE_CODES:
    raise TypeError(f"query dtype {query.dtype} not in float32/bfloat16")
  if key.dtype != query.dtype or value.dtype != query.dtype:
    raise TypeError(f"dtypes differ: q {query.dtype}, k {key.dtype}, "
                    f"v {value.dtype}")
  tensors = [("query", query), ("key", key), ("value", value)]
  if bias is not None:
    if bias.dtype != torch.float32:
      raise TypeError(f"bias must be float32, got {bias.dtype}")
    if (bias.ndim != 4 or bias.shape[0] != batch
        or bias.shape[1] not in (1, heads)
        or tuple(bias.shape[2:]) != (q_len, kv_len)):
      raise ValueError(f"bias {tuple(bias.shape)} is not "
                       f"[{batch}, 1|{heads}, {q_len}, {kv_len}]")
    tensors.append(("bias", bias))
  if kv_mask is not None:
    if kv_mask.dtype != torch.bool:
      raise TypeError(f"kv_mask must be bool, got {kv_mask.dtype}")
    if tuple(kv_mask.shape) != (batch, kv_len):
      raise ValueError(f"kv_mask {tuple(kv_mask.shape)} is not "
                       f"[{batch}, {kv_len}]")
    tensors.append(("kv_mask", kv_mask))
  for name, t in tensors:
    if t.device != query.device:
      raise ValueError(f"{name} is on {t.device}, query on {query.device}")
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
  return kv_len


def flash_attention(query: torch.Tensor,
                    key: torch.Tensor,
                    value: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    *,
                    kv_transposed: bool = False) -> torch.Tensor:
  """softmax(q k^T + bias + (keep - 1) * 1e10) v, no 1/sqrt(d).

  Args:
    query: [batch, q_len, heads, head_dim], float32 or bfloat16.
    key/value: [batch, kv_len, heads, head_dim], or [batch, heads, kv_len,
      head_dim] when kv_transposed; the query's dtype.
    bias: optional float32 [batch, 1 | heads, q_len, kv_len] additive bias.
    kv_mask: optional bool [batch, kv_len]; False drops the key for every
      query row. A row whose keys are all dropped averages them evenly.

  All tensors contiguous and on one device; head_dim <= 128. Returns
  [batch, q_len, heads, head_dim] in the query's dtype. On CUDA tensors the
  kernel runs (counted in `flash_attention.launches`); on CPU tensors the
  plain version does.
  """
  kv_len = _check(query, key, value, bias, kv_mask, kv_transposed)
  if query.device.type == "cpu":
    return attention_reference(query, key, value, bias, kv_mask,
                               kv_transposed=kv_transposed)
  if query.device.type != "cuda":
    raise ValueError(f"flash_attention runs on cuda or cpu, not "
                     f"{query.device}")
  lib = _library()
  batch, q_len, heads, head_dim = query.shape
  out = torch.empty_like(query)
  stream = torch.cuda.current_stream(query.device).cuda_stream
  err = lib.msd_flash_fwd(
      query.data_ptr(), key.data_ptr(), value.data_ptr(),
      bias.data_ptr() if bias is not None else None,
      kv_mask.data_ptr() if kv_mask is not None else None,
      out.data_ptr(), batch, heads, q_len, kv_len, head_dim,
      int(kv_transposed), bias.shape[1] if bias is not None else 1,
      _DTYPE_CODES[query.dtype], stream)
  if err != 0:
    raise RuntimeError(
        f"flash_fwd launch failed: CUDA error {err} "
        f"({lib.msd_cuda_error_string(err).decode()})")
  flash_attention.launches += 1
  return out


flash_attention.launches = 0


def _library() -> ctypes.CDLL:
  lib = _build.load("flash_fwd")
  if not getattr(lib, "_msd_typed", False):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.msd_flash_fwd.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.msd_flash_fwd.restype = i32
    lib.msd_cuda_error_string.argtypes = [i32]
    lib.msd_cuda_error_string.restype = ctypes.c_char_p
    lib._msd_typed = True
  return lib
