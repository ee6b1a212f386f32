"""Weight-only int8 serving: quantization and the hand-written int8 GEMM.

Port of music_spectrogram_diffusion_tpu/ops/quantize.py. Symmetric
per-output-channel int8: a kernel w [K, N] becomes q int8 [K, N] and
scale f32 [N] with w ~= q * scale. `quantized_matmul` computes
x @ (q * scale) as the TPU kernel `_qmm_kernel` does: x and q go to bf16
(exact for |q| <= 127), the sum is f32, and the scale multiplies the sum
once. On CUDA tensors it launches `csrc/qmm.cu` (built by nvcc on first
use, see `_build.py`); on CPU tensors it runs `qmm_reference`, the plain
version. There is no fallback between the two: a CUDA call the kernel
does not take raises.

Not ported: the mesh partitioning (`_qmm_partitioned`,
`quantized_param_shardings`), which waits for the port's parallelism.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernel tiles: K in steps of 32, N in blocks of 64, M in blocks of
# 16 (M <= 16) or 64.
K_MULTIPLE, N_MULTIPLE = 32, 64
# Split K until about this many blocks per SM are in flight, into at most
# MAX_SPLITS ranges.
BLOCKS_PER_SM, MAX_SPLITS = 4, 16
# quantize_params: kernels whose dims are multiples of this are quantized.
_LANE = 128
# Kept in full precision, as in the JAX package: the f32 output projection.
_DEFAULT_EXCLUDE = ("spec_out_dense",)


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-output-channel int8 quantization of a 2-D kernel.

  Returns (q, scale): q int8 [K, N], scale float32 [N] with
  w ~= q * scale[None, :]. Scales are computed in float32 whatever the
  input dtype (a bf16 kernel quantizes from its bf16 values).
  """
  if w.ndim != 2:
    raise ValueError(f"quantize_kernel wants a 2D kernel, got "
                     f"{tuple(w.shape)}")
  w32 = w.float()
  absmax = w32.abs().amax(dim=0)
  scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
  q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127).to(
      torch.int8)
  return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Inverse of quantize_kernel."""
  return (q.float() * scale[None, :].float()).to(dtype)


def qmm_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """The plain version: the kernel's arithmetic in PyTorch.

  x is rounded to bf16; the bf16 products of the integer weights are exact
  in f32 and summed in f32; the per-column scale multiplies the sum.
  """
  out_dtype = out_dtype or x.dtype
  acc = x.to(torch.bfloat16).float() @ q.float()
  return (acc * scale.float()[None, :]).to(out_dtype)


def _check(x, q, scale, out_dtype):
  if x.ndim != 2 or q.ndim != 2:
    raise ValueError(f"quantized_matmul wants 2D operands, got "
                     f"{tuple(x.shape)} @ {tuple(q.shape)}")
  m, k = x.shape
  if q.shape[0] != k or tuple(scale.shape) != (q.shape[1],):
    raise ValueError(f"shapes do not match: x {tuple(x.shape)}, q "
                     f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
  if q.dtype != torch.int8 or scale.dtype != torch.float32:
    raise TypeError(f"q must be int8 and scale float32, got {q.dtype} and "
                    f"{scale.dtype}")
  if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
    raise TypeError(f"x {x.dtype} and out {out_dtype} must be float32 or "
                    "bfloat16")
  for name, t in (("x", x), ("q", q), ("scale", scale)):
    if t.device != x.device:
      raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     *, out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
  """x @ (q * scale[None, :]) with the weight kept int8 on the device.

  Args:
    x: [M, K] float32 or bfloat16 activations (rounded to bf16 inside).
    q: [K, N] int8 kernel.
    scale: [N] float32 per-output-channel scales.
    out_dtype: float32 or bfloat16 (default: x's dtype).

  On CUDA tensors the kernel runs (counted in `quantized_matmul.launches`)
  and takes contiguous, 16-byte-aligned tensors with K % 32 == 0 and
  N % 64 == 0, raising on anything else; on CPU tensors the plain version
  runs.
  """
  out_dtype = out_dtype or x.dtype
  _check(x, q, scale, out_dtype)
  if x.device.type == "cpu":
    return qmm_reference(x, q, scale, out_dtype)
  if x.device.type != "cuda":
    raise ValueError(f"quantized_matmul runs on cuda or cpu, not "
                     f"{x.device}")
  m, k = x.shape
  n = q.shape[1]
  if k % K_MULTIPLE or n % N_MULTIPLE:
    raise ValueError(f"the int8 GEMM kernel takes K % {K_MULTIPLE} == 0 and "
                     f"N % {N_MULTIPLE} == 0, got K={k}, N={n}")
  out = torch.empty((m, n), dtype=out_dtype, device=x.device)
  for name, t in (("x", x), ("q", q), ("scale", scale), ("out", out)):
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f"{name} must be contiguous and 16-byte aligned")
  splits = split_k(m, k, n, _sm_count(x.device))
  workspace = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
  lib = _library()
  stream = torch.cuda.current_stream(x.device).cuda_stream
  err = lib.msd_qmm(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                    out.data_ptr(),
                    workspace.data_ptr() if workspace is not None else None,
                    m, k, n, splits, _DTYPE_CODES[x.dtype],
                    _DTYPE_CODES[out_dtype], stream)
  if err != 0:
    raise RuntimeError(
        f"qmm launch failed: CUDA error {err} "
        f"({lib.msd_cuda_error_string(err).decode()})")
  quantized_matmul.launches += 1
  return out


quantized_matmul.launches = 0


def split_k(m: int, k: int, n: int, sm_count: int) -> int:
  """How many K ranges the kernel splits an [M, K] @ [K, N] call into.

  The kernel has one block per 16- or 64-row by 64-column output tile; a
  serving call often has too few tiles to fill the card (24 for a FiLM
  projection), so K is split until about BLOCKS_PER_SM blocks per SM are in
  flight. The count divides K's 32-wide steps and is at most MAX_SPLITS. A
  call with a tile for every SM already fills the card and is not split:
  there the partial sums would only add a pass.
  """
  tiles = (n // N_MULTIPLE) * -(-m // (16 if m <= 16 else 64))
  if tiles >= sm_count:
    return 1
  want = max(1, min(MAX_SPLITS, BLOCKS_PER_SM * sm_count // tiles))
  steps = k // K_MULTIPLE
  return max(d for d in range(1, want + 1) if steps % d == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def _library() -> ctypes.CDLL:
  lib = _build.load("qmm")
  if not getattr(lib, "_msd_typed", False):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.msd_qmm.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.msd_qmm.restype = i32
    lib.msd_cuda_error_string.argtypes = [i32]
    lib.msd_cuda_error_string.restype = ctypes.c_char_p
    lib._msd_typed = True
  return lib


# ---------------------------------------------------------------------------
# The serving tree: a state_dict (name -> tensor), as the port stores it.
# ---------------------------------------------------------------------------


def quantizable(name: str, tensor: torch.Tensor, *, min_dim: int = 512,
                exclude: Sequence[str] = _DEFAULT_EXCLUDE) -> bool:
  """The JAX package's rule: a 2-D float `kernel` with min(shape) >= min_dim,
  both dims multiples of 128, and no path component in `exclude`."""
  parts = name.split(".")
  return (parts[-1] == "kernel" and tensor.ndim == 2
          and tensor.dtype.is_floating_point
          and min(tensor.shape) >= min_dim
          and tensor.shape[0] % _LANE == 0 and tensor.shape[1] % _LANE == 0
          and not any(e in parts[:-1] for e in exclude))


def quantize_params(state: Mapping[str, torch.Tensor], *, min_dim: int = 512,
                    exclude: Sequence[str] = _DEFAULT_EXCLUDE
                    ) -> Dict[str, torch.Tensor]:
  """Rewrite a state_dict for int8 serving.

  Every kernel `quantizable` accepts becomes int8 with a sibling
  `kernel_scale` [N] float32 (`models.layers.DenseGeneral` takes both);
  every other tensor is passed through.
  """
  out: Dict[str, torch.Tensor] = {}
  for name, tensor in state.items():
    if quantizable(name, tensor, min_dim=min_dim, exclude=exclude):
      q, s = quantize_kernel(tensor)
      out[name] = q
      out[name + "_scale"] = s
    else:
      out[name] = tensor
  return out


def quantized_bytes(state: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
  """(total_bytes, int8_bytes) of a serving state_dict, for logging."""
  total = int8 = 0
  for tensor in state.values():
    nbytes = tensor.numel() * tensor.element_size()
    total += nbytes
    if tensor.dtype == torch.int8:
      int8 += nbytes
  return total, int8
