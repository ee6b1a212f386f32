"""Weight-only int8 serving: quantization and the hand-written int8 GEMM.

Port of music_spectrogram_diffusion_tpu/ops/quantize.py. Symmetric
per-output-channel int8: a kernel w [K, N] becomes q int8 [K, N] and
scale f32 [N] with w ~= q * scale. `quantized_matmul` computes
x @ (q * scale) as the TPU kernel `_qmm_kernel` does: x and q go to bf16
(exact for |q| <= 127), the sum is f32, and the scale multiplies the sum
once. On CUDA tensors it launches `csrc/qmm.cu` (built by nvcc on first
use, see `_build.py`) by the call's `plan`: a GEMV route for calls of up to
GEMV_MAX_M rows and a wgmma route for the rest, K split across a cluster of
blocks where the tiles alone cannot fill the card. On CPU tensors it runs
`qmm_reference`, the plain version; `qmm_split_reference` is the same in
the kernel's split-K order and `widen_int8_reference` the kernel's int8
widening, bit for bit. There is no fallback between the two: a CUDA call
the kernel does not take raises.

On a mesh each rank runs the kernel on its shard (the mesh rules of JAX's
`_qmm_partitioned`): a kernel split on N (`models/layers.py DenseGeneral`
column-parallel) on its column slice and the scale's, with no collective;
one split on K writes its partial product in float32 (`out_dtype`), which
is summed over the model group, then cast. The int8 tree's split is JAX's
`quantized_param_shardings` (`parallel.mesh.param_shardings`). Shards of
N % 128 != 0 (N = 192 at a 1x4 mesh) take the 32-column GEMV blocks or the
64-column wgmma tiles: `plan` takes N % 64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernel takes: K a multiple of 64 (the tensor-core route's K step)
# and N of 64 (the narrowest configuration that every route has: the wgmma
# route's tiles; GEMV has 32-column blocks too), and N a multiple of the
# chosen configuration's columns. The serving tree's quantized kernels have
# both multiples of 128 (`quantizable`); their shards on a mesh N / 2 or
# N / 4 of them.
K_MULTIPLE, N_MULTIPLE = 64, 64
# The kernel's tile table, csrc/qmm.cu kConfigs: (route, rows, columns,
# threads, stages), route GEMV (rows: the most M it takes) or WGMMA.
# `_library` checks the built kernel's table against it.
CONFIGS = ((0, 4, 128, 256, 0), (0, 4, 32, 256, 0), (1, 128, 64, 256, 4))
GEMV, WGMMA = 0, 1
# The route cut-off: calls with M <= GEMV_MAX_M rows take the GEMV route.
GEMV_MAX_M = CONFIGS[0][1]
# The most K ranges a call may be split into: the blocks of one output tile
# form a thread-block cluster, at most 8 (the portable cluster size). Splits
# are powers of two.
MAX_SPLITS = 8
# The split fills the card. WGMMA: the fewest ranges that give the grid at
# least one block an SM; where that makes more than 1.5 blocks an SM from
# clusters of 4 or 8, half as many ranges (measured faster: clusters that
# large do not all fit at once). GEMV: the fewest ranges that leave each
# thread one batch of GEMV_LOADS rows and give the grid 0.7-2 blocks an SM;
# where no split does both, the most ranges within 2 blocks an SM.
GEMV_FILL, GEMV_MAX_FILL = 0.7, 2.0


def gemv_loads(m: int) -> int:
  """The K rows a GEMV thread loads at a time (csrc/qmm.cu kGemvLoads)."""
  return 8 if m == 1 else 4

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


def qmm_split_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None, *,
                        splits: int = 1) -> torch.Tensor:
  """`qmm_reference` in the kernel's split-K order: K cut into `splits` equal
  ranges, each range summed, the range sums added in order 0, 1, ... (as the
  last block of a tile adds them), then the scale applied once."""
  out_dtype = out_dtype or x.dtype
  k = x.shape[1]
  if k % splits:
    raise ValueError(f"{splits} splits do not divide K={k}")
  step = k // splits
  xb, qf = x.to(torch.bfloat16).float(), q.float()
  acc = torch.zeros(x.shape[0], q.shape[1], dtype=torch.float32,
                    device=x.device)
  for s in range(splits):
    acc = acc + xb[:, s * step:(s + 1) * step] @ qf[s * step:(s + 1) * step]
  return (acc * scale.float()[None, :]).to(out_dtype)


def widen_int8_reference(q: torch.Tensor) -> torch.Tensor:
  """The kernel's int8 -> float32 widening, bit for bit: byte ^ 0x80 in the
  low byte of 0x4B000000 (the float 2^23 + b + 128, by one byte permute),
  minus 2^23 + 128. Exact for every int8 value."""
  flipped = (q.view(torch.uint8) ^ 0x80).to(torch.int32)
  return (flipped | 0x4B000000).view(torch.float32) - 8388736.0


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

  On CUDA tensors the kernel runs, one launch a call (counted in
  `quantized_matmul.launches`), and takes contiguous, 16-byte-aligned
  tensors with K % 64 == 0 and N % 64 == 0 (see `plan`), raising on
  anything else; on CPU tensors the plain version runs. Each (M, K, N, dtypes, device) is
  planned once (`plan`) and its plan kept.
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
  key = (m, k, n, x.dtype, out_dtype, x.device)
  launch = _LAUNCHES.get(key)
  if launch is None:
    launch = _LAUNCHES[key] = Launch(plan(m, k, n, _sm_count(x.device)),
                                     x.dtype, out_dtype)
  for name, t in (("x", x), ("q", q), ("scale", scale)):
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f"{name} must be contiguous and 16-byte aligned")
  out = torch.empty((m, n), dtype=out_dtype, device=x.device)
  launch(x, q, scale, out)
  quantized_matmul.launches += 1
  return out


quantized_matmul.launches = 0


class Plan(NamedTuple):
  """How the kernel runs one (M, K, N): route (GEMV, MMA or WGMMA), the
  tile configuration (an index of CONFIGS) and its rows and columns, the K
  split (the cluster of blocks that share an output tile) and the grid."""
  route: int
  config: int
  rows: int
  cols: int
  splits: int
  k_per_split: int
  grid: Tuple[int, int, int]


def k_step(config: int) -> int:
  """The K granularity of a configuration: 64 on the tensor cores; on GEMV
  the K rows a block takes at a time (its threads over columns / 16)."""
  route, _, cols, threads, _ = CONFIGS[config]
  return threads // (cols // 16) if route == GEMV else K_MULTIPLE


def plan(m: int, k: int, n: int, sm_count: int, *,
         config: Optional[int] = None, splits: Optional[int] = None) -> Plan:
  """The kernel's plan for an [M, K] @ [K, N] call on a card of `sm_count`
  SMs; `config` and `splits` force a choice (for measurements).

  M <= GEMV_MAX_M takes the GEMV route, 32 columns a block for one row and
  128 for more (the other width where N or K does not fit the first: a
  shard of N % 128 != 0, or K % 128 != 0 for the 32-column blocks); the
  rest the wgmma route's 128 x 64 tiles. K is split as the comment at
  GEMV_FILL says (tools/torch_qmm_times.py --sweep times every choice).
  """
  if k % K_MULTIPLE or n % N_MULTIPLE or m < 1:
    raise ValueError(f"the int8 GEMM kernel takes K % {K_MULTIPLE} == 0 and "
                     f"N % {N_MULTIPLE} == 0, got M={m}, K={k}, N={n}")
  if config is None:
    preferred = ((1, 0) if m == 1 else (0, 1)) if m <= GEMV_MAX_M else (2,)
    fits = [c for c in preferred
            if n % CONFIGS[c][2] == 0 and k % k_step(c) == 0]
    config = fits[0] if fits else preferred[0]
  route, rows, cols = CONFIGS[config][:3]
  if route == GEMV and m > rows:
    raise ValueError(f"the GEMV route takes M <= {rows}, got {m}")
  if n % cols:
    raise ValueError(f"config {config} takes N % {cols} == 0, got N={n}")
  gemv = route == GEMV
  step = k_step(config)
  if k % step:
    raise ValueError(f"config {config} takes K % {step} == 0, got K={k}")
  tiles = (n // cols) * (1 if gemv else -(-m // rows))
  allowed = [d for d in (1, 2, 4, 8)
             if d <= MAX_SPLITS and (k // step) % d == 0]
  if splits is None and gemv:
    lanes = k_step(config)
    fits = [d for d in allowed if tiles * d <= GEMV_MAX_FILL * sm_count]
    splits = next((d for d in fits if tiles * d >= GEMV_FILL * sm_count and
                   -(-k // (d * lanes)) <= gemv_loads(m)), fits[-1])
  elif splits is None:
    splits = next((d for d in allowed if tiles * d >= sm_count), allowed[-1])
    if splits >= 4 and tiles * splits > 1.5 * sm_count:
      splits //= 2
  elif splits not in allowed:
    raise ValueError(f"{splits} splits of K={k}: the kernel takes {allowed}")
  grid = ((n // cols, splits, 1) if gemv else
          (n // cols, -(-m // rows), splits))
  return Plan(route, config, rows, cols, splits, k // splits, grid)


class Launch:
  """One plan made ready to launch: the C entry's integer arguments fixed.
  Calling it launches the kernel on the current stream."""

  def __init__(self, p: Plan, x_dtype: torch.dtype, out_dtype: torch.dtype):
    self.plan = p
    self.lib = _library()
    self._codes = (p.config, p.splits, _DTYPE_CODES[x_dtype],
                   _DTYPE_CODES[out_dtype])

  def __call__(self, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out: torch.Tensor) -> None:
    m, k = x.shape
    err = self.lib.msd_qmm(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
        q.shape[1], *self._codes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
      raise RuntimeError(
          f"qmm launch failed: CUDA error {err} "
          f"({self.lib.msd_cuda_error_string(err).decode()})")


# (M, K, N, x dtype, out dtype, device) -> its Launch.
_LAUNCHES: Dict[tuple, Launch] = {}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def _library() -> ctypes.CDLL:
  lib = _build.load("qmm")
  if not getattr(lib, "_msd_typed", False):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.msd_qmm.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.msd_qmm.restype = i32
    lib.msd_qmm_configs.argtypes = [ptr, i32]
    lib.msd_qmm_configs.restype = i32
    lib.msd_cuda_error_string.argtypes = [i32]
    lib.msd_cuda_error_string.restype = ctypes.c_char_p
    count = lib.msd_qmm_configs(None, 0)
    width = len(CONFIGS[0])
    rows = (ctypes.c_int * (width * count))()
    lib.msd_qmm_configs(ctypes.cast(rows, ctypes.c_void_p), width * count)
    built = tuple(tuple(rows[width * i:width * (i + 1)])
                  for i in range(count))
    if built != CONFIGS:
      raise RuntimeError(f"csrc/qmm.cu's tile table {built} is not "
                         f"quantize.CONFIGS {CONFIGS}")
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
