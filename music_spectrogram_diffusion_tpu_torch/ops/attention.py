"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

`flash_attention` computes softmax(q k^T + bias + (keep - 1) * 1e10) v,
T5-style with no 1/sqrt(d) scaling, as the TPU kernel
`music_spectrogram_diffusion_tpu/ops/attention.py:flash_attention` does. On
CUDA tensors it launches `csrc/flash_fwd.cu` (built by nvcc on first use,
see `_build.py`); on CPU tensors it runs `attention_reference`, the plain
PyTorch version. There is no fallback between the two: a CUDA call that
cannot launch raises.

Both kernels compute on the tensor cores: bf16 products as bf16 mma, f32
products as three TF32 products each (`split_tf32`, `einsum_3xtf32`, the
plain versions of that arithmetic, which the tests use). Where a call's
blocks cannot fill the card, the forward splits each query tile's keys into
ranges and combines them (`kv_split`; `attention_split_kv_reference` is its
plain version).

`flash_attention_diff` is the differentiable form (the training path), as
the JAX package's `flash_attention_diff`: its forward is the forward kernel,
which also writes each row's softmax max and sum, and its backward
`flash_attention_bwd` launches `csrc/flash_bwd.cu` (TPU kernel
`_flash_bwd_pallas`), in float32 or bfloat16, by one of two routes
(`bwd_route`): bf16 at head_dim 64 on wgmma and TMA
(`csrc/flash_bwd_wgmma.cuh`, its dq pass split along the keys by
`dq_key_split` where the queries are few), every other call on mma.sync.
On CPU tensors
`flash_attention_bwd` runs `flash_attention_bwd_reference`, and
`flash_attention_diff` is autograd through `attention_reference` in
float32 and, in bfloat16, the plain versions of both kernels (so that p and
dS round to bf16 where the kernel rounds them).
"""

from __future__ import annotations

import ctypes
import functools
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


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version of the kernels' operand split (csrc/attention_mma.cuh
  `split_tf32`): f32 x as big + small, each rounded to TF32 (10 mantissa
  bits) as `cvt.rna.tf32.f32` rounds, to nearest with ties away from zero.
  big + small equals x within 2^-21 relative. Where x is NaN or inf, small
  is NaN, so every product it enters is NaN."""

  def rna(bits):  # the kernels' integer add-and-mask on the f32 bits
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)

  x = x.float().contiguous()
  big = rna(x.view(torch.int32).to(torch.int64))
  rest = x - big
  # The card's float add gives the NaN 0x7fffffff, which the kernels clamp
  # to 0x7fffefff, so that it rounds to a NaN and not into the sign bit.
  return big, rna(torch.where(torch.isnan(rest), 0x7FFFEFFF,
                              rest.view(torch.int32).to(torch.int64)))


def einsum_3xtf32(equation: str, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
  """The plain version of an f32 product as the kernels take it on the
  tensor cores (3xTF32): small(a) big(b) + big(a) small(b) + big(a) big(b),
  each term exact in f32, the small x small term dropped."""
  a_big, a_small = split_tf32(a)
  b_big, b_small = split_tf32(b)
  return (torch.einsum(equation, a_small, b_big)
          + torch.einsum(equation, a_big, b_small)
          + torch.einsum(equation, a_big, b_big))


def _scores(query, key, bias, kv_mask, kv_transposed, einsum=torch.einsum):
  """f32 scores [b, h, q, kv]: q k^T + bias + (keep - 1) * 1e10."""
  k_sub = "bhkd" if kv_transposed else "bkhd"
  scores = einsum(f"bqhd,{k_sub}->bhqk", query.float(), key.float())
  if bias is not None:
    scores = scores + bias.float()
  if kv_mask is not None:
    scores = scores + ((kv_mask.float() - 1.0) * 1e10)[:, None, None, :]
  return scores


def softmax_stats_reference(query, key, bias=None, kv_mask=None, *,
                            kv_transposed: bool = False,
                            einsum=torch.einsum) -> torch.Tensor:
  """The plain version of the forward kernel's statistics: f32
  [2, b, h, q], each row's max m and its sum l of exp(s - m). `einsum`
  takes the products (`einsum_3xtf32`: as the kernel's f32 path does)."""
  scores = _scores(query, key, bias, kv_mask, kv_transposed, einsum)
  m = scores.amax(dim=-1)
  return torch.stack([m, torch.exp(scores - m[..., None]).sum(dim=-1)])


def attention_reference(query: torch.Tensor,
                        key: torch.Tensor,
                        value: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        kv_mask: Optional[torch.Tensor] = None,
                        *,
                        kv_transposed: bool = False,
                        einsum=torch.einsum) -> torch.Tensor:
  """The plain version: materialized f32 scores, then softmax, then p v.

  Same arguments and result as `flash_attention`; the output has the
  query's dtype. `einsum` takes the two products (`einsum_3xtf32`: as the
  kernel's f32 path does).
  """
  k_sub = "bhkd" if kv_transposed else "bkhd"
  weights = torch.softmax(
      _scores(query, key, bias, kv_mask, kv_transposed, einsum), dim=-1)
  return einsum(f"bhqk,{k_sub}->bqhd", weights,
                value.float()).to(query.dtype)


def kv_split(batch: int, heads: int, q_len: int, kv_len: int, sm_count: int,
             rows: int, keys: int) -> Tuple[int, int]:
  """(splits, keys_per_split) of the forward kernel's split-KV path.

  A call whose b h ceil(q / rows) blocks (`rows` query rows a block, `keys`
  keys a K/V tile: the kernel's block shape, `fwd_tile`) cannot fill the
  card's `sm_count` SMs cuts each query tile's keys into ranges of whole
  K/V tiles, aiming at about two blocks an SM, and combines them; a call
  that fills the card takes 1 split (keys_per_split = kv_len). Every range
  starts below kv_len, so it holds a key that is scored.
  """
  blocks = batch * heads * -(-q_len // rows)
  tiles = -(-kv_len // keys)
  if blocks >= sm_count or tiles == 1:
    return 1, kv_len
  per = -(-tiles // min(tiles, -(-2 * sm_count // blocks)))  # tiles a split
  return -(-tiles // per), per * keys


# The backward's wgmma route (csrc/flash_bwd_wgmma.cuh): the head_dim it
# takes, and the alignment (bytes) of q, k, v, out and dO that its TMA and
# prologue loads need.
WGMMA_HEAD_DIM = 64
WGMMA_ALIGN = 16
# The dq key split: splits until the dq pass has about this many work items
# an SM, at most DQ_MAX_SPLITS.
DQ_SPLIT_WAVES = 4
DQ_MAX_SPLITS = 8


def bwd_route(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
  """The backward kernel's route for a call, as `csrc/flash_bwd.cu`
  `wgmma_route` chooses it: "wgmma" for bfloat16 at head_dim 64 with q, k,
  v, out and dO 16-byte aligned (`aligned`; every training call of the
  model), else "mma_sync" (float32, another head_dim, a misaligned
  tensor). A route, not a fallback."""
  if dtype == torch.bfloat16 and head_dim == WGMMA_HEAD_DIM and aligned:
    return "wgmma"
  return "mma_sync"


def dq_key_split(batch: int, heads: int, q_len: int, kv_len: int,
                 sm_count: int, rows: int, keys: int) -> Tuple[int, int]:
  """(splits, keys_per_split) of the wgmma route's dq pass.

  The pass runs b h ceil(q / rows) work items (`rows` queries an item,
  `keys` keys a streamed tile: the route's block shape, `bwd_tile`), each
  walking its keys in order, at most one block an SM. Where that is fewer
  than DQ_SPLIT_WAVES items an SM (the 256-query shapes), the keys are cut
  into ranges of whole tiles, one item each, whose f32 partials are summed
  in range order; else 1 split of every tile. Ranges cover [0, kv_len)
  once, in order, and each starts below kv_len.
  """
  blocks = batch * heads * -(-q_len // rows)
  tiles = -(-kv_len // keys)
  if blocks >= DQ_SPLIT_WAVES * sm_count or tiles == 1:
    return 1, tiles * keys
  want = min(tiles, DQ_MAX_SPLITS, -(-DQ_SPLIT_WAVES * sm_count // blocks))
  per = -(-tiles // want)  # tiles a split
  return -(-tiles // per), per * keys


def bwd_tile(q_len: int) -> Tuple[int, int]:
  """(queries a dq work item owns, rows a streamed tile) of the backward's
  wgmma route for q_len queries, as `csrc/flash_bwd.cu` is built (loads
  it; needs the card): the dq pass takes three warpgroups (192 rows) where
  the queries fill such items, else two (128)."""
  lib = _library("flash_bwd")
  return lib.msd_flash_bwd_tile(0, q_len), lib.msd_flash_bwd_tile(1, q_len)


def fwd_tile(dtype: torch.dtype) -> Tuple[int, int]:
  """(query rows a block, keys a K/V tile) of the forward kernel for
  `dtype`, as `csrc/flash_fwd.cu` is built (loads it; needs the card)."""
  return _library("flash_fwd").msd_fwd_tile[dtype]


def tf32_round_probe(bits: torch.Tensor):
  """Each f32 bit pattern of `bits` (int32, on the card) rounded to TF32 by
  the kernels' `round_tf32` and by `cvt.rna.tf32.f32`, the instruction it
  stands in for, and the small term of the kernels' `split_tf32`: (ours,
  cvt, small), int32 bit patterns."""
  if bits.device.type != "cuda" or bits.dtype != torch.int32:
    raise ValueError(f"tf32_round_probe takes int32 on cuda, got "
                     f"{bits.dtype} on {bits.device}")
  lib = _library("flash_fwd")
  bits = bits.contiguous()
  ours, cvt, small = (torch.empty_like(bits) for _ in range(3))
  err = lib.msd_tf32_round_probe(bits.data_ptr(), ours.data_ptr(),
                                 cvt.data_ptr(), small.data_ptr(),
                                 bits.numel(), _stream(bits))
  _raise_on(lib, err, "tf32_round_probe")
  return ours, cvt, small


def attention_split_kv_reference(query, key, value, bias=None, kv_mask=None,
                                 *, kv_transposed: bool = False,
                                 keys_per_split: int):
  """The plain version of the forward kernel's split-KV path: each range of
  `keys_per_split` keys gives its row max m_s, its sum l_s of exp(s - m_s)
  and its unnormalised exp(s - m_s) v; the combine takes, over the ranges
  in ascending order, m = max m_s, l = sum exp(m_s - m) l_s and out =
  sum exp(m_s - m) acc_s / l. Returns (out in the query's dtype, f32
  statistics [2, b, h, q]) as `flash_attention(return_stats=True)`."""
  scores = _scores(query, key, bias, kv_mask, kv_transposed)
  v = value.float() if kv_transposed else value.float().transpose(1, 2)
  parts = []
  for start in range(0, scores.shape[-1], keys_per_split):
    s = scores[..., start:start + keys_per_split]
    m_s = s.amax(dim=-1)
    e = torch.exp(s - m_s[..., None])
    parts.append((m_s, e.sum(dim=-1), torch.einsum(
        "bhqk,bhkd->bhqd", e, v[:, :, start:start + keys_per_split])))
  m = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
  l = torch.zeros_like(m)
  acc = torch.zeros_like(parts[0][2])
  for m_s, l_s, acc_s in parts:
    w = torch.exp(m_s - m)
    l = l + w * l_s
    acc = acc + w[..., None] * acc_s
  out = (acc / l[..., None]).transpose(1, 2).to(query.dtype)
  return out, torch.stack([m, l])


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
                    kv_transposed: bool = False,
                    return_stats: bool = False):
  """softmax(q k^T + bias + (keep - 1) * 1e10) v, no 1/sqrt(d).

  Args:
    query: [batch, q_len, heads, head_dim], float32 or bfloat16.
    key/value: [batch, kv_len, heads, head_dim], or [batch, heads, kv_len,
      head_dim] when kv_transposed; the query's dtype.
    bias: optional float32 [batch, 1 | heads, q_len, kv_len] additive bias.
    kv_mask: optional bool [batch, kv_len]; False drops the key for every
      query row. A row whose keys are all dropped averages them evenly.

  All tensors contiguous and on one device; head_dim <= 128. Returns
  [batch, q_len, heads, head_dim] in the query's dtype, and with
  `return_stats` also the softmax statistics, f32 [2, b, h, q] (each row's
  max, then its sum of exp(s - max)). On CUDA tensors the kernel runs
  (counted in `flash_attention.launches`); on CPU tensors the plain
  versions do.
  """
  kv_len = _check(query, key, value, bias, kv_mask, kv_transposed)
  if query.device.type == "cpu":
    out = attention_reference(query, key, value, bias, kv_mask,
                              kv_transposed=kv_transposed)
    if not return_stats:
      return out
    return out, softmax_stats_reference(query, key, bias, kv_mask,
                                        kv_transposed=kv_transposed)
  _check_cuda(query, "flash_attention")
  lib = _library("flash_fwd")
  batch, q_len, heads, head_dim = query.shape
  f32 = dict(dtype=torch.float32, device=query.device)
  out = torch.empty_like(query)
  stats = (torch.empty(2, batch, heads, q_len, **f32) if return_stats
           else None)
  splits, keys_per_split = kv_split(batch, heads, q_len, kv_len,
                                    _sm_count(query.device.index),
                                    *lib.msd_fwd_tile[query.dtype])
  part_acc = part_ml = None
  if splits > 1:  # the split-KV scratch, combined by a second kernel
    part_acc = torch.empty(splits, batch, heads, q_len, head_dim, **f32)
    part_ml = torch.empty(2, splits, batch, heads, q_len, **f32)
  err = lib.msd_flash_fwd(
      query.data_ptr(), key.data_ptr(), value.data_ptr(),
      bias.data_ptr() if bias is not None else None,
      kv_mask.data_ptr() if kv_mask is not None else None,
      out.data_ptr(), stats.data_ptr() if stats is not None else None,
      part_acc.data_ptr() if part_acc is not None else None,
      part_ml.data_ptr() if part_ml is not None else None,
      batch, heads, q_len, kv_len, head_dim,
      int(kv_transposed), bias.shape[1] if bias is not None else 1,
      _DTYPE_CODES[query.dtype], splits, keys_per_split, _stream(query))
  _raise_on(lib, err, "flash_fwd")
  flash_attention.launches += 1
  return (out, stats) if return_stats else out


flash_attention.launches = 0  # one per call, the split-KV combine included


def flash_attention_bwd_reference(query, key, value, bias, kv_mask, out,
                                  stats, dout, *,
                                  kv_transposed: bool = False,
                                  einsum=torch.einsum):
  """The plain version of `flash_attention_bwd`, with the kernel's
  arithmetic: p = exp(s - m) / l from the forward's statistics,
  delta = rowsum(dO out) in f32, dS = p (dP - delta); dV = p^T dO,
  dK = dS^T q, dQ = dS k. `einsum` takes the five products
  (`einsum_3xtf32`: as the kernel's f32 route does). On bfloat16 inputs p
  and dS are rounded to bf16 before the products that use them, as the
  kernel (and the TPU kernel with mxu_bf16) rounds them; every product
  sums in f32. Returns (dq, dk, dv) in the inputs' dtype, each rounded
  once at the end, in the layouts of q and k/v."""
  k_sub = "bhkd" if kv_transposed else "bkhd"
  low = query.dtype == torch.bfloat16
  m, l = stats[0], stats[1]
  p = torch.exp(_scores(query, key, bias, kv_mask, kv_transposed, einsum)
                - m[..., None]) / l[..., None]
  do = dout.float()
  delta = torch.einsum("bqhd,bqhd->bhq", do, out.float())
  dp = einsum(f"bqhd,{k_sub}->bhqk", do, value.float())
  ds = p * (dp - delta[..., None])
  if low:
    p = p.to(torch.bfloat16).float()
    ds = ds.to(torch.bfloat16).float()
  dv = einsum(f"bhqk,bqhd->{k_sub}", p, do)
  dk = einsum(f"bhqk,bqhd->{k_sub}", ds, query.float())
  dq = einsum(f"bhqk,{k_sub}->bqhd", ds, key.float())
  return dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype)


def flash_attention_bwd(query, key, value, bias, kv_mask, out, stats, dout,
                        *, kv_transposed: bool = False):
  """dQ, dK, dV of `flash_attention` from its output and statistics.

  Args as `flash_attention` (float32 or bfloat16), plus `out` (its
  output), `stats` (f32 [2, b, h, q] from `return_stats`) and `dout` (the
  output's gradient); q, k, v, out and dout all of one dtype. Bias and mask
  get no gradient. On CUDA tensors it launches `csrc/flash_bwd.cu`
  (counted in `flash_attention_bwd.launches`) by the route its
  `wgmma_route` picks (`bwd_route` here): bfloat16 at head_dim 64 with q,
  k, v, out and dout 16-byte aligned takes the wgmma route, which computes
  delta = rowsum(dO out) itself and splits its dq pass along the keys as
  `dq_key_split` plans; every other call takes the mma.sync route, with
  delta computed here in f32. On CPU tensors it runs
  `flash_attention_bwd_reference`. Returns (dq, dk, dv) in the inputs'
  dtype, in the layouts of q and k/v.
  """
  kv_len = _check(query, key, value, bias, kv_mask, kv_transposed)
  batch, q_len, heads, head_dim = query.shape
  for name, t in (("out", out), ("dout", dout)):
    if t.dtype != query.dtype:
      raise TypeError(f"flash_attention_bwd takes one dtype for q, k, v, "
                      f"out and dout: q is {query.dtype}, {name} is "
                      f"{t.dtype}")
  for name, t, shape in (("out", out, query.shape),
                         ("dout", dout, query.shape),
                         ("stats", stats, (2, batch, heads, q_len))):
    if tuple(t.shape) != tuple(shape) or t.device != query.device:
      raise ValueError(f"{name} {tuple(t.shape)} on {t.device} is not "
                       f"{tuple(shape)} on {query.device}")
    if query.device.type == "cuda" and not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")
  if stats.dtype != torch.float32:
    raise TypeError(f"stats must be float32, got {stats.dtype}")
  if query.device.type == "cpu":
    return flash_attention_bwd_reference(query, key, value, bias, kv_mask,
                                         out, stats, dout,
                                         kv_transposed=kv_transposed)
  _check_cuda(query, "flash_attention_bwd")
  lib = _library("flash_bwd")
  code = _DTYPE_CODES[query.dtype]
  aligned = all(t.data_ptr() % WGMMA_ALIGN == 0
                for t in (query, key, value, out, dout))
  f32 = dict(dtype=torch.float32, device=query.device)
  delta = rowstat = kterm = dq_part = None
  splits, keys_per_split = 1, kv_len
  if lib.msd_flash_bwd_route(code, head_dim, int(aligned)):
    # The wgmma route's f32 scratch: each row's m, 1 / l and delta, each
    # key's mask term (lengths padded to whole blocks), the dq partials.
    rows, keys, kv_rows = (lib.msd_flash_bwd_tile(i, q_len) for i in range(3))
    rowstat = torch.empty(batch, heads, -(-q_len // rows) * rows // keys, 3,
                          keys, **f32)
    kterm = torch.empty(batch, -(-kv_len // kv_rows) * kv_rows, **f32)
    splits, keys_per_split = dq_key_split(
        batch, heads, q_len, kv_len, _sm_count(query.device.index), rows,
        keys)
    if splits > 1:
      dq_part = torch.empty(splits, *query.shape, **f32)
  else:
    # delta = rowsum(dO out), f32 [b, h, q]: computed outside the kernel, as
    # the JAX package does, and summed in f32 whatever the inputs' dtype.
    delta = torch.einsum("bqhd,bqhd->bhq", dout.float(),
                         out.float()).contiguous()
  dq = torch.empty_like(query)
  dk = torch.empty_like(key)
  dv = torch.empty_like(value)

  def ptr(t):
    return t.data_ptr() if t is not None else None

  err = lib.msd_flash_bwd(
      query.data_ptr(), key.data_ptr(), value.data_ptr(), ptr(bias),
      ptr(kv_mask), stats.data_ptr(), ptr(delta), out.data_ptr(),
      dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
      ptr(rowstat), ptr(kterm), ptr(dq_part), batch, heads, q_len, kv_len,
      head_dim, int(kv_transposed), bias.shape[1] if bias is not None else 1,
      code, splits, keys_per_split, _stream(query))
  _raise_on(lib, err, "flash_bwd")
  flash_attention_bwd.launches += 1
  return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttentionFn(torch.autograd.Function):
  """Forward kernel with statistics; backward kernel. Bias and mask are
  not differentiated."""

  @staticmethod
  def forward(ctx, query, key, value, bias, kv_mask, kv_transposed):
    out, stats = flash_attention(query, key, value, bias, kv_mask,
                                 kv_transposed=kv_transposed,
                                 return_stats=True)
    ctx.save_for_backward(query, key, value, bias, kv_mask, out, stats)
    ctx.kv_transposed = kv_transposed
    return out

  @staticmethod
  def backward(ctx, dout):
    query, key, value, bias, kv_mask, out, stats = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(
        query, key, value, bias, kv_mask, out, stats, dout.contiguous(),
        kv_transposed=ctx.kv_transposed)
    return dq, dk, dv, None, None, None


def flash_attention_diff(query: torch.Tensor,
                         key: torch.Tensor,
                         value: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         kv_mask: Optional[torch.Tensor] = None,
                         *,
                         kv_transposed: bool = False) -> torch.Tensor:
  """Differentiable `flash_attention` (the training path), in q, k and v.

  `bias` must be a constant (a mask's): it gets no gradient, as in the JAX
  package. Attention dropout that broadcasts along the queries (the T5
  pattern) composes from outside: scale the value rows by keep / (1 - rate)
  before the call, which equals dropping the normalized weights.

  q, k and v are float32 or bfloat16, of one dtype; the gradients come in
  it. On CUDA tensors the forward and backward kernels run. On CPU tensors
  float32 is autograd through `attention_reference`, and bfloat16 runs the
  kernels' plain versions (the backward rounds p and dS to bf16 as the
  kernel does, which autograd through the f32 reference would not).
  """
  _check(query, key, value, bias, kv_mask, kv_transposed)
  if query.device.type == "cpu" and query.dtype == torch.float32:
    return attention_reference(query, key, value, bias, kv_mask,
                               kv_transposed=kv_transposed)
  if query.device.type != "cpu":
    _check_cuda(query, "flash_attention_diff")
  return _FlashAttentionFn.apply(query, key, value, bias, kv_mask,
                                 kv_transposed)


def _check_cuda(query: torch.Tensor, what: str) -> None:
  if query.device.type != "cuda":
    raise ValueError(f"{what} runs on cuda or cpu, not {query.device}")


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(lib: ctypes.CDLL, err: int, name: str) -> None:
  if err != 0:
    raise RuntimeError(
        f"{name} launch failed: CUDA error {err} "
        f"({lib.msd_cuda_error_string(err).decode()})")


# Pointer arguments, then int arguments, of each kernel's C entry (the
# stream is the last pointer).
_SIGNATURES = {"flash_fwd": ("msd_flash_fwd", 9, 10),
               "flash_bwd": ("msd_flash_bwd", 15, 10)}


def _library(name: str) -> ctypes.CDLL:
  lib = _build.load(name)
  if not getattr(lib, "_msd_typed", False):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn_name, n_ptr, n_int = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
    fn.restype = i32
    lib.msd_cuda_error_string.argtypes = [i32]
    lib.msd_cuda_error_string.restype = ctypes.c_char_p
    if name == "flash_fwd":
      lib.msd_flash_fwd_rows.argtypes = [i32]
      lib.msd_flash_fwd_rows.restype = i32
      lib.msd_flash_fwd_keys.argtypes = []
      lib.msd_flash_fwd_keys.restype = i32
      lib.msd_tf32_round_probe.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
      lib.msd_tf32_round_probe.restype = i32
      # The block shape, asked once: kv_split plans every call by it.
      lib.msd_fwd_tile = {
          dtype: (lib.msd_flash_fwd_rows(code), lib.msd_flash_fwd_keys())
          for dtype, code in _DTYPE_CODES.items()}
    if name == "flash_bwd":
      lib.msd_flash_bwd_route.argtypes = [i32, i32, i32]
      lib.msd_flash_bwd_route.restype = i32
      lib.msd_flash_bwd_tile.argtypes = [i32, i32]
      lib.msd_flash_bwd_tile.restype = i32
    lib._msd_typed = True
  return lib
