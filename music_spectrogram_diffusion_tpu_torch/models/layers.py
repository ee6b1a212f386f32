"""T5.1.1-style layers in PyTorch.

Port of music_spectrogram_diffusion_tpu/models/layers.py. Parameters keep
the Flax layout and names (2-D `kernel` [in, out], `scale`, `embedding`),
so `convert.py` moves a Flax tree over leaf for leaf. Parameters are
trainable, except the fixed position tables (JAX stops their gradient) and
an int8 `DenseGeneral`, which serves only.

Every `MultiHeadAttention` goes through `ops.attention`:
`flash_attention_diff` when grad mode is on and its query, key or value
needs a gradient (training), else `flash_attention` (serving, whose modules
are frozen); every int8 `DenseGeneral` goes through
`ops.quantize.quantized_matmul`. Those are the CUDA kernels on the card and
their plain versions on the CPU. The autoregressive decoder's causal
self-attention and its single-frame decode steps (`DecodeCacheAttention`,
and the cross-attention of a decode step) run `dot_product_attention`, plain
einsums, as the JAX package runs them in einsums outside its kernels.

Dropout draws from an explicit `torch.Generator` passed to `forward`; with
none (or rate 0) it is off. It cannot reproduce `jax.random`'s bits, only
their distribution: a unit is kept with probability 1 - rate and scaled by
1 / (1 - rate), with the same broadcast axes as the JAX layers.

Every parameter states the logical axes JAX gives it (`logical_axes`;
`DenseGeneral(kernel_axes=...)` as JAX's), and `parallel.mesh.shard_module_`
cuts the layers to one rank's shard of a ('data', 'model') mesh
(`shard_`). A sharded layer runs its shard with the collectives written
out, as GSPMD and JAX's kernel partitioners place them: a column-parallel
`DenseGeneral` (N split: the MLP's `wi`, the q/k/v projections) needs none;
a row-parallel one (K split: `wo`, the attention output, the 'vocab'-axis
inputs) sums its partial product over the model group in float32 (kernel #3
writes the int8 partial in float32, as JAX's `_qmm_partitioned`; a float
partial is the product in the compute dtype, widened), then casts; an
output split on 'vocab' is gathered. Attention runs the flash kernels on
the local heads; a vocab-split `Embed` looks up its rows and sums over the
model group. Dropout then draws at the global shape and keeps the rank's
block (`parallel.mesh.rand`), so a sharded step equals the unsharded one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch.ops import attention
from music_spectrogram_diffusion_tpu_torch.ops import quantize
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    # Flax's nn.gelu is the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def sinusoidal_table(max_len: int, features: int,
                     generator: Optional[torch.Generator] = None,
                     min_scale: float = 1.0,
                     max_scale: float = 10000.0) -> torch.Tensor:
  """Sinusoidal position table [max_len, features].

  With a generator the phases are offset at random and the bands permuted
  ('fixed_permuted_offset'); without one it is the plain table ('fixed').
  A trained model's table is a parameter and is loaded, not recomputed.
  """
  half = features // 2
  position = np.arange(max_len)[:, None]
  scale_factor = -np.log(max_scale / min_scale) / (half - 1)
  div_term = min_scale * np.exp(np.arange(half) * scale_factor)
  rads = torch.as_tensor(position * div_term, dtype=torch.float32)
  sin_off = cos_off = 0.0
  if generator is not None:
    sin_off = torch.rand(half, generator=generator) * (2 * math.pi)
    cos_off = torch.rand(half, generator=generator) * (2 * math.pi)
  pe = torch.zeros(max_len, features)
  pe[:, :half] = torch.sin(rads + sin_off)
  pe[:, half:2 * half] = torch.cos(rads + cos_off)
  if generator is not None:
    pe = pe[:, torch.randperm(features, generator=generator)]
  return pe


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            broadcast_dims: Sequence[int] = (),
            model_dim: Optional[int] = None) -> torch.Tensor:
  """Flax's nn.Dropout: keep with probability 1 - rate, scale by
  1 / (1 - rate); one draw shared along `broadcast_dims`. Off without a
  generator or at rate 0. Under a mesh the mask is drawn at the global
  shape (`parallel.mesh.rand`; `model_dim`: the dim of x split over
  'model')."""
  if generator is None or rate == 0.0:
    return x
  shape = list(x.shape)
  for dim in broadcast_dims:
    shape[dim] = 1
  keep = mesh_lib.rand(shape, generator=generator, device=x.device,
                       model_dim_=model_dim) < 1.0 - rate
  return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator,
             truncated: bool):
  """Flax variance-scaling init: a normal, or one truncated at 2 std."""
  if truncated:
    # Flax divides by the std of a unit normal truncated to [-2, 2].
    std = std / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
  else:
    nn.init.normal_(t, std=std, generator=generator)


class DenseGeneral(nn.Module):
  """Bias-free linear map over the last len(in_features) input axes.

  `kernel` is stored flat, [prod(in_shape), prod(features)], as in Flax,
  with the logical axes `kernel_axes` (JAX's; () for none). In its int8
  form (`quantize_dense_`), as in an int8 serving tree of the JAX package,
  `kernel` is int8 and a float32 `kernel_scale` [N] sits beside it; the
  product then goes through `quantized_matmul`.

  Sharded (`shard_`), `split` is the kernel dim cut over 'model' (None:
  replicated); `in_features` and `features` describe the activations the
  shard takes and gives.
  """

  def __init__(self, in_features: Sequence[int] | int,
               features: Sequence[int] | int, *, dtype=torch.float32,
               kernel_axes: Tuple[str, str] = ()):
    super().__init__()
    self.in_features = tuple(np.atleast_1d(in_features).tolist())
    self.features = tuple(np.atleast_1d(features).tolist())
    self.dtype = dtype
    self.kernel_axes = tuple(kernel_axes)
    self.kernel = nn.Parameter(torch.empty(
        int(np.prod(self.in_features)), int(np.prod(self.features))))
    self.mesh: Optional[mesh_lib.Mesh] = None
    self.split: Optional[int] = None
    self._specs = None

  def init_weights(self, generator: torch.Generator, *, scale: float = 1.0,
                   truncated: bool = True):
    _normal_(self.kernel, scale / math.sqrt(self.kernel.shape[0]), generator,
             truncated)

  @property
  def is_int8(self) -> bool:
    return self.kernel.dtype == torch.int8

  def logical_axes(self):
    axes = self.kernel_axes or (None, None)
    return {"kernel": axes, "kernel_scale": (axes[-1],)}

  def param_splits(self, mesh: mesh_lib.Mesh, rules=mesh_lib.DEFAULT_RULES):
    """The mesh axis of each dim of `kernel` (and `kernel_scale`, which
    follows N) on `mesh`, for the full layer; a flattened dim splits only
    along its leading axis."""
    if self._specs is None or self.mesh is not mesh:
      spec = mesh_lib.split_dims(self.logical_axes()["kernel"],
                                 (self.in_features[0], self.features[0]),
                                 mesh, rules)
      specs = {"kernel": spec}
      if self.is_int8:
        specs["kernel_scale"] = (spec[1],)
      return specs
    return self._specs

  def shard_(self, mesh: mesh_lib.Mesh, rules=mesh_lib.DEFAULT_RULES):
    """Cut the kernel (and scale) to this rank's shard of `mesh`."""
    specs = self.param_splits(mesh, rules)
    split = mesh_lib.model_dim(specs["kernel"], mesh)
    if split is not None:
      with torch.no_grad():
        self.kernel = nn.Parameter(
            mesh.shard(self.kernel.data, "model", split),
            requires_grad=self.kernel.requires_grad)
        if self.is_int8 and split == 1:
          self.kernel_scale = nn.Parameter(
              mesh.shard(self.kernel_scale.data, "model", 0),
              requires_grad=False)
      axis = self.kernel_axes[split]
      if split == 0 and axis in mesh_lib.SPLIT_ACTIVATIONS:
        self.in_features = ((self.in_features[0] // mesh.model,)
                            + self.in_features[1:])
      if split == 1 and axis in mesh_lib.SPLIT_ACTIVATIONS:
        self.features = ((self.features[0] // mesh.model,)
                         + self.features[1:])
    self.mesh, self.split, self._specs = mesh, split, specs

  def _product(self, x2d: torch.Tensor, out_dtype) -> torch.Tensor:
    if self.is_int8:
      return quantize.quantized_matmul(x2d.contiguous(), self.kernel,
                                       self.kernel_scale, out_dtype=out_dtype)
    y = x2d @ self.kernel.to(self.dtype)
    return y if out_dtype == self.dtype else y.to(out_dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    n_in = len(self.in_features)
    lead = x.shape[:x.ndim - n_in]
    x2d = x.to(self.dtype).reshape(-1, x.shape[x.ndim - n_in:].numel())
    mesh = self.mesh
    if self.split is None:
      y = self._product(x2d, self.dtype)
    elif self.split == 1:  # column-parallel: the output's columns
      y = self._product(mesh_lib.copy_to_model(x2d, mesh), self.dtype)
      if y.shape[1] != math.prod(self.features):
        y = mesh_lib.gather_from_model(y, mesh)
    else:  # row-parallel: a partial product, summed in float32
      width = self.kernel.shape[0]
      if x2d.shape[1] != width:  # a replicated input: this rank's slice
        x2d = mesh_lib.copy_to_model(x2d, mesh).narrow(
            1, mesh.model_index * width, width)
      y = mesh_lib.reduce_from_model(self._product(x2d, torch.float32),
                                     mesh).to(self.dtype)
    return y.reshape(*lead, *self.features)


def quantize_dense_(dense: DenseGeneral, q: torch.Tensor,
                    scale: torch.Tensor):
  """Turn a float DenseGeneral into its int8 form, in place: `kernel`
  becomes q (int8, the float kernel's shape) and `kernel_scale` is scale
  (float32 [N]), both moved to the module's device."""
  if dense.is_int8:
    raise ValueError("DenseGeneral is int8 already")
  if q.dtype != torch.int8 or scale.dtype != torch.float32:
    raise TypeError(f"int8 kernel and float32 scale wanted, got {q.dtype} "
                    f"and {scale.dtype}")
  if q.shape != dense.kernel.shape or scale.shape != q.shape[1:]:
    raise ValueError(f"int8 kernel {tuple(q.shape)} / scale "
                     f"{tuple(scale.shape)} do not fit the kernel "
                     f"{tuple(dense.kernel.shape)}")
  device = dense.kernel.device
  dense.kernel = nn.Parameter(q.to(device), requires_grad=False)
  dense.kernel_scale = nn.Parameter(scale.to(device), requires_grad=False)


class MlpBlock(nn.Module):
  """Feed-forward block with gated activations (e.g. gelu * linear); the
  intermediate dropout shares one draw along the length axis."""

  def __init__(self, emb_dim: int, intermediate_dim: int,
               activations: Sequence[str], *, dtype=torch.float32,
               dropout_rate: float = 0.0):
    super().__init__()
    self.dropout_rate = dropout_rate
    self.activations = tuple(activations)
    names = (["wi"] if len(self.activations) == 1 else
             [f"wi_{i}" for i in range(len(self.activations))])
    self.wi_names = names
    for name in names:
      setattr(self, name, DenseGeneral(emb_dim, intermediate_dim,
                                       dtype=dtype,
                                       kernel_axes=("embed", "mlp")))
    self.wo = DenseGeneral(intermediate_dim, emb_dim, dtype=dtype,
                           kernel_axes=("mlp", "embed"))

  def init_weights(self, generator):
    for name in self.wi_names:
      getattr(self, name).init_weights(generator)
    self.wo.init_weights(generator)

  def forward(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    h = None
    for name, act in zip(self.wi_names, self.activations):
      branch = _ACTIVATIONS[act](getattr(self, name)(x))
      h = branch if h is None else h * branch
    h = dropout(h, self.dropout_rate, generator, broadcast_dims=(-2,),
                model_dim=-1 if self.wo.split == 0 else None)
    return self.wo(h)


class MultiHeadAttention(nn.Module):
  """Multi-head attention with a split K/V projection.

  Call patterns:
    * `forward(q_in, kv_in, kv_mask=...)`: self- or cross-attention.
    * `project_kv(memory)` once, then `forward(q_in, cached_kv=kv, ...)`:
      cross-attention over a fixed memory (cached K/V are [b, h, l, d]).

  T5-style: no 1/sqrt(d) on the scores (it is in the query init), and a
  dropped key adds -1e10 to its score. Attention dropout keeps or drops a
  key for every query of a head at once (keep mask [b, h, kv], as the JAX
  layer draws it), so it is applied as a scale on the value rows, which
  equals dropping the normalized weights.
  """

  def __init__(self, emb_dim: int, num_heads: int, head_dim: int,
               out_features: int, *, dtype=torch.float32,
               dropout_rate: float = 0.0):
    super().__init__()
    self.num_heads, self.head_dim = num_heads, head_dim
    self.dropout_rate = dropout_rate
    proj = (num_heads, head_dim)
    heads_in, heads_out = ("embed", "joined_kv"), ("joined_kv", "embed")
    self.query = DenseGeneral(emb_dim, proj, dtype=dtype,
                              kernel_axes=heads_in)
    self.key = DenseGeneral(emb_dim, proj, dtype=dtype, kernel_axes=heads_in)
    self.value = DenseGeneral(emb_dim, proj, dtype=dtype,
                              kernel_axes=heads_in)
    self.out = DenseGeneral(proj, out_features, dtype=dtype,
                            kernel_axes=heads_out)

  def shard_(self, mesh: mesh_lib.Mesh, rules=mesh_lib.DEFAULT_RULES):
    """The local heads: the projections cut by `shard_module_` (this runs
    after them) hold num_heads / model heads each, or all of them where
    the heads do not divide."""
    del rules
    if self.query.mesh is not mesh:
      raise RuntimeError("shard the projections first (shard_module_)")
    self.num_heads = self.query.features[0]

  @property
  def heads_split(self) -> bool:
    return self.query.split == 1

  def init_weights(self, generator):
    self.query.init_weights(generator, scale=1.0 / math.sqrt(self.head_dim),
                            truncated=False)
    for dense in (self.key, self.value, self.out):
      dense.init_weights(generator, truncated=False)

  def project_kv(self, memory: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory [b, l, emb] -> (key, value), each [b, h, l, d] contiguous."""
    return attention.transpose_kv(self.key(memory), self.value(memory))

  def forward(self, inputs_q: torch.Tensor,
              inputs_kv: Optional[torch.Tensor] = None, *,
              cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_mask: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """kv_mask: optional bool [b, kv_len] keep-mask, constant over queries.
    generator: attention dropout's draws (None: no dropout)."""
    query = self.query(inputs_q)
    if cached_kv is not None:
      key, value = cached_kv  # [b, h, l, d]
    else:
      key, value = self.key(inputs_kv), self.value(inputs_kv)
    transposed = cached_kv is not None
    if generator is not None and self.dropout_rate > 0.0:
      batch, kv_len = value.shape[0], value.shape[2 if transposed else 1]
      keep = mesh_lib.rand(
          (batch, self.num_heads, kv_len), generator=generator,
          device=value.device,
          model_dim_=1 if self.heads_split else None) < 1.0 - self.dropout_rate
      scale = keep.to(value.dtype) / (1.0 - self.dropout_rate)
      value = value * (scale[..., None] if transposed
                       else scale.transpose(1, 2)[..., None])
    differentiate = torch.is_grad_enabled() and (
        query.requires_grad or key.requires_grad or value.requires_grad)
    attend = (attention.flash_attention_diff if differentiate
              else attention.flash_attention)
    x = attend(query, key, value, kv_mask=kv_mask, kv_transposed=transposed)
    return self.out(x)


def dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          kv_transposed: bool = False,
                          heads_split: bool = False) -> torch.Tensor:
  """Plain softmax attention (the JAX package's `dot_product_attention`):
  q [b, q, h, d], k and v [b, kv, h, d] ([b, h, kv, d] if `kv_transposed`),
  an additive bias broadcast to [b, h, q, kv]; out [b, q, h, d] in the
  query's dtype.

  Scores and softmax are float32 in every dtype; JAX's bf16 path rounds
  them to bf16 (a known deviation, stated in the tests). Dropout, with a
  generator and a positive rate, keeps or drops each key for every query
  of a head at once, as JAX draws it (`heads_split`: the heads are a
  shard of a model-split layer's, for the mask's global draw).
  """
  k_sub = "bhkd" if kv_transposed else "bkhd"
  weights = torch.einsum(f"bqhd,{k_sub}->bhqk", query.float(), key.float())
  if bias is not None:
    weights = weights + bias.float()
  weights = torch.softmax(weights, dim=-1)
  if generator is not None and dropout_rate > 0.0:
    b, h, _, k = weights.shape
    keep = mesh_lib.rand((b, h, 1, k), generator=generator,
                         device=weights.device,
                         model_dim_=1 if heads_split else None
                         ) < 1.0 - dropout_rate
    weights = weights * (keep.float() / (1.0 - dropout_rate))
  return torch.einsum(f"bhqk,{k_sub}->bqhd", weights,
                      value.float()).to(query.dtype)


class DecodeCacheAttention(MultiHeadAttention):
  """The autoregressive decoder's self-attention (JAX `DecodeCacheAttention`,
  the same parameters as `MultiHeadAttention`), in plain einsums.

  `forward` attends over the whole target under an additive bias (the
  teacher-forced pass, with the causal mask). `step` takes one frame
  [b, 1, emb] and the step's position `index` (int64 [1], on the cache's
  device), writes its key and value there in a `KVCache` of fixed length
  and attends over every position, those after `index` masked out: JAX's
  `cache_index` decode step, whose shapes do not change from step to step.
  """

  def forward(self, inputs: torch.Tensor, bias: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    x = dot_product_attention(
        self.query(inputs), self.key(inputs), self.value(inputs), bias,
        dropout_rate=self.dropout_rate, generator=generator,
        heads_split=self.heads_split)
    return self.out(x)

  def step(self, inputs: torch.Tensor, cache: "KVCache",
           index: torch.Tensor) -> torch.Tensor:
    cache.key.index_copy_(2, index, self.key(inputs).transpose(1, 2))
    cache.value.index_copy_(2, index, self.value(inputs).transpose(1, 2))
    bias = torch.where(cache.positions <= index, 0.0, -1e10)
    x = dot_product_attention(self.query(inputs), cache.key, cache.value,
                              bias, kv_transposed=True)
    return self.out(x)


class KVCache:
  """One decoder layer's self-attention cache: key and value, each
  [b, h, length, d], written one position a decode step, and the
  positions 0..length-1 (int64) that a step's mask compares with its
  index."""

  def __init__(self, batch: int, heads: int, length: int, head_dim: int, *,
               dtype, device):
    shape = (batch, heads, length, head_dim)
    self.key = torch.zeros(shape, dtype=dtype, device=device)
    self.value = torch.zeros(shape, dtype=dtype, device=device)
    self.positions = torch.arange(length, device=device)


class Embed(nn.Module):
  """Integer-id embedding table [num_embeddings, features]; a `fixed` table
  is never trained (JAX stops its gradient)."""

  def __init__(self, num_embeddings: int, features: int, *,
               dtype=torch.float32, fixed: bool = False):
    super().__init__()
    self.dtype = dtype
    self.embedding = nn.Parameter(torch.empty(num_embeddings, features),
                                  requires_grad=not fixed)
    self.mesh: Optional[mesh_lib.Mesh] = None
    self.split: Optional[int] = None

  def logical_axes(self):
    return {"embedding": ("vocab", "embed")}

  def param_splits(self, mesh: mesh_lib.Mesh, rules=mesh_lib.DEFAULT_RULES):
    if self.mesh is mesh:
      return {"embedding": self._spec}
    return {"embedding": mesh_lib.split_dims(
        ("vocab", "embed"), tuple(self.embedding.shape), mesh, rules)}

  def shard_(self, mesh: mesh_lib.Mesh, rules=mesh_lib.DEFAULT_RULES):
    """Keep this rank's rows of the table (if the vocab splits)."""
    spec = self.param_splits(mesh, rules)["embedding"]
    self.split = mesh_lib.model_dim(spec, mesh)
    if self.split is not None:
      with torch.no_grad():
        self.embedding = nn.Parameter(
            mesh.shard(self.embedding.data, "model", 0),
            requires_grad=self.embedding.requires_grad)
    self.mesh, self._spec = mesh, spec

  def forward(self, ids: torch.Tensor) -> torch.Tensor:
    if ids.dtype.is_floating_point:
      raise ValueError("Embed inputs must be integers.")
    if self.split is None:
      return F.embedding(ids.long(), self.embedding).to(self.dtype)
    # This rank's rows looked up, the others zero, summed over the group.
    rows = self.embedding.shape[0]
    local = ids.long() - self.mesh.model_index * rows
    inside = (local >= 0) & (local < rows)
    found = F.embedding(local.clamp(0, rows - 1), self.embedding)
    found = torch.where(inside[..., None], found, found.new_zeros(()))
    return mesh_lib.reduce_from_model(found, self.mesh).to(self.dtype)


class FixedEmbed(nn.Module):
  """A fixed sinusoidal table (position ids -> rows), never trained.

  As in Flax, where the table is computed and is no parameter, it is a
  buffer that no state_dict carries. `step(index)` is the decode
  position: the row of the single-frame decode step at `index` (int64 [1]
  on the table's device; JAX counts the steps in its decode cache,
  starting at uint32 max so that the cache-init pass takes one; the
  port's caller holds the count).
  """

  def __init__(self, features: int, max_length: int = 2048):
    super().__init__()
    self.register_buffer("embedding", sinusoidal_table(max_length, features),
                         persistent=False)

  def forward(self, ids: torch.Tensor) -> torch.Tensor:
    if ids.dtype.is_floating_point:
      raise ValueError("FixedEmbed inputs must be integers.")
    return F.embedding(ids.long(), self.embedding)

  def step(self, index: torch.Tensor) -> torch.Tensor:
    """Row `index` as [1, features]."""
    return self.embedding.index_select(0, index)


class RMSNorm(nn.Module):
  """T5 layer norm: rms only, no mean subtraction, no bias; f32 inside."""

  def __init__(self, features: int, *, epsilon: float = 1e-6,
               dtype=torch.float32):
    super().__init__()
    self.epsilon, self.dtype = epsilon, dtype
    self.scale = nn.Parameter(torch.ones(features))

  def logical_axes(self):
    return {"scale": ("embed",)}

  def param_splits(self, mesh: mesh_lib.Mesh, rules=mesh_lib.DEFAULT_RULES):
    return {"scale": mesh_lib.split_dims(("embed",), tuple(self.scale.shape),
                                         mesh, rules)}

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mean2 = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(mean2 + self.epsilon)).to(self.dtype)
    return y * self.scale.to(self.dtype)


class FiLM(nn.Module):
  """Feature-wise linear modulation: x * (scale + 1) + bias."""

  def __init__(self, cond_dim: int, features: int, *, dtype=torch.float32):
    super().__init__()
    self.dense = DenseGeneral(cond_dim, 2 * features, dtype=dtype,
                              kernel_axes=("vocab", "embed"))

  def init_weights(self, generator):
    self.dense.init_weights(generator)

  def forward(self, x: torch.Tensor,
              conditioning: torch.Tensor) -> torch.Tensor:
    scale, bias = torch.chunk(self.dense(conditioning), 2, dim=-1)
    return x * (scale + 1.0) + bias


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  """0/1 mask -> additive attention bias (0 or -1e10)."""
  return torch.where(mask > 0, torch.zeros((), dtype=dtype),
                     torch.full((), -1e10, dtype=dtype))


def make_attention_mask(query_input: torch.Tensor, key_input: torch.Tensor,
                        pairwise_fn=torch.mul,
                        dtype=torch.float32) -> torch.Tensor:
  """[b, len_q] x [b, len_kv] -> [b, 1, len_q, len_kv] mask."""
  mask = pairwise_fn(query_input[..., :, None], key_input[..., None, :])
  return mask[..., None, :, :].to(dtype)


def combine_masks(*masks: Optional[torch.Tensor],
                  dtype=torch.float32) -> Optional[torch.Tensor]:
  """Logical AND of the given masks (None entries skipped)."""
  masks = [m for m in masks if m is not None]
  if not masks:
    return None
  mask = masks[0] > 0
  for other in masks[1:]:
    mask = torch.logical_and(mask, other > 0)
  return mask.to(dtype)


def make_causal_mask(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  """[b, len] -> [b, 1, len, len], 1 where the key is at or before the
  query."""
  idxs = torch.arange(x.shape[-1], device=x.device).expand(x.shape)
  return make_attention_mask(idxs, idxs, torch.greater_equal, dtype=dtype)


def combine_biases(*biases: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
  """The sum of the given biases (None entries skipped)."""
  biases = [b for b in biases if b is not None]
  if not biases:
    return None
  out = biases[0]
  for other in biases[1:]:
    out = out + other
  return out


def make_decoder_mask(decoder_target_tokens: torch.Tensor, dtype,
                      decoder_causal_attention: Optional[torch.Tensor] = None,
                      decoder_segment_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
  """Causal and padding (and optional prefix-LM and packing) decoder
  self-attention mask [b, 1, len, len]."""
  causal = make_causal_mask(decoder_target_tokens, dtype=dtype)
  if decoder_causal_attention is not None:
    inputs_mask = make_attention_mask(
        decoder_causal_attention, decoder_causal_attention,
        torch.logical_and, dtype=dtype)
    causal = torch.logical_or(causal > 0, inputs_mask > 0).to(dtype)
  valid = decoder_target_tokens > 0
  masks = [causal, make_attention_mask(valid, valid, dtype=dtype)]
  if decoder_segment_ids is not None:
    masks.append(make_attention_mask(decoder_segment_ids, decoder_segment_ids,
                                     torch.eq, dtype=dtype))
  return combine_masks(*masks, dtype=dtype)


def zero_if_all_masked(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  """Zero y where the whole [b, kv] keep-mask row is 0.

  With every key masked the softmax averages all keys evenly, which looks
  like nothing masked; this makes all-masked cross-attention (the CFG
  unconditional rows, the empty first-segment context) exactly zero.
  """
  is_not_empty = torch.any(mask == 1, dim=-1)[:, None, None]
  return y * is_not_empty.to(y.dtype)
