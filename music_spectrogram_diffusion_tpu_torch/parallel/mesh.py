"""A ('data', 'model') mesh over torch.distributed ranks, and the sharding
rules of the parameters.

Port of music_spectrogram_diffusion_tpu/parallel/mesh.py. JAX names each
parameter's axes (Flax `param_with_axes`) and lets GSPMD insert the
collectives; here every layer of `models/layers.py` states the same
logical axes (`DenseGeneral(kernel_axes=...)`, `Embed`: ('vocab',
'embed'), `RMSNorm`: ('embed',)), `DEFAULT_RULES` maps them onto the mesh
as JAX's table does, and the layers run their own shard with the
collectives written out (`shard_module_`, and the layers' forwards).

Ranks form a grid of `data` rows and `model` columns, rank
= d * model + m (JAX's `devices.reshape(data, model)`). The batch splits
over 'data'; the MLP hidden, the attention heads and the vocab rows over
'model'. Each rank belongs to one model group (its row: the ranks that
hold one batch shard and split the weights) and one data group (its
column: the ranks that hold the same weight shard; their gradients are
summed). The groups are explicit `torch.distributed.new_group`s, which
also serve two ranks that share one card over gloo.

The collectives are sums (`all_reduce`) and nothing else: gloo takes only
all_reduce and broadcast on CUDA tensors, so a gather is an all_reduce of
zero-padded shards. Without `torch.distributed.init_process_group` the
mesh is the 1x1 mesh, whose collectives are identities.

A dimension whose size does not divide its shard count is replicated, as
JAX's attention partitioner does (ops/attention.py:516-519); a flattened
dimension ((heads, head_dim) of an attention projection) splits only
along its leading axis, so that shards hold whole heads.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# logical axis -> mesh axis (None = replicated): the JAX package's table.
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "data"),
    ("length", None),
    ("embed", None),
    ("mlp", "model"),
    ("heads", "model"),
    ("kv", None),
    ("joined_kv", "model"),
    ("vocab", "model"),
)

# The logical axes whose activations stay split between the two layers of
# a block (the MLP hidden between wi and wo, the heads between the q/k/v
# projections and the output projection). An output split on another axis
# ('vocab': an output projection) is gathered; a split input on another
# axis is a replicated activation sliced to the shard.
SPLIT_ACTIVATIONS = ("mlp", "joined_kv", "heads")

# (name, logical axes per dim) of a module's parameters.
Spec = Tuple[Optional[str], ...]


class Mesh:
  """This rank's place on a ('data', 'model') grid and its two groups.

  `with mesh:` makes it the mesh the layers draw dropout on
  (`current`, `rand`), as JAX's `with mesh:`.
  """

  def __init__(self, data: int, model: int, rank: int = 0,
               data_group=None, model_group=None):
    self.data, self.model, self.rank = data, model, rank
    self._groups = {"data": data_group, "model": model_group}
    self._outer: List[Optional["Mesh"]] = []

  @property
  def shape(self) -> Dict[str, int]:
    return {"data": self.data, "model": self.model}

  @property
  def size(self) -> int:
    return self.data * self.model

  @property
  def data_index(self) -> int:
    return self.rank // self.model

  @property
  def model_index(self) -> int:
    return self.rank % self.model

  def axis_index(self, axis: str) -> int:
    return self.data_index if axis == "data" else self.model_index

  def __repr__(self):
    return f"Mesh({self.data}x{self.model}, rank {self.rank})"

  def all_reduce_(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum `tensor` in place over the ranks of `axis` ('data': this rank's
    data group, 'model': its model group); an identity on an axis of 1."""
    if self.shape[axis] > 1:
      dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self._groups[axis])
    return tensor

  def gather(self, tensor: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The shards of `axis` concatenated along `dim`, every shard of one
    size, bit for bit: an all_reduce of zero-padded shards, summed as
    integers of the elements' width (so -0.0 and NaN payloads survive;
    16-bit ones widened to 32, which gloo sums)."""
    n = self.shape[axis]
    if n == 1:
      return tensor
    dim = dim % tensor.ndim
    bits = (tensor.view(_INT_OF_WIDTH[tensor.element_size()])
            if tensor.is_floating_point() else tensor)
    wide = bits.to(torch.int32) if bits.dtype == torch.int16 else bits
    shape = list(tensor.shape)
    width = shape[dim]
    shape[dim] = width * n
    full = wide.new_zeros(shape)
    full.narrow(dim, self.axis_index(axis) * width, width).copy_(wide)
    self.all_reduce_(full, axis)
    if wide is not bits:
      full = full.to(bits.dtype)
    return full.view(tensor.dtype)

  def shard(self, tensor: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's shard of `tensor` along `dim` (a contiguous copy)."""
    n = self.shape[axis]
    if n == 1:
      return tensor
    width = tensor.shape[dim] // n
    return tensor.narrow(dim, self.axis_index(axis) * width,
                         width).contiguous()

  def __enter__(self) -> "Mesh":
    self._outer.append(current())
    _active.mesh = self
    return self

  def __exit__(self, *exc) -> None:
    _active.mesh = self._outer.pop()


_active = threading.local()
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def current() -> Optional[Mesh]:
  """The mesh of the innermost `with mesh:` block, or None."""
  return getattr(_active, "mesh", None)


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
  """A ('data', 'model') mesh over `ranks` (default: every rank of the
  process group; the 1x1 mesh without one). `data` defaults to
  len(ranks) // model; data x model must equal len(ranks), else
  ValueError, as JAX's make_mesh. Every rank of the process group calls
  it (each group is made by all of them)."""
  if ranks is None:
    ranks = (list(range(dist.get_world_size())) if dist.is_initialized()
             else [0])
  ranks = list(ranks)
  if data is None:
    data = len(ranks) // model
  if data * model != len(ranks):
    raise ValueError(f"mesh {data}x{model} != {len(ranks)} devices")
  if not dist.is_initialized():
    return Mesh(data, model)
  me = dist.get_rank()
  if me not in ranks:
    raise ValueError(f"rank {me} is not one of the mesh's ranks {ranks}")
  grid = [ranks[d * model:(d + 1) * model] for d in range(data)]
  data_group = model_group = None
  # Every rank makes every group, in the same order.
  for m in range(model):
    members = [row[m] for row in grid]
    group = dist.new_group(members) if data > 1 else None
    if me in members:
      data_group = group
  for row in grid:
    group = dist.new_group(row) if model > 1 else None
    if me in row:
      model_group = group
  return Mesh(data, model, ranks.index(me), data_group, model_group)


def parse_mesh(spec: str) -> Tuple[int, int]:
  """'DATAxMODEL' (e.g. '4x2') -> (data, model)."""
  try:
    data, model = (int(v) for v in spec.lower().split("x"))
  except ValueError:
    raise ValueError(f"--mesh {spec!r}: want DATAxMODEL, e.g. 4x2") from None
  if data < 1 or model < 1:
    raise ValueError(f"--mesh {spec!r}: both sizes must be at least 1")
  return data, model


# ---------------------------------------------------------------------------
# The parameters' logical axes and their split on a mesh.
# ---------------------------------------------------------------------------


def param_logical_specs(module: torch.nn.Module) -> Dict[str, Spec]:
  """Each parameter's logical axes, by state_dict name, as the layers
  state them (`logical_axes()`), JAX's `params_axes` collection. A
  parameter of a module that states none raises."""
  specs: Dict[str, Spec] = {}
  for prefix, sub in module.named_modules():
    own = dict(sub.named_parameters(recurse=False))
    if not own:
      continue
    if not hasattr(sub, "logical_axes"):
      raise TypeError(f"{prefix or type(module).__name__} "
                      f"({type(sub).__name__}) states no logical axes")
    for name, axes in sub.logical_axes().items():
      if name in own:
        specs[f"{prefix}.{name}" if prefix else name] = tuple(axes)
  return specs


def split_dims(axes: Spec, groups: Sequence[int], mesh: Mesh,
               rules=DEFAULT_RULES) -> Tuple[Optional[str], ...]:
  """The mesh axis each dim splits on (None: replicated). `groups[i]` is
  the size dim i's split must divide: the dim's size, or for a flattened
  dim its leading axis."""
  rule_map = dict(rules)
  out = []
  for axis, size in zip(axes, groups):
    mesh_axis = rule_map.get(axis) if axis is not None else None
    if mesh_axis is not None and size % mesh.shape[mesh_axis]:
      mesh_axis = None
    out.append(mesh_axis)
  return tuple(out)


def param_shardings(module: torch.nn.Module, mesh: Mesh,
                    rules=DEFAULT_RULES) -> Dict[str, Tuple[Optional[str],
                                                            ...]]:
  """Each parameter's split, by state_dict name: the mesh axis of each
  dim (None: replicated), JAX's PartitionSpec of `param_shardings`, for
  the module as built (its full, unsharded shapes). Int8 kernels keep
  their float kernel's split and each kernel_scale follows its kernel's
  N (JAX's `quantized_param_shardings`)."""
  out = {}
  for prefix, sub in module.named_modules():
    if not hasattr(sub, "param_splits"):
      continue
    for name, spec in sub.param_splits(mesh, rules).items():
      out[f"{prefix}.{name}" if prefix else name] = spec
  return out


def model_dim(spec: Sequence[Optional[str]], mesh: Mesh) -> Optional[int]:
  """The dim a spec cuts over `mesh`'s model group (None if it does not,
  or if the group is one rank: a split over one is no split)."""
  dims = [i for i, axis in enumerate(spec) if axis == "model"]
  if len(dims) > 1:
    raise ValueError(f"spec {spec} splits 'model' twice")
  return dims[0] if dims and mesh.model > 1 else None


def shard_module_(module: torch.nn.Module, mesh: Mesh,
                  rules=DEFAULT_RULES) -> torch.nn.Module:
  """Cut `module`'s parameters (float or int8) to this rank's shards, in
  place, and make its layers run the shard with the collectives over
  `mesh`'s model group. Sharding a module twice on one mesh changes
  nothing; on another mesh it raises."""
  done = getattr(module, "_msd_mesh", None)
  if done is not None:
    if done is not mesh:
      raise ValueError(f"module is sharded on {done} already, not {mesh}")
    return module
  # Children first: an attention layer reads its projections' shards.
  for sub in reversed(list(module.modules())):
    if hasattr(sub, "shard_"):
      sub.shard_(mesh, rules)
  module._msd_mesh = mesh
  return module


def module_mesh(module: torch.nn.Module) -> Optional[Mesh]:
  """The mesh `shard_module_` cut `module` for (None: not sharded)."""
  return getattr(module, "_msd_mesh", None)


def splits_model(module: torch.nn.Module) -> bool:
  """Whether `module` is cut over more than one rank of a model group
  (its forward then runs collectives)."""
  mesh = module_mesh(module)
  return mesh is not None and mesh.model > 1


def shard_pytree(tree: Mapping[str, torch.Tensor],
                 shardings: Mapping[str, Sequence[Optional[str]]],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
  """This rank's shard of each full tensor of `tree` (name -> tensor),
  split as `shardings` says; a name it lacks is replicated."""
  out = {}
  for name, tensor in tree.items():
    spec = shardings.get(name, ())
    for dim, axis in enumerate(spec):
      if axis is not None:
        tensor = mesh.shard(tensor, axis, dim)
    out[name] = tensor
  return out


def gather_pytree(tree: Mapping[str, torch.Tensor],
                  shardings: Mapping[str, Sequence[Optional[str]]],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
  """The inverse of `shard_pytree`: the full tensors, on every rank (a
  collective: every rank of the mesh calls it)."""
  out = {}
  for name, tensor in tree.items():
    spec = shardings.get(name, ())
    for dim, axis in enumerate(spec):
      if axis is not None:
        tensor = mesh.gather(tensor, axis, dim)
    out[name] = tensor
  return out


def batch_sharding(mesh: Mesh) -> Tuple[Optional[str], ...]:
  """The batch's split: its leading dim over 'data'."""
  del mesh
  return ("data",)


def replicated(mesh: Mesh) -> Tuple[Optional[str], ...]:
  del mesh
  return ()


# ---------------------------------------------------------------------------
# Collectives inside autograd (the four conjugate pairs of tensor
# parallelism: identity forward and sum backward, and so on).
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
  """Identity forward; the gradient summed over the model group (a
  replicated activation entering split work)."""

  @staticmethod
  def forward(ctx, x, mesh):
    ctx.mesh = mesh
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    return ctx.mesh.all_reduce_(grad.contiguous().clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
  """Sum over the model group forward (partial products); the gradient
  passes as it is."""

  @staticmethod
  def forward(ctx, x, mesh):
    return mesh.all_reduce_(x.contiguous().clone(), "model")

  @staticmethod
  def backward(ctx, grad):
    return grad, None


class _GatherFromModel(torch.autograd.Function):
  """The model group's shards concatenated along the last dim; the
  gradient is this rank's slice."""

  @staticmethod
  def forward(ctx, x, mesh):
    ctx.mesh, ctx.width = mesh, x.shape[-1]
    return mesh.gather(x.contiguous(), "model", -1)

  @staticmethod
  def backward(ctx, grad):
    return grad.narrow(-1, ctx.mesh.model_index * ctx.width,
                       ctx.width), None


def _differentiable(x: torch.Tensor) -> bool:
  return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  if mesh.model == 1 or not _differentiable(x):
    return x
  return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  if mesh.model == 1:
    return x
  if not _differentiable(x):
    return mesh.all_reduce_(x.contiguous().clone(), "model")
  return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  if mesh.model == 1:
    return x
  if not _differentiable(x):
    return mesh.gather(x.contiguous(), "model", -1)
  return _GatherFromModel.apply(x, mesh)


# ---------------------------------------------------------------------------
# Draws at the global shape.
# ---------------------------------------------------------------------------


def rand(shape: Sequence[int], *, generator: torch.Generator, device,
         model_dim_: Optional[int] = None) -> torch.Tensor:
  """torch.rand(shape) as the unsharded run draws it: under `with mesh:`
  the draw is made at the global shape (dim 0 times 'data', and
  `model_dim_`, the dim of a model-split activation, times 'model') and
  this rank keeps its block. Every rank draws the same numbers, so a
  replicated activation takes the same mask on every rank of its model
  group and the generator advances as in the unsharded run."""
  mesh = current()
  full = list(shape)
  index = [slice(None)] * len(full)
  if mesh is not None:
    for dim, axis in ((0, "data"), (model_dim_, "model")):
      if dim is None or mesh.shape[axis] == 1:
        continue
      dim %= len(full)
      width = full[dim]
      full[dim] = width * mesh.shape[axis]
      start = mesh.axis_index(axis) * width
      index[dim] = slice(start, start + width)
  return torch.rand(full, generator=generator, device=device)[tuple(index)]


def rows(mesh: Mesh, local_rows: int) -> slice:
  """This rank's rows of a batch split over 'data' into `local_rows`."""
  start = mesh.data_index * local_rows
  return slice(start, start + local_rows)


def global_draws(draws, mesh: Mesh):
  """A draws provider `draws(x0, *args) -> tuple of [batch, ...]` (the
  diffusion and distillation steps') made at the global batch's shape,
  this rank keeping its rows."""
  if mesh.data == 1:
    return draws

  def draw(x0, *args):
    full = x0.new_empty((x0.shape[0] * mesh.data,) + tuple(x0.shape[1:]))
    return tuple(t[rows(mesh, x0.shape[0])] for t in draws(full, *args))
  return draw


def global_noise(noise, mesh: Mesh):
  """A sampler noise provider `noise(i, shape)` drawn at the global batch's
  shape, this rank keeping its rows."""
  if mesh.data == 1:
    return noise

  def draw(i, shape):
    full = (shape[0] * mesh.data,) + tuple(shape[1:])
    return noise(i, full)[rows(mesh, shape[0])]
  return draw


