"""The train step: Adafactor written out by hand, the warmup-constant LR,
MultiSteps accumulation, and one step of a model of any family (context or
notes-only diffusion, autoregressive, or a distillation round); and AdamW,
written out as optax computes it, for the trainers that use it (the
vocoders', the transcriber's).

Port of music_spectrogram_diffusion_tpu/train/trainer.py. The JAX package
trains with
`optax.adafactor(decay_rate=0.8, decay_offset=0,
multiply_by_parameter_scale=True, clipping_threshold=1.0)` under a
warmup-constant LR and, with microbatches, `optax.MultiSteps`. `Adafactor`
and `MultiSteps` below compute what those do, step for step;
`torch.optim.Adafactor` is another algorithm (its defaults differ).

Parameters live in the model's module, in float32 whatever the
experiment's compute dtype (bfloat16 training casts them where they are
used, as Flax's param_dtype); the optimizer works on a dict of its
trainable parameters by name. A step's randomness (the diffusion draws and
dropout; the autoregressive loss takes no draws) is seeded from (seed,
step), as JAX folds the step into its key,
so a resumed run reproduces the steps it continues. A model states
whether its loss takes draws (`takes_draws`); one that does makes them
from the step's generator with its `draws(generator)`, as JAX's
`aux_params` models take their frozen tree and the step's key. (The
distillation model holds its frozen teacher as a module of its own, so
`Trainer.params` are the student's only.) `Trainer.eval_step` is JAX's
deterministic eval pass.

`Trainer(mesh=)` trains on a ('data', 'model') mesh
(`parallel/mesh.py`), as JAX's Trainer: the module is cut to this rank's
shards (`shard_module_`), each rank takes its rows of the global batch
(`shard_batch`, or its own rows fed by `parallel.multihost`), and the
step's draws and dropout masks are drawn at the global batch's shape, each
rank keeping its rows. The loss is a sum over the global batch (JAX's
`sum(loss * mask)`), so the gradients are SUMMED over the data group (a
mean would divide them by its size), as are `loss`, `n_frames` and
`n_seqs` before `loss_per_frame`. Adafactor's means (the factored second
moments, their row mean, the update's and the parameter's RMS) and
`grad_norm` are taken over the whole parameter, with sums over the model
group for a split one, and the optimizer state is split with its
parameter; so the sharded step is the one-device step, in other summation
orders.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib

Tensors = Dict[str, torch.Tensor]


def warmup_constant_schedule(learning_rate: float,
                             warmup_steps: int) -> Callable[[int], float]:
  """Linear warmup to a constant LR, in float32 as the JAX schedule."""
  def schedule(step: int) -> float:
    frac = np.float32(step + 1) / np.float32(max(1, warmup_steps))
    return float(np.float32(learning_rate) * min(np.float32(1.0), frac))
  return schedule


# What the JAX trainer fixes (optax.adafactor's defaults there, with
# decay_offset=0 and clipping_threshold=1.0).
MIN_DIM_SIZE_TO_FACTOR = 128
CLIPPING_THRESHOLD = 1.0
EPS = 1e-30
MIN_SCALE = 1e-3


@dataclasses.dataclass
class ParamLayout:
  """How the trained parameters lie on a mesh: the dim each is split on
  over the model group (None: replicated) and its full shape. The
  optimizer's means over a split dim are sums over the group."""
  mesh: mesh_lib.Mesh
  splits: Dict[str, Optional[int]]
  full_shapes: Dict[str, Tuple[int, ...]]

  def mean(self, x: torch.Tensor, name: str, dim: Optional[int] = None,
           *, param_dim: Optional[int] = None,
           keepdim: bool = False) -> torch.Tensor:
    """The mean of x, a tensor of parameter `name`'s (or of its reduced
    second moment's) layout, over its `dim` (param_dim: that dim's index
    in the parameter), or over every element with dim None, as the full
    parameter's."""
    split = self.splits.get(name)
    whole = dim is None
    if split is None or (not whole and split != param_dim):
      return x.mean() if whole else x.mean(dim, keepdim=keepdim)
    full = self.full_shapes[name]
    total = x.sum() if whole else x.sum(dim, keepdim=keepdim)
    count = int(np.prod(full)) if whole else full[param_dim]
    return self.mesh.all_reduce_(total, "model") / count


def factored_dims(shape) -> Optional[Tuple[int, int]]:
  """optax's choice: factor the two largest axes when the second largest
  has at least MIN_DIM_SIZE_TO_FACTOR entries; returns (d1, d0), the
  second largest axis and the largest, or None."""
  if len(shape) < 2:
    return None
  sorted_dims = np.argsort(shape)
  if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
    return None
  return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor:
  """optax.adafactor(learning_rate, decay_rate, decay_offset=0,
  multiply_by_parameter_scale=True, clipping_threshold=1.0, eps=1e-30).

  Per parameter: factored second moments (a row and a column mean of
  g^2 + EPS) where `factored_dims` says so, else a full one, decayed with
  1 - (t + 1)^-decay_rate; the update g / sqrt(v) clipped to an RMS of
  CLIPPING_THRESHOLD, times the learning rate, times the parameter's RMS
  (at least MIN_SCALE); then subtracted.
  """

  def __init__(self, learning_rate: Callable[[int], float],
               decay_rate: float = 0.8,
               layout: Optional[ParamLayout] = None):
    self.learning_rate, self.decay_rate = learning_rate, decay_rate
    # Set for a sharded model: the means are then the full parameters'.
    self.layout = layout

  def _full_shape(self, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    if self.layout is None:
      return tuple(p.shape)
    return self.layout.full_shapes[name]

  def _mean(self, x, name, dim=None, *, param_dim=None, keepdim=False):
    if self.layout is None:
      return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    return self.layout.mean(x, name, dim, param_dim=param_dim,
                            keepdim=keepdim)

  def init(self, params: Tensors) -> Dict[str, Any]:
    v_row, v_col, v = {}, {}, {}
    for name, p in params.items():
      dims = factored_dims(self._full_shape(name, p))
      if dims is None:
        v[name] = torch.zeros_like(p)
      else:
        d1, d0 = dims
        shape = list(p.shape)
        v_row[name] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
        v_col[name] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
    return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

  @torch.no_grad()
  def update(self, grads: Tensors, state: Dict[str, Any],
             params: Tensors) -> Tuple[Tensors, Dict[str, Any]]:
    """The updates to add to `params`, and the new state."""
    count = state["count"]
    t = torch.tensor(float(count + 1))
    decay = float(1.0 - t ** (-self.decay_rate))
    lr = self.learning_rate(count)
    new = {"count": count + 1, "v_row": {}, "v_col": {}, "v": {}}
    updates = {}
    for name, g in grads.items():
      dims = factored_dims(self._full_shape(name, g))
      g_sqr = g * g + EPS
      if dims is not None:
        d1, d0 = dims
        v_row = decay * state["v_row"][name] + (1.0 - decay) * self._mean(
            g_sqr, name, d0, param_dim=d0)
        v_col = decay * state["v_col"][name] + (1.0 - decay) * self._mean(
            g_sqr, name, d1, param_dim=d1)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = self._mean(v_row, name, reduced_d1, param_dim=d1,
                                  keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        new["v_row"][name], new["v_col"][name] = v_row, v_col
      else:
        v = decay * state["v"][name] + (1.0 - decay) * g_sqr
        u = g * v ** -0.5
        new["v"][name] = v
      clip = torch.clamp(torch.sqrt(self._mean(u * u, name))
                         / CLIPPING_THRESHOLD, min=1.0)
      u = (u / clip) * lr
      p = params[name]
      u = u * torch.clamp(torch.sqrt(self._mean(p * p, name)), min=MIN_SCALE)
      updates[name] = -u
    return updates, new


class MultiSteps:
  """optax.MultiSteps(opt, every_k_schedule=k): the mean gradient of k
  consecutive steps (a running mean, as optax keeps it) goes to the inner
  optimizer on every k-th step; the other steps change nothing."""

  def __init__(self, inner: Adafactor, every_k: int):
    self.inner, self.every_k = inner, every_k

  def init(self, params: Tensors) -> Dict[str, Any]:
    return {"mini_step": 0, "gradient_step": 0,
            "inner": self.inner.init(params),
            "acc_grads": {n: torch.zeros_like(p) for n, p in params.items()}}

  @torch.no_grad()
  def update(self, grads: Tensors, state: Dict[str, Any], params: Tensors
             ) -> Tuple[Optional[Tensors], Dict[str, Any]]:
    """(updates or None on an accumulating step, the new state)."""
    n = state["mini_step"]
    acc = {name: a + (grads[name] - a) / (n + 1)
           for name, a in state["acc_grads"].items()}
    if n < self.every_k - 1:
      return None, dict(state, mini_step=n + 1, acc_grads=acc)
    updates, inner = self.inner.update(acc, state["inner"], params)
    return updates, {"mini_step": 0,
                     "gradient_step": state["gradient_step"] + 1,
                     "inner": inner,
                     "acc_grads": {k: torch.zeros_like(a)
                                   for k, a in acc.items()}}


class AdamW:
  """optax.adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
  weight_decay): Adam's bias-corrected moments, the decayed weight added
  to the update, then the update times -learning_rate(count), count
  starting at 0; every parameter decays (optax's mask None).
  `torch.optim.AdamW` is another algorithm here (weight decay 1e-2 by
  default, applied before the Adam step)."""

  def __init__(self, learning_rate: Callable[[int], float],
               weight_decay: float = 1e-4, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8):
    self.learning_rate, self.weight_decay = learning_rate, weight_decay
    self.b1, self.b2, self.eps = b1, b2, eps

  def init(self, params: Tensors) -> Dict[str, Any]:
    return {"count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

  @torch.no_grad()
  def step_(self, params: Tensors, grads: Tensors,
            state: Dict[str, Any]) -> Dict[str, Any]:
    """Update `params` in place; returns the new state."""
    count = state["count"]
    t = count + 1
    c1 = 1.0 - float(np.float32(self.b1) ** np.float32(t))
    c2 = 1.0 - float(np.float32(self.b2) ** np.float32(t))
    lr = self.learning_rate(count)
    new = {"count": t, "mu": {}, "nu": {}}
    for name, p in params.items():
      g = grads[name]
      mu = (1.0 - self.b1) * g + self.b1 * state["mu"][name]
      nu = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][name]
      update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
      update = update + self.weight_decay * p
      p.add_(update * -lr)
      new["mu"][name], new["nu"][name] = mu, nu
    return new


def constant_schedule(learning_rate: float) -> Callable[[int], float]:
  """optax's constant learning rate (a float given to optax.adamw)."""
  return lambda count: learning_rate


def make_optimizer(train_cfg: cfg_lib.TrainConfig,
                   layout: Optional[ParamLayout] = None):
  """Adafactor as the JAX trainer configures it (and MultiSteps with
  microbatches); `layout` for a sharded model."""
  tx = Adafactor(warmup_constant_schedule(train_cfg.learning_rate,
                                          train_cfg.warmup_steps),
                 decay_rate=train_cfg.adafactor_decay_rate, layout=layout)
  if train_cfg.num_microbatches > 1:
    return MultiSteps(tx, train_cfg.num_microbatches)
  return tx


def build_model(experiment: cfg_lib.ExperimentConfig, *, seed: int = 0,
                device="cuda") -> inference.Model:
  """The model to train, of the experiment's family, with random weights
  from `seed`, on `device` (which must exist: 'cuda' without a card
  raises).

  It computes in the experiment's dtype ('float32' or 'bfloat16') with
  float32 parameters, and rematerializes every layer when
  `experiment.remat` (e.g. `dataclasses.replace(experiment,
  dtype="bfloat16", remat=True)`)."""
  dev = inference.resolve_device(device)
  module = inference.network(experiment)
  return inference.wrap(experiment, module.to(dev).train()).init(seed)


# The eval pass's draws (eps, time, the condition drop): one fixed
# generator seed, so every eval of a batch sees the same draws.
EVAL_DRAWS_SEED = 0


@dataclasses.dataclass
class TrainState:
  """The step count and the optimizer state; the parameters are the
  model's."""
  step: int
  opt_state: Dict[str, Any]


def step_generators(seed: int, step: int, device
                    ) -> Tuple[torch.Generator, torch.Generator]:
  """(the diffusion draws', dropout's) generators of one step, seeded from
  (seed, step) only."""
  return tuple(torch.Generator(device=device).manual_seed(
      core._mix_seed(seed, step, stream)) for stream in (0, 1))


def batch_to_device(batch: Mapping[str, Any], device) -> Tensors:
  """numpy arrays (or tensors) -> tensors on `device`."""
  return {k: (v.to(device) if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v), device=device))
          for k, v in batch.items()}


# Summed over the data group; the other scalar metrics are means over
# rows, averaged over it; loss_per_frame is made anew from the sums.
SUMMED_METRICS = ("loss", "n_frames", "n_seqs")


def _walk_state(tree, fn, path=()):
  """`tree` (an optimizer state: nested dicts, tensor leaves keyed by
  parameter name) with fn(path, tensor) applied to each tensor."""
  if isinstance(tree, torch.Tensor):
    return fn(path, tree)
  if isinstance(tree, dict):
    return {k: _walk_state(v, fn, path + (k,)) for k, v in tree.items()}
  return tree


class Trainer:
  """One model's train step, on one device or on a mesh.

  Usage:
    trainer = Trainer(model, experiment.train[, mesh=mesh])
    state = trainer.create_state()
    state, metrics = trainer.train_step(state, trainer.shard_batch(batch),
                                        seed)

  With a mesh, `train_step` takes this rank's rows of the global batch
  (`shard_batch` cuts them from the global batch; a multi-process run
  feeds each process its rows, `parallel.multihost`), and its metrics are
  the global batch's.
  """

  def __init__(self, model: inference.Model,
               train_cfg: cfg_lib.TrainConfig,
               mesh: Optional[mesh_lib.Mesh] = None):
    self.model = model
    # The diffusion and distillation losses take the step's draws; the
    # autoregressive one takes none (JAX's trainer calls either signature).
    self.takes_draws = model.takes_draws
    self.train_cfg = train_cfg
    self.mesh = mesh
    layout = None
    if mesh is not None:
      mesh_lib.shard_module_(model.module, mesh)
      self.shardings = mesh_lib.param_shardings(model.module, mesh)
    self.params: Tensors = {n: p for n, p in model.module.named_parameters()
                            if p.requires_grad}
    if mesh is not None:
      splits = {n: mesh_lib.model_dim(self.shardings[n], mesh)
                for n in self.params}
      full = {}
      for n, p in self.params.items():
        shape = list(p.shape)
        if splits[n] is not None:
          shape[splits[n]] *= mesh.model
        full[n] = tuple(shape)
      layout = ParamLayout(mesh, splits, full)
    self.layout = layout
    self.optimizer = make_optimizer(train_cfg, layout)

  @property
  def device(self) -> torch.device:
    return self.model.device

  def create_state(self) -> TrainState:
    return TrainState(step=0, opt_state=self.optimizer.init(self.params))

  def shard_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (every rank passes the same);
    a batch that does not divide over 'data' raises, as JAX's. Without a
    mesh, the batch."""
    if self.mesh is None:
      return dict(batch)
    size = len(next(iter(batch.values())))
    if size % self.mesh.data:
      raise ValueError(
          f"global batch size {size} is not divisible by the data mesh "
          f"axis ({self.mesh.data} devices)")
    rows = mesh_lib.rows(self.mesh, size // self.mesh.data)
    return {k: v[rows] for k, v in batch.items()}

  def loss_and_grads(self, batch: Tensors, draws: dops.DrawsFn,
                     dropout_generator: Optional[torch.Generator]
                     ) -> Tuple[Dict[str, torch.Tensor], Tensors]:
    """(metrics, gradients by parameter name) of one batch; a parameter
    the loss does not reach gets a zero gradient, as in JAX. On a mesh,
    this rank's: its rows' loss and the gradients of its shards, before
    the sums over the data group."""
    for p in self.params.values():
      p.grad = None
    with self._on_mesh():
      loss, metrics = self._loss_fn(batch, draws, dropout_generator)
      loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
    for p in self.params.values():
      p.grad = None
    return metrics, grads

  def _on_mesh(self):
    return self.mesh if self.mesh is not None else contextlib.nullcontext()

  @torch.no_grad()
  def eval_step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The loss_fn's metrics of one batch with no dropout and fixed draws,
    the JAX package's `loss_fn(params, batch, None)` ("dropout_rng=None
    means a deterministic eval pass"). The draws come from a generator
    seeded EVAL_DRAWS_SEED on the model's device, the same at every call;
    they are not JAX's threefry draws for its PRNGKey(0). On a mesh,
    `batch` is this rank's rows and the metrics the global batch's."""
    batch = batch_to_device(batch, self.device)
    draws = torch.Generator(device=self.device).manual_seed(EVAL_DRAWS_SEED)
    with self._on_mesh():
      _, metrics = self._loss_fn(batch, self._draws(draws), None)
    return self._reduce_metrics(metrics)

  def _draws(self, generator: torch.Generator):
    """The model's draws from `generator` (None for a model without), at
    the global batch's shape on a mesh."""
    if not self.takes_draws:
      return None
    draws = self.model.draws(generator)
    return (mesh_lib.global_draws(draws, self.mesh) if self.mesh is not None
            else draws)

  def _loss_fn(self, batch, draws, dropout_generator):
    if self.takes_draws:
      return self.model.loss_fn(batch, draws, dropout_generator)
    return self.model.loss_fn(batch, dropout_generator)

  def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from each data group's (sums over it,
    and means of the row means)."""
    if self.mesh is None or self.mesh.data == 1:
      return metrics
    keys = sorted(metrics)
    values = torch.stack([metrics[k].detach().float().reshape(())
                          for k in keys])
    self.mesh.all_reduce_(values, "data")
    out = {k: values[i] if k in SUMMED_METRICS else values[i] / self.mesh.data
           for i, k in enumerate(keys)}
    if "loss_per_frame" in out:
      out["loss_per_frame"] = out["loss"] / torch.clamp(out["n_frames"],
                                                        min=1.0)
    return out

  def _sum_over_data(self, grads: Tensors) -> Tensors:
    """Each gradient summed over the data group (one all_reduce)."""
    if self.mesh is None or self.mesh.data == 1:
      return grads
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    self.mesh.all_reduce_(flat, "data")
    out, start = {}, 0
    for n in names:
      size = grads[n].numel()
      out[n] = flat[start:start + size].view_as(grads[n])
      start += size
    return out

  def _grad_norm(self, grads: Tensors) -> torch.Tensor:
    """optax.global_norm of the full gradients: a split parameter's
    squares summed over the model group."""
    if self.layout is None:
      return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    split = [torch.sum(g * g) for n, g in grads.items()
             if self.layout.splits[n] is not None]
    whole = [torch.sum(g * g) for n, g in grads.items()
             if self.layout.splits[n] is None]
    total = sum(whole) if whole else torch.zeros((), device=self.device)
    if split:
      total = total + self.mesh.all_reduce_(torch.stack(split).sum(), "model")
    return torch.sqrt(total)

  def train_step(self, state: TrainState, batch: Mapping[str, Any],
                 seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step (one microstep under MultiSteps) on `batch`
    (this rank's rows on a mesh).

    The metrics are the loss_fn's and `grad_norm`, 0-d tensors on the
    device (reading one waits for the step).
    """
    batch = batch_to_device(batch, self.device)
    draws_gen, dropout_gen = step_generators(seed, state.step, self.device)
    metrics, grads = self.loss_and_grads(batch, self._draws(draws_gen),
                                         dropout_gen)
    grads = self._sum_over_data(grads)
    metrics = self._reduce_metrics({k: v.detach()
                                    for k, v in metrics.items()})
    metrics["grad_norm"] = self._grad_norm(grads)
    updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                               self.params)
    if updates is not None:
      with torch.no_grad():
        for name, u in updates.items():
          self.params[name].add_(u)
    return TrainState(step=state.step + 1, opt_state=opt_state), metrics

  # -- checkpoints: the full tree, whatever the mesh ------------------------

  def _state_split(self, path: Tuple[str, ...]) -> Optional[int]:
    """The dim an optimizer-state tensor at `path` (..., kind, name) is
    split on over 'model': its parameter's, less the dim a factored
    second moment reduced (a moment reduced over the split dim is
    replicated)."""
    name = path[-1]
    split = self.layout.splits.get(name) if self.layout else None
    if split is None:
      return None
    kind = path[-2] if len(path) > 1 else None
    if kind in ("v_row", "v_col"):
      d1, d0 = factored_dims(self.layout.full_shapes[name])
      removed = d0 if kind == "v_row" else d1
      if split == removed:
        return None
      return split - 1 if split > removed else split
    return split

  def full_params(self) -> Dict[str, torch.Tensor]:
    """The module's state_dict, every split tensor gathered (a collective
    on a mesh: every rank calls it)."""
    state = self.model.module.state_dict()
    if self.mesh is None:
      return state
    return mesh_lib.gather_pytree(state, self.shardings, self.mesh)

  def full_opt_state(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The optimizer state with every split tensor gathered (a
    collective on a mesh)."""
    if self.mesh is None:
      return opt_state

    def gather(path, t):
      dim = self._state_split(path)
      return t if dim is None else self.mesh.gather(t, "model", dim)
    return _walk_state(opt_state, gather)

  def load_full_params_(self, params: Mapping[str, torch.Tensor]) -> None:
    """Load a full state_dict (a checkpoint's) into the module, each
    tensor cut to this rank's shard."""
    if self.mesh is not None:
      params = mesh_lib.shard_pytree(params, self.shardings, self.mesh)
    with torch.no_grad():
      self.model.module.load_state_dict(params)

  def shard_opt_state(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """A full optimizer state (a checkpoint's) cut to this rank's shard."""
    if self.mesh is None:
      return opt_state

    def shard(path, t):
      dim = self._state_split(path)
      return t if dim is None else self.mesh.shard(t, "model", dim)
    return _walk_state(opt_state, shard)
