"""The train step: Adafactor written out by hand, the warmup-constant LR,
MultiSteps accumulation, and one step of a model of any family (context or
notes-only diffusion, or autoregressive).

Port of music_spectrogram_diffusion_tpu/train/trainer.py on one device
(the mesh waits for the port's parallelism). The JAX package trains with
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
so a resumed run reproduces the steps it continues. `Trainer.eval_step`
is JAX's deterministic eval pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model as diffusion_model)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops

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
               decay_rate: float = 0.8):
    self.learning_rate, self.decay_rate = learning_rate, decay_rate

  def init(self, params: Tensors) -> Dict[str, Any]:
    v_row, v_col, v = {}, {}, {}
    for name, p in params.items():
      dims = factored_dims(tuple(p.shape))
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
      dims = factored_dims(tuple(g.shape))
      g_sqr = g * g + EPS
      if dims is not None:
        d1, d0 = dims
        v_row = decay * state["v_row"][name] + (1.0 - decay) * g_sqr.mean(d0)
        v_col = decay * state["v_col"][name] + (1.0 - decay) * g_sqr.mean(d1)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(reduced_d1, keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        new["v_row"][name], new["v_col"][name] = v_row, v_col
      else:
        v = decay * state["v"][name] + (1.0 - decay) * g_sqr
        u = g * v ** -0.5
        new["v"][name] = v
      clip = torch.clamp(torch.sqrt(torch.mean(u * u)) / CLIPPING_THRESHOLD,
                         min=1.0)
      u = (u / clip) * lr
      p = params[name]
      u = u * torch.clamp(torch.sqrt(torch.mean(p * p)), min=MIN_SCALE)
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


def make_optimizer(train_cfg: cfg_lib.TrainConfig):
  """Adafactor as the JAX trainer configures it (and MultiSteps with
  microbatches)."""
  tx = Adafactor(warmup_constant_schedule(train_cfg.learning_rate,
                                          train_cfg.warmup_steps),
                 decay_rate=train_cfg.adafactor_decay_rate)
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


def batch_to_device(batch: Mapping[str, np.ndarray], device
                    ) -> Tensors:
  return {k: torch.as_tensor(np.asarray(v), device=device)
          for k, v in batch.items()}


class Trainer:
  """One model's train step.

  Usage:
    trainer = Trainer(model, experiment.train)
    state = trainer.create_state()
    state, metrics = trainer.train_step(state, batch, seed)
  """

  def __init__(self, model: inference.Model,
               train_cfg: cfg_lib.TrainConfig):
    self.model = model
    # The diffusion loss takes the step's draws; the autoregressive one
    # takes none (JAX's trainer calls either signature).
    self.takes_draws = isinstance(model, diffusion_model.DiffusionModelBase)
    self.train_cfg = train_cfg
    self.optimizer = make_optimizer(train_cfg)
    self.params: Tensors = {n: p for n, p in model.module.named_parameters()
                            if p.requires_grad}

  @property
  def device(self) -> torch.device:
    return self.model.device

  def create_state(self) -> TrainState:
    return TrainState(step=0, opt_state=self.optimizer.init(self.params))

  def loss_and_grads(self, batch: Tensors, draws: dops.DrawsFn,
                     dropout_generator: Optional[torch.Generator]
                     ) -> Tuple[Dict[str, torch.Tensor], Tensors]:
    """(metrics, gradients by parameter name) of one batch; a parameter
    the loss does not reach gets a zero gradient, as in JAX."""
    for p in self.params.values():
      p.grad = None
    loss, metrics = self._loss_fn(batch, draws, dropout_generator)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
    for p in self.params.values():
      p.grad = None
    return metrics, grads

  @torch.no_grad()
  def eval_step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The loss_fn's metrics of one batch with no dropout and fixed draws,
    the JAX package's `loss_fn(params, batch, None)` ("dropout_rng=None
    means a deterministic eval pass"). The draws come from a generator
    seeded EVAL_DRAWS_SEED on the model's device, the same at every call;
    they are not JAX's threefry draws for its PRNGKey(0)."""
    batch = batch_to_device(batch, self.device)
    draws = torch.Generator(device=self.device).manual_seed(EVAL_DRAWS_SEED)
    _, metrics = self._loss_fn(batch, dops.generator_draws(draws), None)
    return metrics

  def _loss_fn(self, batch, draws, dropout_generator):
    if self.takes_draws:
      return self.model.loss_fn(batch, draws, dropout_generator)
    return self.model.loss_fn(batch, dropout_generator)

  def train_step(self, state: TrainState, batch: Mapping[str, Any],
                 seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step (one microstep under MultiSteps) on `batch`.

    The metrics are the loss_fn's and `grad_norm`, 0-d tensors on the
    device (reading one waits for the step).
    """
    batch = batch_to_device(batch, self.device)
    draws_gen, dropout_gen = step_generators(seed, state.step, self.device)
    metrics, grads = self.loss_and_grads(batch,
                                         dops.generator_draws(draws_gen),
                                         dropout_gen)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = torch.sqrt(sum(torch.sum(g * g)
                                          for g in grads.values()))
    updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                               self.params)
    if updates is not None:
      with torch.no_grad():
        for name, u in updates.items():
          self.params[name].add_(u)
    return TrainState(step=state.step + 1, opt_state=opt_state), metrics
