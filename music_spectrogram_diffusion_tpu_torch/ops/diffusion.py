"""Diffusion process math and samplers in PyTorch.

Port of music_spectrogram_diffusion_tpu/ops/diffusion.py: the schedules,
the parameterisation conversions, the training input and loss, the DDPM,
DDIM and DPM-Solver++(2M) updates, classifier-free guidance with its
interval, `sampler_step`, `multistep_sampler_step` and `sample`. The
configs are the same frozen dataclasses, so an ExperimentConfig JSON
written by either package reads in both.

JAX runs the reverse process as one program (`lax.scan`). Here each step
splits into what the host decides (`StepKind`: the pair or the
conditional-only forward, the multistep samplers' first-order first step,
the last step's return of pred_x0) and what the device computes from
tensors alone: the step's time and log-SNRs are rows of per-step tables
and its draw a row of a noise table, read at a step index held in a
device tensor (`SamplerState`). So one CUDA graph captures every step of a
kind and is replayed from a short host loop (`ops/graphs.py`); on the CPU
the same steps run eagerly. Differences from the JAX module, none of which
changes the arithmetic:

* The guidance interval is decided per step on the host: steps inside it
  run the fused two-row CFG forward, steps outside it one conditional
  forward. The JAX module makes the same choice per step in
  `_predict_x0_eps` and, at batch >= 4, in `sample`; both apply the CFG mix
  to (cond, cond) outside the window.
* Noise comes from a provider `noise(i, shape)`: i is None for the initial
  draw and the step index for a step's draw. `SamplerState.start` draws
  every step's noise before the loop, in the eager loop's order.
  `generator_noise` draws from one `torch.Generator` per batch row; tests
  hand in JAX's draws instead.
* Likewise `training_input` takes eps, time and include_conditioning from a
  provider `draws(x0, config)`; `generator_draws` draws them from a
  `torch.Generator`.
* Sampler state stays float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch.ops import graphs as graphs_lib

LOGSNR_MIN = -20.0
LOGSNR_MAX = 20.0


@dataclasses.dataclass(frozen=True)
class Schedule:
  """A noise schedule mapping t in [0, 1] to log-SNR ('cosine' or the
  tabulated beta-'linear', which uses start/stop/num_steps)."""
  name: str = "cosine"
  start: Optional[float] = None
  stop: Optional[float] = None
  num_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
  """Classifier-free guidance; `interval` = (t_lo, t_hi) restricts the CFG
  mix and its unconditional forward to t_lo <= t <= t_hi."""
  drop_condition_prob: float = 0.1
  eval_condition_weight: float = 5.0
  interval: Optional[Tuple[float, float]] = None


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
  """Reverse-process sampler: 'ddpm' | 'ddim' | 'dpm++' | 'sde-dpm++'."""
  name: str = "ddpm"
  schedule: Schedule = Schedule(name="cosine")
  num_steps: int = 1000
  clip_x0: bool = True
  logvar_type: str = "large"  # 'small' | 'large' | 'medium:<frac>'


MULTISTEP_SAMPLERS = ("dpm++", "sde-dpm++")
STOCHASTIC_SAMPLERS = ("ddpm", "sde-dpm++")  # a draw every step
SAMPLERS = ("ddpm", "ddim") + MULTISTEP_SAMPLERS


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
  """Top-level diffusion hyperparameters."""
  time_sampling: str = "continuous"
  train_schedule: Schedule = Schedule(name="cosine")
  loss_norm: str = "l1"
  loss_type: str = "eps"
  model_output: str = "eps"  # 'eps' | 'x0' | 'x0_and_eps' | 'v'
  guidance: GuidanceConfig = GuidanceConfig()
  sampler: SamplerConfig = SamplerConfig()


# (i, shape) -> standard normal float32 tensor; i is None for the initial z.
NoiseFn = Callable[[Optional[int], Tuple[int, ...]], torch.Tensor]
# (x0, config) -> (eps like x0, time [b] in [0, 1), include_conditioning
# bool [b]): the random inputs of one training step.
DrawsFn = Callable[[torch.Tensor, "DiffusionConfig"],
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
# (z_t, time) -> model output of one network forward.
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (z_t, time) -> (cond output, uncond output) of one fused two-row forward.
DenoisePairFn = Callable[[torch.Tensor, torch.Tensor],
                         Tuple[torch.Tensor, torch.Tensor]]


def generator_noise(generators: Sequence[torch.Generator],
                    device) -> NoiseFn:
  """Noise with one generator per batch row, so a row's draws do not
  depend on its batch neighbours (batched == one at a time)."""
  def draw(i, shape):
    del i  # each generator's stream advances one draw per call
    if shape[0] != len(generators):
      raise ValueError(f"{len(generators)} generators for batch {shape[0]}")
    return torch.stack([
        torch.randn(tuple(shape[1:]), generator=g, device=device,
                    dtype=torch.float32) for g in generators])
  return draw


def generator_draws(generator: torch.Generator) -> DrawsFn:
  """A training step's draws from one generator, as the JAX package draws
  them from its key (eps, then time, then the condition drop): eps
  standard normal, time uniform in [0, 1) (or k / n for 'discrete'), and
  each row conditioned with probability 1 - drop_condition_prob."""
  def draw(x0, config):
    batch, dev = x0.shape[0], x0.device
    eps = torch.randn(x0.shape, generator=generator, device=dev,
                      dtype=torch.float32)
    if config.time_sampling == "continuous":
      time = torch.rand(batch, generator=generator, device=dev)
    elif config.time_sampling == "discrete":
      n = config.train_schedule.num_steps
      time = torch.randint(0, n, (batch,), generator=generator,
                           device=dev).float() / float(n)
    else:
      raise ValueError(f"Invalid time_sampling: {config.time_sampling}")
    keep = 1.0 - config.guidance.drop_condition_prob
    include = torch.rand(batch, generator=generator, device=dev) < keep
    return eps, time, include
  return draw


# ---------------------------------------------------------------------------
# Schedules and conversions.
# ---------------------------------------------------------------------------


def _linear_schedule_table(schedule: Schedule):
  betas = np.linspace(schedule.start, schedule.stop, schedule.num_steps,
                      dtype=np.float64)
  alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
  logsnr = np.log(alphas_cumprod) - np.log1p(-alphas_cumprod)
  logsnr = np.clip(logsnr, LOGSNR_MIN, LOGSNR_MAX)
  return np.linspace(0.0, 1.0, schedule.num_steps), logsnr


def logsnr_at(t: torch.Tensor, schedule: Schedule) -> torch.Tensor:
  """log-SNR(t) for t in [0, 1] (float32), clipped to [-20, 20]."""
  if schedule.name == "cosine":
    b = float(np.float32(np.arctan(np.exp(-0.5 * LOGSNR_MAX))))
    a = float(np.float32(np.arctan(np.exp(-0.5 * LOGSNR_MIN)) -
                         np.arctan(np.exp(-0.5 * LOGSNR_MAX))))
    return -2.0 * torch.log(torch.tan(a * t + b))
  if schedule.name == "linear":
    ts, table = _linear_schedule_table(schedule)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=t.device)
    table = torch.as_tensor(table, dtype=torch.float32, device=t.device)
    # np.interp / jnp.interp, term for term.
    idx = torch.clamp(torch.searchsorted(ts, t, right=True), 1, len(ts) - 1)
    t0, t1 = ts[idx - 1], ts[idx]
    y0, y1 = table[idx - 1], table[idx]
    out = y0 + ((t - t0) / (t1 - t0)) * (y1 - y0)
    return torch.where(t < ts[0], table[0],
                       torch.where(t > ts[-1], table[-1], out))
  raise ValueError(f"Unknown schedule: {schedule.name}")


def bcast_left(x: torch.Tensor, shape) -> torch.Tensor:
  """Broadcast a scalar/batch tensor against trailing dims."""
  return x.reshape(tuple(x.shape) + (1,) * (len(shape) - x.ndim)).expand(
      tuple(shape))


def log1mexp(x: torch.Tensor) -> torch.Tensor:
  """log(1 - exp(-x)) for x > 0, stable on both branches."""
  return torch.where(x > math.log(2.0), torch.log1p(-torch.exp(-x)),
                     torch.log(-torch.expm1(-x)))


def forward_process(x0, logsnr) -> Dict[str, torch.Tensor]:
  """q(z_t | x0) in the logSNR parameterisation."""
  return {"mean": x0 * torch.sqrt(torch.sigmoid(logsnr)),
          "std": torch.sqrt(torch.sigmoid(-logsnr)),
          "var": torch.sigmoid(-logsnr),
          "logvar": F.logsigmoid(-logsnr)}


def reverse_process(x0, z_t, logsnr_s, logsnr_t,
                    logvar_type: str) -> Dict[str, torch.Tensor]:
  """q(z_s | z_t, x0) for s < t, fixed variance."""
  alpha_st = torch.sqrt((1.0 + torch.exp(-logsnr_t)) /
                        (1.0 + torch.exp(-logsnr_s)))
  alpha_s = torch.sqrt(torch.sigmoid(logsnr_s))
  r = torch.exp(logsnr_t - logsnr_s)
  one_minus_r = -torch.expm1(logsnr_t - logsnr_s)
  log_one_minus_r = log1mexp(logsnr_s - logsnr_t)
  mean = r * alpha_st * z_t + one_minus_r * alpha_s * x0
  if logvar_type == "small":
    var = one_minus_r * torch.sigmoid(-logsnr_s)
    logvar = log_one_minus_r + F.logsigmoid(-logsnr_s)
  elif logvar_type == "large":
    var = one_minus_r * torch.sigmoid(-logsnr_t)
    logvar = log_one_minus_r + F.logsigmoid(-logsnr_t)
  elif logvar_type.startswith("medium:"):
    frac = float(logvar_type.split(":")[1])
    if not 0.0 <= frac <= 1.0:
      raise ValueError(f"medium logvar fraction {frac} outside [0, 1]")
    min_logvar = log_one_minus_r + F.logsigmoid(-logsnr_s)
    max_logvar = log_one_minus_r + F.logsigmoid(-logsnr_t)
    logvar = frac * max_logvar + (1.0 - frac) * min_logvar
    var = torch.exp(logvar)
  else:
    raise ValueError(f"Unknown logvar_type: {logvar_type}")
  return {"mean": mean, "std": torch.sqrt(var), "var": var, "logvar": logvar}


def eps_from_x0(z, x0, logsnr):
  logsnr = bcast_left(logsnr, z.shape)
  return torch.sqrt(1.0 + torch.exp(logsnr)) * (
      z - x0 * torch.rsqrt(1.0 + torch.exp(-logsnr)))


def x0_from_eps(z, eps, logsnr):
  logsnr = bcast_left(logsnr, z.shape)
  return torch.sqrt(1.0 + torch.exp(-logsnr)) * (
      z - eps * torch.rsqrt(1.0 + torch.exp(logsnr)))


def x0_from_v(z, v, logsnr):
  logsnr = bcast_left(logsnr, z.shape)
  return (torch.sqrt(torch.sigmoid(logsnr)) * z -
          torch.sqrt(torch.sigmoid(-logsnr)) * v)


def x0_eps_from_model_output(z, time, model_output,
                             config: DiffusionConfig
                             ) -> Dict[str, torch.Tensor]:
  """The network output as both x0 and eps."""
  logsnr = logsnr_at(time, config.train_schedule)
  if config.model_output == "eps":
    return {"eps": model_output, "x0": x0_from_eps(z, model_output, logsnr)}
  if config.model_output == "x0":
    return {"eps": eps_from_x0(z, model_output, logsnr), "x0": model_output}
  if config.model_output == "x0_and_eps":
    x0_direct, eps_direct = torch.chunk(model_output, 2, dim=-1)
    x0_indirect = x0_from_eps(z, eps_direct, logsnr)
    wx = bcast_left(torch.sigmoid(-logsnr), z.shape)
    x0_out = wx * x0_direct + (1.0 - wx) * x0_indirect
    return {"x0": x0_out, "eps": eps_from_x0(z, x0_out, logsnr)}
  if config.model_output == "v":
    x0_out = x0_from_v(z, model_output, logsnr)
    return {"x0": x0_out, "eps": eps_from_x0(z, x0_out, logsnr)}
  raise ValueError(f"Unknown model_output: {config.model_output}")


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


def training_input(draws: DrawsFn, x0: torch.Tensor, config: DiffusionConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
  """(z_t, eps, time, include_conditioning) for a training step; eps, time
  and include_conditioning come from `draws`, z_t = alpha x0 + sigma eps."""
  eps, time, include_conditioning = draws(x0, config)
  logsnr = logsnr_at(time, config.train_schedule)
  dist = forward_process(x0, bcast_left(logsnr, x0.shape))
  z_t = dist["mean"] + dist["std"] * eps
  return z_t, eps, time, include_conditioning


def training_loss(x0, eps, z, time, model_output,
                  config: DiffusionConfig) -> torch.Tensor:
  """Per-element diffusion loss (unreduced)."""
  outputs = x0_eps_from_model_output(z, time, model_output, config)

  def norm(a, b):
    if config.loss_norm == "l1":
      return torch.abs(a - b)
    if config.loss_norm == "l2":
      return torch.square(a - b)
    raise ValueError(f"Unknown loss_norm: {config.loss_norm}")

  if config.loss_type == "x0":
    return norm(outputs["x0"], x0)
  if config.loss_type == "eps":
    return norm(outputs["eps"], eps)
  if config.loss_type == "max_x0_eps":
    return torch.maximum(norm(outputs["x0"], x0), norm(outputs["eps"], eps))
  if config.loss_type == "x0_and_eps":
    return norm(outputs["eps"], eps) + norm(outputs["x0"], x0)
  raise ValueError(f"Unknown loss_type: {config.loss_type}")


# ---------------------------------------------------------------------------
# Sampler updates and steps.
# ---------------------------------------------------------------------------


def ddim_update(logsnr_s, pred_x0, pred_eps):
  """One DDIM step z_t -> z_s."""
  logsnr_s = bcast_left(logsnr_s, pred_x0.shape)
  return (torch.sqrt(torch.sigmoid(logsnr_s)) * pred_x0 +
          torch.sqrt(torch.sigmoid(-logsnr_s)) * pred_eps)


def ddpm_update(noise: torch.Tensor, logsnr_s, logsnr_t, pred_x0, z_t,
                logvar_type: str):
  """One ancestral DDPM step; `noise` is the step's standard normal draw."""
  dist = reverse_process(pred_x0, z_t, bcast_left(logsnr_s, pred_x0.shape),
                         bcast_left(logsnr_t, pred_x0.shape), logvar_type)
  return dist["mean"] + dist["std"] * noise


def dpm_update(first: bool, noise: Optional[torch.Tensor], logsnr_s,
               logsnr_t, logsnr_t_prev, pred_x0, prev_x0, z_t, *,
               stochastic: bool):
  """One DPM-Solver++(2M) step over half-logSNR:

      D    = x0_t + (x0_t - x0_prev) / (2 r),   r = h_prev / h
      det:  z_s = (sigma_s/sigma_t) z_t - alpha_s expm1(-h) D
      sde:  z_s = (sigma_s/sigma_t) e^{-h} z_t - alpha_s expm1(-2h) D
                  + sigma_s sqrt(-expm1(-2h)) xi

  First order (D = x0_t) at the first step (`first`); `noise` is xi.
  """
  shape = pred_x0.shape
  lam_s = bcast_left(logsnr_s, shape) * 0.5
  lam_t = bcast_left(logsnr_t, shape) * 0.5
  lam_p = bcast_left(logsnr_t_prev, shape) * 0.5
  h = lam_s - lam_t
  if first:
    d = pred_x0
  else:
    r = (lam_t - lam_p) / torch.clamp(h, min=1e-12)
    d = pred_x0 + (1.0 / (2.0 * r)) * (pred_x0 - prev_x0)
  logsnr_s_b = bcast_left(logsnr_s, shape)
  logsnr_t_b = bcast_left(logsnr_t, shape)
  alpha_s = torch.sqrt(torch.sigmoid(logsnr_s_b))
  sigma_ratio = torch.exp(0.5 * (F.logsigmoid(-logsnr_s_b) -
                                 F.logsigmoid(-logsnr_t_b)))
  if stochastic:
    sigma_s = torch.sqrt(torch.sigmoid(-logsnr_s_b))
    one_minus_e2h = -torch.expm1(-2.0 * h)
    return (sigma_ratio * torch.exp(-h) * z_t + alpha_s * one_minus_e2h * d
            + sigma_s * torch.sqrt(one_minus_e2h) * noise)
  return sigma_ratio * z_t - alpha_s * torch.expm1(-h) * d


def _f32_ratio(a: float, b: float) -> float:
  """a / b rounded once to float32, as the JAX sampler computes times."""
  return float(np.float32(a) / np.float32(b))


def _step_times(i: int, num_steps: int, batch: int, schedule: Schedule,
                device):
  """(time, logsnr_s, logsnr_t) at step i: t = (i+1)/N, s = i/N."""
  t = torch.full((batch,), _f32_ratio(i + 1.0, num_steps),
                 dtype=torch.float32, device=device)
  s = torch.full((batch,), _f32_ratio(i, num_steps), dtype=torch.float32,
                 device=device)
  return t, logsnr_at(s, schedule), logsnr_at(t, schedule)


@dataclasses.dataclass(frozen=True)
class StepKind:
  """What the host decides about one reverse step; the rest of the step
  comes from device tensors, so one captured graph serves every step of a
  kind. `pair`: the two-row CFG forward (inside the guidance interval,
  static as in JAX); `first`: the multistep samplers' first-order first
  step; `last`: the step that returns pred_x0 (i == 0)."""
  pair: bool
  first: bool
  last: bool


def step_kind(i: int, config: DiffusionConfig) -> StepKind:
  """The host's decisions for step i."""
  sampler, guidance = config.sampler, config.guidance
  pair = True
  if guidance.eval_condition_weight != 1.0 and guidance.interval is not None:
    # Compared in float32, as the JAX sampler compares its float32 times.
    t = np.float32(_f32_ratio(i + 1.0, sampler.num_steps))
    pair = bool(np.float32(guidance.interval[0]) <= t
                <= np.float32(guidance.interval[1]))
  return StepKind(pair=pair,
                  first=(sampler.name in MULTISTEP_SAMPLERS
                         and i == sampler.num_steps - 1),
                  last=i == 0)


def _row(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
  """Row `index` (int64 [1], on the table's device) of a table: a read
  that a captured step replays at whatever the index holds."""
  return table.index_select(0, index)[0]


class SamplerState:
  """One reverse process's device state, at fixed addresses.

  The per-step tables [num_steps, batch] hold, at row i, what the eager
  loop computes for step i: `time`, `logsnr_s` and `logsnr_t` from
  `_step_times` and, for the multistep samplers, `logsnr_t_prev` (the
  previous network eval's noise level, clamped at t = 1). `noise`
  [num_steps, *shape] holds step i's draw at row i (DDPM and SDE-DPM++).
  `z`, `prev_x0` and `index` (int64 [1], the step to run next) are the
  loop's state. `start` refills what changes from run to run.
  """

  def __init__(self, shape: Tuple[int, ...], config: DiffusionConfig,
               device):
    sampler = config.sampler
    if sampler.name not in SAMPLERS:
      raise ValueError(f"Unknown sampler: {sampler.name}")
    n, batch = sampler.num_steps, shape[0]
    self.shape, self.num_steps = tuple(shape), n
    self.multistep = sampler.name in MULTISTEP_SAMPLERS
    columns = zip(*[_step_times(i, n, batch, sampler.schedule, device)
                    for i in range(n)])
    self.time, self.logsnr_s, self.logsnr_t = (torch.stack(c)
                                               for c in columns)
    self.logsnr_t_prev = None
    if self.multistep:
      self.logsnr_t_prev = torch.stack([
          logsnr_at(torch.full((batch,), min(_f32_ratio(i + 2.0, n), 1.0),
                               dtype=torch.float32, device=device),
                    sampler.schedule) for i in range(n)])
    f32 = dict(dtype=torch.float32, device=device)
    self.noise = (torch.zeros((n,) + self.shape, **f32)
                  if sampler.name in STOCHASTIC_SAMPLERS else None)
    self.z = torch.zeros(self.shape, **f32)
    self.prev_x0 = torch.zeros(self.shape, **f32)
    self.index = torch.zeros(1, dtype=torch.int64, device=device)

  def start(self, noise: NoiseFn) -> None:
    """A new run: z the initial draw, then every step's draw in the eager
    loop's order (steps N-1 down to 1; step 0 draws nothing), prev_x0
    zero, the index at the first step."""
    self.z.copy_(noise(None, self.shape))
    if self.noise is not None:
      for i in reversed(range(1, self.num_steps)):
        self.noise[i].copy_(noise(i, self.shape))
    self.prev_x0.zero_()
    self.index.fill_(self.num_steps - 1)


def _predict_x0_eps(z_t, time, logsnr_t, pair: bool, *,
                    config: DiffusionConfig,
                    denoise_pair_fn: DenoisePairFn,
                    denoise_cond_fn: Optional[DenoiseFn]):
  """Network eval + guidance + clipping shared by every sampler; returns
  (pred_x0, pred_eps)."""
  cond_wt = config.guidance.eval_condition_weight
  if cond_wt != 1.0:
    if pair:
      cond_out, uncond_out = denoise_pair_fn(z_t, time)
    else:
      # Outside the window the mix below reduces to the conditional
      # prediction (w*c + (1-w)*c), so one conditional forward suffices.
      if denoise_cond_fn is not None:
        cond_out = denoise_cond_fn(z_t, time)
      else:
        cond_out, _ = denoise_pair_fn(z_t, time)
      uncond_out = cond_out
    cond = x0_eps_from_model_output(z_t, time, cond_out, config)
    uncond = x0_eps_from_model_output(z_t, time, uncond_out, config)
    pred_eps = cond_wt * cond["eps"] + (1.0 - cond_wt) * uncond["eps"]
    pred_x0 = x0_from_eps(z_t, pred_eps, logsnr_t)
  else:
    out, _ = denoise_pair_fn(z_t, time)
    outputs = x0_eps_from_model_output(z_t, time, out, config)
    pred_eps, pred_x0 = outputs["eps"], outputs["x0"]
  if config.sampler.clip_x0:
    pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    pred_eps = eps_from_x0(z_t, pred_x0, logsnr_t)
  return pred_x0, pred_eps


def sampler_step(z_t: torch.Tensor, index: torch.Tensor, kind: StepKind,
                 state: SamplerState, *, config: DiffusionConfig,
                 denoise_pair_fn: DenoisePairFn,
                 denoise_cond_fn: Optional[DenoiseFn] = None
                 ) -> torch.Tensor:
  """One DDPM or DDIM step z_t -> z_s (JAX `sampler_step`): step i =
  `index`'s value (t = (i+1)/N, s = i/N), its times and draw read from
  `state`'s tables there; pred_x0 at the last step."""
  sampler = config.sampler
  if sampler.name not in ("ddpm", "ddim"):
    raise ValueError(f"sampler_step runs ddpm and ddim, not {sampler.name}")
  logsnr_s, logsnr_t = _row(state.logsnr_s, index), _row(state.logsnr_t,
                                                          index)
  pred_x0, pred_eps = _predict_x0_eps(
      z_t, _row(state.time, index), logsnr_t, kind.pair, config=config,
      denoise_pair_fn=denoise_pair_fn, denoise_cond_fn=denoise_cond_fn)
  if kind.last:
    return pred_x0
  if sampler.name == "ddim":
    return ddim_update(logsnr_s, pred_x0, pred_eps)
  return ddpm_update(_row(state.noise, index), logsnr_s, logsnr_t, pred_x0,
                     z_t, sampler.logvar_type)


def multistep_sampler_step(z_t: torch.Tensor, prev_x0: torch.Tensor,
                           index: torch.Tensor, kind: StepKind,
                           state: SamplerState, *, config: DiffusionConfig,
                           denoise_pair_fn: DenoisePairFn,
                           denoise_cond_fn: Optional[DenoiseFn] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """One DPM-Solver++(2M) step (JAX `multistep_sampler_step`), read from
  `state`'s tables at `index` as `sampler_step`; returns (z_s, pred_x0)
  for the next step."""
  sampler = config.sampler
  if sampler.name not in MULTISTEP_SAMPLERS:
    raise ValueError(f"multistep_sampler_step runs {MULTISTEP_SAMPLERS}, "
                     f"not {sampler.name}")
  pred_x0, _ = _predict_x0_eps(
      z_t, _row(state.time, index), _row(state.logsnr_t, index), kind.pair,
      config=config, denoise_pair_fn=denoise_pair_fn,
      denoise_cond_fn=denoise_cond_fn)
  if kind.last:
    return pred_x0, pred_x0
  stochastic = sampler.name == "sde-dpm++"
  z_s = dpm_update(kind.first,
                   _row(state.noise, index) if stochastic else None,
                   _row(state.logsnr_s, index), _row(state.logsnr_t, index),
                   _row(state.logsnr_t_prev, index), pred_x0, prev_x0, z_t,
                   stochastic=stochastic)
  return z_s, pred_x0


def advance(state: SamplerState, kind: StepKind, *,
            config: DiffusionConfig, denoise_pair_fn: DenoisePairFn,
            denoise_cond_fn: Optional[DenoiseFn] = None) -> None:
  """One step of `state`'s run, in place: z (and prev_x0) take the step's
  results and the index moves to the next step. This is what a captured
  step graph replays."""
  fns = dict(config=config, denoise_pair_fn=denoise_pair_fn,
             denoise_cond_fn=denoise_cond_fn)
  if state.multistep:
    z_s, pred_x0 = multistep_sampler_step(state.z, state.prev_x0,
                                          state.index, kind, state, **fns)
    state.prev_x0.copy_(pred_x0)
  else:
    z_s = sampler_step(state.z, state.index, kind, state, **fns)
  state.z.copy_(z_s)
  state.index.sub_(1)


def run(state: SamplerState, config: DiffusionConfig, *,
        denoise_pair_fn: DenoisePairFn,
        denoise_cond_fn: Optional[DenoiseFn] = None,
        step_graphs: Optional[graphs_lib.StepGraphs] = None,
        key: tuple = ()) -> torch.Tensor:
  """Every step of a started `state`, highest t first; returns state.z,
  pred_x0 after the last step. With `step_graphs` each kind of step is
  captured once, under key + (kind,), and replayed (inside its
  `on_stream()`); without, every step runs eagerly."""
  for i in reversed(range(state.num_steps)):
    kind = step_kind(i, config)
    step = functools.partial(advance, state, kind, config=config,
                             denoise_pair_fn=denoise_pair_fn,
                             denoise_cond_fn=denoise_cond_fn)
    if step_graphs is None:
      step()
    else:
      step_graphs.run(key + (kind,), step)
  return state.z


def sample(noise: NoiseFn,
           target_shape: Tuple[int, ...],
           config: DiffusionConfig,
           *,
           denoise_pair_fn: DenoisePairFn,
           denoise_cond_fn: Optional[DenoiseFn] = None,
           device="cuda",
           graphs: Optional[bool] = None) -> torch.Tensor:
  """Full reverse diffusion; returns pred_x0 in [-1, 1], float32.

  Args:
    noise: provider of the initial and per-step standard normal draws.
    target_shape: [batch, frames, dims].
    config: diffusion hyperparameters.
    denoise_pair_fn: (z, time) -> (cond_out, uncond_out) in one forward.
    denoise_cond_fn: optional (z, time) -> cond_out, for steps outside
      `config.guidance.interval`.
    graphs: None captures each kind of step as a CUDA graph on a CUDA
      device and runs eagerly on the CPU; False runs eagerly; True
      captures, and raises on the CPU. The denoisers of a captured run
      must read tensors that keep their addresses.
  """
  device = torch.device(device)
  captured = graphs_lib.use_graphs(device, graphs)
  state = SamplerState(tuple(target_shape), config, device)
  state.start(noise)
  step_graphs = graphs_lib.StepGraphs(device) if captured else None
  with graphs_lib.on_stream(step_graphs):
    return run(state, config, denoise_pair_fn=denoise_pair_fn,
               denoise_cond_fn=denoise_cond_fn, step_graphs=step_graphs)


def timing_embedding(position: torch.Tensor, num_channels: int,
                     min_timescale: float = 1.0,
                     max_timescale: float = 2.0e4) -> torch.Tensor:
  """Tensor2Tensor sinusoidal timing signal, [batch, num_channels]."""
  if position.ndim != 1 or num_channels % 2:
    raise ValueError("timing_embedding wants 1-d positions, even channels")
  num_timescales = num_channels // 2
  log_increment = float(np.float32(
      np.log(max_timescale / min_timescale) / (num_timescales - 1.0)))
  inv_timescales = min_timescale * torch.exp(
      torch.arange(num_timescales, dtype=torch.float32,
                   device=position.device) * -log_increment)
  scaled = position[:, None] * inv_timescales[None, :]
  return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
