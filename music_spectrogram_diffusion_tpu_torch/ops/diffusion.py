"""Diffusion process math and samplers in PyTorch.

Port of music_spectrogram_diffusion_tpu/ops/diffusion.py: the schedules,
the parameterisation conversions, the training input and loss, the DDPM,
DDIM and DPM-Solver++(2M) updates, classifier-free guidance with its
interval, and `sample`. The configs are the same frozen dataclasses, so an
ExperimentConfig JSON written by either package reads in both.

Differences from the JAX module, none of which changes the arithmetic:

* The reverse loop is a Python loop (PyTorch runs eagerly), so the guidance
  interval is decided per step: steps inside it run the fused two-row CFG
  forward, steps outside it one conditional forward. The JAX module makes
  the same choice per step in `_predict_x0_eps` and, at batch >= 4, in
  `sample`; both apply the CFG mix to (cond, cond) outside the window.
* Noise comes from a provider `noise(i, shape)`: i is None for the initial
  draw and the step index for a step's draw. `generator_noise` draws from
  one `torch.Generator` per batch row; tests hand in JAX's draws instead.
* Likewise `training_input` takes eps, time and include_conditioning from a
  provider `draws(x0, config)`; `generator_draws` draws them from a
  `torch.Generator`.
* Sampler state stays float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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
# Sampler updates.
# ---------------------------------------------------------------------------


def ddim_update(i: int, logsnr_s, pred_x0, pred_eps):
  """One DDIM step (returns x0 at i == 0)."""
  if i == 0:
    return pred_x0
  logsnr_s = bcast_left(logsnr_s, pred_x0.shape)
  return (torch.sqrt(torch.sigmoid(logsnr_s)) * pred_x0 +
          torch.sqrt(torch.sigmoid(-logsnr_s)) * pred_eps)


def ddpm_update(i: int, noise: NoiseFn, logsnr_s, logsnr_t, pred_x0, z_t,
                logvar_type: str):
  """One ancestral DDPM step (returns x0 at i == 0)."""
  if i == 0:
    return pred_x0
  dist = reverse_process(pred_x0, z_t, bcast_left(logsnr_s, pred_x0.shape),
                         bcast_left(logsnr_t, pred_x0.shape), logvar_type)
  return dist["mean"] + dist["std"] * noise(i, tuple(pred_x0.shape))


def dpm_update(i: int, noise: Optional[NoiseFn], logsnr_s, logsnr_t,
               logsnr_t_prev, pred_x0, prev_x0, z_t, *, num_steps: int,
               stochastic: bool):
  """One DPM-Solver++(2M) step over half-logSNR (returns x0 at i == 0).

      D    = x0_t + (x0_t - x0_prev) / (2 r),   r = h_prev / h
      det:  z_s = (sigma_s/sigma_t) z_t - alpha_s expm1(-h) D
      sde:  z_s = (sigma_s/sigma_t) e^{-h} z_t - alpha_s expm1(-2h) D
                  + sigma_s sqrt(-expm1(-2h)) xi

  First order (D = x0_t) at the first step i == num_steps - 1.
  """
  if i == 0:
    return pred_x0
  shape = pred_x0.shape
  lam_s = bcast_left(logsnr_s, shape) * 0.5
  lam_t = bcast_left(logsnr_t, shape) * 0.5
  lam_p = bcast_left(logsnr_t_prev, shape) * 0.5
  h = lam_s - lam_t
  if i >= num_steps - 1:
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
            + sigma_s * torch.sqrt(one_minus_e2h) * noise(i, tuple(shape)))
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


def _predict_x0_eps(z_t, i: int, *, config: DiffusionConfig,
                    denoise_pair_fn: DenoisePairFn,
                    denoise_cond_fn: Optional[DenoiseFn]):
  """Network eval + guidance + clipping shared by every sampler.

  Returns (pred_x0, pred_eps, logsnr_s, logsnr_t) at step i.
  """
  sampler = config.sampler
  time, logsnr_s, logsnr_t = _step_times(
      i, sampler.num_steps, z_t.shape[0], sampler.schedule, z_t.device)
  cond_wt = config.guidance.eval_condition_weight
  if cond_wt != 1.0:
    interval = config.guidance.interval
    # Compared in float32, as the JAX sampler compares its float32 times.
    t = np.float32(_f32_ratio(i + 1.0, sampler.num_steps))
    if interval is None or (np.float32(interval[0]) <= t
                            <= np.float32(interval[1])):
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
  if sampler.clip_x0:
    pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    pred_eps = eps_from_x0(z_t, pred_x0, logsnr_t)
  return pred_x0, pred_eps, logsnr_s, logsnr_t


def sample(noise: NoiseFn,
           target_shape: Tuple[int, ...],
           config: DiffusionConfig,
           *,
           denoise_pair_fn: DenoisePairFn,
           denoise_cond_fn: Optional[DenoiseFn] = None,
           device="cuda") -> torch.Tensor:
  """Full reverse diffusion; returns pred_x0 in [-1, 1], float32.

  Args:
    noise: provider of the initial and per-step standard normal draws.
    target_shape: [batch, frames, dims].
    config: diffusion hyperparameters.
    denoise_pair_fn: (z, time) -> (cond_out, uncond_out) in one forward.
    denoise_cond_fn: optional (z, time) -> cond_out, for steps outside
      `config.guidance.interval`.
  """
  sampler = config.sampler
  n = sampler.num_steps
  z = noise(None, tuple(target_shape)).to(device=device, dtype=torch.float32)
  prev_x0 = torch.zeros_like(z)
  for i in reversed(range(n)):
    pred_x0, pred_eps, logsnr_s, logsnr_t = _predict_x0_eps(
        z, i, config=config, denoise_pair_fn=denoise_pair_fn,
        denoise_cond_fn=denoise_cond_fn)
    if sampler.name in MULTISTEP_SAMPLERS:
      # Noise level of the previous network eval, clamped at t = 1.
      t_prev = torch.full((z.shape[0],), min(_f32_ratio(i + 2.0, n), 1.0),
                          dtype=torch.float32, device=z.device)
      z = dpm_update(i, noise, logsnr_s, logsnr_t,
                     logsnr_at(t_prev, sampler.schedule), pred_x0, prev_x0,
                     z, num_steps=n, stochastic=sampler.name == "sde-dpm++")
      prev_x0 = pred_x0
    elif sampler.name == "ddim":
      z = ddim_update(i, logsnr_s, pred_x0, pred_eps)
    elif sampler.name == "ddpm":
      z = ddpm_update(i, noise, logsnr_s, logsnr_t, pred_x0, z,
                      sampler.logvar_type)
    else:
      raise ValueError(f"Unknown sampler: {sampler.name}")
  return z


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
