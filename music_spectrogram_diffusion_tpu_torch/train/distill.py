"""Progressive distillation: halve the sampler's step count each round.

Port of music_spectrogram_diffusion_tpu/train/distill.py (Salimans & Ho
2022, with guidance folded in as Meng et al. 2023): a student that starts
as the teacher learns, in one forward, the x0 that makes ONE student DDIM
step land where TWO teacher DDIM half-steps land, the teacher's prediction
already mixing classifier-free guidance, so the student samples with no
unconditional forward. Each round halves num_steps (1000 -> 500 -> 250
...).

What differs from the JAX module, none of which changes the arithmetic:
* The teacher is a frozen module that `DistillModel` holds (eval mode, no
  gradients, so no dropout, as JAX's `enable_dropout=False`), and its
  target is computed under `torch.no_grad()` (JAX's `stop_gradient`). The
  student's parameters are tensors of its own, loaded from the teacher's:
  the optimizer updates them in place and the teacher stays as it was.
* The loss's draws come from a provider `draws(x0, num_student_steps) ->
  (time, eps)`, in JAX's order: the student-grid time randint(1, N + 1) /
  N, then eps. `generator_draws` draws them from a `torch.Generator`;
  tests hand in JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model as diffusion_model)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops
from music_spectrogram_diffusion_tpu_torch.utils import profiling

# (x0, num_student_steps) -> (time [b] on the student grid, eps like x0).
DistillDrawsFn = Callable[[torch.Tensor, int],
                          Tuple[torch.Tensor, torch.Tensor]]


def generator_draws(generator: torch.Generator) -> DistillDrawsFn:
  """A distillation step's draws from one generator, in JAX's order: the
  time k / N with k uniform in {1, ..., N}, then eps standard normal."""
  def draw(x0, num_student_steps):
    dev = x0.device
    idx = torch.randint(1, num_student_steps + 1, (x0.shape[0],),
                        generator=generator, device=dev)
    time = idx.float() / num_student_steps
    eps = torch.randn(x0.shape, generator=generator, device=dev,
                      dtype=torch.float32)
    return time, eps
  return draw


def _alpha_sigma(t: torch.Tensor, schedule: dops.Schedule,
                 shape) -> Tuple[torch.Tensor, torch.Tensor]:
  logsnr = dops.bcast_left(dops.logsnr_at(t, schedule), shape)
  return (torch.sqrt(torch.sigmoid(logsnr)),
          torch.sqrt(torch.sigmoid(-logsnr)))


def two_step_teacher_target(
    denoise_x0_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    z_t: torch.Tensor,
    t: torch.Tensor,
    num_student_steps: int,
    schedule: dops.Schedule,
    clip_x0: bool = True,
) -> torch.Tensor:
  """x0 target such that ONE student DDIM step from (z_t, t) equals TWO
  teacher DDIM half-steps.

  Args:
    denoise_x0_fn: (z, time) -> predicted x0 with the TEACHER (guidance
      already applied).
    z_t: noisy sample at time t.
    t: [batch] times on the student grid (multiples of 1/num_student_steps).
    num_student_steps: N/2 where the teacher ran N steps.

  Returns the per-example x̃ the student should output at (z_t, t); where
  the one-step solve's denominator vanishes (near t = 0), the teacher's
  second x0.
  """
  dt = 1.0 / num_student_steps
  t1 = t - 0.5 * dt  # teacher midpoint
  t2 = t - dt        # student target time

  alpha_t, sigma_t = _alpha_sigma(t, schedule, z_t.shape)
  alpha_1, sigma_1 = _alpha_sigma(t1, schedule, z_t.shape)
  alpha_2, sigma_2 = _alpha_sigma(t2, schedule, z_t.shape)

  def clip(x):
    return torch.clamp(x, -1.0, 1.0) if clip_x0 else x

  # Teacher DDIM half-step 1: t -> t1.
  x0_a = clip(denoise_x0_fn(z_t, t))
  eps_a = (z_t - alpha_t * x0_a) / torch.clamp(sigma_t, min=1e-12)
  z_1 = alpha_1 * x0_a + sigma_1 * eps_a
  # Teacher DDIM half-step 2: t1 -> t2.
  x0_b = clip(denoise_x0_fn(z_1, t1))
  eps_b = (z_1 - alpha_1 * x0_b) / torch.clamp(sigma_1, min=1e-12)
  z_2 = alpha_2 * x0_b + sigma_2 * eps_b

  # Solve one student DDIM step z_t -> z_2 for its implied x0:
  #   z_2 = alpha_2 x̃ + (sigma_2 / sigma_t) (z_t - alpha_t x̃)
  ratio = sigma_2 / torch.clamp(sigma_t, min=1e-12)
  denom = alpha_2 - ratio * alpha_t
  # Near t=0 the denominator vanishes; fall back to the teacher's x0.
  safe = torch.abs(denom) > 1e-6
  return torch.where(
      safe, (z_2 - ratio * z_t) / torch.where(safe, denom,
                                              torch.ones_like(denom)), x0_b)


class DistillModel:
  """One distillation round as the Trainer's model: `module` is the
  student's (the Trainer trains its parameters and TrainLoop saves it),
  `teacher` its frozen teacher, `loss_fn` the distillation loss.

  The student starts as the teacher: its parameters are loaded from the
  teacher's, into tensors of its own. The teacher's guidance weight is
  `guidance_weight` (default: its eval_condition_weight).
  """

  takes_draws = True

  def __init__(self, student: diffusion_model.DiffusionModelBase,
               teacher: diffusion_model.DiffusionModelBase,
               num_student_steps: int,
               guidance_weight: Optional[float] = None):
    teacher.module.eval().requires_grad_(False)
    student_storage = {p.data_ptr() for p in student.module.parameters()}
    if any(p.data_ptr() in student_storage
           for p in teacher.module.parameters()):
      raise ValueError("the student shares storage with its teacher; "
                       "give it a module of its own (new_student)")
    with torch.no_grad():
      student.module.load_state_dict(teacher.module.state_dict())
    self.student = student
    self.teacher = teacher
    self.module = student.module
    self.audio_codec = student.audio_codec
    self.num_student_steps = num_student_steps
    dconfig = teacher.diffusion_config
    # The train schedule for every alpha/sigma conversion: it is what
    # x0_eps_from_model_output uses, and the sampler's in every reference
    # configuration (both cosine).
    self.schedule = dconfig.train_schedule
    self.guidance_weight = (dconfig.guidance.eval_condition_weight
                            if guidance_weight is None else guidance_weight)

  @property
  def device(self) -> torch.device:
    return self.student.device

  @staticmethod
  def draws(generator: torch.Generator) -> DistillDrawsFn:
    return generator_draws(generator)

  @torch.no_grad()
  def teacher_target(self, batch: Mapping[str, torch.Tensor],
                     z_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x̃ of `two_step_teacher_target` with the teacher's guided x0: the
    encoders and cross-attention K/V once, then a decoder forward each
    half-step, the CFG pair as one 2B-row forward whose unconditional rows
    skip cross-attention (one conditional forward at weight 1). Guidance
    applies at every time (no guidance interval, as in JAX)."""
    teacher, w = self.teacher, self.guidance_weight
    dconfig = teacher.diffusion_config
    encodings = teacher.encode(batch)
    cross_kv = teacher.module.precompute_cross_kv(encodings)

    def teacher_x0(z, time):
      if w == 1.0:
        out = teacher.module.decode(encodings, z, time, cross_kv=cross_kv)
        eps_g = dops.x0_eps_from_model_output(z, time, out, dconfig)["eps"]
      else:
        rows = z.shape[0]
        out = teacher.module.decode(encodings, torch.cat([z, z]),
                                    torch.cat([time, time]),
                                    cross_kv=cross_kv, cond_rows=rows)
        c = dops.x0_eps_from_model_output(z, time, out[:rows], dconfig)
        u = dops.x0_eps_from_model_output(z, time, out[rows:], dconfig)
        eps_g = w * c["eps"] + (1 - w) * u["eps"]
      return dops.x0_from_eps(z, eps_g, dops.logsnr_at(time, self.schedule))

    return two_step_teacher_target(teacher_x0, z_t, t,
                                   self.num_student_steps, self.schedule,
                                   clip_x0=dconfig.sampler.clip_x0)

  def loss_fn(self, batch: Mapping[str, torch.Tensor],
              draws: DistillDrawsFn,
              dropout_generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Truncated-SNR-weighted squared error, max(alpha^2 / sigma^2, 1) x
    (student x0 - x̃)^2, masked and summed; every row conditioned. Dropout
    in the student when `dropout_generator` is given."""
    targets = self.audio_codec.scale_features(
        batch["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
    batch_size = targets.shape[0]
    t, eps = draws(targets, self.num_student_steps)
    alpha_t, sigma_t = _alpha_sigma(t, self.schedule, targets.shape)
    z_t = alpha_t * targets + sigma_t * eps

    with profiling.annotate("distill/teacher"):
      x_tilde = self.teacher_target(batch, z_t, t)

    with profiling.annotate("distill/student"):
      include = torch.ones(batch_size, device=targets.device)
      s_out = self.student._apply_train(batch, z_t, t, include,
                                        dropout_generator)
      s = dops.x0_eps_from_model_output(z_t, t, s_out,
                                        self.student.diffusion_config)
      snr = (alpha_t / torch.clamp(sigma_t, min=1e-12)) ** 2
      w = torch.clamp(snr, min=1.0)
      per = w * (s["x0"] - x_tilde) ** 2
      mask = batch["decoder_target_mask"]
      loss = torch.sum(per * mask[..., None].to(per.dtype))
      n_frames = mask.sum().float()
    return loss, {
        "loss": loss,
        "loss_per_frame": loss / torch.clamp(n_frames, min=1.0),
        "n_frames": n_frames,
        "n_seqs": torch.tensor(float(batch_size), device=loss.device),
    }


def param_digest(tensors: Iterable[torch.Tensor]) -> int:
  """A fingerprint of tensors' bits (e.g. `module.parameters()`): the sum
  over the tensors of their elements' bit patterns as integers, each
  weighted by its position modulo a prime, in int64 on the tensors'
  device. Any changed bit changes it (barring an exact cancellation); the
  order of the tensors does not."""
  as_int = {4: torch.int32, 2: torch.int16, 1: torch.int8}
  total = 0
  for p in tensors:
    bits = p.detach().contiguous().reshape(-1).view(
        as_int[p.element_size()]).to(torch.int64)
    weights = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
    total += int((bits * (weights + 1)).sum())
  return total


def new_student(student_experiment_, device) -> (
    diffusion_model.DiffusionModelBase):
  """A student network of `student_experiment_` allocated on `device`, in
  train mode and not yet initialized: `DistillModel` loads the teacher's
  weights into it (no random draw of 412M weights first)."""
  with torch.device(inference.resolve_device(device)):
    module = inference.network(student_experiment_)
  return inference.wrap(student_experiment_, module.train())


@dataclasses.dataclass
class DistillRound:
  """One halving round: teacher at N steps -> student at N//2."""
  teacher_steps: int

  @property
  def student_steps(self) -> int:
    return self.teacher_steps // 2


def student_experiment(teacher_experiment, student_steps: int):
  """Teacher config -> student config: half the steps, DDIM sampler,
  guidance folded in (weight 1 at sampling)."""
  d = teacher_experiment.diffusion
  return dataclasses.replace(
      teacher_experiment,
      diffusion=dataclasses.replace(
          d,
          guidance=dataclasses.replace(d.guidance,
                                       eval_condition_weight=1.0),
          sampler=dataclasses.replace(d.sampler, name="ddim",
                                      num_steps=student_steps)))
