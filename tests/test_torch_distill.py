"""The port's progressive distillation against the JAX package's, at tiny
size.

Both sides get the same numpy-seeded inputs and the same weights (the
Flax tree through `convert.flax_to_state_dict`); the loss's draws (the
student-grid time, then eps) are JAX's own, reproduced from its key and
handed to the port through its provider; dropout is off.

Tolerances: the two-step target 1e-6 (the same float32 formulas); its
consistency with two teacher half-steps 1e-4 (JAX's own test); the loss
and its metrics 1e-5 relative and each gradient 3e-4 of its leaf's
largest magnitude (tests/test_torch_train.py's, for the same network),
except for draws at t = 1 (see LOSS_CASES);
the teacher unchanged, and the student equal to it at the start, bit for
bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu.train import distill as jax_distill
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model, network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d
from music_spectrogram_diffusion_tpu_torch.train import distill, trainer

TARGET_TOL = 1e-6
LOSS_REL = 1e-5
GRAD_REL = 3e-4


def _denoise_pair():
  """A fixed nonlinear 'teacher' in both frameworks: x0 = 1.5 z / (1 + |z|)
  + 0.3 t, which leaves [-1, 1] so that clipping matters. (Correctly
  rounded operations only: XLA's float32 tanh is 2.4e-7 from the true one,
  which the first half-step's division by sigma_t amplifies.)"""
  def jax_fn(z, time):
    return 1.5 * z / (1 + jnp.abs(z)) + 0.3 * time[:, None, None]

  def torch_fn(z, time):
    return 1.5 * z / (1 + torch.abs(z)) + 0.3 * time[:, None, None]
  return jax_fn, torch_fn


# (student steps, times): the grid's top, middle and first step (t2 = 0);
# at 10^9 steps t - dt rounds back to t in float32, so the one-step solve's
# denominator is exactly 0 and the target falls back to the teacher's x0.
CASES = [(4, [1.0, 0.5, 0.25]), (1000, [0.001, 0.002, 0.5]),
         (10 ** 9, [0.5, 0.25, 1.0])]


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("steps,times", CASES)
def test_two_step_teacher_target_matches_jax(steps, times, clip):
  schedule_j, schedule_t = jd.Schedule(name="cosine"), d.Schedule(
      name="cosine")
  z = np.random.RandomState(0).randn(3, 8, 4).astype(np.float32)
  t = np.asarray(times, np.float32)
  jax_fn, torch_fn = _denoise_pair()
  want = jax_distill.two_step_teacher_target(
      jax_fn, jnp.asarray(z), jnp.asarray(t), steps, schedule_j,
      clip_x0=clip)
  got = distill.two_step_teacher_target(
      torch_fn, torch.from_numpy(z), torch.from_numpy(t), steps, schedule_t,
      clip_x0=clip)
  np.testing.assert_allclose(got.numpy(), np.asarray(want),
                             rtol=TARGET_TOL, atol=TARGET_TOL)
  if steps == 10 ** 9:
    # The fallback: the teacher's second x0, at t1 = t (float32).
    x0 = torch_fn(torch.from_numpy(z), torch.from_numpy(t))
    np.testing.assert_allclose(
        got.numpy(), (torch.clamp(x0, -1, 1) if clip else x0).numpy(),
        rtol=TARGET_TOL, atol=TARGET_TOL)


def test_two_step_target_consistency():
  """JAX's own case (tests/test_distill.py): one student DDIM step toward
  x̃ lands exactly where two teacher DDIM half-steps land."""
  schedule = d.Schedule(name="cosine")
  z_t = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 4).astype(
      np.float32))
  t = torch.tensor([1.0, 0.5])
  n_student = 4

  def denoise_x0(z, time):
    return torch.tanh(z) * 0.5

  x_tilde = distill.two_step_teacher_target(denoise_x0, z_t, t, n_student,
                                            schedule, clip_x0=False)

  def alpha_sigma(tt):
    logsnr = d.bcast_left(d.logsnr_at(tt, schedule), z_t.shape)
    return torch.sqrt(torch.sigmoid(logsnr)), torch.sqrt(
        torch.sigmoid(-logsnr))

  dt = 1.0 / n_student
  a_t, s_t = alpha_sigma(t)
  a_1, s_1 = alpha_sigma(t - 0.5 * dt)
  a_2, s_2 = alpha_sigma(t - dt)
  x0a = denoise_x0(z_t, t)
  z1 = a_1 * x0a + s_1 * (z_t - a_t * x0a) / s_t
  x0b = denoise_x0(z1, t - 0.5 * dt)
  z2 = a_2 * x0b + s_2 * (z1 - a_1 * x0b) / s_1
  z2_student = a_2 * x_tilde + s_2 * (z_t - a_t * x_tilde) / s_t
  np.testing.assert_allclose(z2_student.numpy(), z2.numpy(), rtol=1e-4,
                             atol=1e-4)


# ---------------------------------------------------------------------------
# The loss and its gradients against make_distill_loss_fn.
# ---------------------------------------------------------------------------

STUDENT_STEPS = 4


def _batch(rows=3):
  r = np.random.RandomState(0)
  batch = {
      "encoder_input_tokens": r.randint(1, 200, (rows, 24)).astype(np.int32),
      "encoder_continuous_inputs": (r.randn(rows, 16, 128) * 3 - 4).astype(
          np.float32),
      "encoder_continuous_mask": np.ones((rows, 16), bool),
      "decoder_target_tokens": (r.randn(rows, 16, 128) * 3 - 4).astype(
          np.float32),
      "decoder_target_mask": np.ones((rows, 16), bool),
  }
  batch["encoder_input_tokens"][1, 10:] = 0
  batch["encoder_continuous_mask"][0, 9:] = False
  batch["encoder_continuous_mask"][2] = False  # a song's first segment
  batch["decoder_target_mask"][2, 12:] = False
  return batch


def _net_cfg(framework):
  return framework.network_config("tiny", with_context=True, vocab_size=256,
                                  dropout_rate=0.0)


def _jax_models(batch):
  def build(steps):
    dcfg = jd.DiffusionConfig(sampler=jd.SamplerConfig(num_steps=steps))
    return jax_model.ContextDiffusionModel(
        jax_network.ContextTransformer(config=_net_cfg(jax_config)), dcfg,
        jax_codecs.MelGan())
  teacher, student = build(2 * STUDENT_STEPS), build(STUDENT_STEPS)
  params = jax.jit(lambda key: teacher.init_variables(
      key, {k: v.shape for k, v in batch.items()},
      {k: v.dtype for k, v in batch.items()}))(
          jax.random.PRNGKey(0))["params"]
  return teacher, student, params


def _port_model(steps, state=None):
  module = network.ContextTransformer(_net_cfg(config))
  if state is not None:
    module.load_state_dict(state)
  return model.ContextDiffusionModel(
      module, d.DiffusionConfig(sampler=d.SamplerConfig(num_steps=steps)),
      codecs.MelGan())


def _jax_draws(key, targets_shape):
  """JAX's loss draws for `key`: the time from the first of three keys,
  eps from the second."""
  rng_t, rng_eps, _ = jax.random.split(key, 3)
  idx = jax.random.randint(rng_t, (targets_shape[0],), 1, STUDENT_STEPS + 1)
  t = np.asarray(idx.astype(jnp.float32) / STUDENT_STEPS)
  eps = np.asarray(jax.random.normal(rng_eps, targets_shape))
  return lambda x0, n: (torch.from_numpy(t), torch.from_numpy(eps))


_JAX_STEPS = {}


def _jax_loss_and_grads(guidance, batch):
  """JAX's loss, metrics and gradients at a key, jitted once a guidance
  weight: (teacher params, student params, the function of the key)."""
  if guidance not in _JAX_STEPS:
    teacher, student, t_params = _jax_models(batch)
    # The student apart from its teacher, as after some distillation.
    s_params = jax.tree.map(
        lambda p: p * (1 + 0.05 * jnp.cos(jnp.arange(p.size).reshape(
            p.shape))), t_params)
    loss_fn = jax_distill.make_distill_loss_fn(
        student, teacher, STUDENT_STEPS, guidance_weight=guidance)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(lambda key: jax.value_and_grad(
        lambda p: loss_fn(p, jb, key, t_params), has_aux=True)(s_params))
    _JAX_STEPS[guidance] = t_params, s_params, step
  return _JAX_STEPS[guidance]


# (guidance weight, JAX key, whether its draws hold t = 1). Key 11 draws
# the times 1/4, 2/4, 2/4; key 7 draws 4/4, 3/4, 2/4. At t = 1 the eps ->
# x0 conversion multiplies by sqrt(1 + e^20) = 22026 what is left of
# z - sigma eps, in JAX as in the port, so float32 rounding in the
# network's sums is amplified 2e4-fold there: that row's gradients are
# held to GRAD_RMS_AT_T1 relative RMS per leaf and GRAD_MAX_AT_T1 of the
# largest (measured 4e-4 of the largest), the others to GRAD_REL.
LOSS_CASES = [(5.0, 11, False), (1.0, 11, False), (5.0, 7, True)]
GRAD_RMS_AT_T1 = 3e-4
GRAD_MAX_AT_T1 = 2e-3


@pytest.mark.parametrize("guidance,key,top", LOSS_CASES)
def test_distill_loss_and_gradients_match_jax(guidance, key, top):
  batch = _batch()
  t_params, s_params, jax_step = _jax_loss_and_grads(guidance, batch)
  key = jax.random.PRNGKey(key)
  (loss, metrics), grads = jax_step(key)
  t_draws = np.asarray(_jax_draws(key, (3, 1))(None, None)[0])
  assert (t_draws == 1.0).any() == top

  teacher_m = _port_model(2 * STUDENT_STEPS)
  teacher_m.module.load_state_dict(convert.flax_to_state_dict(
      t_params, teacher_m.module))
  student_m = _port_model(STUDENT_STEPS)
  dm = distill.DistillModel(student_m, teacher_m, STUDENT_STEPS,
                            guidance_weight=guidance)
  dm.module.load_state_dict(convert.flax_to_state_dict(s_params, dm.module))
  targets_shape = batch["decoder_target_tokens"].shape
  t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
  got, got_metrics = dm.loss_fn(t_batch, _jax_draws(key, targets_shape))
  assert got_metrics["loss"] is got
  got.backward()
  np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_REL)
  assert set(got_metrics) == set(metrics)
  for k, v in metrics.items():
    np.testing.assert_allclose(got_metrics[k].item(), float(v),
                               rtol=LOSS_REL, err_msg=k)
  named = dict(dm.module.named_parameters())
  flat = convert.flatten(jax.tree.map(np.asarray, grads))
  assert {convert.torch_name(k) for k in flat} == set(named)
  for path, want in flat.items():
    p = named[convert.torch_name(path)]
    got_g = (p.grad.numpy() if p.requires_grad
             else np.zeros(tuple(p.shape), np.float32))  # a fixed table
    want = np.asarray(want).reshape(got_g.shape)
    if not top:
      np.testing.assert_allclose(got_g, want, rtol=0,
                                 atol=GRAD_REL * np.abs(want).max() + 1e-8,
                                 err_msg=path)
      continue
    err = got_g - want
    assert (np.sqrt(np.mean(err ** 2)) <= GRAD_RMS_AT_T1 * np.sqrt(
        np.mean(want ** 2)) + 1e-8), path
    assert np.abs(err).max() <= GRAD_MAX_AT_T1 * np.abs(want).max() + 1e-8, (
        path)
  # The teacher took no gradient.
  assert all(p.grad is None for p in teacher_m.module.parameters())


def test_teacher_forwards_single_at_weight_one_and_paired_otherwise():
  batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
  for weight, rows in ((1.0, 3), (5.0, 6)):
    teacher = _port_model(2 * STUDENT_STEPS, network.ContextTransformer(
        _net_cfg(config)).init_weights(
            torch.Generator().manual_seed(0)).state_dict())
    dm = distill.DistillModel(_port_model(STUDENT_STEPS), teacher,
                              STUDENT_STEPS, guidance_weight=weight)
    seen = []
    decode = teacher.module.decode
    teacher.module.decode = lambda enc, z, *a, **k: (
        seen.append((z.shape[0], k.get("cond_rows"))) or decode(
            enc, z, *a, **k))
    z = torch.randn(3, 16, 128, generator=torch.Generator().manual_seed(1))
    dm.teacher_target(batch, z, torch.tensor([0.5, 0.75, 1.0]))
    assert seen == [(rows, None if weight == 1.0 else 3)] * 2


def _tiny_experiment():
  return dataclasses.replace(
      config.preset("context_tiny"),
      train=dataclasses.replace(config.preset("context_tiny").train,
                                learning_rate=1e-3, warmup_steps=1))


def test_student_starts_as_the_teacher_and_the_teacher_stays():
  experiment = _tiny_experiment()
  teacher = trainer.build_model(experiment, seed=0, device="cpu")
  before = {n: t.clone() for n, t in teacher.module.state_dict().items()}
  student_exp = distill.student_experiment(experiment, 500)
  dm = distill.DistillModel(distill.new_student(student_exp, "cpu"), teacher,
                            500)
  for name, t in dm.module.state_dict().items():
    assert torch.equal(t, before[name]), name
  t = trainer.Trainer(dm, student_exp.train)
  assert set(t.params) == {n for n, p in dm.module.named_parameters()
                           if p.requires_grad}
  assert not any(p.requires_grad for p in teacher.module.parameters())
  digest = distill.param_digest(teacher.module.parameters())
  batch = _batch()  # short lengths: the network takes any up to its own
  state = t.create_state()
  for _ in range(3):
    state, metrics = t.train_step(state, batch, seed=0)
    assert np.isfinite(metrics["loss"].item())
  assert state.step == 3
  moved = [n for n, v in dm.module.state_dict().items()
           if not torch.equal(v, before[n])]
  assert moved
  for name, v in teacher.module.state_dict().items():
    assert torch.equal(v, before[name]), name
  assert distill.param_digest(teacher.module.parameters()) == digest
  # The eval pass takes the same draws provider (no dropout).
  assert np.isfinite(t.eval_step(batch)["loss"].item())
  # A student that shares its teacher's storage is refused.
  with pytest.raises(ValueError, match="shares storage"):
    distill.DistillModel(teacher, teacher, 500)


def test_param_digest_sees_one_bit():
  module = network.ContextTransformer(_net_cfg(config)).init_weights(
      torch.Generator().manual_seed(0))
  digest = distill.param_digest(module.parameters())
  with torch.no_grad():
    p = next(module.parameters())
    bits = p.view(-1).view(torch.int32)
    bits[5] ^= 1
  assert distill.param_digest(module.parameters()) != digest


def test_student_experiment_matches_jax_field_by_field():
  for name in ("context_tiny", "context_base", "diffusion_small"):
    ours = distill.student_experiment(config.preset(name), 500)
    theirs = jax_distill.student_experiment(jax_config.preset(name), 500)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert ours.diffusion.sampler.name == "ddim"
    assert ours.diffusion.sampler.num_steps == 500
    assert ours.diffusion.guidance.eval_condition_weight == 1.0
  assert distill.DistillRound(1000).student_steps == 500


def test_generator_draws_are_on_the_student_grid():
  draw = distill.generator_draws(torch.Generator().manual_seed(0))
  t, eps = draw(torch.zeros(4000, 3, 2), 8)
  assert eps.shape == (4000, 3, 2) and t.shape == (4000,)
  assert set((t * 8).round().int().tolist()) == set(range(1, 9))
  again = distill.generator_draws(torch.Generator().manual_seed(0))(
      torch.zeros(4000, 3, 2), 8)
  assert torch.equal(t, again[0]) and torch.equal(eps, again[1])
