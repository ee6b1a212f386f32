"""The port's one-program sampler: `sampler_step` and
`multistep_sampler_step` against the JAX package's functions of the same
name, and the table-driven loop that CUDA graphs replay against the
per-step loop it replaced, on the CPU at tiny size.

* A step against JAX's, on the same z (and previous x0), step index and
  draw (JAX's `_normal_from_keys` at that index, put into the port's noise
  table): every sampler, with and without the guidance interval, first,
  middle and last steps; atol 1e-5 (float32 on both sides).
* `sample` against `eager_loop_reference`, a copy of the per-step loop the
  port ran before (each step's times from `torch.full`, its draw from the
  provider, its branches on the Python step index), with seeded per-row
  generators: `torch.equal`, since the same operations run on the same
  values. The same holds for a model's `predict`.
* The noise table holds the values that the per-step loop's calls draw, in
  their order.
* Captured steps are asked for on the CPU: every entry point raises.
* `cuda`: on the card, a captured `sample` equals the eager one bit for
  bit, each kind of step captured once and replayed for the others. JAX is
  imported only by the tests that compare with it, so that this one also
  runs where JAX is not installed (`pytest --noconftest -m cuda`).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d
from music_spectrogram_diffusion_tpu_torch.ops import graphs

ATOL = 1e-5
STEPS = 10
SHAPE = (2, 6, 4)


def _cfg(name, steps=STEPS, interval=None, weight=5.0, schedule=None):
  return d.DiffusionConfig(
      guidance=d.GuidanceConfig(eval_condition_weight=weight,
                                interval=interval),
      sampler=d.SamplerConfig(name=name,
                              schedule=schedule or d.Schedule(name="cosine"),
                              num_steps=steps))


def _jax_cfg(cfg):
  from music_spectrogram_diffusion_tpu.ops import diffusion as jd
  g = cfg.guidance
  return jd.DiffusionConfig(
      guidance=jd.GuidanceConfig(eval_condition_weight=g.eval_condition_weight,
                                 interval=g.interval),
      sampler=jd.SamplerConfig(name=cfg.sampler.name,
                               schedule=jd.Schedule(name="cosine"),
                               num_steps=cfg.sampler.num_steps))


def torch_pair(z, tm):
  """A toy network with a time dependence (tests/test_torch_diffusion.py's)."""
  s = d.bcast_left(tm, z.shape)
  return (0.9 - 0.3 * s) * z + 0.05, (0.45 + 0.1 * s) * z - 0.02


def jax_pair(z, tm):
  from music_spectrogram_diffusion_tpu.ops import diffusion as jd
  s = jd.bcast_left(tm, z.shape)
  return (0.9 - 0.3 * s) * z + 0.05, (0.45 + 0.1 * s) * z - 0.02


def _inputs(seed):
  r = np.random.RandomState(seed)
  return (r.randn(*SHAPE).astype(np.float32),
          np.clip(r.randn(*SHAPE), -1, 1).astype(np.float32))


def _state_with_jax_draw(cfg, key, i):
  """A port SamplerState whose noise row i is JAX's draw for step i."""
  import jax.numpy as jnp
  from music_spectrogram_diffusion_tpu.ops import diffusion as jd
  state = d.SamplerState(SHAPE, cfg, "cpu")
  if state.noise is not None:
    state.noise[i] = torch.from_numpy(np.array(jd._normal_from_keys(
        key, jnp.asarray(i, jnp.int32), SHAPE, jnp.float32)))
  return state


# (interval, step i): the first step (t = 1, outside [0.1, 0.8]), steps
# outside and inside the interval, and the last (t = 0.1, inside).
STEP_CASES = [(None, 9), (None, 4), (None, 0), ((0.1, 0.8), 9),
              ((0.1, 0.8), 8), ((0.1, 0.8), 5), ((0.1, 0.8), 1),
              ((0.1, 0.8), 0)]


@pytest.mark.parametrize("name", ["ddpm", "ddim"])
@pytest.mark.parametrize("interval,i", STEP_CASES)
def test_sampler_step_matches_jax(name, interval, i):
  import jax
  import jax.numpy as jnp
  from music_spectrogram_diffusion_tpu.ops import diffusion as jd
  cfg = _cfg(name, interval=interval)
  key = jax.random.PRNGKey(11)
  z, _ = _inputs(i)
  want = jd.sampler_step(jnp.asarray(z), jnp.asarray(i), rng=key,
                         config=_jax_cfg(cfg), denoise_pair_fn=jax_pair,
                         denoise_cond_fn=lambda z, tm: jax_pair(z, tm)[0])
  got = d.sampler_step(
      torch.from_numpy(z), torch.tensor([i]), d.step_kind(i, cfg),
      _state_with_jax_draw(cfg, key, i), config=cfg,
      denoise_pair_fn=torch_pair,
      denoise_cond_fn=lambda z, tm: torch_pair(z, tm)[0])
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=ATOL)


@pytest.mark.parametrize("name", ["dpm++", "sde-dpm++"])
@pytest.mark.parametrize("interval,i", STEP_CASES)
def test_multistep_sampler_step_matches_jax(name, interval, i):
  import jax
  import jax.numpy as jnp
  from music_spectrogram_diffusion_tpu.ops import diffusion as jd
  cfg = _cfg(name, interval=interval)
  key = jax.random.split(jax.random.PRNGKey(12), SHAPE[0])  # per-row keys
  z, prev_x0 = _inputs(100 + i)
  want = jd.multistep_sampler_step(
      jnp.asarray(z), jnp.asarray(prev_x0), jnp.asarray(i), rng=key,
      config=_jax_cfg(cfg), denoise_pair_fn=jax_pair,
      denoise_cond_fn=lambda z, tm: jax_pair(z, tm)[0])
  got = d.multistep_sampler_step(
      torch.from_numpy(z), torch.from_numpy(prev_x0), torch.tensor([i]),
      d.step_kind(i, cfg), _state_with_jax_draw(cfg, key, i), config=cfg,
      denoise_pair_fn=torch_pair,
      denoise_cond_fn=lambda z, tm: torch_pair(z, tm)[0])
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# The per-step loop the port ran before the table-driven one, kept as the
# reference: every value comes from the step index on the host.
# ---------------------------------------------------------------------------


def _ref_step_times(i, num_steps, batch, schedule):
  t = torch.full((batch,), d._f32_ratio(i + 1.0, num_steps))
  s = torch.full((batch,), d._f32_ratio(i, num_steps))
  return t, d.logsnr_at(s, schedule), d.logsnr_at(t, schedule)


def _ref_predict_x0_eps(z_t, i, cfg, pair_fn, cond_fn):
  sampler = cfg.sampler
  time, logsnr_s, logsnr_t = _ref_step_times(i, sampler.num_steps,
                                             z_t.shape[0], sampler.schedule)
  cond_wt = cfg.guidance.eval_condition_weight
  if cond_wt != 1.0:
    interval = cfg.guidance.interval
    t = np.float32(d._f32_ratio(i + 1.0, sampler.num_steps))
    if interval is None or (np.float32(interval[0]) <= t
                            <= np.float32(interval[1])):
      cond_out, uncond_out = pair_fn(z_t, time)
    else:
      if cond_fn is not None:
        cond_out = cond_fn(z_t, time)
      else:
        cond_out, _ = pair_fn(z_t, time)
      uncond_out = cond_out
    cond = d.x0_eps_from_model_output(z_t, time, cond_out, cfg)
    uncond = d.x0_eps_from_model_output(z_t, time, uncond_out, cfg)
    pred_eps = cond_wt * cond["eps"] + (1.0 - cond_wt) * uncond["eps"]
    pred_x0 = d.x0_from_eps(z_t, pred_eps, logsnr_t)
  else:
    out, _ = pair_fn(z_t, time)
    outputs = d.x0_eps_from_model_output(z_t, time, out, cfg)
    pred_eps, pred_x0 = outputs["eps"], outputs["x0"]
  if sampler.clip_x0:
    pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    pred_eps = d.eps_from_x0(z_t, pred_x0, logsnr_t)
  return pred_x0, pred_eps, logsnr_s, logsnr_t


def _ref_dpm_update(i, noise, logsnr_s, logsnr_t, logsnr_t_prev, pred_x0,
                    prev_x0, z_t, num_steps, stochastic):
  if i == 0:
    return pred_x0
  shape = pred_x0.shape
  lam_s = d.bcast_left(logsnr_s, shape) * 0.5
  lam_t = d.bcast_left(logsnr_t, shape) * 0.5
  lam_p = d.bcast_left(logsnr_t_prev, shape) * 0.5
  h = lam_s - lam_t
  if i >= num_steps - 1:
    dd = pred_x0
  else:
    r = (lam_t - lam_p) / torch.clamp(h, min=1e-12)
    dd = pred_x0 + (1.0 / (2.0 * r)) * (pred_x0 - prev_x0)
  logsnr_s_b = d.bcast_left(logsnr_s, shape)
  logsnr_t_b = d.bcast_left(logsnr_t, shape)
  alpha_s = torch.sqrt(torch.sigmoid(logsnr_s_b))
  sigma_ratio = torch.exp(0.5 * (F.logsigmoid(-logsnr_s_b) -
                                 F.logsigmoid(-logsnr_t_b)))
  if stochastic:
    sigma_s = torch.sqrt(torch.sigmoid(-logsnr_s_b))
    one_minus_e2h = -torch.expm1(-2.0 * h)
    return (sigma_ratio * torch.exp(-h) * z_t + alpha_s * one_minus_e2h * dd
            + sigma_s * torch.sqrt(one_minus_e2h) * noise(i, tuple(shape)))
  return sigma_ratio * z_t - alpha_s * torch.expm1(-h) * dd


def eager_loop_reference(noise, shape, cfg, pair_fn, cond_fn=None):
  sampler = cfg.sampler
  n = sampler.num_steps
  z = noise(None, tuple(shape)).to(dtype=torch.float32)
  prev_x0 = torch.zeros_like(z)
  for i in reversed(range(n)):
    pred_x0, pred_eps, logsnr_s, logsnr_t = _ref_predict_x0_eps(
        z, i, cfg, pair_fn, cond_fn)
    if sampler.name in d.MULTISTEP_SAMPLERS:
      t_prev = torch.full((z.shape[0],), min(d._f32_ratio(i + 2.0, n), 1.0))
      z = _ref_dpm_update(i, noise, logsnr_s, logsnr_t,
                          d.logsnr_at(t_prev, sampler.schedule), pred_x0,
                          prev_x0, z, n, sampler.name == "sde-dpm++")
      prev_x0 = pred_x0
    elif sampler.name == "ddim":
      if i == 0:
        z = pred_x0
      else:
        ls = d.bcast_left(logsnr_s, pred_x0.shape)
        z = (torch.sqrt(torch.sigmoid(ls)) * pred_x0 +
             torch.sqrt(torch.sigmoid(-ls)) * pred_eps)
    elif sampler.name == "ddpm":
      if i == 0:
        z = pred_x0
      else:
        dist = d.reverse_process(
            pred_x0, z, d.bcast_left(logsnr_s, pred_x0.shape),
            d.bcast_left(logsnr_t, pred_x0.shape), sampler.logvar_type)
        z = dist["mean"] + dist["std"] * noise(i, tuple(pred_x0.shape))
  return z


def _noise(seed, rows=SHAPE[0]):
  return d.generator_noise(
      [torch.Generator().manual_seed(seed + r) for r in range(rows)], "cpu")


LINEAR = d.Schedule(name="linear", start=1e-4, stop=0.02, num_steps=1000)
LOOP_CASES = {
    "ddpm": dict(name="ddpm"),
    "ddpm_interval": dict(name="ddpm", interval=(0.1, 0.8)),
    "ddpm_linear_schedule": dict(name="ddpm", schedule=LINEAR),
    "ddim": dict(name="ddim"),
    "ddim_interval": dict(name="ddim", interval=(0.25, 0.75)),
    "dpm": dict(name="dpm++"),
    "dpm_interval": dict(name="dpm++", interval=(0.1, 0.8)),
    "sde_dpm": dict(name="sde-dpm++"),
    "sde_dpm_interval": dict(name="sde-dpm++", interval=(0.1, 0.8)),
    "sde_dpm_no_guidance": dict(name="sde-dpm++", weight=1.0),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
@pytest.mark.parametrize("with_cond_fn", [True, False])
def test_table_driven_sample_equals_the_eager_loop(case, with_cond_fn):
  cfg = _cfg(steps=12, **LOOP_CASES[case])
  cond_fn = (lambda z, tm: torch_pair(z, tm)[0]) if with_cond_fn else None
  want = eager_loop_reference(_noise(5), SHAPE, cfg, torch_pair, cond_fn)
  got = d.sample(_noise(5), SHAPE, cfg, denoise_pair_fn=torch_pair,
                 denoise_cond_fn=cond_fn, device="cpu")
  assert torch.equal(got, want)


@pytest.mark.parametrize("name", d.SAMPLERS)
def test_noise_table_holds_the_eager_loops_draws(name):
  cfg = _cfg(name, steps=7)
  calls = []
  draw = _noise(9)

  def recorded(i, shape):
    calls.append((i, shape))
    return draw(i, shape)

  state = d.SamplerState(SHAPE, cfg, "cpu")
  state.start(recorded)
  again = _noise(9)
  assert torch.equal(state.z, again(None, SHAPE))
  if name in d.STOCHASTIC_SAMPLERS:
    assert calls == [(None, SHAPE)] + [(i, SHAPE) for i in range(6, 0, -1)]
    for i in range(6, 0, -1):
      assert torch.equal(state.noise[i], again(i, SHAPE))
    assert not state.noise[0].any()  # step 0 returns pred_x0, draws none
  else:
    assert calls == [(None, SHAPE)] and state.noise is None
  assert state.index.tolist() == [6] and not state.prev_x0.any()


@pytest.mark.parametrize("name", d.SAMPLERS)
def test_step_kinds(name):
  """The serving sampler's 100 steps with CFG on [0.1, 0.8]: 71 pair and 29
  conditional steps, the first order only at the first multistep step,
  pred_x0 returned at step 0."""
  cfg = _cfg(name, steps=100, interval=(0.1, 0.8))
  kinds = [d.step_kind(i, cfg) for i in range(100)]
  assert sum(k.pair for k in kinds) == 71
  assert [i for i, k in enumerate(kinds) if k.first] == (
      [99] if name in d.MULTISTEP_SAMPLERS else [])
  assert [i for i, k in enumerate(kinds) if k.last] == [0]
  assert all(d.step_kind(i, _cfg(name, steps=100)).pair for i in range(100))


@pytest.mark.parametrize("preset", ["context_tiny", "diffusion_tiny"])
def test_model_predict_equals_the_eager_loop(preset):
  """A model's predict on the CPU (the same steps a captured render
  replays) equals the per-step loop over the model's own forwards."""
  experiment = inference.with_sampler(config.preset(preset),
                                      sampler_steps=6,
                                      sampler_name="sde-dpm++",
                                      guidance_interval=(0.1, 0.8))
  model = inference.InferenceModel(experiment, device="cpu").model
  lengths = experiment.task_lengths
  tokens = torch.zeros(2, lengths.inputs, dtype=torch.int64)
  tokens[:, :7] = torch.arange(1, 8)
  batch = {"encoder_input_tokens": tokens,
           "decoder_target_tokens": torch.zeros(2, lengths.targets, 128)}
  if model.USES_CONTEXT:
    batch["encoder_continuous_inputs"] = torch.randn(
        2, lengths.targets_context, 128,
        generator=torch.Generator().manual_seed(3))
    batch["encoder_continuous_mask"] = torch.ones(2, lengths.targets_context,
                                                  dtype=torch.bool)
  got = model.predict(batch, _noise(21))
  with torch.inference_mode():
    encodings = model.encode(batch)
    fns = model._denoisers(encodings,
                           model.module.precompute_cross_kv(encodings), 2)
    want = eager_loop_reference(_noise(21), tuple(
        batch["decoder_target_tokens"].shape), model.diffusion_config,
                                fns["denoise_pair_fn"],
                                fns["denoise_cond_fn"])
  assert torch.equal(got, model.audio_codec.scale_to_features(want))


def _tiny(preset):
  return inference.InferenceModel(config.preset(preset), device="cpu")


CPU_REQUESTS = {
    "sample": lambda: d.sample(_noise(1), SHAPE, _cfg("ddim"),
                               denoise_pair_fn=torch_pair, device="cpu",
                               graphs=True),
    "step_graphs": lambda: graphs.StepGraphs("cpu"),
    "use_graphs": lambda: graphs.use_graphs("cpu", True),
    "diffusion_predict": lambda: _tiny("diffusion_tiny").predict(
        {"encoder_input_tokens": np.ones((1, 32), np.int64),
         "decoder_target_tokens": np.zeros((1, 4, 128), np.float32)},
        graphs=True),
    "ar_render": lambda: _tiny("ar_tiny").synthesizer().render_song(
        [np.arange(1, 6)], vocode=False, graphs=True),
}


@pytest.mark.parametrize("request_", sorted(CPU_REQUESTS))
def test_graphs_asked_for_on_the_cpu_raise(request_):
  with pytest.raises(ValueError, match="cuda"):
    CPU_REQUESTS[request_]()


def test_use_graphs_defaults_by_device():
  assert graphs.use_graphs("cpu", None) is False
  assert graphs.use_graphs("cpu", False) is False
  assert graphs.use_graphs("cuda", None) is True
  assert graphs.use_graphs("cuda", False) is False


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", d.SAMPLERS)
def test_captured_sample_equals_eager_on_card(cuda_device, name):
  cfg = _cfg(name, steps=20, interval=(0.1, 0.8))
  shape = (2, 256, 128)

  def noise():
    return d.generator_noise([torch.Generator(cuda_device).manual_seed(s)
                              for s in (1, 2)], cuda_device)

  def pair(z, tm):
    s = d.bcast_left(tm, z.shape)
    return torch.tanh((0.9 - 0.3 * s) * z), 0.45 * z - 0.02 * s

  eager = d.sample(noise(), shape, cfg, denoise_pair_fn=pair,
                   denoise_cond_fn=lambda z, tm: pair(z, tm)[0],
                   device=cuda_device, graphs=False)
  captured = d.sample(noise(), shape, cfg, denoise_pair_fn=pair,
                      denoise_cond_fn=lambda z, tm: pair(z, tm)[0],
                      device=cuda_device)
  torch.cuda.synchronize()
  assert torch.equal(captured, eager)
