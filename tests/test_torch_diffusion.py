"""The port's diffusion math and samplers against tests/goldens/diffusion.npz
and the JAX package's `sample`, with JAX's noise replayed through the
port's noise provider. The toy denoisers are the ones of
tests/test_diffusion_ops.py. Tolerances: those of test_diffusion_ops.py
for the goldens (1e-5; 1e-4 relative for whole sampler runs); 1e-5 for
whole runs against JAX (float32 on both sides)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "diffusion.npz")


@pytest.fixture(scope="module")
def g():
  return dict(np.load(GOLDEN_PATH))


def _t(x):
  return torch.from_numpy(np.array(x))


def jax_noise(key) -> d.NoiseFn:
  """The draws JAX's sampler takes from `key` (one key, or [batch] keys)."""
  def draw(i, shape):
    step = None if i is None else jnp.asarray(i, jnp.int32)
    return _t(jd._normal_from_keys(key, step, tuple(shape), jnp.float32))
  return draw


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_logsnr(g, name):
  sched = (d.Schedule(name="cosine") if name == "cosine" else
           d.Schedule(name="linear", start=1e-4, stop=0.02, num_steps=1000))
  np.testing.assert_allclose(d.logsnr_at(_t(g["t"]), sched).numpy(),
                             g[f"logsnr_{name}"], rtol=1e-5, atol=1e-5)


def test_processes_and_conversions(g):
  x0, z = _t(g["x0"]), _t(g["z_t"])
  fwd = d.forward_process(x0, torch.full(x0.shape, -1.3))
  np.testing.assert_allclose(fwd["mean"].numpy(), g["fwd_mean"], rtol=1e-6)
  np.testing.assert_allclose(fwd["std"].numpy(), g["fwd_std"], rtol=1e-6)
  for lv, key in [("small", "small"), ("large", "large"),
                  ("medium:0.3", "medium_03")]:
    rev = d.reverse_process(x0, z, torch.full(x0.shape, 0.7),
                            torch.full(x0.shape, -1.3), lv)
    np.testing.assert_allclose(rev["mean"].numpy(), g[f"rev_mean_{key}"],
                               rtol=1e-5)
    np.testing.assert_allclose(rev["std"].numpy(), g[f"rev_std_{key}"],
                               rtol=1e-5)
  logsnr = _t(g["logsnr_vec"])
  for fn in ("eps_from_x0", "x0_from_eps", "x0_from_v"):
    np.testing.assert_allclose(getattr(d, fn)(z, x0, logsnr).numpy(), g[fn],
                               rtol=1e-5)


def test_timing_embedding(g):
  got = d.timing_embedding(_t(g["timing_pos"]), 16, max_timescale=2.0e4)
  np.testing.assert_allclose(got.numpy(), g["timing"], rtol=1e-5, atol=1e-6)


def _cfg(name, steps=8, interval=None, model_output="eps"):
  return d.DiffusionConfig(
      model_output=model_output,
      guidance=d.GuidanceConfig(interval=interval),
      sampler=d.SamplerConfig(name=name, schedule=d.Schedule(name="cosine"),
                              num_steps=steps))


def _jax_cfg(cfg):
  g = cfg.guidance
  return jd.DiffusionConfig(
      model_output=cfg.model_output,
      guidance=jd.GuidanceConfig(interval=g.interval),
      sampler=jd.SamplerConfig(name=cfg.sampler.name,
                               schedule=jd.Schedule(name="cosine"),
                               num_steps=cfg.sampler.num_steps))


def _toy_pair(z, time):
  """The conditional and unconditional toy networks of the goldens."""
  del time
  return 0.9 * z + 0.05, 0.45 * z + 0.05


@pytest.mark.parametrize("name", ["ddpm", "ddim"])
def test_sampler_matches_reference_goldens(g, name):
  got = d.sample(jax_noise(jax.random.PRNGKey(3)), (2, 8, 4), _cfg(name),
                 denoise_pair_fn=_toy_pair, device="cpu")
  np.testing.assert_allclose(got.numpy(), g[f"sample_{name}"], rtol=1e-4,
                             atol=1e-5)


CASES = {
    # name: (sampler, steps, interval, batch, per-row keys)
    "sde_dpm_interval": ("sde-dpm++", 20, (0.1, 0.8), 2, True),
    "sde_dpm_no_interval": ("sde-dpm++", 12, None, 1, False),
    "sde_dpm_interval_batch4": ("sde-dpm++", 10, (0.1, 0.8), 4, True),
    "dpm_interval": ("dpm++", 10, (0.25, 0.75), 2, False),
    "ddpm_interval": ("ddpm", 16, (0.1, 0.8), 2, True),
    "ddim": ("ddim", 8, None, 2, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_matches_jax(case):
  name, steps, interval, batch, per_row = CASES[case]
  cfg = _cfg(name, steps, interval)
  shape = (batch, 6, 4)
  key = jax.random.PRNGKey(7)
  if per_row:
    key = jax.random.split(key, batch)

  # A toy network with a time dependence, identical in both frameworks.
  def jax_pair(z, tm):
    s = jd.bcast_left(tm, z.shape)
    return (0.9 - 0.3 * s) * z + 0.05, (0.45 + 0.1 * s) * z - 0.02

  def torch_pair(z, tm):
    s = d.bcast_left(tm, z.shape)
    return (0.9 - 0.3 * s) * z + 0.05, (0.45 + 0.1 * s) * z - 0.02

  want = jd.sample(key, shape, _jax_cfg(cfg), denoise_pair_fn=jax_pair,
                   denoise_cond_fn=lambda z, tm: jax_pair(z, tm)[0])
  calls = {"pair": 0, "cond": 0}

  def counted_pair(z, tm):
    calls["pair"] += 1
    return torch_pair(z, tm)

  def counted_cond(z, tm):
    calls["cond"] += 1
    return torch_pair(z, tm)[0]

  got = d.sample(jax_noise(key), shape, cfg, denoise_pair_fn=counted_pair,
                 denoise_cond_fn=counted_cond, device="cpu")
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  ts = (np.arange(steps, dtype=np.float32) + 1) / np.float32(steps)
  inside = (np.ones(steps, bool) if interval is None else
            (ts >= np.float32(interval[0])) & (ts <= np.float32(interval[1])))
  assert calls == {"pair": int(inside.sum()), "cond": int((~inside).sum())}


def test_generator_noise_rows_are_independent():
  def gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]
  both = d.generator_noise(gens([1, 2]), "cpu")
  alone = d.generator_noise(gens([2]), "cpu")
  for i in (None, 5, 4):
    np.testing.assert_array_equal(both(i, (2, 3, 4))[1].numpy(),
                                  alone(i, (1, 3, 4))[0].numpy())
