"""The port's vocoder discriminators and GAN losses against the JAX
package's, at an odd and an even audio length.

Both sides get the same numpy-seeded audio and the same weights (the Flax
tree mapped by `convert.flax_convs_to_state_dict`, 1-d kernels WIO -> OIW,
2-d HWIO -> OIHW). Tolerance: every logit and feature within 2e-5 of its
array's largest magnitude (float32 convolutions summed in other orders;
the STFT's FFTs are other implementations), the losses within 1e-5
relative; the SAME paddings equal XLA's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.audio import (
    discriminators as jax_disc)
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.audio import discriminators

REL = 2e-5
LOSS_REL = 1e-5


def _close(got, want, rel=REL, what=""):
  want = np.asarray(want)
  got = np.asarray(got)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * np.abs(want).max() + 1e-7,
                             err_msg=what)


@pytest.mark.parametrize("n,k,s", [(n, k, s) for n in (1, 7, 8, 255, 256,
                                                        4001, 4096)
                                   for k, s in ((41, 4), (3, 2), (4, 2),
                                                (15, 1), (3, 1))])
def test_same_padding_matches_xla(n, k, s):
  want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
  assert discriminators.same_padding(n, k, s) == tuple(want)


def _audio(n, rows=2, seed=0):
  return (np.random.RandomState(seed).randn(rows, n) * 0.3).astype(
      np.float32)


@pytest.fixture(scope="module")
def ensemble():
  jm = jax_disc.VocoderDiscriminators()
  params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 2048)))["params"]
  # Nonzero biases, so their mapping is checked too.
  params = jax.tree.map(
      lambda p: p + 0.01 * jnp.sin(jnp.arange(p.size).reshape(p.shape)),
      params)
  module = discriminators.VocoderDiscriminators()
  module.load_state_dict(convert.flax_convs_to_state_dict(params, module))
  return jm, params, module


@pytest.mark.parametrize("n", [4001, 4096])
def test_ensemble_logits_and_features_match_jax(ensemble, n):
  jm, params, module = ensemble
  audio = _audio(n)
  want = jax.jit(jm.apply)({"params": params}, jnp.asarray(audio))
  with torch.no_grad():
    got = module(torch.from_numpy(audio))
  assert len(got) == len(want) == 4
  for i, ((gl, gf), (wl, wf)) in enumerate(zip(got, want)):
    _close(gl.numpy(), wl, what=f"logits {i}")
    assert len(gf) == len(wf)
    for j, (a, b) in enumerate(zip(gf, wf)):
      _close(a.numpy(), b, what=f"feature {i}.{j}")


@pytest.mark.parametrize("n", [4001, 4096])
def test_losses_match_jax(ensemble, n):
  jm, params, module = ensemble
  real, fake = _audio(n, seed=1), _audio(n, seed=2)
  apply = jax.jit(jm.apply)
  jr = apply({"params": params}, jnp.asarray(real))
  jf = apply({"params": params}, jnp.asarray(fake))
  with torch.no_grad():
    tr = module(torch.from_numpy(real))
    tf = module(torch.from_numpy(fake))
  for name in ("hinge_d_loss", "feature_matching_loss"):
    got = getattr(discriminators, name)(tr, tf).item()
    want = float(getattr(jax_disc, name)(jr, jf))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, err_msg=name)
  np.testing.assert_allclose(discriminators.hinge_g_loss(tf).item(),
                             float(jax_disc.hinge_g_loss(jf)),
                             rtol=LOSS_REL)


def test_parameter_names_and_shapes_match_flax(ensemble):
  _, params, module = ensemble
  flat = convert.flatten(params)
  assert len(flat) == len(module.state_dict())
  # The grouped strided convs: groups = out / 16, kernel 41.
  conv = module.waves.scale_0.Conv_2
  assert (conv.groups, conv.kernel_size, conv.stride) == (16, (41,), (4,))
  assert flat["waves/scale_0/Conv_2/kernel"].shape == (41, 4, 256)
  assert flat["stft/Conv_1/kernel"].shape == (3, 3, 32, 64)
