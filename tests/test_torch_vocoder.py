"""The port's vocoders against the JAX package's, on the CPU.

* MagnitudeNet / HybridGLVocoder at hidden 16 on random weights, and at
  full width (hidden 512) on the repo's trained weights, the committed
  export `assets/magnitude_gl_step4000.npz`: the net's magnitude, the
  mel-consistency projection, PGHI from JAX's magnitude bit for bit, and
  the fast Griffin-Lim audio from the same initial phase.
* `load_trained` on exports of both arches, and its refusal of an orbax
  directory.
* SoundStreamDecoder at base 32 with the real strides (8, 5, 4, 2) on
  random weights, and its transposed-conv padding against lax's.
* GriffinLimVocoder's phase_init and momentum.

Tolerances. Magnitudes: 1e-5 of the max (float32 convs and matmuls in two
libraries, sums in other orders; measured at most 7.4e-7). Audio: 1e-3 of
the peak from the second frame on, as tests/test_torch_stft.py holds
Griffin-Lim (the first frame's window-envelope division scales float error
by up to 1e4; measured at most 3.7e-4, from a zero start). SoundStream:
1e-4 absolute on its tanh output (measured at most 2.2e-6).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.audio import vocoder as jax_vocoder
from music_spectrogram_diffusion_tpu.ops import stft as jax_stft
from music_spectrogram_diffusion_tpu.train import checkpoints as jax_ckpt
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.data import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(frame_length=640, frame_step=320, fft_length=1024)
MAG_REL = 1e-5
AUDIO_REL = 1e-3
SOUNDSTREAM_ATOL = 1e-4


def export_tool():
  path = os.path.join(ROOT, "tools", "export_jax_checkpoint.py")
  spec = importlib.util.spec_from_file_location("export_jax_checkpoint",
                                                path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _log_mel(frames, seed=0):
  """A synthetic clip's log-mel [1, frames, 128] (the eval CLI's source)."""
  rng = np.random.RandomState(seed)
  seconds = frames * 320 / 16000
  ns = synthetic.random_note_sequence(rng, duration=seconds + 1.0)
  audio = synthetic.render_note_sequence(ns, 16000, duration=seconds + 1.0)
  return codecs.MelGan().encode_np(audio[None, :frames * 320])


def _perturbed(variables, scale=0.05):
  """Random weights away from init (the zero-init head makes the net the
  pinv exactly)."""
  leaves, tree = jax.tree.flatten(variables)
  keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
  return jax.tree.unflatten(tree, [
      np.asarray(x + scale * jax.random.normal(k, x.shape))
      for x, k in zip(leaves, keys)])


def _close(got, want, rel):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _close_audio(got, want):
  _close(np.asarray(got)[..., KW["frame_length"]:],
         np.asarray(want)[..., KW["frame_length"]:], AUDIO_REL)


def _hybrid_matches(variables, hidden, log_mel, num_iters=4):
  theirs_raw = jax_vocoder.HybridGLVocoder(
      variables, hidden=hidden, num_iters=num_iters, mel_consistency=False)
  theirs = jax_vocoder.HybridGLVocoder(variables, hidden=hidden,
                                       num_iters=num_iters)
  state = convert.flax_convs_to_state_dict(
      variables["params"], vocoder.MagnitudeNet(hidden=hidden))
  ours_raw = vocoder.HybridGLVocoder(state, hidden=hidden,
                                     num_iters=num_iters,
                                     mel_consistency=False, device="cpu")
  ours = vocoder.HybridGLVocoder(state, hidden=hidden, num_iters=num_iters,
                                 device="cpu")
  x = torch.from_numpy(log_mel)
  raw = np.array(theirs_raw._apply(variables, jnp.asarray(log_mel)))
  _close(ours_raw.magnitude(x).numpy(), raw, MAG_REL)
  mag = np.array(theirs._apply(variables, jnp.asarray(log_mel)))
  _close(ours.magnitude(x).numpy(), mag, MAG_REL)
  assert not np.allclose(raw, mag)  # the projection moved it
  init = ours.initial_phase(torch.from_numpy(mag))
  np.testing.assert_array_equal(init.numpy(),
                                jax_stft.pghi_phase(mag, **KW))
  want = theirs._gl(jnp.asarray(mag), init_phase=jnp.asarray(init.numpy()))
  got = ours.griffin_lim(torch.from_numpy(mag), init)
  _close_audio(got, want)
  audio = ours(x)
  assert tuple(audio.shape) == (1, log_mel.shape[1] * 320)
  assert bool(torch.isfinite(audio).all())
  return ours


def test_magnitude_net_and_hybrid_match_jax_random_weights():
  log_mel = _log_mel(24)
  net = jax_vocoder.MagnitudeNet(hidden=16)
  variables = _perturbed(net.init(jax.random.PRNGKey(0),
                                  jnp.asarray(log_mel)))
  ours = _hybrid_matches(variables, 16, log_mel)
  assert ours.momentum == 0.9 and ours.num_iters == 4
  assert ours.phase_init == "pghi"


@pytest.fixture(scope="module")
def trained_export():
  params, config_json, step = convert.read_export(
      vocoder.TRAINED_MAGNITUDE_GL)
  return params, json.loads(config_json), step


def test_trained_vocoder_full_width_matches_jax(trained_export):
  params, cfg, step = trained_export
  assert cfg == {"arch": "magnitude_gl", "hidden": 512} and step == 4000
  variables = jax.tree.map(np.asarray, params)
  _hybrid_matches(variables, 512, _log_mel(40, seed=3))


def test_load_trained_serves_the_committed_export(trained_export):
  voc = vocoder.load_trained(vocoder.TRAINED_MAGNITUDE_GL, device="cpu")
  assert isinstance(voc, vocoder.HybridGLVocoder)
  assert voc.net.hidden == 512 and voc.num_iters == 32
  assert voc.momentum == 0.9 and voc.phase_init == "pghi"
  assert tuple(voc.net.conv_in.weight.shape) == (512, 128, 5)
  kernel = trained_export[0]["params"]["conv_mid"]["kernel"]
  assert torch.equal(voc.net.conv_mid.weight,
                     convert.conv_weight(kernel))
  audio = voc(torch.from_numpy(_log_mel(8)))
  assert tuple(audio.shape) == (1, 8 * 320)


def _jax_magnitude_gl_checkpoint(model_dir, hidden=16):
  net = jax_vocoder.MagnitudeNet(hidden=hidden)
  variables = _perturbed(net.init(jax.random.PRNGKey(2),
                                  jnp.zeros((1, 8, 128))))
  jax_ckpt.save_checkpoint(model_dir, 3, variables, config_json=json.dumps(
      {"arch": "magnitude_gl", "hidden": hidden}))
  return variables


def _jax_soundstream_checkpoint(model_dir, base=16):
  dec = jax_vocoder.SoundStreamDecoder(
      config=jax_vocoder.SoundStreamConfig(base_channels=base))
  variables = _perturbed(dec.init(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 4, 128))), 0.02)
  jax_ckpt.save_checkpoint(model_dir, 7, variables)  # no config: soundstream
  return variables


def test_load_trained_routes_both_arches(tmp_path):
  tool = export_tool()
  log_mel = _log_mel(6) * 0.1
  mag_dir = str(tmp_path / "magnet")
  _jax_magnitude_gl_checkpoint(mag_dir)
  tool.export(mag_dir, str(tmp_path / "magnet.npz"))
  voc = vocoder.load_trained(str(tmp_path / "magnet.npz"), num_iters=2,
                             device="cpu")
  assert isinstance(voc, vocoder.HybridGLVocoder) and voc.net.hidden == 16
  want = jax_vocoder.load_trained(mag_dir, num_iters=2)
  mag = np.array(want._apply(want.params, jnp.asarray(log_mel)))
  _close(voc.magnitude(torch.from_numpy(log_mel)).numpy(), mag, MAG_REL)

  ss_dir = str(tmp_path / "soundstream")
  _jax_soundstream_checkpoint(ss_dir)
  tool.export(ss_dir, str(tmp_path / "soundstream.npz"))
  voc = vocoder.load_trained(str(tmp_path / "soundstream.npz"),
                             base_channels=16, device="cpu")
  assert isinstance(voc, vocoder.SoundStreamVocoder)
  want = np.asarray(jax_vocoder.load_trained(ss_dir, base_channels=16)(
      jnp.asarray(log_mel)))
  got = voc(torch.from_numpy(log_mel)).numpy()
  assert got.shape == (1, 6 * 320)
  np.testing.assert_allclose(got, want, rtol=0, atol=SOUNDSTREAM_ATOL)

  for path in (mag_dir, os.path.join(ss_dir, "step_7")):
    with pytest.raises(ValueError, match="tools/export_jax_checkpoint.py"):
      vocoder.load_trained(path, device="cpu")


@pytest.mark.parametrize("stride", [8, 5, 4, 2])
def test_conv_transpose_padding_matches_lax(stride):
  from jax._src.lax.convolution import _conv_transpose_padding
  want = _conv_transpose_padding(2 * stride, stride, "SAME")
  assert vocoder.conv_transpose_padding(2 * stride, stride) == tuple(want)


def test_soundstream_matches_jax_base_32():
  cfg = jax_vocoder.SoundStreamConfig(base_channels=32)
  dec = jax_vocoder.SoundStreamDecoder(config=cfg)
  log_mel = _log_mel(6) * 0.1
  variables = _perturbed(dec.init(jax.random.PRNGKey(0),
                                  jnp.asarray(log_mel)), 0.02)
  want = np.asarray(dec.apply(variables, jnp.asarray(log_mel)))
  assert np.abs(want).max() < 0.99  # tanh not saturated
  ours = vocoder.SoundStreamDecoder(vocoder.SoundStreamConfig(
      base_channels=32))
  ours.load_state_dict(convert.flax_convs_to_state_dict(
      variables["params"], ours))
  assert ours.config.hop_size == 320
  with torch.no_grad():
    got = ours(torch.from_numpy(log_mel)).numpy()
  assert got.shape == (1, 6 * 320)
  np.testing.assert_allclose(got, want, rtol=0, atol=SOUNDSTREAM_ATOL)


def test_load_soundstream_reads_converted_weights(tmp_path):
  dec = jax_vocoder.SoundStreamDecoder(
      config=jax_vocoder.SoundStreamConfig(base_channels=16))
  log_mel = _log_mel(4) * 0.1
  variables = _perturbed(dec.init(jax.random.PRNGKey(4),
                                  jnp.asarray(log_mel)), 0.02)
  path = str(tmp_path / "soundstream.npz")
  np.savez(path, **convert.flatten(variables["params"]))
  want = np.asarray(jax_vocoder.load_soundstream(path, base_channels=16)(
      jnp.asarray(log_mel)))
  got = vocoder.load_soundstream(path, base_channels=16, device="cpu")(
      torch.from_numpy(log_mel)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=SOUNDSTREAM_ATOL)


def test_conv_mapping_is_exact_and_strict():
  kernel = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
  w = convert.conv_weight(kernel)
  assert tuple(w.shape) == (4, 3, 5)
  for k in range(5):
    np.testing.assert_array_equal(w[:, :, k].numpy(), kernel[k].T)
  net = vocoder.MagnitudeNet(hidden=4)
  tree = {name: {"kernel": np.zeros((k, i, o), np.float32),
                 "bias": np.zeros(o, np.float32)}
          for name, (k, i, o) in {"conv_in": (5, 128, 4),
                                  "conv_mid": (5, 4, 4),
                                  "conv_out": (1, 4, 513)}.items()}
  assert set(convert.flax_convs_to_state_dict(tree, net)) == {
      f"{n}.{p}" for n in ("conv_in", "conv_mid", "conv_out")
      for p in ("weight", "bias")}
  with pytest.raises(KeyError, match="without a Flax leaf"):
    convert.flax_convs_to_state_dict({"conv_in": tree["conv_in"]}, net)
  tree["conv_mid"]["kernel"] = np.zeros((3, 4, 4), np.float32)
  with pytest.raises(ValueError, match="does not fit"):
    convert.flax_convs_to_state_dict(tree, net)


@pytest.mark.parametrize("phase_init,momentum", [("zero", 0.0),
                                                 ("zero", 0.9),
                                                 ("pghi", 0.9)])
def test_griffin_lim_vocoder_phase_init_and_momentum(phase_init, momentum):
  """Zero start (no generator) and PGHI start, classic and FGLA, from
  JAX's magnitude; zero-phase GL is ill-conditioned (tests/
  test_torch_stft.py), so 2 iterations."""
  log_mel = _log_mel(20)
  theirs = jax_vocoder.GriffinLimVocoder(num_iters=2, phase_init=phase_init,
                                         momentum=momentum)
  ours = vocoder.GriffinLimVocoder(num_iters=2, phase_init=phase_init,
                                   momentum=momentum, device="cpu")
  mag = np.array(theirs._mag_fn(jnp.asarray(log_mel)))
  init = ours.initial_phase(torch.from_numpy(mag))
  assert (init is None) == (phase_init == "zero")
  want = theirs._gl(jnp.asarray(mag), init_phase=None if init is None
                    else jnp.asarray(init.numpy()))
  _close_audio(ours.griffin_lim(torch.from_numpy(mag), init), want)


def test_random_phase_start_comes_from_the_generator():
  log_mel = torch.from_numpy(_log_mel(12))
  voc = vocoder.GriffinLimVocoder(num_iters=0, phase_init="zero",
                                  device="cpu")
  a = voc(log_mel, torch.Generator().manual_seed(0))
  b = voc(log_mel, torch.Generator().manual_seed(0))
  c = voc(log_mel, torch.Generator().manual_seed(1))
  assert torch.equal(a, b) and not torch.equal(a, c)
  assert not torch.equal(a, voc(log_mel))  # zero start without one
  mag = voc.magnitude(log_mel)
  gen = torch.Generator().manual_seed(0)
  angles = (torch.rand(mag.shape, generator=gen) * 2 - 1) * np.pi
  assert float(angles.min()) >= -np.pi and float(angles.max()) < np.pi
  want = voc.griffin_lim(mag, angles)
  assert torch.equal(a, want)
  with pytest.raises(ValueError, match="phase_init"):
    vocoder.GriffinLimVocoder(phase_init="random", device="cpu")
