"""The port's STFT, mel, Griffin-Lim, PGHI, codec and vocoder against
tests/goldens/stft.npz and the JAX package's functions.

Tolerances: the goldens' own (2e-4 for |STFT|, 1e-6 for the filterbank,
2e-3 for log-mel, as tests/test_stft_goldens.py); against JAX, 1e-4 for the
codec, and for inverse transforms 1e-4 of the signal's peak from the
second frame on (float32 FFTs in two libraries; only the first frame covers
the first hop, where the window-envelope division scales float error by up
to 1e4); PGHI bit for bit: the port's C++ heap against the JAX package's
C heap (its default, native/), the port's Python heap against JAX's.

The vocoder holds to 1e-3 of the peak: its pinv magnitudes come from two
matmul libraries (2e-7 apart, relative) and Griffin-Lim iterations amplify
that (measured 2.7e-4 of the peak after 4). Both sides run PGHI through
their default heap, C++ and C, which break ties in the same order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.ops import stft as jax_stft
from music_spectrogram_diffusion_tpu_torch.audio import codecs, vocoder
from music_spectrogram_diffusion_tpu_torch.ops import stft

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "stft.npz")
KW = dict(frame_length=640, frame_step=320, fft_length=1024)


@pytest.fixture(scope="module")
def goldens():
  return np.load(GOLDENS)


def _close_to_peak(got, want, rel=1e-4):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape
  got, want = got[..., KW["frame_length"]:], want[..., KW["frame_length"]:]
  assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _probe(seconds=0.5, sr=16000):
  t = np.arange(int(seconds * sr)) / sr
  sig = sum(a * np.sin(2 * np.pi * f * t)
            for f, a in [(220, .5), (440, .3), (660, .2)])
  return (sig * (0.3 + 0.7 * (np.sin(2 * np.pi * 3 * t) > 0))
          ).astype(np.float32)


@pytest.mark.parametrize("case", ["exact", "overhang", "short", "segment"])
def test_stft_magnitude_matches_goldens(goldens, case):
  got = stft.stft_magnitude(torch.from_numpy(goldens[f"audio_{case}"]), **KW)
  want = goldens[f"stft_{case}"]
  assert tuple(got.shape) == want.shape
  np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_mel_matrices_and_log_mel_match_goldens(goldens):
  np.testing.assert_allclose(
      stft.linear_to_mel_matrix(128, 513, 16000.0, 0.0, 8000.0),
      goldens["mel_matrix_melgan"], atol=1e-6)
  np.testing.assert_allclose(
      stft.linear_to_mel_matrix(64, 257, 16000.0, 125.0, 7500.0),
      goldens["mel_matrix_vggish"], atol=1e-6)
  mel = codecs.MelGan().encode(
      torch.from_numpy(goldens["audio_segment"])[None])[0]
  want = np.log(np.maximum(
      goldens["stft_segment"] @ goldens["mel_matrix_melgan"], 1e-5))
  np.testing.assert_allclose(mel.numpy(), want, rtol=2e-3, atol=2e-3)


def test_codec_matches_jax():
  audio = np.random.RandomState(5).randn(2, 6400).astype(np.float32) * 0.2
  ours, theirs = codecs.MelGan(), jax_codecs.MelGan()
  np.testing.assert_allclose(ours.encode(torch.from_numpy(audio)).numpy(),
                             np.asarray(theirs.encode(jnp.asarray(audio))),
                             rtol=1e-4, atol=1e-4)
  feats = np.random.RandomState(6).uniform(-14, 5, (2, 8, 128)).astype(
      np.float32)
  for clip in (False, True):
    scaled = ours.scale_features(torch.from_numpy(feats), clip=clip)
    np.testing.assert_allclose(
        scaled.numpy(),
        np.asarray(theirs.scale_features(jnp.asarray(feats), clip=clip)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ours.scale_to_features(scaled, clip=clip).numpy(),
        np.asarray(theirs.scale_to_features(jnp.asarray(scaled.numpy()),
                                            clip=clip)),
        rtol=1e-6, atol=1e-6)
  for name in ("min_value", "max_value", "pad_value", "hop_size", "n_dims",
               "sample_rate", "frame_rate"):
    assert getattr(ours, name) == getattr(theirs, name), name


def test_istft_and_griffin_lim_match_jax():
  sig = _probe()
  mag = jax_stft.stft_magnitude(jnp.asarray(sig), **KW)
  mag_t = torch.from_numpy(np.array(mag))
  spec = np.fft.rfft(np.random.RandomState(0).randn(3, 7, 1024), axis=-1)
  spec = spec.astype(np.complex64)
  _close_to_peak(
      stft.istft(torch.from_numpy(spec), num_samples=7 * 320, **KW),
      jax_stft.istft(jnp.asarray(spec), num_samples=7 * 320, **KW))
  init = stft.pghi_phase(mag_t.numpy(), **KW)
  # Zero-phase GL is too ill-conditioned for a bound after iterations
  # (measured 1.5e-3 of the peak after 6); PGHI's start is what serves.
  for num_iters, momentum, init_phase in [(0, 0.0, None), (6, 0.0, init),
                                          (6, 0.9, init)]:
    want = jax_stft.griffin_lim(
        mag, num_iters=num_iters, momentum=momentum,
        init_phase=None if init_phase is None else jnp.asarray(init_phase),
        **KW)
    got = stft.griffin_lim(
        mag_t, num_iters=num_iters, momentum=momentum,
        init_phase=None if init_phase is None else torch.from_numpy(
            init_phase), **KW)
    _close_to_peak(got, want)


def test_pghi_matches_python_heap_bit_for_bit():
  """The port's plain heap (`_pghi_heap_py`) against the JAX package's
  Python heap; `pghi_phase` itself runs the C++ heap
  (tests/test_torch_pghi.py holds it against JAX's C heap)."""
  mag = np.abs(np.random.RandomState(0).randn(2, 20, 33)).astype(np.float32)
  mag[:, 5:8, 10:14] *= 20  # a dominant region
  mag[0, 15, 5] = 0.0
  log_mag = np.log(np.maximum(mag, 1e-12))
  tgrad, fgrad = jax_stft._pghi_gradients(log_mag, 640, 320, 1024)
  ours = stft._pghi_gradients(log_mag, 640, 320, 1024)
  np.testing.assert_array_equal(ours[0], tgrad)
  np.testing.assert_array_equal(ours[1], fgrad)
  for b in range(2):
    want = jax_stft._pghi_heap_py(mag[b], tgrad[b], fgrad[b], 1e-6)
    got = stft._pghi_heap_py(mag[b], tgrad[b], fgrad[b], 1e-6)
    np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(stft.pghi_phase(mag, **KW),
                                jax_stft.pghi_phase(mag, **KW))


def test_griffin_lim_vocoder_matches_jax():
  """Stage by stage, then end to end. The pinv magnitudes agree to float
  ulps (two matmul libraries; measured 9.6e-8 of the max) and hold
  hundreds of exact ties, where the C heap's order is discontinuous: those
  ulps turn 24 of 10260 bins' initial phase (measured), 1.1e-3 of the
  peak in the audio before any iteration, 3.5e-4 after 4. So PGHI and
  Griffin-Lim are held from JAX's magnitude (the phase bit for bit, the
  audio at 1e-3 of the peak), and the whole chain after 4 iterations."""
  from music_spectrogram_diffusion_tpu import native
  from music_spectrogram_diffusion_tpu.audio import vocoder as jax_vocoder
  assert native.get() is not None  # JAX's default: the C heap
  log_mel = np.array(jax_codecs.MelGan().encode(
      jnp.asarray(_probe(0.4))[None]))
  for num_iters in (0, 4):
    theirs = jax_vocoder.GriffinLimVocoder(num_iters=num_iters)
    ours = vocoder.GriffinLimVocoder(num_iters=num_iters, device="cpu")
    mag = np.array(theirs._mag_fn(jnp.asarray(log_mel)))
    np.testing.assert_allclose(
        ours.magnitude(torch.from_numpy(log_mel)).numpy(), mag, rtol=0,
        atol=1e-6 * mag.max())
    init = ours.initial_phase(torch.from_numpy(mag))
    np.testing.assert_array_equal(init.numpy(),
                                  jax_stft.pghi_phase(mag, **KW))
    _close_to_peak(ours.griffin_lim(torch.from_numpy(mag), init),
                   theirs._gl(jnp.asarray(mag), init_phase=jnp.asarray(
                       init.numpy())), rel=1e-3)
    got = ours(torch.from_numpy(log_mel))
    assert tuple(got.shape) == (1, log_mel.shape[1] * 320)
    if num_iters:
      _close_to_peak(got, theirs(jnp.asarray(log_mel)), rel=1e-3)
