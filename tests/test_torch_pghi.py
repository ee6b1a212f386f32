"""The port's PGHI heap (C++, `ops/csrc/pghi_heap.cc`, built with g++ on
first use) against the JAX package's default heap, its C extension
(`native/msd_native.cc pghi_heap`): bit for bit, on random magnitudes, on
magnitudes with many exact ties, and on pinv magnitudes of a mel (where
ties occur too). The Python heaps break ties in another order; the test
shows that the inputs here do have ties on which the orders differ, so
the bit-for-bit check covers them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from music_spectrogram_diffusion_tpu import native
from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.ops import stft as jax_stft
from music_spectrogram_diffusion_tpu_torch.ops import _build
from music_spectrogram_diffusion_tpu_torch.ops import stft

KW = dict(frame_length=640, frame_step=320, fft_length=1024)


def _jax_c_heap(S, tol=1e-6):
  mod = native.get()
  assert mod is not None and hasattr(mod, "pghi_heap")
  log_mag = np.log(np.maximum(S, 1e-12))
  tgrad, fgrad = jax_stft._pghi_gradients(log_mag, **_grad_kw())
  n, nb = S.shape
  raw = mod.pghi_heap(np.ascontiguousarray(S).tobytes(), tgrad.tobytes(),
                      fgrad.tobytes(), n, nb, tol)
  return np.frombuffer(raw, np.float32).reshape(n, nb), tgrad, fgrad


def _grad_kw():
  return dict(frame_length=640, frame_step=320, fft_length=1024)


def _random(seed):
  mag = np.abs(np.random.RandomState(seed).randn(40, 65)).astype(np.float32)
  mag[10:14, 20:30] *= 30  # a dominant region
  mag[30:, :5] = 0.0  # bins below the threshold keep phase 0
  return mag


def _tied(seed):
  # Four magnitude levels: nearly every bin ties with many others.
  rng = np.random.RandomState(seed)
  return (rng.randint(1, 5, size=(40, 65)) * 0.25).astype(np.float32)


def _pinv(seed):
  # pinv magnitudes of a mel, as the weights-free vocoder computes them:
  # harmonics under an on/off envelope (the tests/test_torch_stft.py
  # probe), whose pinv magnitudes hold hundreds of exact ties.
  t = np.arange(6400 + 1600 * seed) / 16000.0
  sig = sum(a * np.sin(2 * np.pi * f * t)
            for f, a in [(220, .5), (440, .3), (660, .2)])
  audio = sig * (0.3 + 0.7 * (np.sin(2 * np.pi * 3 * t) > 0))
  log_mel = np.asarray(jax_codecs.MelGan().encode(
      jnp.asarray(audio, jnp.float32)[None]))[0]
  basis = jax_stft.linear_to_mel_matrix(128, 513, 16000, 0.0, 8000)
  return np.maximum(np.exp(log_mel) @ np.linalg.pinv(basis),
                    0.0).astype(np.float32)


@pytest.mark.parametrize("make,seed", [(_random, 0), (_random, 1),
                                       (_tied, 0), (_tied, 1), (_pinv, 0),
                                       (_pinv, 1)])
def test_cpp_heap_equals_jax_c_heap(make, seed):
  S = make(seed)
  want, tgrad, fgrad = _jax_c_heap(S)
  got = stft.pghi_heap(S, tgrad, fgrad, 1e-6)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(stft.pghi_phase(S, **KW), want)


@pytest.mark.parametrize("make", [_tied, _pinv])
def test_inputs_have_ties_that_the_heaps_break_differently(make):
  """The tie cases are real: the Python heaps (port and JAX, equal) give
  another phase than the C/C++ heaps on these magnitudes."""
  S = make(0)
  above = S[S > 1e-6 * S.max()]
  assert np.unique(above).size < above.size  # exact ties
  want, tgrad, fgrad = _jax_c_heap(S)
  py = stft._pghi_heap_py(S, tgrad, fgrad, 1e-6)
  np.testing.assert_array_equal(
      py, jax_stft._pghi_heap_py(S, tgrad, fgrad, 1e-6))
  assert not np.array_equal(py, want)


def test_pghi_phase_batches_and_shapes():
  S = np.stack([_random(0), _tied(0)])[None]  # [1, 2, n, bins]
  got = stft.pghi_phase(S, **KW)
  assert got.shape == S.shape and got.dtype == np.float32
  for b in range(2):
    np.testing.assert_array_equal(got[0, b], _jax_c_heap(S[0, b])[0])
  with pytest.raises(ValueError, match="shapes"):
    stft.pghi_heap(S[0, 0], S[0, 0][:-1], S[0, 0], 1e-6)


def test_heap_build_raises_without_a_compiler(tmp_path, monkeypatch):
  """No g++, no heap: the build raises; there is no Python fallback."""
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(_build, "_libraries", {})
  monkeypatch.setattr(_build.shutil, "which", lambda name: None)
  with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
    stft.pghi_phase(_random(0), **KW)


def test_heap_library_is_keyed_by_source_and_flags():
  path = _build.library_path("pghi_heap")
  assert path.parent == _build.BUILD_DIR
  assert path.name.startswith("libpghi_heap-") and path.suffix == ".so"
  stft.pghi_heap(_random(0), *_jax_c_heap(_random(0))[1:], 1e-6)
  assert path.exists()
