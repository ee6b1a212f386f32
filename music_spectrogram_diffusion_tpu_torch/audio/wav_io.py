"""WAV read/write + resampling with scipy and the standard library.

The port's own copy of music_spectrogram_diffusion_tpu/audio/wav_io.py
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import io
import math
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def decode_wav(data: bytes) -> Tuple[int, np.ndarray]:
  """WAV bytes -> (sample_rate, float32 mono samples in [-1, 1])."""
  sample_rate, samples = wavfile.read(io.BytesIO(data))
  if samples.dtype == np.int16:
    samples = samples.astype(np.float32) / 32768.0
  elif samples.dtype == np.int32:
    samples = samples.astype(np.float32) / 2147483648.0
  elif samples.dtype == np.uint8:
    samples = (samples.astype(np.float32) - 128.0) / 128.0
  else:
    samples = samples.astype(np.float32)
  if samples.ndim == 2:  # mixdown to mono
    samples = samples.mean(axis=1)
  return sample_rate, samples


def encode_wav(samples: np.ndarray, sample_rate: int) -> bytes:
  """float samples in [-1, 1] -> 16-bit PCM WAV bytes."""
  pcm = (np.clip(np.asarray(samples), -1.0, 1.0) * 32767).astype(np.int16)
  buf = io.BytesIO()
  wavfile.write(buf, sample_rate, pcm)
  return buf.getvalue()


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
  with open(path, "wb") as f:
    f.write(encode_wav(samples, sample_rate))


def resample(samples: np.ndarray, orig_rate: int,
             target_rate: int) -> np.ndarray:
  """Polyphase resampling (numerically close to librosa's default)."""
  if orig_rate == target_rate:
    return np.asarray(samples, np.float32)
  g = math.gcd(int(orig_rate), int(target_rate))
  up, down = target_rate // g, orig_rate // g
  return resample_poly(np.asarray(samples, np.float64),
                       up, down).astype(np.float32)


def samples_from_example(audio, sample_rate: Optional[float],
                         target_rate: int) -> np.ndarray:
  """Normalize dataset audio: WAV bytes or raw samples -> target rate."""
  if isinstance(audio, (bytes, bytearray)):
    rate, samples = decode_wav(bytes(audio))
    return resample(samples, rate, target_rate)
  samples = np.asarray(audio, np.float32)
  # Dataset features hand sample_rate over as a size-1 array; int() on a
  # ndim>0 array is a NumPy deprecation that becomes an error.
  if sample_rate is not None:
    sample_rate = int(np.asarray(sample_rate).reshape(-1)[0]) if np.size(
        sample_rate) else 0
  if sample_rate and sample_rate != target_rate:
    samples = resample(samples, sample_rate, target_rate)
  return samples
