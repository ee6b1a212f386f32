"""STFT, mel filterbank, inverse STFT, Griffin-Lim and PGHI in PyTorch.

Port of music_spectrogram_diffusion_tpu/ops/stft.py with tf.signal
semantics:

  * pad_end framing: n_frames = ceil(n_samples / hop); frames that overrun
    are zero-padded on the right.
  * Periodic Hann window of `win_length`, zero-padded to `n_fft` on the
    right before the FFT.
  * HTK mel scale (2595 * log10(1 + f/700)) with triangular weights on the
    bin frequencies excluding DC; the DC row of the filterbank is zero.

The filterbank, the window and the PGHI phase integration are on the
host (numpy, and the heap in C++: `ops/csrc/pghi_heap.cc`, built with g++
on first use); the transforms run on the tensors' device.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import Optional

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch.ops import _build


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
  """Periodic Hann window (tf.signal.hann_window default)."""
  return (0.5 - 0.5 * np.cos(
      2.0 * np.pi * np.arange(win_length) / win_length)).astype(dtype)


def _hertz_to_mel(f):
  return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def linear_to_mel_matrix(num_mel_bins: int,
                         num_spectrogram_bins: int,
                         sample_rate: float,
                         lower_edge_hertz: float,
                         upper_edge_hertz: float,
                         dtype=np.float32) -> np.ndarray:
  """tf.signal.linear_to_mel_weight_matrix: [spectrogram_bins, mel_bins]."""
  nyquist = sample_rate / 2.0
  freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]  # drop DC
  spectrogram_mels = _hertz_to_mel(freqs)[:, None]
  edges = np.linspace(_hertz_to_mel(lower_edge_hertz),
                      _hertz_to_mel(upper_edge_hertz), num_mel_bins + 2)
  lower = edges[:-2][None, :]
  center = edges[1:-1][None, :]
  upper = edges[2:][None, :]
  lower_slopes = (spectrogram_mels - lower) / (center - lower)
  upper_slopes = (upper - spectrogram_mels) / (upper - center)
  weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
  return np.pad(weights, [[1, 0], [0, 0]]).astype(dtype)


def _window(frame_length: int, device) -> torch.Tensor:
  return torch.as_tensor(hann_window(frame_length), device=device)


def frame_signal(audio: torch.Tensor, frame_length: int,
                 frame_step: int) -> torch.Tensor:
  """[..., n] -> [..., ceil(n / frame_step), frame_length] (pad_end)."""
  n = audio.shape[-1]
  n_frames = -(-n // frame_step)
  pad = max(0, (n_frames - 1) * frame_step + frame_length - n)
  audio = torch.nn.functional.pad(audio, (0, pad))
  idx = (torch.arange(frame_length, device=audio.device)[None, :] +
         frame_step * torch.arange(n_frames, device=audio.device)[:, None])
  return audio[..., idx]


def stft_magnitude(audio: torch.Tensor, *, frame_length: int,
                   frame_step: int, fft_length: int) -> torch.Tensor:
  """|STFT| with a periodic Hann window, [..., n_frames, fft//2+1]."""
  frames = frame_signal(audio, frame_length, frame_step)
  frames = frames * _window(frame_length, audio.device)
  return torch.abs(torch.fft.rfft(frames, n=fft_length, dim=-1))


def _overlap_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
  """Overlap-add [..., n_frames, frame_length] -> [..., total]: k shifted
  adds of hop-sized pieces, in the JAX module's order."""
  *batch, n_frames, frame_length = frames.shape
  if frame_length % frame_step:
    raise ValueError(f"frame_length {frame_length} is not a multiple of "
                     f"frame_step {frame_step}")
  total = (n_frames - 1) * frame_step + frame_length
  k = frame_length // frame_step
  pieces = frames.reshape(*batch, n_frames, k, frame_step)
  out = torch.zeros(*batch, n_frames + k - 1, frame_step,
                    dtype=frames.dtype, device=frames.device)
  for j in range(k):
    out = out + torch.nn.functional.pad(pieces[..., :, j, :],
                                        (0, 0, j, k - 1 - j))
  return out.reshape(*batch, -1)[..., :total]


def istft(stft_matrix: torch.Tensor, *, frame_length: int, frame_step: int,
          fft_length: int, num_samples: int) -> torch.Tensor:
  """Inverse STFT: Hann synthesis window, overlap-add, envelope division."""
  frames = torch.fft.irfft(stft_matrix, n=fft_length, dim=-1)
  frames = frames[..., :frame_length]
  window = _window(frame_length, stft_matrix.device)
  frames = frames * window
  n_frames = frames.shape[-2]
  out = _overlap_add(frames, frame_step)
  env = _overlap_add((window * window).expand(n_frames, frame_length),
                     frame_step)
  out = out / torch.clamp(env, min=1e-8)
  return out[..., :num_samples]


# PGHI phase-gradient constant for the Hann window (see the JAX module).
_PGHI_HANN_GAMMA = 0.25645


def _pghi_gradients(log_mag: np.ndarray, frame_length: int,
                    frame_step: int, fft_length: int):
  """Phase-gradient estimates (rad/hop, rad/bin) from log|STFT|."""
  gamma = _PGHI_HANN_GAMMA * frame_length * frame_length
  c_t = np.pi ** 2 * gamma / (frame_step * fft_length)
  n_bins = log_mag.shape[-1]
  dldm = np.zeros_like(log_mag)
  dldm[..., 1:-1] = (log_mag[..., 2:] - log_mag[..., :-2]) / 2
  dldn = np.zeros_like(log_mag)
  dldn[..., 1:-1, :] = (log_mag[..., 2:, :] - log_mag[..., :-2, :]) / 2
  m = np.arange(n_bins, dtype=log_mag.dtype)
  tgrad = c_t * dldm + 2 * np.pi * frame_step * m / fft_length
  fgrad = (-1.0 / c_t) * dldn - 2 * np.pi * (frame_length / 2) / fft_length
  return tgrad.astype(np.float32), fgrad.astype(np.float32)


def _pghi_heap_py(S: np.ndarray, tgrad: np.ndarray, fgrad: np.ndarray,
                  tol: float) -> np.ndarray:
  """Heap integration of the phase gradients, largest magnitude first: the
  plain version of `pghi_heap`, a copy of the JAX package's Python heap.
  It breaks ties between equal magnitudes in another order than the C++
  heap; the tests hold each against its JAX counterpart."""
  n, nb = S.shape
  phase = np.zeros_like(S)
  done = S <= tol * S.max()
  order = np.argsort(S, axis=None)[::-1]
  seed_pos = 0
  flat_done = done.reshape(-1)
  heap = []
  while True:
    while seed_pos < order.size and flat_done[order[seed_pos]]:
      seed_pos += 1
    if seed_pos >= order.size:
      break
    si, sj = divmod(int(order[seed_pos]), nb)
    flat_done[order[seed_pos]] = True
    heapq.heappush(heap, (-S[si, sj], si, sj))
    while heap:
      _, i, j = heapq.heappop(heap)
      for di, dj, grad, sign in ((1, 0, tgrad, 1), (-1, 0, tgrad, -1),
                                 (0, 1, fgrad, 1), (0, -1, fgrad, -1)):
        ni, nj = i + di, j + dj
        if 0 <= ni < n and 0 <= nj < nb and not done[ni, nj]:
          phase[ni, nj] = phase[i, j] + sign * 0.5 * (
              grad[i, j] + grad[ni, nj])
          done[ni, nj] = True
          flat_done[ni * nb + nj] = True
          heapq.heappush(heap, (-S[ni, nj], ni, nj))
  return phase


def _heap_entry():
  fn = _build.load("pghi_heap").msd_pghi_heap
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_double, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


def pghi_heap(S: np.ndarray, tgrad: np.ndarray, fgrad: np.ndarray,
              tol: float) -> np.ndarray:
  """Heap integration of the phase gradients in C++ (`csrc/pghi_heap.cc`),
  the JAX package's default heap (`native/msd_native.cc pghi_heap`) step
  for step. S, tgrad, fgrad: float32 [n_frames, n_bins]. Raises if the
  heap cannot be built (no g++): there is no quiet Python fallback."""
  S, tgrad, fgrad = (np.ascontiguousarray(a, np.float32)
                     for a in (S, tgrad, fgrad))
  if S.ndim != 2 or tgrad.shape != S.shape or fgrad.shape != S.shape:
    raise ValueError(f"pghi_heap: shapes {S.shape}, {tgrad.shape}, "
                     f"{fgrad.shape}; want three equal [n, bins]")
  phase = np.empty_like(S)
  _heap_entry()(S.ctypes.data, tgrad.ctypes.data, fgrad.ctypes.data,
                S.shape[0], S.shape[1], float(tol), phase.ctypes.data)
  return phase


def pghi_phase(magnitude, *, frame_length: int, frame_step: int,
               fft_length: int, tol: float = 1e-6) -> np.ndarray:
  """Phase Gradient Heap Integration (Prusa et al. 2017) on the host.

  [..., n_frames, n_bins] |STFT| -> phase of the same shape; the
  initializer of `griffin_lim`. The heap is `pghi_heap` (C++), on every
  device.
  """
  S = np.asarray(magnitude, np.float32)
  batch_shape = S.shape[:-2]
  S2 = S.reshape((-1,) + S.shape[-2:])
  log_mag = np.log(np.maximum(S2, 1e-12))
  tgrad, fgrad = _pghi_gradients(log_mag, frame_length, frame_step,
                                 fft_length)
  out = np.empty_like(S2)
  for b in range(S2.shape[0]):
    out[b] = pghi_heap(S2[b], tgrad[b], fgrad[b], tol)
  return out.reshape(batch_shape + S.shape[-2:])


def griffin_lim(magnitude: torch.Tensor, *, frame_length: int,
                frame_step: int, fft_length: int, num_iters: int = 32,
                init_phase: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                momentum: float = 0.0) -> torch.Tensor:
  """Griffin-Lim phase reconstruction from |STFT| -> audio.

  `init_phase` (e.g. from `pghi_phase`) replaces the zero start; without
  it, a `generator` draws a random start, uniform in [-pi, pi), on its
  own device (the JAX package draws it from its `rng`).
  `momentum` > 0 is the fast Griffin-Lim update (Perraudin et al. 2013):
  c_{n+1} = t_n + momentum * (t_n - t_{n-1}); 0 is the classic
  alternating projections.
  """
  n_frames = magnitude.shape[-2]
  num_samples = n_frames * frame_step
  window = _window(frame_length, magnitude.device)
  if init_phase is not None:
    angles = init_phase.to(magnitude.device, torch.float32)
  elif generator is not None:
    angles = (torch.rand(magnitude.shape, generator=generator,
                         device=generator.device) * 2 - 1) * np.pi
    angles = angles.to(magnitude.device)
  else:
    angles = torch.zeros_like(magnitude)
  stft_c = magnitude * torch.exp(1j * angles.to(torch.complex64))

  def project(c):
    audio = istft(c, frame_length=frame_length, frame_step=frame_step,
                  fft_length=fft_length, num_samples=num_samples)
    frames = frame_signal(audio, frame_length, frame_step)
    rebuilt = torch.fft.rfft(frames * window, n=fft_length, dim=-1)
    return magnitude * (rebuilt / torch.clamp(torch.abs(rebuilt), min=1e-8))

  if momentum:
    t_prev = stft_c
    for _ in range(num_iters):
      t = project(stft_c)
      stft_c = t + momentum * (t - t_prev)
      t_prev = t
    stft_c = t_prev
  else:
    for _ in range(num_iters):
      stft_c = project(stft_c)
  return istft(stft_c, frame_length=frame_length, frame_step=frame_step,
               fft_length=fft_length, num_samples=num_samples)


def mel_to_linear(mel: torch.Tensor, mel_basis: np.ndarray) -> torch.Tensor:
  """Approximate |STFT| from mel via the filterbank pseudo-inverse."""
  pinv = torch.as_tensor(np.linalg.pinv(np.asarray(mel_basis)),
                         device=mel.device)
  return torch.clamp(mel @ pinv, min=0.0)


def mel_spectrogram(audio: torch.Tensor, *, sample_rate: int, n_fft: int,
                    hop_length: int, win_length: int, n_mel_channels: int,
                    mel_fmin: float, mel_fmax: float) -> torch.Tensor:
  """Log-mel of [batch, n_samples] -> [batch, frames, mels], clipped to
  [1e-5, 1e8] before the log."""
  mag = stft_magnitude(audio, frame_length=win_length, frame_step=hop_length,
                       fft_length=n_fft)
  basis = torch.as_tensor(linear_to_mel_matrix(
      num_mel_bins=n_mel_channels, num_spectrogram_bins=n_fft // 2 + 1,
      sample_rate=sample_rate, lower_edge_hertz=mel_fmin,
      upper_edge_hertz=mel_fmax), device=audio.device)
  return torch.log(torch.clamp(mag @ basis, 1e-5, 1e8))


def mel_spectrogram_np(audio: np.ndarray,
                       *,
                       sample_rate: int = 16000,
                       n_fft: int = 1024,
                       hop_length: int = 160,
                       win_length: int = 400,
                       n_mel_channels: Optional[int] = 64,
                       drop_dc: bool = True,
                       mel_fmin: float = 60.0,
                       mel_fmax: Optional[float] = 7800.0,
                       clip_value_min: float = 1e-5,
                       clip_value_max: float = 1e8,
                       log_amplitude: bool = True) -> np.ndarray:
  """Pure-numpy mel_spectrogram for the host-side data pipeline: a copy of
  the JAX package's `mel_spectrogram_np` (same math, same constants), so
  the port's training features equal the JAX package's bit for bit."""
  if mel_fmax is None:
    mel_fmax = sample_rate // 2
  audio = np.asarray(audio, np.float32)
  n = audio.shape[-1]
  n_frames = -(-n // hop_length)  # ceil (tf.signal pad_end)
  pad = max(0, (n_frames - 1) * hop_length + win_length - n)
  audio = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])
  idx = (np.arange(win_length)[None, :] +
         hop_length * np.arange(n_frames)[:, None])
  frames = audio[..., idx] * hann_window(win_length)
  mag = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1))
  if n_mel_channels is not None:
    basis = linear_to_mel_matrix(
        num_mel_bins=n_mel_channels,
        num_spectrogram_bins=n_fft // 2 + 1,
        sample_rate=sample_rate,
        lower_edge_hertz=mel_fmin,
        upper_edge_hertz=mel_fmax)
    out = mag @ basis
  else:
    out = mag[..., 1:] if drop_dc else mag
  if log_amplitude:
    out = np.log(np.clip(out, clip_value_min, clip_value_max))
  return out.astype(np.float32)
