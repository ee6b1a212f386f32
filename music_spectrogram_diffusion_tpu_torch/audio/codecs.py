"""Audio codecs: log-mel features and their scaling to the network's range.

Port of music_spectrogram_diffusion_tpu/audio/codecs.py, MelGan codec only:
`encode` on tensors, `encode_np` in numpy for the host-side data pipeline.
Decoding back to audio is the vocoder's job (audio/vocoder.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch.ops import stft


class MelGan:
  """128-bin log-mel at 16 kHz / hop 320 (50 frames/s).

  min/max/pad values are tied to how the published mel inverter was
  trained and must not drift.
  """

  name = "melgan"
  n_dims = 128
  sample_rate = 16000
  hop_size = 320
  min_value = float(np.log(1e-5))
  max_value = 4.0
  pad_value = float(np.log(1e-5))
  frame_length = 640
  # 16 extra frames: the tail frames of a pad_end STFT see zero-padding,
  # so the reference encodes 16 frames past a segment's end and slices
  # them off; the MIDI front end's segment split carries them.
  additional_frames_for_encoding = 16
  fft_size = 1024
  lo_hz = 0.0

  @property
  def frame_rate(self) -> int:
    return int(self.sample_rate // self.hop_size)

  @property
  def context_codec(self) -> "MelGan":
    """The codec of the previous segment's context features: this one."""
    return self

  def scale_features(self, features: torch.Tensor,
                     output_range: Tuple[float, float] = (-1.0, 1.0),
                     clip: bool = False) -> torch.Tensor:
    """Linearly map [min_value, max_value] -> output_range."""
    min_out, max_out = output_range
    if clip:
      features = torch.clamp(features, self.min_value, self.max_value)
    zero_one = (features - self.min_value) / (self.max_value - self.min_value)
    return zero_one * (max_out - min_out) + min_out

  def scale_to_features(self, outputs: torch.Tensor,
                        input_range: Tuple[float, float] = (-1.0, 1.0),
                        clip: bool = False) -> torch.Tensor:
    """Inverse of scale_features."""
    min_out, max_out = input_range
    if clip:
      outputs = torch.clamp(outputs, min_out, max_out)
    zero_one = (outputs - min_out) / (max_out - min_out)
    return zero_one * (self.max_value - self.min_value) + self.min_value

  def encode(self, audio: torch.Tensor) -> torch.Tensor:
    """[batch, n_samples] -> [batch, ceil(n_samples / hop), 128] log-mel."""
    return stft.mel_spectrogram(
        audio, sample_rate=self.sample_rate, n_fft=self.fft_size,
        hop_length=self.hop_size, win_length=self.frame_length,
        n_mel_channels=self.n_dims, mel_fmin=self.lo_hz,
        mel_fmax=self.sample_rate // 2)

  def encode_np(self, audio) -> np.ndarray:
    """numpy `encode` for the host-side data pipeline (the JAX package's
    `encode_np`, the same math as `encode`)."""
    audio = np.asarray(audio, np.float32)
    if audio.shape[0] == 0:
      return np.zeros((0, self.n_dims), dtype=np.float32)
    return stft.mel_spectrogram_np(
        audio, sample_rate=self.sample_rate, n_fft=self.fft_size,
        hop_length=self.hop_size, win_length=self.frame_length,
        n_mel_channels=self.n_dims, mel_fmin=self.lo_hz,
        mel_fmax=self.sample_rate // 2)


def get_codec(name: str) -> MelGan:
  if name != "melgan":
    raise ValueError(f"Unknown codec {name!r}; the port has 'melgan'")
  return MelGan()
