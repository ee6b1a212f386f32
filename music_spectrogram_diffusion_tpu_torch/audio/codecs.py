"""Audio codecs: log-mel features and their scaling to the network's range.

Port of music_spectrogram_diffusion_tpu/audio/codecs.py, MelGan codec only:
`encode` on tensors, `encode_np` in numpy for the host-side data pipeline.
`decode` hands the features (dithered, when the codec was made with a
`decode_dither_amount`) to the vocoder attached with `set_vocoder`
(audio/vocoder.py has them).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

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

  def __init__(self, decode_dither_amount: float = 0.0,
               vocoder_apply_fn: Optional[Callable] = None,
               vocoder_params: Any = None):
    self.decode_dither_amount = decode_dither_amount
    self._vocoder_apply_fn = vocoder_apply_fn
    self._vocoder_params = vocoder_params

  @property
  def abbrev_str(self) -> str:
    """The codec's part of a task's name (data/tasks.construct_task_name)."""
    return self.name

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


  def to_images(self, features: torch.Tensor) -> torch.Tensor:
    """[batch, frames, n_dims] features scaled to [0, 1], for images."""
    assert features.ndim == 3
    return self.scale_features(features, output_range=(0.0, 1.0))

  def set_vocoder(self, apply_fn: Callable, params: Any = None) -> None:
    """Attach the decoder: `apply_fn(params, features) -> audio`, as the JAX
    package's adapters have it. A vocoder of audio/vocoder.py goes in as
    `set_vocoder(lambda _, mel: voc(mel))`."""
    self._vocoder_apply_fn = apply_fn
    self._vocoder_params = params

  def decode(self, features: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[batch, n_frames, 128] -> [batch, n_frames * hop_size] audio.

    With a `decode_dither_amount`, Gaussian noise of that scale, drawn from
    `generator` (on the features' device), is added to the features first;
    the dither needs an explicit generator, as JAX's needs an rng key."""
    if self._vocoder_apply_fn is None:
      raise ValueError(
          "No vocoder attached; call set_vocoder(lambda _, mel: voc(mel)) "
          "with voc from audio/vocoder.py (vocoder.load_trained(path) or "
          "vocoder.GriffinLimVocoder())")
    if self.decode_dither_amount > 0:
      if generator is None:
        raise ValueError("decode dither requires a torch.Generator")
      features = features + _dither_noise(
          features, generator) * self.decode_dither_amount
    return self._vocoder_apply_fn(self._vocoder_params, features)


def _dither_noise(features: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
  """Standard normal noise of the features' shape, dtype and device."""
  return torch.randn(features.shape, generator=generator,
                     dtype=features.dtype, device=features.device)


def get_codec(name: str, **kwargs) -> MelGan:
  if name != "melgan":
    raise ValueError(f"Unknown codec {name!r}; the port has 'melgan'")
  return MelGan(**kwargs)
