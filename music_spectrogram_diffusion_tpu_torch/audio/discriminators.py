"""GAN discriminators for vocoder training (SoundStream/MelGAN style).

Port of music_spectrogram_diffusion_tpu/audio/discriminators.py. Two
ensembles, as in SoundStream (Zeghidour et al. 2021):
  * multi-scale waveform discriminators at 1x/2x/4x downsampling
    (MelGAN-style grouped strided convs),
  * an STFT discriminator over the complex spectrogram.
Hinge adversarial losses + feature matching, used by
audio/vocoder_train.AdversarialVocoderTrainer.

Each discriminator returns (logits, features) as the Flax modules do, in
their layout: a wave discriminator's logits [B, T'] and features
[B, T', C]; the STFT discriminator's logits [B, T * F'] (T-major) and
features [B, T, F', C]. The convolutions are named as Flax names them
(`Conv_<i>` in each discriminator, `scale_<i>` in the multi-scale one,
`waves` and `stft` in the ensemble), so `convert.flax_convs_to_state_dict`
maps a Flax tree onto them. Flax's padding="SAME" with a stride pads
ceil(n / s) * s - s + k - n in all, the low side getting half rounded
down; it is written out here (`same_padding`), as is avg_pool's, which
counts the padded zeros.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops

Outputs = List[Tuple[torch.Tensor, List[torch.Tensor]]]


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(low, high) padding of XLA's SAME for length n."""
  out = -(-n // stride)
  total = max((out - 1) * stride + kernel - n, 0)
  return total // 2, total - total // 2


def _conv1d_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
  """conv over [B, C, T] with SAME padding."""
  x = F.pad(x, same_padding(x.shape[-1], conv.kernel_size[0],
                            conv.stride[0]))
  return conv(x)


def _conv2d_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
  """conv over [B, C, H, W] with SAME padding."""
  (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
  x = F.pad(x, same_padding(x.shape[-1], kw, sw)
            + same_padding(x.shape[-2], kh, sh))
  return conv(x)


class WaveDiscriminator(nn.Module):
  """Single-scale MelGAN discriminator over raw waveform [B, T]."""

  def __init__(self, base_channels: int = 16, max_channels: int = 512):
    super().__init__()
    convs = [nn.Conv1d(1, base_channels, 15)]
    channels = base_channels
    for _ in range(4):
      out_ch = min(channels * 4, max_channels)
      groups = max(out_ch // 16, 1)
      convs.append(nn.Conv1d(channels, out_ch, 41, stride=4, groups=groups))
      channels = out_ch
    convs.append(nn.Conv1d(channels, min(channels, max_channels), 5))
    convs.append(nn.Conv1d(min(channels, max_channels), 1, 3))
    for i, conv in enumerate(convs):
      self.add_module(f"Conv_{i}", conv)
    self.num_convs = len(convs)

  def forward(self, audio: torch.Tensor
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    x = audio[:, None, :]  # [B, 1, T]
    features = []
    for i in range(self.num_convs - 1):
      x = F.leaky_relu(_conv1d_same(getattr(self, f"Conv_{i}"), x), 0.2)
      features.append(x.transpose(1, 2))
    logits = _conv1d_same(getattr(self, f"Conv_{self.num_convs - 1}"), x)
    return logits[:, 0], features


def _avg_pool_same(x: torch.Tensor, window: int = 4,
                   stride: int = 2) -> torch.Tensor:
  """Flax `nn.avg_pool(x[..., None], (window,), (stride,), "SAME")[..., 0]`
  over [B, T]: zeros padded as SAME pads, every window divided by its
  full size."""
  x = F.pad(x, same_padding(x.shape[-1], window, stride))
  return F.avg_pool1d(x[:, None], window, stride)[:, 0]


class MultiScaleWaveDiscriminator(nn.Module):
  """Discriminators at 1x/2x/4x average-pooled scales."""

  def __init__(self, num_scales: int = 3):
    super().__init__()
    self.num_scales = num_scales
    for i in range(num_scales):
      self.add_module(f"scale_{i}", WaveDiscriminator())

  def forward(self, audio: torch.Tensor) -> Outputs:
    outputs = []
    x = audio
    for i in range(self.num_scales):
      outputs.append(getattr(self, f"scale_{i}")(x))
      if i + 1 < self.num_scales:
        x = _avg_pool_same(x)
    return outputs


class STFTDiscriminator(nn.Module):
  """2D-conv discriminator over the STFT (real/imag as channels)."""

  def __init__(self, n_fft: int = 1024, hop: int = 256,
               channels: Sequence[int] = (32, 64, 128, 256)):
    super().__init__()
    self.n_fft, self.hop = n_fft, hop
    in_ch = 2
    for i, ch in enumerate(channels):
      self.add_module(f"Conv_{i}", nn.Conv2d(
          in_ch, ch, (3, 3), stride=(1, 2) if i else (1, 1)))
      in_ch = ch
    self.add_module(f"Conv_{len(channels)}", nn.Conv2d(in_ch, 1, (3, 3)))
    self.num_convs = len(channels) + 1

  def forward(self, audio: torch.Tensor) -> Outputs:
    frames = stft_ops.frame_signal(audio, self.n_fft, self.hop)
    spec = torch.fft.rfft(frames * stft_ops._window(self.n_fft, audio.device),
                          dim=-1)
    x = torch.stack([spec.real, spec.imag], dim=1)  # [B, 2, T, F]
    features = []
    for i in range(self.num_convs - 1):
      x = F.leaky_relu(_conv2d_same(getattr(self, f"Conv_{i}"), x), 0.2)
      features.append(x.permute(0, 2, 3, 1))
    logits = _conv2d_same(getattr(self, f"Conv_{self.num_convs - 1}"), x)
    return [(logits[:, 0].reshape(logits.shape[0], -1), features)]


class VocoderDiscriminators(nn.Module):
  """The full ensemble used for adversarial vocoder training."""

  def __init__(self):
    super().__init__()
    self.waves = MultiScaleWaveDiscriminator()
    self.stft = STFTDiscriminator()

  def forward(self, audio: torch.Tensor) -> Outputs:
    return self.waves(audio) + self.stft(audio)


def hinge_d_loss(real_outputs: Outputs, fake_outputs: Outputs
                 ) -> torch.Tensor:
  """Discriminator hinge loss over the ensemble."""
  loss = 0.0
  for (real_logits, _), (fake_logits, _) in zip(real_outputs, fake_outputs):
    loss = loss + torch.mean(F.relu(1.0 - real_logits))
    loss = loss + torch.mean(F.relu(1.0 + fake_logits))
  return loss / len(real_outputs)


def hinge_g_loss(fake_outputs: Outputs) -> torch.Tensor:
  """Generator hinge loss."""
  loss = 0.0
  for fake_logits, _ in fake_outputs:
    loss = loss - torch.mean(fake_logits)
  return loss / len(fake_outputs)


def feature_matching_loss(real_outputs: Outputs, fake_outputs: Outputs
                          ) -> torch.Tensor:
  """L1 between discriminator features of real and generated audio."""
  loss = 0.0
  count = 0
  for (_, real_feats), (_, fake_feats) in zip(real_outputs, fake_outputs):
    for rf, ff in zip(real_feats, fake_feats):
      loss = loss + torch.mean(torch.abs(rf - ff))
      count += 1
  return loss / max(count, 1)
