"""Vocoders: log-mel -> 16 kHz audio in PyTorch.

Port of music_spectrogram_diffusion_tpu/audio/vocoder.py:

* `GriffinLimVocoder`: weights-free; the mel filterbank's pseudo-inverse
  gives an approximate |STFT|, PGHI integrates an initial phase on the
  host (`ops/stft.py pghi_phase`, the C++ heap), and Griffin-Lim refines
  it on the device.
* `MagnitudeNet` + `HybridGLVocoder`: the trained mel inversion. A small
  conv net corrects the pinv magnitude, a mel-consistency projection
  restores mel(magnitude) ~= mel, then PGHI and fast Griffin-Lim.
* `SoundStreamDecoder` (with `ResidualUnit`, `DecoderBlock`): the GAN
  mel-inverter architecture, for converted or trained weights.
* `load_trained` / `load_soundstream`: the weights from an `.npz` (a JAX
  checkpoint exported by tools/export_jax_checkpoint.py, or the converted
  SoundStream weights of tools/convert_soundstream.py).

Every vocoder is a callable `[B, T, mel] log-mel -> [B, T * hop] audio` on
its device. On a CUDA device the convolutions run through cuDNN, which
uses TF32 unless `torch.backends.cudnn.allow_tf32` is False.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops

PHASE_INITS = ("pghi", "zero")


class _StagedGriffinLim:
  """What the Griffin-Lim vocoders share: a magnitude on the device, PGHI
  on the host, Griffin-Lim on the device."""

  def _init_gl(self, *, n_fft: int, hop_length: int, win_length: int,
               num_iters: int, phase_init: str, momentum: float, device):
    if phase_init not in PHASE_INITS:
      raise ValueError(f"phase_init {phase_init!r} not in {PHASE_INITS}")
    self.device = inference.resolve_device(device)
    self.hop_length = hop_length
    self.num_iters = num_iters
    self.phase_init = phase_init
    self.momentum = momentum
    self.stft_params = dict(frame_length=win_length, frame_step=hop_length,
                            fft_length=n_fft)

  def initial_phase(self, magnitude: torch.Tensor
                    ) -> Optional[torch.Tensor]:
    """PGHI's phase of `magnitude` (host C++ heap) on the vocoder's
    device, or None for phase_init='zero'."""
    if self.phase_init != "pghi":
      return None
    return torch.as_tensor(stft_ops.pghi_phase(
        magnitude.float().cpu().numpy(), **self.stft_params),
                           device=self.device)

  def griffin_lim(self, magnitude: torch.Tensor,
                  init_phase: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Griffin-Lim (FGLA with the vocoder's momentum) from `init_phase`,
    else from a random start drawn from `generator`, else from zero."""
    return stft_ops.griffin_lim(magnitude, num_iters=self.num_iters,
                                init_phase=init_phase, generator=generator,
                                momentum=self.momentum, **self.stft_params)

  def magnitude(self, log_mel: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError

  @torch.inference_mode()
  def __call__(self, log_mel: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, T, mel] log-mel -> [B, T * hop] audio on the vocoder's device.
    `generator` draws the random start of phase_init='zero' (none: zero
    phase)."""
    log_mel = torch.as_tensor(log_mel, dtype=torch.float32,
                              device=self.device)
    magnitude = self.magnitude(log_mel)
    return self.griffin_lim(magnitude, self.initial_phase(magnitude),
                            generator)


class GriffinLimVocoder(_StagedGriffinLim):
  """Weights-free mel inversion: pinv filterbank + PGHI + Griffin-Lim."""

  def __init__(self, *, sample_rate: int = 16000, n_fft: int = 1024,
               hop_length: int = 320, win_length: int = 640,
               n_mel_channels: int = 128, mel_fmin: float = 0.0,
               num_iters: int = 32, phase_init: str = "pghi",
               momentum: float = 0.0, device="cuda"):
    # momentum 0 (classic GL): the JAX package found FGLA slightly worse in
    # spectral convergence on pinv magnitudes.
    self._init_gl(n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                  num_iters=num_iters, phase_init=phase_init,
                  momentum=momentum, device=device)
    self.mel_basis = stft_ops.linear_to_mel_matrix(
        num_mel_bins=n_mel_channels, num_spectrogram_bins=n_fft // 2 + 1,
        sample_rate=sample_rate, lower_edge_hertz=mel_fmin,
        upper_edge_hertz=sample_rate // 2)

  def magnitude(self, log_mel: torch.Tensor) -> torch.Tensor:
    return stft_ops.mel_to_linear(torch.exp(log_mel), self.mel_basis)


def _conv1d(in_ch: int, out_ch: int, kernel_size: int,
            dilation: int = 1) -> nn.Conv1d:
  """Flax `nn.Conv(padding="SAME")` for an odd (dilated) kernel: the same
  padding on both sides."""
  if kernel_size % 2 == 0:
    raise ValueError(f"SAME padding here takes odd kernels, {kernel_size}")
  return nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation,
                   padding=dilation * (kernel_size - 1) // 2)


def _channels_last(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
  """Apply a conv over [B, T, C] (Flax's layout) -> [B, T, C']."""
  return conv(x.transpose(1, 2)).transpose(1, 2)


class MagnitudeNet(nn.Module):
  """Trained mel inversion: log-mel [B, T, mel] -> linear STFT magnitude
  [B, T, fft//2 + 1] at the same frame rate.

  The output is the mel pseudo-inverse baseline times a learned bounded
  correction, exp(max_log_correction * tanh(x)), so an untrained head (a
  zero `conv_out`) gives the pinv exactly. Parameters `conv_in`,
  `conv_mid` (k=5, SAME) and `conv_out` (k=1), as the JAX module names
  them (`convert.flax_convs_to_state_dict`).
  """

  def __init__(self, hidden: int = 512, out_bins: int = 513,
               kernel_size: int = 5, mel_bins: int = 128,
               sample_rate: int = 16000, max_log_correction: float = 4.0):
    super().__init__()
    self.hidden, self.out_bins = hidden, out_bins
    self.mel_bins, self.sample_rate = mel_bins, sample_rate
    self.max_log_correction = max_log_correction
    self.conv_in = _conv1d(mel_bins, hidden, kernel_size)
    self.conv_mid = _conv1d(hidden, hidden, kernel_size)
    self.conv_out = _conv1d(hidden, out_bins, 1)
    basis = self.mel_basis()
    # The pseudo-inverse in float32 on the host, as the JAX module's
    # mel_to_linear computes it (np.linalg.pinv), not torch.linalg.pinv.
    self.register_buffer("pinv", torch.from_numpy(
        np.linalg.pinv(basis)), persistent=False)

  def mel_basis(self) -> np.ndarray:
    """The filterbank [out_bins, mel_bins], upper edge sample_rate / 2."""
    return stft_ops.linear_to_mel_matrix(
        num_mel_bins=self.mel_bins, num_spectrogram_bins=self.out_bins,
        sample_rate=self.sample_rate, lower_edge_hertz=0.0,
        upper_edge_hertz=self.sample_rate / 2)

  def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
    base = torch.clamp(torch.exp(log_mel) @ self.pinv, min=0.0)
    x = F.elu(_channels_last(self.conv_in, log_mel))
    x = F.elu(_channels_last(self.conv_mid, x))
    x = _channels_last(self.conv_out, x)
    return base * torch.exp(self.max_log_correction * torch.tanh(x))


class HybridGLVocoder(_StagedGriffinLim):
  """Trained magnitude (MagnitudeNet) + PGHI + fast Griffin-Lim.

  `params` is the Flax variables dict of MagnitudeNet, `{"params": {...}}`,
  as the JAX package's HybridGLVocoder takes it (a vocoder checkpoint
  stores it so: `load_trained` passes it on as it is).
  """

  def __init__(self, params: Mapping[str, Any], *, n_fft: int = 1024,
               hop_length: int = 320, win_length: int = 640,
               hidden: int = 512, num_iters: int = 32,
               mel_consistency: bool = True, phase_init: str = "pghi",
               momentum: float = 0.9, device="cuda"):
    # momentum 0.9: FGLA improved every metric of the trained chain in the
    # JAX package's 16-clip evaluation.
    self._init_gl(n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                  num_iters=num_iters, phase_init=phase_init,
                  momentum=momentum, device=device)
    if set(params) != {"params"}:
      raise ValueError("HybridGLVocoder takes the Flax variables dict "
                       f"{{'params': ...}}, got keys {sorted(params)}")
    self.net = MagnitudeNet(hidden=hidden, out_bins=n_fft // 2 + 1)
    self.net.load_state_dict(
        convert.flax_convs_to_state_dict(params["params"], self.net),
        strict=True)
    self.net.to(self.device).eval().requires_grad_(False)
    self.mel_consistency = mel_consistency
    self.basis = torch.from_numpy(self.net.mel_basis()).to(self.device)

  def magnitude(self, log_mel: torch.Tensor) -> torch.Tensor:
    """The net's magnitude, projected onto mel consistency (if on):
    mag + (exp(log_mel) - mag @ basis) @ pinv, clamped at 0."""
    magnitude = self.net(log_mel)
    if self.mel_consistency:
      residual = torch.exp(log_mel) - magnitude @ self.basis
      magnitude = torch.clamp(magnitude + residual @ self.net.pinv, min=0.0)
    return magnitude


# --------------------------------------------------------------------------
# SoundStream-style decoder.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SoundStreamConfig:
  """SoundStream-style mel decoder (Zeghidour et al. 2021, fig. 4); the
  strides multiply to the codec hop (8 * 5 * 4 * 2 = 320)."""
  mel_bins: int = 128
  base_channels: int = 512
  strides: Tuple[int, ...] = (8, 5, 4, 2)
  dilations: Tuple[int, ...] = (1, 3, 9)
  kernel_size: int = 7

  @property
  def hop_size(self) -> int:
    return int(np.prod(self.strides))


def conv_transpose_padding(kernel: int, stride: int) -> Tuple[int, int]:
  """The (before, after) padding of Flax `ConvTranspose(padding="SAME")`
  (`lax._conv_transpose_padding`): asymmetric for odd strides, e.g.
  (7, 6) for kernel 10, stride 5."""
  pad_len = kernel + stride - 2
  pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
  return pad_a, pad_len - pad_a


class ConvTranspose1d(nn.Module):
  """Flax `nn.ConvTranspose(padding="SAME")` with its default
  `transpose_kernel=False`: zeros inserted between the inputs (stride s),
  the SAME padding of `conv_transpose_padding`, then a correlation with the
  kernel as stored (not flipped). Output length T * s."""

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
               stride: int):
    super().__init__()
    self.stride = stride
    self.padding = conv_transpose_padding(kernel_size, stride)
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
    self.bias = nn.Parameter(torch.empty(out_ch))
    fan_in = in_ch * kernel_size
    nn.init.uniform_(self.weight, -fan_in ** -0.5, fan_in ** -0.5)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, c, t = x.shape
    dilated = x.new_zeros(b, c, (t - 1) * self.stride + 1)
    dilated[..., ::self.stride] = x
    return F.conv1d(F.pad(dilated, self.padding), self.weight, self.bias)


class ResidualUnit(nn.Module):
  """x + pointwise(elu(dilated(elu(x)))), channels last."""

  def __init__(self, channels: int, dilation: int, kernel_size: int = 7):
    super().__init__()
    self.dilated_conv = _conv1d(channels, channels, kernel_size, dilation)
    self.pointwise_conv = _conv1d(channels, channels, 1)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    y = _channels_last(self.dilated_conv, F.elu(x))
    return x + _channels_last(self.pointwise_conv, F.elu(y))


class DecoderBlock(nn.Module):
  """elu, upsample by `stride` (ConvTranspose, kernel 2 * stride), then one
  ResidualUnit per dilation; channels last."""

  def __init__(self, in_ch: int, channels: int, stride: int,
               dilations: Sequence[int], kernel_size: int):
    super().__init__()
    self.upsample = ConvTranspose1d(in_ch, channels, 2 * stride, stride)
    for i, d in enumerate(dilations):
      self.add_module(f"residual_{i}",
                      ResidualUnit(channels, d, kernel_size))
    self.num_units = len(dilations)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = _channels_last(self.upsample, F.elu(x))
    for i in range(self.num_units):
      x = getattr(self, f"residual_{i}")(x)
    return x


class SoundStreamDecoder(nn.Module):
  """Mel [B, T, mel_bins] -> audio [B, T * hop]. Parameter names follow the
  Flax module's (`input_conv`, `block_<i>.upsample`,
  `block_<i>.residual_<j>.dilated_conv`, `output_conv`)."""

  def __init__(self, config: SoundStreamConfig = SoundStreamConfig()):
    super().__init__()
    self.config = config
    self.input_conv = _conv1d(config.mel_bins, config.base_channels,
                              config.kernel_size)
    channels = config.base_channels
    for i, stride in enumerate(config.strides):
      out = max(channels // 2, 32)
      self.add_module(f"block_{i}", DecoderBlock(
          channels, out, stride, config.dilations, config.kernel_size))
      channels = out
    self.output_conv = _conv1d(channels, 1, config.kernel_size)

  def forward(self, mel: torch.Tensor) -> torch.Tensor:
    x = _channels_last(self.input_conv, mel)
    for i in range(len(self.config.strides)):
      x = getattr(self, f"block_{i}")(x)
    x = _channels_last(self.output_conv, F.elu(x))
    return torch.tanh(x)[..., 0]


class SoundStreamVocoder:
  """A SoundStreamDecoder with its weights on a device, as a vocoder."""

  def __init__(self, decoder: SoundStreamDecoder, device="cuda"):
    self.device = inference.resolve_device(device)
    self.decoder = decoder.to(self.device).eval().requires_grad_(False)
    self.hop_length = decoder.config.hop_size

  @torch.inference_mode()
  def __call__(self, log_mel: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    del generator  # deterministic
    return self.decoder(torch.as_tensor(log_mel, dtype=torch.float32,
                                        device=self.device))


def _soundstream(params: Mapping[str, Any], base_channels: int,
                 device) -> SoundStreamVocoder:
  decoder = SoundStreamDecoder(SoundStreamConfig(base_channels=base_channels))
  decoder.load_state_dict(convert.flax_convs_to_state_dict(params, decoder),
                          strict=True)
  return SoundStreamVocoder(decoder, device)


def load_soundstream(npz_path: str, base_channels: int = 512,
                     device="cuda") -> SoundStreamVocoder:
  """Converted SoundStream weights (tools/convert_soundstream.py: an `.npz`
  of '<module/path>/<leaf>' arrays in SoundStreamDecoder's tree)."""
  params: dict = {}
  with np.load(npz_path) as raw:
    for key in raw.files:
      node = params
      parts = key.split("/")
      for part in parts[:-1]:
        node = node.setdefault(part, {})
      node[parts[-1]] = raw[key]
  return _soundstream(params, base_channels, device)


def load_trained(path: str, base_channels: int = 512, num_iters: int = 32,
                 phase_init: str = "pghi", momentum: float = 0.9,
                 device="cuda"):
  """A trained vocoder from an exported checkpoint (`.npz` of
  tools/export_jax_checkpoint.py on a cli/train_vocoder.py checkpoint).

  Its config_json routes: arch 'magnitude_gl' -> HybridGLVocoder(hidden);
  'soundstream' or none -> SoundStreamDecoder (base_channels from the
  config, else the argument). Both store the Flax variables dict, an extra
  `params` level. Anything that is not an export (an orbax directory)
  raises ValueError naming the export tool.
  """
  params, config_json, _ = convert.read_export(path)
  cfg = json.loads(config_json) if config_json else {}
  if "params" not in params:
    raise ValueError(f"{os.fspath(path)}: a vocoder export holds the Flax "
                     "variables dict (params/params/...)")
  if cfg.get("arch") == "magnitude_gl":
    return HybridGLVocoder(params, hidden=cfg.get("hidden", 512),
                           num_iters=num_iters, phase_init=phase_init,
                           momentum=momentum, device=device)
  return _soundstream(params["params"],
                      cfg.get("base_channels", base_channels), device)


ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")
# The repo's trained vocoder (JAX checkpoint results/round3/vocoder_ckpt/
# step_4000, arch magnitude_gl, hidden 512), exported.
TRAINED_MAGNITUDE_GL = os.path.join(ASSETS, "magnitude_gl_step4000.npz")
