"""Weights-free vocoder: log-mel -> 16 kHz audio in PyTorch.

Port of `GriffinLimVocoder` from music_spectrogram_diffusion_tpu/audio/
vocoder.py: the mel filterbank's pseudo-inverse gives an approximate
|STFT|, PGHI integrates an initial phase on the host, and Griffin-Lim
refines it on the device. The trained MagnitudeNet / HybridGLVocoder wait
for an export of their checkpoint (ROADMAP).
"""

from __future__ import annotations

import torch

from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops


class GriffinLimVocoder:
  """pinv filterbank + PGHI phase init + Griffin-Lim."""

  def __init__(self, *, sample_rate: int = 16000, n_fft: int = 1024,
               hop_length: int = 320, win_length: int = 640,
               n_mel_channels: int = 128, mel_fmin: float = 0.0,
               num_iters: int = 32, device="cuda"):
    self.device = inference.resolve_device(device)
    self.hop_length = hop_length
    self.num_iters = num_iters
    self.stft_params = dict(frame_length=win_length, frame_step=hop_length,
                            fft_length=n_fft)
    self.mel_basis = stft_ops.linear_to_mel_matrix(
        num_mel_bins=n_mel_channels, num_spectrogram_bins=n_fft // 2 + 1,
        sample_rate=sample_rate, lower_edge_hertz=mel_fmin,
        upper_edge_hertz=sample_rate // 2)

  @torch.inference_mode()
  def __call__(self, log_mel: torch.Tensor) -> torch.Tensor:
    """[B, T, mel] log-mel -> [B, T * hop] audio on the vocoder's device."""
    log_mel = torch.as_tensor(log_mel, dtype=torch.float32,
                              device=self.device)
    magnitude = stft_ops.mel_to_linear(torch.exp(log_mel), self.mel_basis)
    init = torch.as_tensor(stft_ops.pghi_phase(
        magnitude.cpu().numpy(), **self.stft_params), device=self.device)
    # Classic GL (no FGLA momentum): the JAX package found momentum worse
    # in spectral convergence on pinv magnitudes.
    return stft_ops.griffin_lim(magnitude, num_iters=self.num_iters,
                                init_phase=init, **self.stft_params)
