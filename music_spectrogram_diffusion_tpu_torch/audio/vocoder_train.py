"""The vocoders' spectral loss in PyTorch.

Port of `stft_loss` (with `DEFAULT_RESOLUTIONS`) from
music_spectrogram_diffusion_tpu/audio/vocoder_train.py: the multi-
resolution STFT loss that scores a vocoder (cli/eval_vocoder.py). Vocoder
training is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops

# (fft_length, hop, win) triples for the multi-resolution loss.
DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (2048, 512, 1200), (1024, 256, 600), (512, 128, 240),
)


def stft_loss(pred: torch.Tensor, target: torch.Tensor,
              resolutions: Sequence[Tuple[int, int, int]] = (
                  DEFAULT_RESOLUTIONS)) -> Dict[str, torch.Tensor]:
  """Multi-resolution STFT loss (Yamamoto et al. 2020): spectral
  convergence ||T - P|| / ||T|| and the mean |log T - log P| (magnitudes
  clamped at 1e-5), each averaged over the resolutions."""
  sc_total = mag_total = 0.0
  for n_fft, hop, win in resolutions:
    p = stft_ops.stft_magnitude(pred, frame_length=win, frame_step=hop,
                                fft_length=n_fft)
    t = stft_ops.stft_magnitude(target, frame_length=win, frame_step=hop,
                                fft_length=n_fft)
    sc = torch.linalg.norm(t - p) / torch.clamp(torch.linalg.norm(t),
                                                min=1e-6)
    mag = torch.mean(torch.abs(torch.log(torch.clamp(t, min=1e-5))
                               - torch.log(torch.clamp(p, min=1e-5))))
    sc_total = sc_total + sc
    mag_total = mag_total + mag
  n = len(resolutions)
  return {"spectral_convergence": sc_total / n,
          "log_magnitude": mag_total / n}
