"""Train-step throughput metrics.

`throughput_metrics` of music_spectrogram_diffusion_tpu/train/metrics.py,
copied; the evaluation metrics (embedding distances, Fréchet audio
distance) are not ported yet.
"""

from __future__ import annotations

from typing import Dict


def throughput_metrics(num_seqs: float, num_frames: float,
                       step_seconds: float,
                       num_devices: int = 1,
                       num_steps: int = 1) -> Dict[str, float]:
  """Throughput over a window of `num_steps` steps taking
  `step_seconds` wall seconds total."""
  out = {
      "timing/seqs_per_second": num_seqs / step_seconds,
      "timing/target_frames_per_second": num_frames / step_seconds,
      "timing/seconds_per_step": step_seconds / max(num_steps, 1),
  }
  out["timing/seqs_per_second_per_core"] = (
      out["timing/seqs_per_second"] / num_devices)
  out["timing/target_frames_per_second_per_core"] = (
      out["timing/target_frames_per_second"] / num_devices)
  return out
