"""Image/audio summaries for evaluation logging.

Port of music_spectrogram_diffusion_tpu/train/summaries.py (the
equivalent of the reference's seqio metric_fns that render spectrogram
images and audio clips for TensorBoard), without the TF event-file
dependency: summaries are written as PNG/WAV files under a log directory,
with an index JSON for browsing. matplotlib is imported only by the image
summaries, so the scalar and audio summaries run where it is missing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

# TensorBoard audio cap in the reference (metrics.py:221): 10 MB.
MAX_AUDIO_BYTES = 10_000_000


def spectrogram_to_image(features: np.ndarray, audio_codec
                         ) -> np.ndarray:
  """Mel features -> uint8 RGB image (viridis, low freq at bottom)."""
  import matplotlib.cm as cm
  scaled = audio_codec.scale_features(
      torch.as_tensor(np.asarray(features)), output_range=(0.0, 1.0),
      clip=True).cpu().numpy()
  img = cm.viridis(scaled.T[::-1])[..., :3]  # [mels, frames, 3]
  return (img * 255).astype(np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
  import matplotlib.pyplot as plt
  plt.imsave(path, image)


class SummaryWriter:
  """Writes spectrogram images + audio clips + scalar index to disk."""

  def __init__(self, log_dir: str, audio_codec=None):
    self.log_dir = log_dir
    self.audio_codec = audio_codec
    os.makedirs(log_dir, exist_ok=True)
    self._index: Dict[str, list] = {"images": [], "audio": [],
                                    "scalars": []}
    # Per-step audio budget (the reference cap guards one metric
    # invocation, not the writer's lifetime — a lifetime cap would
    # silently stop audio for all later eval steps).
    self._audio_bytes: Dict[int, int] = {}

  def add_spectrogram_image(self, tag: str, step: int,
                            features: np.ndarray) -> Optional[str]:
    assert self.audio_codec is not None
    name = f"{tag.replace('/', '_')}_{step}.png"
    path = os.path.join(self.log_dir, name)
    write_png(path, spectrogram_to_image(features, self.audio_codec))
    self._index["images"].append({"tag": tag, "step": step, "file": name})
    self._flush_index()
    return path

  def add_audio(self, tag: str, step: int, audio: np.ndarray,
                sample_rate: int = 16000) -> Optional[str]:
    nbytes = audio.size * 2
    if self._audio_bytes.get(step, 0) + nbytes > MAX_AUDIO_BYTES:
      return None  # same per-invocation cap as the reference's TB logger
    from music_spectrogram_diffusion_tpu_torch.audio import wav_io
    name = f"{tag.replace('/', '_')}_{step}.wav"
    path = os.path.join(self.log_dir, name)
    wav_io.write_wav(path, audio, sample_rate)
    self._audio_bytes[step] = self._audio_bytes.get(step, 0) + nbytes
    self._index["audio"].append({"tag": tag, "step": step, "file": name})
    self._flush_index()
    return path

  def add_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
    self._index["scalars"].append(
        {"step": step, **{k: float(v) for k, v in scalars.items()}})
    self._flush_index()

  def _flush_index(self) -> None:
    with open(os.path.join(self.log_dir, "index.json"), "w") as f:
      json.dump(self._index, f, indent=2)


def eval_summaries(writer: SummaryWriter, step: int,
                   targets: Sequence[Mapping],
                   predictions: Sequence[Mapping],
                   audio_codec, vocoder=None,
                   max_examples: int = 5) -> None:
  """Write per-example target/prediction spectrograms (+ audio when a
  vocoder is attached), like the reference image/audio metric fns."""
  for i, (target, pred) in enumerate(
      zip(targets[:max_examples], predictions[:max_examples])):
    if "features" in target:
      writer.add_spectrogram_image(f"target/{i}", step,
                                   np.asarray(target["features"]))
    if "predicted_features" in pred:
      feats = np.asarray(pred["predicted_features"])
      writer.add_spectrogram_image(f"prediction/{i}", step, feats)
      if vocoder is not None:
        audio = vocoder(torch.as_tensor(feats[None]))[0].cpu().numpy()
        writer.add_audio(f"prediction/{i}", step, audio,
                         audio_codec.sample_rate)
    if "raw_targets" in target and target["raw_targets"] is not None:
      writer.add_audio(f"target/{i}", step,
                       np.asarray(target["raw_targets"]),
                       audio_codec.sample_rate)
