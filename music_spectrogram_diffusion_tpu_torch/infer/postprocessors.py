"""Postprocessing: model outputs -> metric-ready dictionaries.

Port of music_spectrogram_diffusion_tpu/infer/postprocessors.py: decodes
predicted spectrograms to audio and attaches evaluation embeddings.
Embedders are pluggable callables registered in EMBEDDING_MODELS (VGGish
and TRILL register themselves when their converted weights are given:
infer/vggish.py, infer/trill.py). `mel_frame_embeddings` (mel frames as
the embedding space) is always available and is what the mel-Fréchet
metric uses.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch.ops import stft

Array = np.ndarray

# name -> callable([samples] float audio @16k) -> [frames, dim] embedding.
EMBEDDING_MODELS: Dict[str, Callable[[Array], Array]] = {}


def register_embedding_model(name: str,
                             fn: Callable[[Array], Array]) -> None:
  EMBEDDING_MODELS[name] = fn


def mel_frame_embeddings(audio: Array, sample_rate: int = 16000,
                         device="cpu") -> Array:
  """Log-mel frames as embeddings (always-available FAD space), computed
  on `device` (the registered default is the CPU; cli/evaluate.py
  registers its own device's)."""
  mel = stft.mel_spectrogram(
      torch.as_tensor(np.asarray(audio, np.float32), device=device)[None],
      sample_rate=sample_rate, n_fft=1024, hop_length=320, win_length=640,
      n_mel_channels=128, mel_fmin=0.0, mel_fmax=sample_rate // 2)
  return mel[0].cpu().numpy()


register_embedding_model("mel", mel_frame_embeddings)


def get_embeddings(audio: Array) -> Dict[str, Array]:
  """Run every registered embedder over an audio clip."""
  return {name: fn(audio) for name, fn in EMBEDDING_MODELS.items()}


def make_output_dict(audio_codec,
                     example: Mapping,
                     prediction: Optional[Array] = None,
                     is_target: bool = False,
                     vocoder=None,
                     compute_embeddings: bool = True) -> Dict:
  """Build the per-example dict consumed by metric functions.

  For targets: raw audio + its embeddings + the NoteSequence.
  For predictions: decode the predicted spectrogram to audio (via the
  attached vocoder, on its device) + embeddings + timing info.
  """
  del audio_codec  # the JAX signature's; the vocoder carries the codec
  out: Dict = {}
  if is_target:
    raw = example.get("raw_targets")
    out["raw_targets"] = raw
    out["sequence"] = example.get("sequence")
    if compute_embeddings and raw is not None:
      out["embeddings"] = get_embeddings(np.asarray(raw))
  else:
    assert prediction is not None
    out["predicted_features"] = np.asarray(prediction)
    if vocoder is not None:
      audio = vocoder(torch.as_tensor(np.asarray(prediction)[None]))
      audio = audio[0].cpu().numpy()
      out["audio"] = audio
      if compute_embeddings:
        out["embeddings"] = get_embeddings(audio)
    if "timings" in example:
      out["timings"] = example["timings"]
  return out
