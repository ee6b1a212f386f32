"""Transcription-based evaluation plug-in interface.

A copy of music_spectrogram_diffusion_tpu/infer/transcription.py on the
port's midi/sequences.py and midi/vocabularies.py. The reference scores
synthesized audio by transcribing it with MT3 and comparing note F1 against
the ground-truth NoteSequence at flat/midi_class/full program granularity.
The transcriber is a pluggable callable (`infer/mt3.py` registers one);
the note-comparison scoring is implemented here.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from music_spectrogram_diffusion_tpu_torch.midi import sequences
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

# audio [samples] @ 16 kHz -> transcribed NoteSequence.
Transcriber = Callable[[np.ndarray], sequences.NoteSequence]

_TRANSCRIBER: Optional[Transcriber] = None


def register_transcriber(fn: Transcriber) -> None:
  """Install a transcription model (e.g. an MT3 port)."""
  global _TRANSCRIBER
  _TRANSCRIBER = fn


def get_transcriber() -> Optional[Transcriber]:
  return _TRANSCRIBER


def _notes_by_granularity(ns: sequences.NoteSequence,
                          granularity_type: str):
  """(onset, pitch, mapped_program, is_drum) tuples for matching."""
  program_map = vocabularies.PROGRAM_GRANULARITIES[
      granularity_type].program_map_fn
  return [(round(n.start_time, 2), n.pitch,
           0 if n.is_drum else program_map(n.program), n.is_drum)
          for n in ns.notes]


def note_onset_scores(ref: sequences.NoteSequence,
                      est: sequences.NoteSequence,
                      granularity_type: str = "flat",
                      onset_tolerance: float = 0.05) -> Dict[str, float]:
  """Program-aware onset precision/recall/F1 (mir_eval-style matching).

  Greedy one-to-one matching on (pitch, program, is_drum) with onsets
  within +-onset_tolerance — the onset-only variant of the reference's
  mt3 program_aware_note_scores.
  """
  ref_notes = _notes_by_granularity(ref, granularity_type)
  est_notes = _notes_by_granularity(est, granularity_type)

  ref_by_key = collections.defaultdict(list)
  for onset, pitch, program, is_drum in ref_notes:
    ref_by_key[(pitch, program, is_drum)].append(onset)
  for v in ref_by_key.values():
    v.sort()

  matched = 0
  used = {k: np.zeros(len(v), bool) for k, v in ref_by_key.items()}
  for onset, pitch, program, is_drum in sorted(est_notes):
    key = (pitch, program, is_drum)
    if key not in ref_by_key:
      continue
    onsets = ref_by_key[key]
    flags = used[key]
    idx = np.searchsorted(onsets, onset)
    best, best_dist = -1, onset_tolerance + 1e-9
    for j in (idx - 1, idx):
      if 0 <= j < len(onsets) and not flags[j]:
        d = abs(onsets[j] - onset)
        if d < best_dist:
          best, best_dist = j, d
    if best >= 0 and best_dist <= onset_tolerance:
      flags[best] = True
      matched += 1

  precision = matched / max(len(est_notes), 1)
  recall = matched / max(len(ref_notes), 1)
  f1 = (2 * precision * recall / max(precision + recall, 1e-9))
  prefix = f"Onset + program precision/recall/F1 ({granularity_type})"
  return {f"{prefix} precision": precision,
          f"{prefix} recall": recall,
          f"{prefix} F1": f1}


def transcription_metrics(
    targets: Sequence[Dict], predictions: Sequence[Dict]
) -> Dict[str, float]:
  """Reference transcription_metric_fn shape (metrics.py:422-446):
  per-granularity scores of (a) the model's transcribed audio and (b)
  the transcribed ground-truth audio (a metric ceiling), vs the true
  NoteSequence."""
  scores = collections.defaultdict(list)
  for target, prediction in zip(targets, predictions):
    if "transcribed_audio" not in prediction:
      continue
    ns_gt = target["sequence"]
    for granularity in ["flat", "midi_class", "full"]:
      for name, value in note_onset_scores(
          ns_gt, prediction["transcribed_audio"], granularity).items():
        scores[f"Model {name}"].append(value)
      if "transcribed_audio" in target:
        for name, value in note_onset_scores(
            ns_gt, target["transcribed_audio"], granularity).items():
          scores[f"GT {name}"].append(value)
  return {k: float(np.mean(v)) for k, v in scores.items()}
