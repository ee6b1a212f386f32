"""Preprocessors of the MIDI front end: tokenize, split, RLE, vocab encode.

The parts of music_spectrogram_diffusion_tpu/data/preprocessors.py that
`cli/synthesize_midi.segment_midi` calls, copied as the JAX package has
them (the port imports nothing of the JAX package): audio framing,
`tokenize_example`, `rekey_transcription_to_synthesis`, `split_full_song`,
`note_representation_chain` and `tokenize_and_append_eos`. They keep the
reference's chunk/segment geometry (the additional-STFT-frames convention,
absolute-shift RLE) that defines what the published models were trained
on. The training-side chunking, audio encoding and length guards wait for
the data pipeline's port.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import run_length
from music_spectrogram_diffusion_tpu_torch.midi import sequences
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

Example = core.Example


def audio_to_frames(samples: np.ndarray, hop_size: int,
                    frame_rate: int) -> Tuple[np.ndarray, np.ndarray]:
  """Split audio into non-overlapping hop-sized frames + frame times.

  Matches reference _audio_to_frames (preprocessors.py:60-81): samples are
  right-padded to a multiple of hop_size first.
  """
  samples = np.asarray(samples, np.float32)
  frame_size = hop_size
  pad = frame_size - len(samples) % frame_size  # note: adds a full frame
  samples = np.pad(samples, [0, pad])           # when already aligned,
  num_frames = len(samples) // frame_size       # same as the reference
  frames = samples.reshape(num_frames, frame_size)
  times = np.arange(num_frames) / frame_rate
  return frames, times


def tokenize_example(
    ns: sequences.NoteSequence,
    samples: np.ndarray,
    audio_codec: codecs.MelGan,
    codec: event_codec.Codec,
    onsets_only: bool = False,
    include_ties: bool = True,
    example_id: Optional[str] = None,
) -> Example:
  """Tokenize one (NoteSequence, audio) pair.

  Output schema matches the reference tokenizers (preprocessors.py:188-197):
  inputs (audio frames), input_times, targets (single-step-shift event
  stream), event_start/end_indices, state_events, state_event_indices.
  """
  if onsets_only and include_ties:
    raise ValueError("Ties not supported when only modeling onsets.")
  sequences.validate_note_sequence(ns)

  frames, frame_times = audio_to_frames(
      samples, audio_codec.hop_size, audio_codec.frame_rate)

  if onsets_only:
    times, values = sequences.note_sequence_to_onsets(ns)
    spec = sequences.NoteOnsetEncodingSpec
  else:
    times, values = (
        sequences.note_sequence_to_onsets_and_offsets_and_programs(ns))
    spec = (sequences.NoteEncodingWithTiesSpec if include_ties
            else sequences.NoteEncodingSpec)

  (events, event_start_indices, event_end_indices, state_events,
   state_event_indices) = run_length.encode_and_index_events(
       state=spec.init_encoding_state_fn(),
       event_times=times,
       event_values=values,
       encode_event_fn=spec.encode_event_fn,
       codec=codec,
       frame_times=frame_times,
       encoding_state_to_events_fn=spec.encoding_state_to_events_fn)

  return {
      "inputs": frames,
      "input_times": frame_times.astype(np.float32),
      "targets": events,
      "event_start_indices": event_start_indices,
      "event_end_indices": event_end_indices,
      "state_events": state_events,
      "state_event_indices": state_event_indices,
      "sequence": ns,
      "id": example_id or "",
  }


def rekey_transcription_to_synthesis(ex: Example) -> Example:
  """Swap roles: synthesis consumes note events and produces audio.

  (Reference tasks.py:92-106 swaps inputs<->targets after tokenization.)
  """
  ex = dict(ex)
  ex["inputs"], ex["targets"] = ex["targets"], ex["inputs"]
  # Frame-aligned index arrays now index into 'inputs' (the events).
  return ex


def split_full_song(
    ex: Example,
    feature_key: str,
    max_tokens: int,
    audio_codec: codecs.MelGan,
    additional_feature_keys: Optional[Sequence[str]] = None,
    passthrough_feature_keys: Optional[Sequence[str]] = None,
) -> Iterator[Example]:
  """Split a song into consecutive <=max_tokens segments (eval path),
  each carrying additional STFT frames past its end."""
  tokens = ex[feature_key]
  n = len(tokens)
  extra = audio_codec.additional_frames_for_encoding
  for i, start in enumerate(range(0, n, max_tokens)):
    end = min(start + max_tokens, n)
    out = {}
    out[feature_key] = tokens[start:end + extra]
    for k in additional_feature_keys or []:
      out[k] = ex[k][start:end]
    for k in passthrough_feature_keys or []:
      out[k] = ex[k]
    out["segment_index"] = np.asarray(i, np.int32)
    out["segment_start_frame"] = np.asarray(start, np.int32)
    yield out


def note_representation_chain(
    ex: Example,
    codec: event_codec.Codec,
    include_ties: bool,
    granularity_type: str = "full",
    feature_key: str = "inputs",
) -> Example:
  """Slice the event tokens for the chosen audio chunk, apply program
  granularity, then run-length encode shifts.

  Reference chain: extract_sequence_with_indices -> map_midi_programs ->
  run_length_encode_shifts (tasks.py:151-171). For synthesis the events
  live in 'inputs' (after rekey).
  """
  tie_token = (codec.encode_event(event_codec.Event("tie", 0))
               if include_ties else None)
  ex = run_length.extract_sequence_with_indices(
      ex, state_events_end_token=tie_token, feature_key=feature_key)

  granularity = vocabularies.PROGRAM_GRANULARITIES[granularity_type]
  tokens = granularity.tokens_map_fn(ex[feature_key], codec)

  state_change_types = ("velocity", "program") if include_ties else ()
  tokens = run_length.run_length_encode_shifts(
      tokens, codec, state_change_event_types=state_change_types)

  out = dict(ex)
  out[feature_key] = tokens
  for k in ("event_start_indices", "event_end_indices", "state_events",
            "state_event_indices"):
    out.pop(k, None)
  return out


def tokenize_and_append_eos(ex: Example,
                            vocab: vocabularies.TokenVocabulary,
                            keys: Sequence[str] = ("inputs",)) -> Example:
  """Shift codec ids into vocab space and append EOS."""
  ex = dict(ex)
  for k in keys:
    encoded = vocab.encode(np.asarray(ex[k], np.int32))
    ex[k] = np.concatenate(
        [encoded, [vocab.eos_id]]).astype(np.int32)
  return ex
