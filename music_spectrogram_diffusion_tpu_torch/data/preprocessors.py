"""Preprocessors: tokenize, split, chunk, RLE, mel-encode, vocab encode.

The parts of music_spectrogram_diffusion_tpu/data/preprocessors.py that
`cli/synthesize_midi.segment_midi` and the synthetic training task
(`data/tasks.py Task.train_dataset`) call, copied as the JAX package has
them (the port imports nothing of the JAX package): audio framing,
`tokenize_example`, `rekey_transcription_to_synthesis`,
`split_cached_frames`, `select_random_chunk_with_feature_context`,
`split_full_song`, `note_representation_chain`, `encode_audio`,
`handle_too_long` and `tokenize_and_append_eos`. They keep the reference's
chunk/segment geometry (the additional-STFT-frames convention,
absolute-shift RLE) that defines what the published models were trained
on.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import run_length
from music_spectrogram_diffusion_tpu_torch.midi import sequences
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

Example = core.Example


def flatten_frames(frames: np.ndarray) -> np.ndarray:
  return np.reshape(frames, [-1])


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


def split_cached_frames(ex: Example, max_frames: int) -> Iterator[Example]:
  """Split a whole song into <= max_frames chunks pre-cache.

  Mirrors the reference's pre-cache split (tasks.py:107-118): targets
  (audio frames) and the aligned per-frame index arrays are sliced
  together; the event stream and state events pass through whole.
  """
  n = len(ex["targets"])
  for start in range(0, n, max_frames):
    sl = slice(start, start + max_frames)
    out = dict(ex)
    out["targets"] = ex["targets"][sl]
    out["input_times"] = ex["input_times"][sl]
    out["event_start_indices"] = ex["event_start_indices"][sl]
    out["event_end_indices"] = ex["event_end_indices"][sl]
    out["state_event_indices"] = ex["state_event_indices"][sl]
    yield out


def select_random_chunk_with_feature_context(
    ex: Example,
    seed: int,
    feature_key: str,
    feature_context_key: str,
    max_feature_length: int,
    max_context_length: int,
    audio_codec: codecs.MelGan,
    additional_feature_keys: Optional[Sequence[str]] = None,
    passthrough_feature_keys: Optional[Sequence[str]] = None,
    minimum_target_frames: int = 1,
) -> Example:
  """Random target chunk + the preceding frames as context.

  Start is drawn from [-max_context_length,
  n - max_context_length - minimum_target_frames), so the context may be
  partially or fully empty at song start — the geometry of reference
  preprocessors.py:751-860.
  """
  assert minimum_target_frames >= 1
  tokens = ex[feature_key]
  n_tokens = len(tokens)
  assert n_tokens >= minimum_target_frames

  rng = np.random.RandomState(seed)
  lo = -max_context_length
  hi = n_tokens - max_context_length - minimum_target_frames
  start = int(rng.randint(lo, max(hi, lo + 1)))

  context_start = max(0, start)
  context_end = start + max_context_length
  feature_start = context_end
  feature_end = min(feature_start + max_feature_length, n_tokens)

  extra_ctx = audio_codec.context_codec.additional_frames_for_encoding
  extra = audio_codec.additional_frames_for_encoding
  chunk = {
      feature_context_key:
          tokens[context_start:context_end + extra_ctx],
      feature_key:
          tokens[feature_start:feature_end + extra],
  }
  for k in additional_feature_keys or []:
    assert len(ex[k]) == n_tokens, (
        f"additional feature {k} length mismatch")
    chunk[k] = ex[k][feature_start:feature_end]
  for k in passthrough_feature_keys or []:
    chunk[k] = ex[k]
  return chunk


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


def encode_audio(
    ex: Example,
    audio_codec: codecs.MelGan,
    sequence_lengths: Mapping[str, int],
    targets_keys: Sequence[str] = (),
    context_keys: Sequence[str] = (),
    keys_to_pad: Optional[Sequence[str]] = None,
    lengths_include_eos_keys: Sequence[str] = (),
) -> Example:
  """Mel-encode audio frame features, slicing off the extra STFT frames.

  Matches reference encode_audio (preprocessors.py:631-696): the encode
  runs over target frames + additional_frames_for_encoding, then the
  extras are sliced off so the final frames are numerically clean; the
  raw sliced samples are kept under 'raw_<key>'.
  """
  ex = dict(ex)
  for k in list(targets_keys) + list(context_keys):
    ac = audio_codec.context_codec if k in context_keys else audio_codec
    frames = np.asarray(ex[k], np.float32)
    max_len = sequence_lengths[k]
    if k in lengths_include_eos_keys:
      max_len -= 1
    assert frames.shape[0] <= max_len + ac.additional_frames_for_encoding, (
        f"{k}: {frames.shape[0]} > {max_len} + extra")
    if keys_to_pad and k in keys_to_pad:
      padding = max(0, max_len - frames.shape[0])
      frames = np.pad(frames, [[0, padding], [0, 0]])
    samples = flatten_frames(frames[:max_len])
    ex[f"raw_{k}"] = samples
    # Zero-pad frames to the fixed maximum before encoding (pad_end
    # already zero-pads, so the extra zeros leave the valid frames
    # bit-identical); slice back to the true frame count afterwards.
    # encode_np keeps this host-side — no per-example jax dispatch.
    n_valid = frames.shape[0]
    if n_valid == 0:
      # Nothing to encode (e.g. the empty targets_context every
      # full-song eval segment carries) — skip the mel frontend instead
      # of running it over all-zero padding just to slice back to 0.
      ex[k] = np.zeros((0, ac.n_dims), np.float32)
      continue
    fixed_len = max_len + ac.additional_frames_for_encoding
    padded = np.pad(frames, [[0, fixed_len - n_valid], [0, 0]])
    encoded = np.asarray(ac.encode_np(flatten_frames(padded)[None, :])[0])
    assert encoded.shape[0] == fixed_len, (
        f"Length of {k} changed during encoding: "
        f"{fixed_len} -> {encoded.shape[0]}")
    ex[k] = encoded[:min(n_valid, max_len)].astype(np.float32)
  return ex


def handle_too_long(ex: Example,
                    sequence_lengths: Mapping[str, int],
                    lengths_include_eos_keys: Sequence[str] = (),
                    skip: bool = False) -> Optional[Example]:
  """Assert (or skip) examples with features over their max length."""
  for k, v in ex.items():
    if k not in sequence_lengths:
      continue
    max_len = sequence_lengths[k]
    if k in lengths_include_eos_keys:
      max_len -= 1
    if np.ndim(v) >= 1 and len(v) > max_len:
      if skip:
        return None
      raise ValueError(
          f'Value for "{k}" field exceeds maximum length '
          f"({len(v)} > {max_len})")
  return ex


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
