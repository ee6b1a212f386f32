"""Vocabulary: codec construction, special tokens, program granularity.

The port's own copy of music_spectrogram_diffusion_tpu/midi/vocabularies.py
(the port imports nothing of the JAX package). Token id layout:

  0 = PAD, 1 = EOS, 2 = UNK, then codec classes shifted by +3,
  then `extra_ids` sentinel ids (t5 convention, default 100).

The embedding table is padded up to a multiple of 128 ids, as the
published checkpoints are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np

from music_spectrogram_diffusion_tpu_torch.midi import event_codec

# MIDI constants (note_seq values, restated to avoid the dependency).
MIN_MIDI_PITCH = 0
MAX_MIDI_PITCH = 127
MIN_MIDI_PROGRAM = 0
MAX_MIDI_PROGRAM = 127
MAX_MIDI_VELOCITY = 127

DECODED_EOS_ID = -1
DECODED_INVALID_ID = -2

DEFAULT_STEPS_PER_SECOND = 100
DEFAULT_MAX_SHIFT_SECONDS = 10
DEFAULT_NUM_VELOCITY_BINS = 127
DEFAULT_EXTRA_IDS = 100  # t5.data.DEFAULT_EXTRA_IDS


@dataclasses.dataclass(frozen=True)
class VocabularyConfig:
  steps_per_second: int = DEFAULT_STEPS_PER_SECOND
  max_shift_seconds: int = DEFAULT_MAX_SHIFT_SECONDS
  num_velocity_bins: int = DEFAULT_NUM_VELOCITY_BINS

  @property
  def abbrev_str(self) -> str:
    s = ""
    if self.steps_per_second != DEFAULT_STEPS_PER_SECOND:
      s += f"ss{self.steps_per_second}"
    if self.max_shift_seconds != DEFAULT_MAX_SHIFT_SECONDS:
      s += f"ms{self.max_shift_seconds}"
    if self.num_velocity_bins != DEFAULT_NUM_VELOCITY_BINS:
      s += f"vb{self.num_velocity_bins}"
    return s


def build_codec(vocab_config: VocabularyConfig) -> event_codec.Codec:
  """Event ranges: shift | pitch | velocity | tie | program | drum."""
  event_ranges = [
      event_codec.EventRange("pitch", MIN_MIDI_PITCH, MAX_MIDI_PITCH),
      # velocity bin 0 = note-off
      event_codec.EventRange("velocity", 0, vocab_config.num_velocity_bins),
      # marks the end of the tie section (pitches active at segment start)
      event_codec.EventRange("tie", 0, 0),
      event_codec.EventRange("program", MIN_MIDI_PROGRAM, MAX_MIDI_PROGRAM),
      event_codec.EventRange("drum", MIN_MIDI_PITCH, MAX_MIDI_PITCH),
  ]
  return event_codec.Codec(
      max_shift_steps=(vocab_config.steps_per_second *
                       vocab_config.max_shift_seconds),
      steps_per_second=vocab_config.steps_per_second,
      event_ranges=event_ranges)


def num_velocity_bins_from_codec(codec: event_codec.Codec) -> int:
  lo, hi = codec.event_type_range("velocity")
  return hi - lo


def velocity_to_bin(velocity, num_velocity_bins: int):
  """Vectorized; bin 0 reserved for note-off."""
  velocity = np.asarray(velocity)
  bins = np.ceil(
      num_velocity_bins * velocity / MAX_MIDI_VELOCITY).astype(np.int32)
  return np.where(velocity == 0, 0, bins)


def bin_to_velocity(velocity_bin, num_velocity_bins: int):
  velocity_bin = np.asarray(velocity_bin)
  vel = (MAX_MIDI_VELOCITY * velocity_bin / num_velocity_bins).astype(
      np.int32)
  return np.where(velocity_bin == 0, 0, vel)


def drop_programs(tokens: np.ndarray,
                  codec: event_codec.Codec) -> np.ndarray:
  """Remove program-change tokens from a token stream."""
  lo, hi = codec.event_type_range("program")
  tokens = np.asarray(tokens)
  return tokens[(tokens < lo) | (tokens > hi)]


def programs_to_midi_classes(tokens: np.ndarray,
                             codec: event_codec.Codec) -> np.ndarray:
  """Map each program token to the first program of its MIDI class (of 8)."""
  lo, hi = codec.event_type_range("program")
  tokens = np.asarray(tokens)
  is_program = (tokens >= lo) & (tokens <= hi)
  return np.where(is_program, lo + 8 * ((tokens - lo) // 8), tokens)


@dataclasses.dataclass(frozen=True)
class ProgramGranularity:
  tokens_map_fn: Callable[[np.ndarray, event_codec.Codec], np.ndarray]
  program_map_fn: Callable[[int], int]


PROGRAM_GRANULARITIES: Dict[str, ProgramGranularity] = {
    "flat": ProgramGranularity(
        tokens_map_fn=drop_programs,
        program_map_fn=lambda program: 0),
    "midi_class": ProgramGranularity(
        tokens_map_fn=programs_to_midi_classes,
        program_map_fn=lambda program: 8 * (program // 8)),
    "full": ProgramGranularity(
        tokens_map_fn=lambda tokens, codec: tokens,
        program_map_fn=lambda program: program),
}


class TokenVocabulary:
  """Pass-through vocabulary with PAD/EOS/UNK specials and extra ids."""

  PAD_ID = 0
  EOS_ID = 1
  UNK_ID = 2
  NUM_SPECIAL = 3

  def __init__(self, regular_ids: int, extra_ids: int = 0):
    self._num_regular = regular_ids
    self.extra_ids = extra_ids

  @property
  def eos_id(self) -> int:
    return self.EOS_ID

  @property
  def unk_id(self) -> int:
    return self.UNK_ID

  @property
  def pad_id(self) -> int:
    return self.PAD_ID

  @property
  def num_regular_tokens(self) -> int:
    return self._num_regular

  @property
  def base_vocab_size(self) -> int:
    return self.NUM_SPECIAL + self._num_regular

  @property
  def vocab_size(self) -> int:
    return self.base_vocab_size + self.extra_ids

  def encode(self, token_ids: np.ndarray) -> np.ndarray:
    """Codec ids -> vocab ids (+NUM_SPECIAL), validated."""
    token_ids = np.asarray(token_ids)
    if token_ids.size and (token_ids.min() < 0 or
                           token_ids.max() >= self._num_regular):
      bad = token_ids[(token_ids < 0) | (token_ids >= self._num_regular)]
      raise ValueError(
          f"token id(s) {bad} outside [0, {self._num_regular})")
    return token_ids + self.NUM_SPECIAL

  def decode(self, ids: np.ndarray) -> np.ndarray:
    """Vocab ids -> codec ids; EOS and everything after it -> -1 (EOS),
    other specials/extra ids -> -2 (invalid)."""
    ids = np.asarray(ids)
    eos_and_after = np.cumsum(ids == self.EOS_ID, axis=-1) > 0
    valid = (ids >= self.NUM_SPECIAL) & (ids < self.base_vocab_size)
    out = np.where(valid, ids - self.NUM_SPECIAL, DECODED_INVALID_ID)
    return np.where(eos_and_after, DECODED_EOS_ID, out)

  def __eq__(self, other) -> bool:
    return (isinstance(other, TokenVocabulary) and
            self.extra_ids == other.extra_ids and
            self._num_regular == other._num_regular)


def vocabulary_from_codec(codec: event_codec.Codec) -> TokenVocabulary:
  return TokenVocabulary(codec.num_classes, extra_ids=DEFAULT_EXTRA_IDS)


def num_embeddings(vocabulary: TokenVocabulary) -> int:
  """Vocab size padded to a multiple of 128 for TPU lane alignment."""
  return 128 * math.ceil(vocabulary.vocab_size / 128)
