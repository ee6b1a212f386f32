"""Typed-event <-> integer-token codec.

The port's own copy of music_spectrogram_diffusion_tpu/midi/event_codec.py
(the port imports nothing of the JAX package). The id space is the
concatenation of per-type ranges, with 'shift' forced to be block 0 so
shift tokens coincide with their step values. The codec is table-driven and
exposes vectorized numpy encode/decode over whole arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EventRange:
  type: str
  min_value: int
  max_value: int

  @property
  def size(self) -> int:
    return self.max_value - self.min_value + 1


@dataclasses.dataclass(frozen=True)
class Event:
  type: str
  value: int


class Codec:
  """Maps typed events to flat token ids by concatenated ranges."""

  def __init__(self, max_shift_steps: int, steps_per_second: float,
               event_ranges: Sequence[EventRange]):
    self.steps_per_second = steps_per_second
    self._shift_range = EventRange("shift", 0, max_shift_steps)
    self._event_ranges: List[EventRange] = (
        [self._shift_range] + list(event_ranges))
    names = [er.type for er in self._event_ranges]
    assert len(names) == len(set(names)), "duplicate event types"

    # Precomputed offset table for O(1) vectorized encode/decode.
    self._offsets: Dict[str, int] = {}
    offset = 0
    for er in self._event_ranges:
      self._offsets[er.type] = offset
      offset += er.size
    self._num_classes = offset
    # Sorted arrays for vectorized decode (searchsorted over range starts).
    self._range_starts = np.array(
        [self._offsets[er.type] for er in self._event_ranges])
    self._range_mins = np.array([er.min_value for er in self._event_ranges])
    self._range_types = [er.type for er in self._event_ranges]

  @property
  def num_classes(self) -> int:
    return self._num_classes

  @property
  def max_shift_steps(self) -> int:
    return self._shift_range.max_value

  @property
  def event_types(self) -> List[str]:
    return list(self._range_types)

  def is_shift_event_index(self, index) -> np.ndarray:
    """Vectorized: True where index is a shift token (works on arrays)."""
    return ((self._shift_range.min_value <= index) &
            (index <= self._shift_range.max_value))

  def event_type_range(self, event_type: str) -> Tuple[int, int]:
    """[min_id, max_id] for an event type."""
    if event_type not in self._offsets:
      raise ValueError(f"Unknown event type: {event_type}")
    offset = self._offsets[event_type]
    er = self._event_ranges[self._range_types.index(event_type)]
    return offset, offset + er.size - 1

  def encode_event(self, event: Event) -> int:
    """Encode a single Event to a token id (scalar parity API)."""
    return int(self.encode(event.type, event.value))

  def encode(self, event_type: str, values) -> np.ndarray:
    """Vectorized encode: values (scalar or array) of one type -> ids."""
    if event_type not in self._offsets:
      raise ValueError(f"Unknown event type: {event_type}")
    er = self._event_ranges[self._range_types.index(event_type)]
    values = np.asarray(values)
    if np.any(values < er.min_value) or np.any(values > er.max_value):
      bad = values[(values < er.min_value) | (values > er.max_value)]
      raise ValueError(
          f"Event value(s) {bad} outside [{er.min_value}, {er.max_value}] "
          f"for type {event_type}")
    return self._offsets[event_type] + values - er.min_value

  def decode_event_index(self, index: int) -> Event:
    """Decode one token id to an Event (scalar parity API)."""
    types, values = self.decode(np.asarray([index]))
    if types[0] < 0:
      raise ValueError(f"Unknown event index: {index}")
    return Event(type=self._range_types[types[0]], value=int(values[0]))

  def decode(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized decode: ids -> (type_idx array, value array).

    type_idx indexes into `self.event_types`; -1 marks invalid ids.
    """
    indices = np.asarray(indices)
    type_idx = np.searchsorted(self._range_starts, indices, side="right") - 1
    valid = (indices >= 0) & (indices < self._num_classes)
    type_idx = np.where(valid, type_idx, -1)
    safe = np.clip(type_idx, 0, len(self._range_types) - 1)
    values = (indices - self._range_starts[safe] + self._range_mins[safe])
    return type_idx, np.where(valid, values, -1)
