"""Run-length encoding of timed events with audio-frame indexing.

The port's own copy of music_spectrogram_diffusion_tpu/midi/run_length.py
(the port imports nothing of the JAX package). Semantics-equivalent to the
reference's run_length_encoding.py but re-engineered for throughput: the reference's `encode_and_index_events`
walks every 10 ms step of a song in a Python loop (the known host-side
bottleneck that forces offline seqio caching); here the loop runs only
over *events*, and the per-frame index arrays are computed with a single
vectorized searchsorted over the shift-step grid.

Token stream layout produced (identical to reference):
  [shift(1) x k, events@step_a, shift(1) x m, events@step_b, ...,
   trailing shift(1)s covering every audio frame]
with per-frame arrays event_start_indices / event_end_indices /
state_event_indices used later to slice out aligned segments.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from music_spectrogram_diffusion_tpu_torch.midi import event_codec

Event = event_codec.Event


def encode_and_index_events(
    state: Any,
    event_times: Sequence[float],
    event_values: Sequence[Any],
    encode_event_fn: Callable[[Any, Any, event_codec.Codec],
                              Sequence[Event]],
    codec: event_codec.Codec,
    frame_times: Sequence[float],
    encoding_state_to_events_fn: Optional[
        Callable[[Any], Sequence[Event]]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
  """Encode timed events into single-step shifts + event tokens, indexed
  to audio frames.

  Returns (events, event_start_indices, event_end_indices, state_events,
  state_event_indices) with the exact reference semantics
  (run_length_encoding.py:62-166): frame i's start index points at the
  shift token whose step first passes the frame's time, and state events
  snapshot the encoding state immediately before each event group.
  """
  frame_times = np.asarray(frame_times, np.float64)
  sps = codec.steps_per_second
  shift_token = codec.encode_event(Event("shift", 1))

  order = np.argsort(np.asarray(event_times), kind="stable")
  event_steps = [round(float(event_times[i]) * sps) for i in order]
  event_values = [event_values[i] for i in order]

  events: list = []
  state_events: list = []
  # A[s-1] = len(events) right after appending the shift token for step s;
  # SA[s-1] = len(state_events) at that moment. Frame index math below
  # reconstructs the reference's incremental cur_event_idx bookkeeping.
  after_shift_event_count: list = []
  after_shift_state_count: list = []
  cur_step = 0

  def append_shifts_until(step: int) -> None:
    nonlocal cur_step
    while cur_step < step:
      events.append(shift_token)
      cur_step += 1
      after_shift_event_count.append(len(events))
      after_shift_state_count.append(len(state_events))

  for step, value in zip(event_steps, event_values):
    append_shifts_until(step)
    if encoding_state_to_events_fn:
      for e in encoding_state_to_events_fn(state):
        state_events.append(codec.encode_event(e))
    for e in encode_event_fn(state, value, codec):
      events.append(codec.encode_event(e))

  # Trailing shifts: cover every audio frame (inclusive comparison matches
  # the reference — a step landing exactly on the last frame still needs
  # one more shift to pass it). The state counter is NOT advanced here:
  # the reference's trailing loop only updates cur_event_idx
  # (run_length_encoding.py:148-152), so frames filled by trailing shifts
  # keep the state index from the last event-driven shift.
  frozen_state_count = (after_shift_state_count[-1]
                        if after_shift_state_count else 0)
  while cur_step / sps <= frame_times[-1]:
    events.append(shift_token)
    cur_step += 1
    after_shift_event_count.append(len(events))
    after_shift_state_count.append(frozen_state_count)

  # Frame f is covered by the first step s with frame_time[f] < s / sps.
  shift_times = np.arange(1, cur_step + 1, dtype=np.float64) / sps
  s_f = np.searchsorted(shift_times, frame_times, side="right") + 1
  assert s_f.max(initial=1) <= cur_step, "frames not covered by shifts"

  # The reference assigns each frame the event/state counts recorded just
  # after the *previous* step's shift (cur_event_idx lags by one step).
  a = np.asarray(after_shift_event_count)
  sa = np.asarray(after_shift_state_count)
  event_start_indices = np.where(s_f >= 2, a[np.maximum(s_f - 2, 0)], 0)
  state_event_indices = np.where(s_f >= 2, sa[np.maximum(s_f - 2, 0)], 0)
  event_end_indices = np.concatenate(
      [event_start_indices[1:], [len(events)]])

  return (np.asarray(events, np.int32),
          event_start_indices.astype(np.int32),
          event_end_indices.astype(np.int32),
          np.asarray(state_events, np.int32),
          state_event_indices.astype(np.int32))


def extract_sequence_with_indices(
    features: dict,
    state_events_end_token: Optional[int] = None,
    feature_key: str = "targets") -> dict:
  """Slice the event tokens matching an audio segment; optionally prepend
  the segment's state-event (tie section) prefix."""
  features = dict(features)
  start_idx = int(features["event_start_indices"][0])
  end_idx = int(features["event_end_indices"][-1])

  tokens = np.asarray(features[feature_key])[start_idx:end_idx]

  if state_events_end_token is not None:
    state_events = np.asarray(features["state_events"])
    state_start = int(features["state_event_indices"][0])
    state_end = state_start + 1
    while state_events[state_end - 1] != state_events_end_token:
      state_end += 1
    tokens = np.concatenate([state_events[state_start:state_end], tokens])

  features[feature_key] = tokens.astype(np.int32)
  return features


def run_length_encode_shifts(
    tokens: np.ndarray,
    codec: event_codec.Codec,
    state_change_event_types: Sequence[str] = (),
) -> np.ndarray:
  """Merge single-step shifts into absolute-step shift tokens and drop
  redundant state-change events.

  Matches reference run_length_encode_shifts_fn
  (run_length_encoding.py:197-271): emitted shift values encode the TOTAL
  number of steps since segment start (split into <=max_shift_steps
  chunks), trailing shifts are trimmed, and a state-change event equal to
  the current state of its type is dropped.
  """
  state_change_ranges = [codec.event_type_range(t)
                         for t in state_change_event_types]
  tokens = np.asarray(tokens)

  shift_steps = 0
  total_shift_steps = 0
  current_state = np.zeros(len(state_change_ranges), np.int64)
  output: list = []

  for event in tokens.tolist():
    if codec.is_shift_event_index(event):
      shift_steps += 1
      total_shift_steps += 1
      continue
    is_redundant = False
    for i, (lo, hi) in enumerate(state_change_ranges):
      if lo <= event <= hi:
        if current_state[i] == event:
          is_redundant = True
        current_state[i] = event
    if is_redundant:
      continue
    if shift_steps > 0:
      shift_steps = total_shift_steps
      while shift_steps > 0:
        output_steps = min(codec.max_shift_steps, shift_steps)
        output.append(output_steps)
        shift_steps -= output_steps
    output.append(event)

  return np.asarray(output, np.int32)


def decode_events(
    state: Any,
    tokens: np.ndarray,
    start_time: float,
    max_time: Optional[float],
    codec: event_codec.Codec,
    decode_event_fn: Callable[[Any, float, Event, event_codec.Codec],
                              None],
) -> Tuple[int, int]:
  """Decode a token stream through a stateful event consumer.

  Returns (invalid_events, dropped_events); events past max_time are
  dropped, undecodable tokens are counted as invalid.
  """
  invalid_events = 0
  dropped_events = 0
  cur_steps = 0
  cur_time = start_time
  for token_idx, token in enumerate(np.asarray(tokens).tolist()):
    try:
      event = codec.decode_event_index(token)
    except ValueError:
      invalid_events += 1
      continue
    if event.type == "shift":
      cur_steps += event.value
      cur_time = start_time + cur_steps / codec.steps_per_second
      if max_time and cur_time > max_time:
        dropped_events = len(tokens) - token_idx
        break
    else:
      cur_steps = 0
      try:
        decode_event_fn(state, cur_time, event, codec)
      except ValueError:
        invalid_events += 1
        continue
  return invalid_events, dropped_events
