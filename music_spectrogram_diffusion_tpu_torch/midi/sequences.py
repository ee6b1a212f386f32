"""Proto-free note sequences and note<->event conversion.

The port's own copy of music_spectrogram_diffusion_tpu/midi/sequences.py
(the port imports nothing of the JAX package). It replaces the reference's
note_seq.NoteSequence protobuf handling (note_sequences.py in the
music_spectrogram_diffusion reference) with a plain array-backed
container. Conversion semantics (sort orders, tie
sections, decoding state machine) are preserved exactly — they define the
token language the published models speak.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

Event = event_codec.Event

DEFAULT_VELOCITY = 100
DEFAULT_NOTE_DURATION = 0.01
# Quantization can produce zero-length notes; enforce a minimum duration.
MIN_NOTE_DURATION = 0.01


@dataclasses.dataclass
class Note:
  start_time: float
  end_time: float
  pitch: int
  velocity: int = DEFAULT_VELOCITY
  program: int = 0
  is_drum: bool = False
  instrument: int = 0


@dataclasses.dataclass
class NoteSequence:
  """A lightweight, mutable bag of notes (no proto, no ticks)."""
  notes: List[Note] = dataclasses.field(default_factory=list)
  total_time: float = 0.0

  def add(self, **kwargs) -> Note:
    note = Note(**kwargs)
    self.notes.append(note)
    self.total_time = max(self.total_time, note.end_time)
    return note

  def __len__(self) -> int:
    return len(self.notes)

  # -- array views ----------------------------------------------------------

  def to_arrays(self) -> Dict[str, np.ndarray]:
    n = self.notes
    return {
        "start_times": np.array([x.start_time for x in n], np.float64),
        "end_times": np.array([x.end_time for x in n], np.float64),
        "pitches": np.array([x.pitch for x in n], np.int32),
        "velocities": np.array([x.velocity for x in n], np.int32),
        "programs": np.array([x.program for x in n], np.int32),
        "is_drums": np.array([x.is_drum for x in n], bool),
    }

  @staticmethod
  def from_arrays(start_times, pitches, end_times=None, velocities=None,
                  programs=None, is_drums=None) -> "NoteSequence":
    ns = NoteSequence()
    n = len(start_times)
    for i in range(n):
      onset = float(start_times[i])
      offset = (onset + DEFAULT_NOTE_DURATION if end_times is None
                else float(end_times[i]))
      ns.add(start_time=onset,
             end_time=offset,
             pitch=int(pitches[i]),
             velocity=(DEFAULT_VELOCITY if velocities is None
                       else int(velocities[i])),
             program=0 if programs is None else int(programs[i]),
             is_drum=False if is_drums is None else bool(is_drums[i]))
    assign_instruments(ns)
    return ns


@dataclasses.dataclass(frozen=True)
class TrackSpec:
  name: str
  program: int = 0
  is_drum: bool = False


def extract_track(ns: NoteSequence, program: int,
                  is_drum: bool) -> NoteSequence:
  track = NoteSequence()
  track.notes = [n for n in ns.notes
                 if n.program == program and n.is_drum == is_drum]
  track.total_time = (max(n.end_time for n in track.notes)
                      if track.notes else 0.0)
  return track


def trim_overlapping_notes(ns: NoteSequence) -> NoteSequence:
  """Trim same-channel overlaps; drop notes left with zero length."""
  out = NoteSequence(total_time=ns.total_time)
  notes = [dataclasses.replace(n) for n in ns.notes]
  channels = set((n.pitch, n.program, n.is_drum) for n in notes)
  for pitch, program, is_drum in channels:
    chan = sorted((n for n in notes if n.pitch == pitch
                   and n.program == program and n.is_drum == is_drum),
                  key=lambda n: n.start_time)
    for prev, cur in zip(chan[:-1], chan[1:]):
      if prev.end_time > cur.start_time:
        prev.end_time = cur.start_time
  out.notes = [n for n in notes if n.start_time < n.end_time]
  return out


def assign_instruments(ns: NoteSequence) -> None:
  """Assign instrument numbers per program; drums get channel 9."""
  program_instruments: Dict[int, int] = {}
  for note in ns.notes:
    if note.is_drum:
      note.instrument = 9
    elif note.program not in program_instruments:
      num = len(program_instruments)
      note.instrument = num if num < 9 else num + 1
      program_instruments[note.program] = note.instrument
    else:
      note.instrument = program_instruments[note.program]


def validate_note_sequence(ns: NoteSequence) -> None:
  for note in ns.notes:
    if note.start_time >= note.end_time:
      raise ValueError(
          f"note has start time >= end time: "
          f"{note.start_time} >= {note.end_time}")
    if note.velocity == 0:
      raise ValueError("note has zero velocity")


# ---------------------------------------------------------------------------
# NoteSequence -> timed event data.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NoteEventData:
  pitch: int
  velocity: Optional[int] = None
  program: Optional[int] = None
  is_drum: Optional[bool] = None
  instrument: Optional[int] = None


def note_sequence_to_onsets(
    ns: NoteSequence) -> Tuple[List[float], List[NoteEventData]]:
  """Onsets only; pitch sort as stable-sort tiebreaker."""
  notes = sorted(ns.notes, key=lambda n: n.pitch)
  return ([n.start_time for n in notes],
          [NoteEventData(pitch=n.pitch) for n in notes])


def note_sequence_to_onsets_and_offsets(
    ns: NoteSequence) -> Tuple[List[float], List[NoteEventData]]:
  """Onsets + offsets (velocity 0); offsets listed first as tiebreaker."""
  notes = sorted(ns.notes, key=lambda n: n.pitch)
  times = ([n.end_time for n in notes] + [n.start_time for n in notes])
  values = ([NoteEventData(pitch=n.pitch, velocity=0) for n in notes] +
            [NoteEventData(pitch=n.pitch, velocity=n.velocity)
             for n in notes])
  return times, values


def note_sequence_to_onsets_and_offsets_and_programs(
    ns: NoteSequence) -> Tuple[List[float], List[NoteEventData]]:
  """Multi-instrument variant; drums have no offsets."""
  notes = sorted(ns.notes, key=lambda n: (n.is_drum, n.program, n.pitch))
  times = ([n.end_time for n in notes if not n.is_drum] +
           [n.start_time for n in notes])
  values = ([NoteEventData(pitch=n.pitch, velocity=0, program=n.program,
                           is_drum=False)
             for n in notes if not n.is_drum] +
            [NoteEventData(pitch=n.pitch, velocity=n.velocity,
                           program=n.program, is_drum=n.is_drum)
             for n in notes])
  return times, values


# ---------------------------------------------------------------------------
# Event-data -> codec events (encoding) with tie-section state.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NoteEncodingState:
  """Tracks active pitches (velocity bin per (pitch, program))."""
  active_pitches: Dict[Tuple[int, int], int] = dataclasses.field(
      default_factory=dict)


def note_event_data_to_events(
    state: Optional[NoteEncodingState],
    value: NoteEventData,
    codec: event_codec.Codec) -> Sequence[Event]:
  """Convert one NoteEventData to codec events, updating tie state."""
  if value.velocity is None:
    return [Event("pitch", value.pitch)]
  num_velocity_bins = vocabularies.num_velocity_bins_from_codec(codec)
  velocity_bin = int(vocabularies.velocity_to_bin(
      value.velocity, num_velocity_bins))
  if value.program is None:
    if state is not None:
      state.active_pitches[(value.pitch, 0)] = velocity_bin
    return [Event("velocity", velocity_bin), Event("pitch", value.pitch)]
  if value.is_drum:
    return [Event("velocity", velocity_bin), Event("drum", value.pitch)]
  if state is not None:
    state.active_pitches[(value.pitch, value.program)] = velocity_bin
  return [Event("program", value.program),
          Event("velocity", velocity_bin),
          Event("pitch", value.pitch)]


def note_encoding_state_to_events(
    state: NoteEncodingState) -> Sequence[Event]:
  """Active-note (program, pitch) events + terminating tie event."""
  events = []
  for pitch, program in sorted(state.active_pitches.keys(),
                               key=lambda k: k[::-1]):
    if state.active_pitches[(pitch, program)]:
      events += [Event("program", program), Event("pitch", pitch)]
  events.append(Event("tie", 0))
  return events


# ---------------------------------------------------------------------------
# Token decoding state machine (tokens -> NoteSequence).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NoteDecodingState:
  current_time: float = 0.0
  current_velocity: int = DEFAULT_VELOCITY
  current_program: int = 0
  # (pitch, program) -> (onset time, velocity)
  active_pitches: Dict[Tuple[int, int], Tuple[float, int]] = (
      dataclasses.field(default_factory=dict))
  tied_pitches: Set[Tuple[int, int]] = dataclasses.field(
      default_factory=set)
  is_tie_section: bool = False
  note_sequence: NoteSequence = dataclasses.field(
      default_factory=NoteSequence)


def _add_note(ns: NoteSequence, start_time, end_time, pitch, velocity,
              program=0, is_drum=False) -> None:
  end_time = max(end_time, start_time + MIN_NOTE_DURATION)
  ns.add(start_time=start_time, end_time=end_time, pitch=pitch,
         velocity=velocity, program=program, is_drum=is_drum)


def decode_note_onset_event(state: NoteDecodingState, time: float,
                            event: Event,
                            codec: event_codec.Codec) -> None:
  """Onsets-only decoding."""
  del codec
  if event.type != "pitch":
    raise ValueError(f"unexpected event type: {event.type}")
  state.note_sequence.add(
      start_time=time, end_time=time + DEFAULT_NOTE_DURATION,
      pitch=event.value, velocity=DEFAULT_VELOCITY)


def decode_note_event(state: NoteDecodingState, time: float,
                      event: Event, codec: event_codec.Codec) -> None:
  """Full decoding: velocities, programs, drums, tie sections."""
  if time < state.current_time:
    raise ValueError(
        f"event time < current time, {time} < {state.current_time}")
  state.current_time = time
  if event.type == "pitch":
    pitch = event.value
    key = (pitch, state.current_program)
    if state.is_tie_section:
      if key not in state.active_pitches:
        raise ValueError(
            f"inactive pitch/program in tie section: {key}")
      if key in state.tied_pitches:
        raise ValueError(f"pitch/program is already tied: {key}")
      state.tied_pitches.add(key)
    elif state.current_velocity == 0:
      if key not in state.active_pitches:
        raise ValueError(f"note-off for inactive pitch/program: {key}")
      onset_time, onset_velocity = state.active_pitches.pop(key)
      _add_note(state.note_sequence, onset_time, time, pitch,
                onset_velocity, state.current_program)
    else:
      if key in state.active_pitches:
        # Already active: close the previous note and restart.
        onset_time, onset_velocity = state.active_pitches.pop(key)
        _add_note(state.note_sequence, onset_time, time, pitch,
                  onset_velocity, state.current_program)
      state.active_pitches[key] = (time, state.current_velocity)
  elif event.type == "drum":
    if state.current_velocity == 0:
      raise ValueError("velocity cannot be zero for drum event")
    _add_note(state.note_sequence, time, time + DEFAULT_NOTE_DURATION,
              event.value, state.current_velocity, is_drum=True)
  elif event.type == "velocity":
    nbins = vocabularies.num_velocity_bins_from_codec(codec)
    state.current_velocity = int(
        vocabularies.bin_to_velocity(event.value, nbins))
  elif event.type == "program":
    state.current_program = event.value
  elif event.type == "tie":
    if not state.is_tie_section:
      raise ValueError("tie section end event when not in tie section")
    for key in list(state.active_pitches.keys()):
      if key not in state.tied_pitches:
        pitch, program = key
        onset_time, onset_velocity = state.active_pitches.pop(key)
        _add_note(state.note_sequence, onset_time, state.current_time,
                  pitch, onset_velocity, program)
    state.is_tie_section = False
  else:
    raise ValueError(f"unexpected event type: {event.type}")


def begin_tied_pitches_section(state: NoteDecodingState) -> None:
  state.tied_pitches = set()
  state.is_tie_section = True


def flush_note_decoding_state(state: NoteDecodingState) -> NoteSequence:
  """Close all active notes and finalize the NoteSequence."""
  for onset_time, _ in state.active_pitches.values():
    state.current_time = max(state.current_time,
                             onset_time + MIN_NOTE_DURATION)
  for key in list(state.active_pitches.keys()):
    pitch, program = key
    onset_time, onset_velocity = state.active_pitches.pop(key)
    _add_note(state.note_sequence, onset_time, state.current_time, pitch,
              onset_velocity, program)
  assign_instruments(state.note_sequence)
  return state.note_sequence


# ---------------------------------------------------------------------------
# Encoding specs (bundled state-machine hooks, reference :410-445).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EventEncodingSpec:
  init_encoding_state_fn: callable
  encode_event_fn: callable
  encoding_state_to_events_fn: Optional[callable]
  init_decoding_state_fn: callable
  begin_decoding_segment_fn: callable
  decode_event_fn: callable
  flush_decoding_state_fn: callable


NoteOnsetEncodingSpec = EventEncodingSpec(
    init_encoding_state_fn=lambda: None,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=None,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=lambda state: None,
    decode_event_fn=decode_note_onset_event,
    flush_decoding_state_fn=lambda state: state.note_sequence)


NoteEncodingSpec = EventEncodingSpec(
    init_encoding_state_fn=lambda: None,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=None,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=lambda state: None,
    decode_event_fn=decode_note_event,
    flush_decoding_state_fn=flush_note_decoding_state)


NoteEncodingWithTiesSpec = EventEncodingSpec(
    init_encoding_state_fn=NoteEncodingState,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=note_encoding_state_to_events,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=begin_tied_pitches_section,
    decode_event_fn=decode_note_event,
    flush_decoding_state_fn=flush_note_decoding_state)
