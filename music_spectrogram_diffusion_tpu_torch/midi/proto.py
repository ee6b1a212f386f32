"""note_seq NoteSequence protobuf wire-format parsing (no protobuf dep).

The port's own copy of music_spectrogram_diffusion_tpu/midi/proto.py (the
port imports nothing of the JAX package).

The published TFRecords store serialized `tensorflow.magenta.NoteSequence`
protos (reference preprocessors.py:142,315,529). This module decodes the
subset of fields the pipeline needs — notes, tempos, control changes,
pitch bends, total_time — straight from the wire format.

Field numbers follow magenta's music.proto; they are collected in the
constants below so they can be corrected in one place if a field is
found to disagree with real data.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

from music_spectrogram_diffusion_tpu_torch.midi import sequences

# NoteSequence field numbers (magenta music.proto).
NS_ID = 1
NS_FILENAME = 2
NS_COLLECTION_NAME = 4
NS_TICKS_PER_QUARTER = 5
NS_TIME_SIGNATURES = 6
NS_KEY_SIGNATURES = 7
NS_TEMPOS = 8
NS_NOTES = 9
NS_TOTAL_TIME = 10
NS_PITCH_BENDS = 11
NS_CONTROL_CHANGES = 12

# Note field numbers.
NOTE_PITCH = 1
NOTE_VELOCITY = 2
NOTE_START_TIME = 4
NOTE_END_TIME = 5
NOTE_NUMERATOR = 6
NOTE_DENOMINATOR = 7
NOTE_INSTRUMENT = 8
NOTE_PROGRAM = 9
NOTE_IS_DRUM = 11
NOTE_VOICE = 12

# ControlChange field numbers.
CC_TIME = 1
CC_CONTROL_NUMBER = 2
CC_CONTROL_VALUE = 3
CC_INSTRUMENT = 4
CC_PROGRAM = 5
CC_IS_DRUM = 6

SUSTAIN_PEDAL = 64


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
  pos = 0
  n = len(buf)
  while pos < n:
    tag, pos = _read_varint(buf, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:
      value, pos = _read_varint(buf, pos)
    elif wire == 1:
      value = struct.unpack("<d", buf[pos:pos + 8])[0]
      pos += 8
    elif wire == 2:
      length, pos = _read_varint(buf, pos)
      value = buf[pos:pos + length]
      pos += length
    elif wire == 5:
      value = struct.unpack("<f", buf[pos:pos + 4])[0]
      pos += 4
    else:
      raise ValueError(f"unsupported wire type {wire}")
    yield field, wire, value


def _parse_note(buf: bytes) -> sequences.Note:
  note = sequences.Note(start_time=0.0, end_time=0.0, pitch=0, velocity=0)
  for field, _, value in _iter_fields(buf):
    if field == NOTE_PITCH:
      note.pitch = int(value)
    elif field == NOTE_VELOCITY:
      note.velocity = int(value)
    elif field == NOTE_START_TIME:
      note.start_time = float(value)
    elif field == NOTE_END_TIME:
      note.end_time = float(value)
    elif field == NOTE_INSTRUMENT:
      note.instrument = int(value)
    elif field == NOTE_PROGRAM:
      note.program = int(value)
    elif field == NOTE_IS_DRUM:
      note.is_drum = bool(value)
  return note


def parse_note_sequence(data: bytes):
  """Parse a serialized NoteSequence.

  Returns (NoteSequence, control_changes, n_pitch_bends) where
  control_changes is a list of dicts.
  """
  ns = sequences.NoteSequence()
  control_changes: List[Dict] = []
  n_pitch_bends = 0
  for field, wire, value in _iter_fields(data):
    if field == NS_NOTES and wire == 2:
      note = _parse_note(value)
      ns.notes.append(note)
      ns.total_time = max(ns.total_time, note.end_time)
    elif field == NS_TOTAL_TIME:
      ns.total_time = max(ns.total_time, float(value))
    elif field == NS_CONTROL_CHANGES and wire == 2:
      cc = {"time": 0.0, "control_number": 0, "control_value": 0,
            "instrument": 0, "program": 0, "is_drum": False}
      for cfield, _, cvalue in _iter_fields(value):
        if cfield == CC_TIME:
          cc["time"] = float(cvalue)
        elif cfield == CC_CONTROL_NUMBER:
          cc["control_number"] = int(cvalue)
        elif cfield == CC_CONTROL_VALUE:
          cc["control_value"] = int(cvalue)
        elif cfield == CC_INSTRUMENT:
          cc["instrument"] = int(cvalue)
        elif cfield == CC_IS_DRUM:
          cc["is_drum"] = bool(cvalue)
      control_changes.append(cc)
    elif field == NS_PITCH_BENDS and wire == 2:
      n_pitch_bends += 1
  return ns, control_changes, n_pitch_bends


# ---------------------------------------------------------------------------
# Serialization (round-trip tests + cache writing).
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
  out = bytearray()
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
  return _varint((num << 3) | wire) + payload


def _double_field(num: int, value: float) -> bytes:
  return _field(num, 1, struct.pack("<d", value))


def serialize_note_sequence(ns: sequences.NoteSequence,
                            control_changes=()) -> bytes:
  out = b""
  for note in ns.notes:
    body = b""
    body += _field(NOTE_PITCH, 0, _varint(note.pitch))
    body += _field(NOTE_VELOCITY, 0, _varint(note.velocity))
    body += _double_field(NOTE_START_TIME, note.start_time)
    body += _double_field(NOTE_END_TIME, note.end_time)
    body += _field(NOTE_INSTRUMENT, 0, _varint(note.instrument))
    body += _field(NOTE_PROGRAM, 0, _varint(note.program))
    if note.is_drum:
      body += _field(NOTE_IS_DRUM, 0, _varint(1))
    out += _field(NS_NOTES, 2, _varint(len(body)) + body)
  for cc in control_changes:
    body = b""
    body += _double_field(CC_TIME, cc["time"])
    body += _field(CC_CONTROL_NUMBER, 0, _varint(cc["control_number"]))
    body += _field(CC_CONTROL_VALUE, 0, _varint(cc["control_value"]))
    out += _field(NS_CONTROL_CHANGES, 2, _varint(len(body)) + body)
  out += _double_field(NS_TOTAL_TIME, ns.total_time)
  return out


# ---------------------------------------------------------------------------
# Sustain pedal application (note_seq.apply_sustain_control_changes).
# ---------------------------------------------------------------------------


def apply_sustain_control_changes(
    ns: sequences.NoteSequence, control_changes,
    sustain_control_number: int = SUSTAIN_PEDAL
) -> sequences.NoteSequence:
  """Extend note ends while the sustain pedal (CC64 >= 64) is down.

  Simplified per-sequence semantics of note_seq's implementation: a note
  whose end falls inside a pedal-down span is extended to the pedal
  release (or the next same-pitch onset, whichever comes first).
  """
  events = sorted(
      (cc for cc in control_changes
       if cc["control_number"] == sustain_control_number),
      key=lambda cc: cc["time"])
  spans = []
  down_since = None
  for cc in events:
    if cc["control_value"] >= 64 and down_since is None:
      down_since = cc["time"]
    elif cc["control_value"] < 64 and down_since is not None:
      spans.append((down_since, cc["time"]))
      down_since = None
  if down_since is not None:
    spans.append((down_since, max(ns.total_time, down_since)))

  if not spans:
    return ns

  import dataclasses as dc
  out = sequences.NoteSequence(total_time=ns.total_time)
  notes = [dc.replace(n) for n in ns.notes]
  # Next same-channel onset caps the extension.
  by_channel: Dict[Tuple[int, int, bool], List[sequences.Note]] = {}
  for n in notes:
    by_channel.setdefault((n.pitch, n.program, n.is_drum), []).append(n)
  for chan_notes in by_channel.values():
    chan_notes.sort(key=lambda n: n.start_time)
    for i, n in enumerate(chan_notes):
      for start, end in spans:
        if start <= n.end_time < end:
          new_end = end
          if i + 1 < len(chan_notes):
            new_end = min(new_end, chan_notes[i + 1].start_time)
          n.end_time = max(n.end_time, new_end)
          break
  out.notes = notes
  out.total_time = max([n.end_time for n in notes] + [ns.total_time])
  return out
