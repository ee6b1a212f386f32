"""Standard MIDI file (SMF) reading/writing, dependency-free.

The port's own copy of music_spectrogram_diffusion_tpu/midi/midi_io.py
(the port imports nothing of the JAX package).
The reference delegates MIDI I/O to the `note_seq` package (pretty_midi
under the hood); this is a minimal self-contained SMF parser producing
this framework's NoteSequence — supports format 0/1 files, tempo changes,
note on/off pairing, programs, and percussion (channel 9).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from music_spectrogram_diffusion_tpu_torch.midi import sequences

DEFAULT_TEMPO_US_PER_QUARTER = 500_000  # 120 bpm


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
  value = 0
  while True:
    b = data[pos]
    pos += 1
    value = (value << 7) | (b & 0x7F)
    if not b & 0x80:
      return value, pos


class _Event:
  __slots__ = ("tick", "kind", "channel", "a", "b", "data")

  def __init__(self, tick, kind, channel=0, a=0, b=0, data=b""):
    self.tick = tick
    self.kind = kind
    self.channel = channel
    self.a = a
    self.b = b
    self.data = data


def _parse_track(data: bytes) -> List[_Event]:
  events = []
  pos = 0
  tick = 0
  running_status = 0
  while pos < len(data):
    delta, pos = _read_varlen(data, pos)
    tick += delta
    status = data[pos]
    if status & 0x80:
      pos += 1
      if status < 0xF0:
        running_status = status
    else:
      status = running_status
    if status == 0xFF:  # meta
      meta_type = data[pos]
      pos += 1
      length, pos = _read_varlen(data, pos)
      payload = data[pos:pos + length]
      pos += length
      events.append(_Event(tick, "meta", a=meta_type, data=payload))
    elif status in (0xF0, 0xF7):  # sysex
      length, pos = _read_varlen(data, pos)
      pos += length
    else:
      kind = status & 0xF0
      channel = status & 0x0F
      if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
        a, b = data[pos], data[pos + 1]
        pos += 2
      else:  # program change / channel pressure: one data byte
        a, b = data[pos], 0
        pos += 1
      name = {0x80: "note_off", 0x90: "note_on", 0xA0: "poly_pressure",
              0xB0: "control", 0xC0: "program", 0xD0: "pressure",
              0xE0: "pitch_bend"}[kind]
      events.append(_Event(tick, name, channel, a, b))
  return events


def midi_to_note_sequence(midi_bytes: bytes) -> sequences.NoteSequence:
  """Parse SMF bytes into a NoteSequence (absolute seconds)."""
  if midi_bytes[:4] != b"MThd":
    raise ValueError("not a MIDI file (missing MThd)")
  header_len = struct.unpack(">I", midi_bytes[4:8])[0]
  fmt, n_tracks, division = struct.unpack(">HHH", midi_bytes[8:14])
  del fmt
  if division & 0x8000:
    raise ValueError("SMPTE time division not supported")
  pos = 8 + header_len

  all_events: List[_Event] = []
  for _ in range(n_tracks):
    if midi_bytes[pos:pos + 4] != b"MTrk":
      raise ValueError("bad track chunk")
    track_len = struct.unpack(">I", midi_bytes[pos + 4:pos + 8])[0]
    track_data = midi_bytes[pos + 8:pos + 8 + track_len]
    pos += 8 + track_len
    all_events.extend(_parse_track(track_data))

  all_events.sort(key=lambda e: e.tick)

  # Tick -> seconds under tempo changes.
  tempo_changes: List[Tuple[int, int]] = [(0, DEFAULT_TEMPO_US_PER_QUARTER)]
  for ev in all_events:
    if ev.kind == "meta" and ev.a == 0x51 and len(ev.data) == 3:
      tempo = (ev.data[0] << 16) | (ev.data[1] << 8) | ev.data[2]
      tempo_changes.append((ev.tick, tempo))

  def tick_to_seconds(tick: int) -> float:
    seconds = 0.0
    for (t0, tempo), nxt in zip(tempo_changes,
                                tempo_changes[1:] + [(None, None)]):
      t1 = nxt[0] if nxt[0] is not None else tick
      span_end = min(tick, t1)
      if span_end > t0:
        seconds += (span_end - t0) * tempo / (division * 1e6)
      if tick <= t1:
        break
    return seconds

  ns = sequences.NoteSequence()
  channel_programs: Dict[int, int] = {}
  active: Dict[Tuple[int, int], Tuple[int, int]] = {}  # (ch,pitch)->(tick,vel)

  for ev in all_events:
    if ev.kind == "program":
      channel_programs[ev.channel] = ev.a
    elif ev.kind == "note_on" and ev.b > 0:
      key = (ev.channel, ev.a)
      if key in active:  # retrigger: close previous
        start_tick, vel = active.pop(key)
        _emit(ns, ev.channel, ev.a, vel, start_tick, ev.tick,
              channel_programs, tick_to_seconds)
      active[key] = (ev.tick, ev.b)
    elif ev.kind == "note_off" or (ev.kind == "note_on" and ev.b == 0):
      key = (ev.channel, ev.a)
      if key in active:
        start_tick, vel = active.pop(key)
        _emit(ns, ev.channel, ev.a, vel, start_tick, ev.tick,
              channel_programs, tick_to_seconds)

  # Close any stuck notes at the last event time.
  if active:
    last_tick = max(e.tick for e in all_events)
    for (channel, pitch), (start_tick, vel) in list(active.items()):
      _emit(ns, channel, pitch, vel, start_tick, last_tick,
            channel_programs, tick_to_seconds)

  sequences.assign_instruments(ns)
  return ns


def _emit(ns, channel, pitch, velocity, start_tick, end_tick,
          channel_programs, tick_to_seconds) -> None:
  start = tick_to_seconds(start_tick)
  end = max(tick_to_seconds(end_tick), start + sequences.MIN_NOTE_DURATION)
  ns.add(start_time=start, end_time=end, pitch=pitch, velocity=velocity,
         program=channel_programs.get(channel, 0),
         is_drum=(channel == 9))


def read_midi_file(path: str) -> sequences.NoteSequence:
  with open(path, "rb") as f:
    return midi_to_note_sequence(f.read())


# ---------------------------------------------------------------------------
# Writing (useful for tests and for exporting decoded transcriptions).
# ---------------------------------------------------------------------------


def _varlen(value: int) -> bytes:
  out = [value & 0x7F]
  value >>= 7
  while value:
    out.append((value & 0x7F) | 0x80)
    value >>= 7
  return bytes(reversed(out))


def note_sequence_to_midi(ns: sequences.NoteSequence,
                          ticks_per_quarter: int = 220,
                          tempo_us: int = DEFAULT_TEMPO_US_PER_QUARTER
                          ) -> bytes:
  """Serialize a NoteSequence to a format-0 SMF byte string."""
  def sec_to_tick(t: float) -> int:
    return int(round(t * 1e6 / tempo_us * ticks_per_quarter))

  # channel assignment: drums -> 9, programs round-robin over the rest.
  program_channel: Dict[int, int] = {}
  events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)

  events.append((0, 0, b"\xff\x51\x03" + struct.pack(">I", tempo_us)[1:]))

  def channel_for(note) -> int:
    if note.is_drum:
      return 9
    if note.program not in program_channel:
      free = [c for c in range(16) if c != 9]
      channel = free[len(program_channel) % len(free)]
      program_channel[note.program] = channel
      events.append((0, 1, bytes([0xC0 | channel, note.program])))
    return program_channel[note.program]

  for note in ns.notes:
    ch = channel_for(note)
    on = bytes([0x90 | ch, note.pitch & 0x7F,
                max(1, min(127, note.velocity))])
    off = bytes([0x80 | ch, note.pitch & 0x7F, 0])
    events.append((sec_to_tick(note.start_time), 2, on))
    events.append((sec_to_tick(note.end_time), 2, off))

  events.sort(key=lambda e: (e[0], e[1]))
  track = b""
  prev_tick = 0
  for tick, _, payload in events:
    track += _varlen(tick - prev_tick) + payload
    prev_tick = tick
  track += _varlen(0) + b"\xff\x2f\x00"  # end of track

  header = b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_quarter)
  return header + b"MTrk" + struct.pack(">I", len(track)) + track


def write_midi_file(ns: sequences.NoteSequence, path: str) -> None:
  with open(path, "wb") as f:
    f.write(note_sequence_to_midi(ns))
