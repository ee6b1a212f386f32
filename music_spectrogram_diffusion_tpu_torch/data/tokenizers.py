"""Dataset-specific tokenizers: raw dataset examples -> tokenized schema.

The port's own copy of music_spectrogram_diffusion_tpu/data/tokenizers.py
(the port imports nothing of the JAX package).

Equivalents of the reference's tokenize_*_example functions
(preprocessors.py:101-628 of the music_spectrogram_diffusion reference),
operating on plain dict examples from data/datasets.py sources instead of
tf.data generators. Each returns zero-or-more tokenized examples with the
standard schema (see data/preprocessors.tokenize_example).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.audio import wav_io
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.data import preprocessors
from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import proto
from music_spectrogram_diffusion_tpu_torch.midi import sequences

Example = core.Example


class PitchBendError(Exception):
  pass


def _decode_id(value) -> str:
  return value.decode() if isinstance(value, (bytes, bytearray)) else str(
      value)


def add_track_to_notesequence(ns: sequences.NoteSequence,
                              track: sequences.NoteSequence,
                              control_changes,
                              n_pitch_bends: int,
                              program: int, is_drum: bool,
                              ignore_pitch_bends: bool) -> None:
  """Merge a (sustain-applied) track into ns with a forced program."""
  if n_pitch_bends and not ignore_pitch_bends:
    raise PitchBendError
  track = proto.apply_sustain_control_changes(track, control_changes)
  for note in track.notes:
    note.program = program
    note.is_drum = is_drum
    ns.notes.append(note)
    ns.total_time = max(ns.total_time, note.end_time)


# ---------------------------------------------------------------------------
# Generic WAV+NoteSequence datasets (MAESTRO).
# ---------------------------------------------------------------------------


def tokenize_transcription_example(
    ex: Example,
    audio_codec: codecs.MelGan,
    codec: event_codec.Codec,
    is_training_data: bool,
    onsets_only: bool,
    include_ties: bool,
    audio_is_samples: bool = False,
    id_feature_key: Optional[str] = "id",
) -> Iterator[Example]:
  """MAESTRO-style example: serialized NoteSequence + WAV (or samples)."""
  del is_training_data
  ns, control_changes, _ = proto.parse_note_sequence(ex["sequence"])
  if not onsets_only:
    ns = proto.apply_sustain_control_changes(ns, control_changes)
  sequences.validate_note_sequence(ns)

  if audio_is_samples:
    samples = wav_io.samples_from_example(
        np.asarray(ex["audio"], np.float32), ex.get("sample_rate"),
        audio_codec.sample_rate)
  else:
    samples = wav_io.samples_from_example(
        ex["audio"], None, audio_codec.sample_rate)

  example_id = (_decode_id(ex[id_feature_key])
                if id_feature_key and id_feature_key in ex else "")
  yield preprocessors.tokenize_example(
      ns=ns, samples=samples, audio_codec=audio_codec, codec=codec,
      onsets_only=onsets_only, include_ties=include_ties,
      example_id=example_id)


# ---------------------------------------------------------------------------
# Program-lookup datasets (GuitarSet, URMP).
# ---------------------------------------------------------------------------


def tokenize_example_with_program_lookup(
    ex: Example,
    audio_codec: codecs.MelGan,
    codec: event_codec.Codec,
    is_training_data: bool,
    onsets_only: bool,
    include_ties: bool,
    inst_name_to_program_fn: Callable[[str], int],
    id_feature_key: Optional[str] = None,
) -> Iterator[Example]:
  """Multi-track example with instrument-name -> program mapping."""
  del is_training_data
  ns = sequences.NoteSequence()
  track_seqs = ex["instrument_sequences"]
  inst_names = ex["inst_names"]
  assert len(track_seqs) == len(inst_names)
  for seq_bytes, inst_name in zip(track_seqs, inst_names):
    track, ccs, n_pb = proto.parse_note_sequence(seq_bytes)
    program = inst_name_to_program_fn(_decode_id(inst_name))
    add_track_to_notesequence(ns, track, ccs, n_pb, program=program,
                              is_drum=False, ignore_pitch_bends=False)
  sequences.assign_instruments(ns)
  sequences.validate_note_sequence(ns)

  samples = wav_io.samples_from_example(
      ex["audio"], None, audio_codec.sample_rate)
  example_id = (_decode_id(ex[id_feature_key])
                if id_feature_key and id_feature_key in ex else "")
  yield preprocessors.tokenize_example(
      ns=ns, samples=samples, audio_codec=audio_codec, codec=codec,
      onsets_only=onsets_only, include_ties=include_ties,
      example_id=example_id)


def guitarset_instrument_to_program(instrument: str) -> int:
  if instrument == "Clean Guitar":
    return 24
  raise ValueError(f"Unknown GuitarSet instrument: {instrument}")


def tokenize_guitarset_example(ex: Example, **kwargs) -> Iterator[Example]:
  ex = dict(ex)
  assert "inst_names" not in ex
  ex["inst_names"] = [b"Clean Guitar"]
  ex["instrument_sequences"] = [ex.pop("sequence")]
  yield from tokenize_example_with_program_lookup(
      ex, inst_name_to_program_fn=guitarset_instrument_to_program,
      id_feature_key="id", **kwargs)


_URMP_INSTRUMENT_PROGRAMS = {
    "vn": 40, "va": 41, "vc": 42, "db": 43, "tpt": 56, "tbn": 57,
    "tba": 58, "hn": 60, "sax": 64, "ob": 68, "bn": 70, "cl": 71,
    "fl": 73,
}


def urmp_instrument_to_program(urmp_instrument: str) -> int:
  if urmp_instrument not in _URMP_INSTRUMENT_PROGRAMS:
    raise ValueError(f"unknown URMP instrument: {urmp_instrument}")
  return _URMP_INSTRUMENT_PROGRAMS[urmp_instrument]


def tokenize_urmp_example(ex: Example, **kwargs) -> Iterator[Example]:
  yield from tokenize_example_with_program_lookup(
      ex, inst_name_to_program_fn=urmp_instrument_to_program,
      id_feature_key="id", **kwargs)


# ---------------------------------------------------------------------------
# Slakh / Cerberus4.
# ---------------------------------------------------------------------------


_SLAKH_CLASS_PROGRAMS = {
    "Acoustic Piano": 0, "Electric Piano": 4, "Chromatic Percussion": 8,
    "Organ": 16, "Acoustic Guitar": 24, "Clean Electric Guitar": 26,
    "Distorted Electric Guitar": 29, "Acoustic Bass": 32,
    "Electric Bass": 33, "Violin": 40, "Viola": 41, "Cello": 42,
    "Contrabass": 43, "Orchestral Harp": 46, "Timpani": 47,
    "String Ensemble": 48, "Synth Strings": 50, "Choir and Voice": 52,
    "Orchestral Hit": 55, "Trumpet": 56, "Trombone": 57, "Tuba": 58,
    "French Horn": 60, "Brass Section": 61, "Soprano/Alto Sax": 64,
    "Tenor Sax": 66, "Baritone Sax": 67, "Oboe": 68, "English Horn": 69,
    "Bassoon": 70, "Clarinet": 71, "Pipe": 73, "Synth Lead": 80,
    "Synth Pad": 88,
}


def slakh_class_to_program_and_is_drum(slakh_class: str
                                       ) -> Tuple[int, bool]:
  if slakh_class == "Drums":
    return 0, True
  if slakh_class not in _SLAKH_CLASS_PROGRAMS:
    raise ValueError(f"unknown Slakh class: {slakh_class}")
  return _SLAKH_CLASS_PROGRAMS[slakh_class], False


def tokenize_slakh_example(
    ex: Example,
    audio_codec: codecs.MelGan,
    codec: event_codec.Codec,
    is_training_data: bool,
    onsets_only: bool,
    include_ties: bool,
    track_specs: Optional[Sequence[sequences.TrackSpec]] = None,
    ignore_pitch_bends: bool = True,
) -> Iterator[Example]:
  """Slakh multitrack example: mix audio + per-track NoteSequences."""
  samples = wav_io.samples_from_example(
      np.asarray(ex["mix"], np.float32), ex.get("audio_sample_rate"),
      audio_codec.sample_rate)

  ns = sequences.NoteSequence()
  track_seqs = ex["note_sequences"]
  inst_names = ex["inst_names"]
  assert len(track_seqs) == len(inst_names)
  try:
    if track_specs:
      assert len(track_seqs) == len(track_specs)
      for seq_bytes, spec, inst_name in zip(track_seqs, track_specs,
                                            inst_names):
        assert _decode_id(inst_name) == spec.name
        track, ccs, n_pb = proto.parse_note_sequence(seq_bytes)
        add_track_to_notesequence(
            ns, track, ccs, n_pb, program=spec.program,
            is_drum=spec.is_drum, ignore_pitch_bends=ignore_pitch_bends)
    else:
      for seq_bytes, inst_name in zip(track_seqs, inst_names):
        program, is_drum = slakh_class_to_program_and_is_drum(
            _decode_id(inst_name))
        track, ccs, n_pb = proto.parse_note_sequence(seq_bytes)
        add_track_to_notesequence(
            ns, track, ccs, n_pb, program=program, is_drum=is_drum,
            ignore_pitch_bends=ignore_pitch_bends)
  except PitchBendError:
    return

  sequences.assign_instruments(ns)
  sequences.validate_note_sequence(ns)
  if is_training_data:
    # Trim overlaps for training (the vocabulary can't represent them);
    # eval keeps the original sequence.
    ns = sequences.trim_overlapping_notes(ns)

  yield preprocessors.tokenize_example(
      ns=ns, samples=samples, audio_codec=audio_codec, codec=codec,
      onsets_only=onsets_only, include_ties=include_ties,
      example_id=_decode_id(ex.get("track_id", "")))


# Tokenizer registry per dataset name.
TOKENIZERS = {
    "maestrov1": tokenize_transcription_example,
    "maestrov3": tokenize_transcription_example,
    "guitarset": tokenize_guitarset_example,
    "urmp": tokenize_urmp_example,
    "musicnet": lambda ex, **kw: tokenize_transcription_example(
        ex, audio_is_samples=True, **kw),
    "cerberus4": tokenize_slakh_example,
    "slakh": tokenize_slakh_example,
}
