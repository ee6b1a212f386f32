"""The port's data/tokenizers.py against the JAX package's: every dataset's
tokenizer on the same parsed records, in the training and the eval branch
(Slakh and Cerberus4 trim overlapping notes for training only), the
program lookups and the pitch-bend rule."""

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.data import datasets as jax_datasets
from music_spectrogram_diffusion_tpu.data import tokenizers as jax_tokenizers
from music_spectrogram_diffusion_tpu.midi import vocabularies as jax_vocab
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import dataset_records
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import tokenizers
from music_spectrogram_diffusion_tpu_torch.midi import proto
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
# clean_registries and no_gcs_backend are autouse fixtures.
from torch_data_parity import (  # noqa: F401
    NAMES, SECONDS, assert_streams_equal, clean_registries, no_gcs_backend,
    notes, write_mirror)


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
  return write_mirror(tmp_path_factory.mktemp("mirror"))


def _kwargs(name, vocab, codec_mod, vocab_mod, config, training,
            onsets_only=False, include_ties=True):
  kw = dict(audio_codec=codec_mod.MelGan(),
            codec=vocab_mod.build_codec(vocab), is_training_data=training,
            onsets_only=onsets_only, include_ties=include_ties)
  if name == "cerberus4":
    kw["track_specs"] = config.track_specs
  return kw


def _both(name, path, training, velocity_bins=1, **rep):
  config = datasets.ALL_DATASET_CONFIGS[name]
  jax_config = jax_datasets.ALL_DATASET_CONFIGS[name]
  port_kw = _kwargs(name, vocabularies.VocabularyConfig(
      num_velocity_bins=velocity_bins), codecs, vocabularies, config,
                    training, **rep)
  jax_kw = _kwargs(name, jax_vocab.VocabularyConfig(
      num_velocity_bins=velocity_bins), jax_codecs, jax_vocab, jax_config,
                   training, **rep)
  got = [out for ex in datasets.tfrecord_source(path, config.features)
         for out in tokenizers.TOKENIZERS[name](ex, **port_kw)]
  want = [out for ex in jax_datasets.tfrecord_source(path,
                                                     jax_config.features)
          for out in jax_tokenizers.TOKENIZERS[name](ex, **jax_kw)]
  return got, want


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_tokenized_examples_equal_jax(name, training, mirror):
  path = dataset_records.shard_path(datasets.ALL_DATASET_CONFIGS[name],
                                    "train", mirror)
  got, want = _both(name, path, training)
  assert_streams_equal(got, want, at_least=2)
  for ex in got:
    assert ex["inputs"].shape[1:] == (320,)  # hop-size frames at 16 kHz
    # 2 s at the codec's rate, whatever rate the record holds.
    assert abs(ex["inputs"].size - SECONDS * 16000) < 1000
    assert len(ex["inputs"]) == len(ex["event_start_indices"])


@pytest.mark.parametrize("name", ["maestrov3", "slakh"])
def test_tokenized_examples_equal_jax_full_vocab_no_ties(name, mirror):
  """The ismir2021 representation: 127 velocity bins, no ties."""
  path = dataset_records.shard_path(datasets.ALL_DATASET_CONFIGS[name],
                                    "validation", mirror)
  got, want = _both(name, path, True, velocity_bins=127, include_ties=False)
  assert_streams_equal(got, want, at_least=2)


def test_eval_keeps_overlapping_notes_training_trims(tmp_path):
  """Slakh: the eval branch keeps the original NoteSequence, the training
  branch trims overlapping notes (a note ends where the next one on its
  pitch starts), in both packages."""
  from music_spectrogram_diffusion_tpu_torch.midi import sequences
  ex = dataset_records.record("slakh", 4, SECONDS)
  piano = sequences.NoteSequence()
  piano.add(start_time=0.1, end_time=1.2, pitch=60, velocity=90)
  piano.add(start_time=0.5, end_time=1.5, pitch=60, velocity=90)
  ex["note_sequences"][0] = proto.serialize_note_sequence(piano)
  path = str(tmp_path / "slakh.tfrecord")
  datasets.write_tfrecord(path, [datasets.serialize_example(ex)])
  (train,), (jax_train,) = _both("slakh", path, True)
  (keep,), (jax_keep,) = _both("slakh", path, False)
  assert notes(train["sequence"]) == notes(jax_train["sequence"])
  assert notes(keep["sequence"]) == notes(jax_keep["sequence"])

  def ends(e):
    return sorted(n.end_time for n in e["sequence"].notes
                  if n.pitch == 60 and n.program == 0 and not n.is_drum)

  assert ends(keep) == [1.2, 1.5] and ends(train) == [0.5, 1.5]


def test_program_lookups_equal_jax():
  for inst in ("Clean Guitar", "Nylon Guitar"):
    for lookup in (tokenizers.guitarset_instrument_to_program,
                   jax_tokenizers.guitarset_instrument_to_program):
      if inst == "Clean Guitar":
        assert lookup(inst) == 24
      else:
        with pytest.raises(ValueError):
          lookup(inst)
  for inst in list(tokenizers._URMP_INSTRUMENT_PROGRAMS) + ["kazoo"]:
    if inst == "kazoo":
      for lookup in (tokenizers.urmp_instrument_to_program,
                     jax_tokenizers.urmp_instrument_to_program):
        with pytest.raises(ValueError):
          lookup(inst)
    else:
      assert tokenizers.urmp_instrument_to_program(inst) == (
          jax_tokenizers.urmp_instrument_to_program(inst))
  for cls in list(tokenizers._SLAKH_CLASS_PROGRAMS) + ["Drums"]:
    assert tokenizers.slakh_class_to_program_and_is_drum(cls) == (
        jax_tokenizers.slakh_class_to_program_and_is_drum(cls))
  with pytest.raises(ValueError):
    tokenizers.slakh_class_to_program_and_is_drum("Theremin")
  assert tokenizers._URMP_INSTRUMENT_PROGRAMS == (
      jax_tokenizers._URMP_INSTRUMENT_PROGRAMS)
  assert tokenizers._SLAKH_CLASS_PROGRAMS == (
      jax_tokenizers._SLAKH_CLASS_PROGRAMS)
  assert sorted(tokenizers.TOKENIZERS) == sorted(jax_tokenizers.TOKENIZERS)


def _with_pitch_bend(track_bytes: bytes) -> bytes:
  """A NoteSequence proto with one PitchBend message (field 11) added."""
  bend = proto._field(1, 1, b"\x00" * 8) + proto._field(2, 0, proto._varint(5))
  return track_bytes + proto._field(proto.NS_PITCH_BENDS, 2,
                                    proto._varint(len(bend)) + bend)


def test_pitch_bends(mirror):
  """URMP's tracks keep pitch bends out: a bent track raises
  PitchBendError; Slakh skips a bent song unless bends are ignored (its
  default), in both packages."""
  ex = dataset_records.record("urmp", 5, SECONDS)
  ex["instrument_sequences"][1] = _with_pitch_bend(
      ex["instrument_sequences"][1])
  raw = datasets.serialize_example(ex)
  for mod, tok, vocab, codec_mod in (
      (datasets, tokenizers, vocabularies, codecs),
      (jax_datasets, jax_tokenizers, jax_vocab, jax_codecs)):
    parsed = mod.parse_example(raw)
    parsed["audio"] = parsed["audio"][0]
    with pytest.raises(tok.PitchBendError):
      list(tok.tokenize_urmp_example(
          parsed, audio_codec=codec_mod.MelGan(),
          codec=vocab.build_codec(vocab.VocabularyConfig()),
          is_training_data=True, onsets_only=False, include_ties=True))
  ex = dataset_records.record("slakh", 5, SECONDS)
  ex["note_sequences"][0] = _with_pitch_bend(ex["note_sequences"][0])
  raw = datasets.serialize_example(ex)
  counts = {}
  for mod, tok, vocab, codec_mod in (
      (datasets, tokenizers, vocabularies, codecs),
      (jax_datasets, jax_tokenizers, jax_vocab, jax_codecs)):
    parsed = mod.parse_example(raw)
    kw = dict(audio_codec=codec_mod.MelGan(),
              codec=vocab.build_codec(vocab.VocabularyConfig()),
              is_training_data=True, onsets_only=False, include_ties=True)
    counts[mod.__name__] = (
        len(list(tok.tokenize_slakh_example(parsed, **kw))),
        len(list(tok.tokenize_slakh_example(parsed, ignore_pitch_bends=False,
                                            **kw))))
  assert list(counts.values()) == [(1, 0), (1, 0)]


def test_add_track_forces_program_and_sustain():
  ns = dataset_records.song(9, 3.0, program=5)
  ccs = dataset_records.sustain_pedal(9, 3.0)
  from music_spectrogram_diffusion_tpu.midi import sequences as jax_seq
  from music_spectrogram_diffusion_tpu_torch.midi import sequences
  raw = proto.serialize_note_sequence(ns, ccs)
  got, want = sequences.NoteSequence(), jax_seq.NoteSequence()
  track, cc, n_pb = proto.parse_note_sequence(raw)
  tokenizers.add_track_to_notesequence(got, track, cc, n_pb, program=40,
                                       is_drum=False,
                                       ignore_pitch_bends=False)
  from music_spectrogram_diffusion_tpu.midi import proto as jax_proto
  track, cc, n_pb = jax_proto.parse_note_sequence(raw)
  jax_tokenizers.add_track_to_notesequence(want, track, cc, n_pb, program=40,
                                           is_drum=False,
                                           ignore_pitch_bends=False)
  assert notes(got) == notes(want)
  assert {n.program for n in got.notes} == {40}
  assert np.isclose(got.total_time, want.total_time)
