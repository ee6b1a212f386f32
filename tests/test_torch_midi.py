"""The port's MIDI front end against the JAX package's: SMF reading and
writing (`midi/midi_io.py`), run-length encoding (`midi/run_length.py`,
against tests/goldens/rle.npz), and `cli/synthesize_midi.segment_midi`,
which cuts a song into per-segment encoder tokens. All of it is integer or
host float64 code copied from the JAX package, so every comparison is
exact: equal note fields, equal bytes, equal token arrays. The port's CLI
then renders a MIDI file to a WAV on the CPU at tiny size.
"""

import os

import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.cli import synthesize_midi as jax_cli
from music_spectrogram_diffusion_tpu.data import synthetic
from music_spectrogram_diffusion_tpu.data import tasks as jax_tasks
from music_spectrogram_diffusion_tpu.midi import midi_io as jax_midi_io
from music_spectrogram_diffusion_tpu.midi import vocabularies as jax_vocab
from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.audio import vocoder, wav_io
from music_spectrogram_diffusion_tpu_torch.cli import synthesize_midi
from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import midi_io
from music_spectrogram_diffusion_tpu_torch.midi import run_length
from music_spectrogram_diffusion_tpu_torch.midi import sequences

NOTE_FIELDS = ("start_time", "end_time", "pitch", "velocity", "program",
               "is_drum", "instrument")
LENGTHS = {"inputs": 2048, "targets": 256, "targets_context": 256}


def _song(seed, duration, num_programs=3, drum_fraction=0.0):
  return synthetic.random_note_sequence(
      np.random.RandomState(seed), duration=duration,
      num_programs=num_programs, drum_fraction=drum_fraction)


def _notes(ns):
  return [tuple(getattr(n, f) for f in NOTE_FIELDS) for n in ns.notes]


@pytest.mark.parametrize("seed,drums", [(0, 0.0), (1, 0.3)])
def test_read_midi_file_matches_jax(tmp_path, seed, drums):
  path = str(tmp_path / "song.mid")
  jax_midi_io.write_midi_file(_song(seed, 6.0, drum_fraction=drums), path)
  got, want = midi_io.read_midi_file(path), jax_midi_io.read_midi_file(path)
  assert len(got.notes) > 10
  assert _notes(got) == _notes(want)
  assert got.total_time == want.total_time


def test_write_midi_file_matches_jax():
  ns = _song(2, 4.0)
  assert midi_io.note_sequence_to_midi(ns) == (
      jax_midi_io.note_sequence_to_midi(ns))


def _small_codec():
  return event_codec.Codec(
      max_shift_steps=100, steps_per_second=100,
      event_ranges=[
          event_codec.EventRange("pitch", 0, 127),
          event_codec.EventRange("velocity", 0, 1),
          event_codec.EventRange("tie", 0, 0),
      ])


def _encode_event_fn(state, value, codec_):
  pitch, vel = value
  if state is not None:
    state[pitch] = vel
  return [event_codec.Event("velocity", vel), event_codec.Event("pitch", pitch)]


def _state_to_events_fn(state):
  evs = [event_codec.Event("pitch", p) for p in sorted(state) if state[p]]
  return evs + [event_codec.Event("tie", 0)]


@pytest.mark.parametrize("with_state", [False, True])
def test_run_length_matches_goldens(with_state):
  golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "rle.npz"))
  res = run_length.encode_and_index_events(
      state={} if with_state else None,
      event_times=[0.0, 0.032, 0.032, 0.05, 0.11, 0.113],
      event_values=[(60, 1), (62, 1), (60, 0), (65, 1), (62, 0), (65, 0)],
      encode_event_fn=_encode_event_fn, codec=_small_codec(),
      frame_times=[i * 0.02 for i in range(8)],
      encoding_state_to_events_fn=(
          _state_to_events_fn if with_state else None))
  tag = "state" if with_state else "plain"
  for name, arr in zip(["events", "start", "end", "state_events",
                        "state_idx"], res):
    np.testing.assert_array_equal(arr, golden[f"{tag}_{name}"],
                                  err_msg=f"{tag}_{name}")


def _jax_task(include_ties=True, onsets_only=False, granularity="full"):
  return jax_tasks.Task(
      name="synthesize_midi", source_fn=lambda: None,
      audio_codec=jax_codecs.MelGan(),
      vocab_config=jax_vocab.VocabularyConfig(num_velocity_bins=1),
      note_rep=jax_tasks.NoteRepresentationConfig(
          include_ties=include_ties, onsets_only=onsets_only),
      program_granularity=granularity)


@pytest.mark.parametrize("seed,duration,include_ties,granularity,n_seg", [
    (0, 3.0, True, "full", 1),
    (3, 14.0, True, "full", 3),   # ties carry notes across segments
    (4, 11.0, False, "flat", 3),  # no ties, programs mapped to one
])
def test_segment_midi_matches_jax_exactly(tmp_path, seed, duration,
                                          include_ties, granularity, n_seg):
  path = str(tmp_path / "song.mid")
  jax_midi_io.write_midi_file(_song(seed, duration, num_programs=4), path)
  want = jax_cli.segment_midi(
      jax_midi_io.read_midi_file(path),
      _jax_task(include_ties=include_ties, granularity=granularity), LENGTHS)
  experiment = config.ExperimentConfig(include_ties=include_ties,
                                       program_granularity=granularity)
  got = synthesize_midi.segment_midi(
      midi_io.read_midi_file(path),
      synthesize_midi.SegmentSettings.for_experiment(experiment), LENGTHS)
  assert len(got) == len(want) == n_seg
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def test_segment_settings_follow_the_experiment():
  settings = synthesize_midi.SegmentSettings.for_experiment(
      config.preset("ismir2021_small"))
  assert (settings.include_ties, settings.program_granularity) == (
      False, "flat")
  assert settings.audio_codec.additional_frames_for_encoding == 16
  # The task vocabulary's ids fit the network's embedding table.
  assert settings.vocabulary.vocab_size <= (
      config.preset("ismir2021_small").network().vocab_size)


@pytest.mark.parametrize("preset,same", [("context_base", True),
                                         ("context_tiny", True),
                                         ("ismir2021_small", False)])
def test_cli_tokenization_against_the_jax_clis_fixed_settings(
    tmp_path, preset, same):
  """The JAX CLI tokenizes with fixed settings whatever the checkpoint
  (jax cli/synthesize_midi.py: one velocity bin, ties, 'full' programs);
  the port's follows the experiment (`SegmentSettings.for_experiment`).
  They agree on every context_* preset; an ismir2021_* experiment (127
  velocity bins, no ties, 'flat') is tokenized differently."""
  path = str(tmp_path / "song.mid")
  jax_midi_io.write_midi_file(_song(3, 8.0, num_programs=4), path)
  want = jax_cli.segment_midi(jax_midi_io.read_midi_file(path),
                              _jax_task(), LENGTHS)
  got = synthesize_midi.segment_midi(
      midi_io.read_midi_file(path),
      synthesize_midi.SegmentSettings.for_experiment(config.preset(preset)),
      LENGTHS)
  equal = len(got) == len(want) and all(
      g.shape == w.shape and np.array_equal(g, w) for g, w in zip(got, want))
  assert equal == same


def test_cli_renders_a_wav_on_the_cpu(tmp_path):
  midi_path = str(tmp_path / "song.mid")
  midi_io.write_midi_file(_song(0, 3.0), midi_path)
  out_path = str(tmp_path / "song.wav")
  timings = synthesize_midi.main([
      "--midi", midi_path, "--output", out_path, "--size", "tiny",
      "--steps", "2", "--sampler", "sde-dpm++", "--guidance_interval",
      "0.1,0.8", "--device", "cpu"])
  with open(out_path, "rb") as f:
    rate, audio = wav_io.decode_wav(f.read())
  assert rate == 16000
  assert audio.size == 256 * 320  # one 5.12 s segment
  assert np.isfinite(audio).all() and np.abs(audio).max() > 0
  assert timings["audio_seconds"] == pytest.approx(5.12)


def _soundstream_export(path, base):
  """An exported 'soundstream' vocoder (tools/export_jax_checkpoint.py's
  layout, random weights in Flax's [k, in, out]) with no width in its
  config, as the JAX trainer's older checkpoints have."""
  dec = vocoder.SoundStreamDecoder(vocoder.SoundStreamConfig(
      base_channels=base))
  rng = np.random.RandomState(0)
  arrays = {"config_json": np.asarray(""), "step": np.asarray(3)}
  for name, t in dec.state_dict().items():
    stem, leaf = name.rsplit(".", 1)
    shape = tuple(t.shape)[::-1] if leaf == "weight" else tuple(t.shape)
    key = f"params/params/{stem.replace('.', '/')}/" + (
        "kernel" if leaf == "weight" else "bias")
    arrays[key] = rng.randn(*shape).astype(np.float32) * 0.01
  np.savez(path, **arrays)


@pytest.mark.parametrize("flag", ["--checkpoint", "--vocoder_checkpoint",
                                  "--vocoder_base_channels"])
def test_cli_loads_exports_and_refuses_orbax(tmp_path, flag):
  """The flags that raised until the export existed: --checkpoint and
  --vocoder_checkpoint refuse an orbax directory, naming the export tool
  (tests/test_torch_export.py serves real exports through them), the
  committed vocoder export loads at hidden 512, and
  --vocoder_base_channels sizes a 'soundstream' export."""
  orbax = tmp_path / "model" / "step_3"
  (orbax / "state").mkdir(parents=True)
  (orbax / "METADATA").write_text('{"step": 3}')
  base = ["--midi", "x.mid", "--output", "y.wav", "--device", "cpu"]
  if flag == "--vocoder_base_channels":
    npz = str(tmp_path / "soundstream.npz")
    _soundstream_export(npz, 16)
    voc = synthesize_midi.build_vocoder(synthesize_midi.parse_args(
        base + ["--vocoder_checkpoint", npz, flag, "16"]))
    assert isinstance(voc, vocoder.SoundStreamVocoder)
    assert voc.decoder.config.base_channels == 16
    audio = voc(torch.zeros(1, 3, 128))
    assert tuple(audio.shape) == (1, 3 * 320)
    return
  for path in (str(orbax), str(orbax.parent)):
    args = synthesize_midi.parse_args(base + [flag, path])
    build = (synthesize_midi.build_model if flag == "--checkpoint"
             else synthesize_midi.build_vocoder)
    with pytest.raises(ValueError, match="tools/export_jax_checkpoint.py"):
      build(args)
  if flag == "--vocoder_checkpoint":
    voc = synthesize_midi.build_vocoder(synthesize_midi.parse_args(
        base + [flag, vocoder.TRAINED_MAGNITUDE_GL]))
    assert isinstance(voc, vocoder.HybridGLVocoder)
    assert voc.net.hidden == 512


def test_note_sequence_to_events_matches_jax(tmp_path):
  from dataclasses import astuple

  from music_spectrogram_diffusion_tpu.midi import sequences as jax_seq
  path = str(tmp_path / "song.mid")
  jax_midi_io.write_midi_file(_song(5, 5.0, drum_fraction=0.2), path)
  got = sequences.note_sequence_to_onsets_and_offsets_and_programs(
      midi_io.read_midi_file(path))
  want = jax_seq.note_sequence_to_onsets_and_offsets_and_programs(
      jax_midi_io.read_midi_file(path))
  assert got[0] == want[0]
  assert [astuple(v) for v in got[1]] == [astuple(v) for v in want[1]]
