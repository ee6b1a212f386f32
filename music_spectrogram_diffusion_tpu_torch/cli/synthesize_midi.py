"""Synthesize a MIDI file to audio with the PyTorch port.

  python -m music_spectrogram_diffusion_tpu_torch.cli.synthesize_midi \
      --midi song.mid --output out.wav [--checkpoint model.npz] \
      [--vocoder_checkpoint vocoder.npz] [--steps 1000] [--size base | \
      --preset ar_tiny] [--device cpu]

Port of music_spectrogram_diffusion_tpu/cli/synthesize_midi.py: the MIDI
file is read, cut into per-segment event tokens (`segment_midi`), rendered
segment by segment (chained through the context for the context diffusion
model, independently for the notes-only and autoregressive models) and
vocoded.

`--checkpoint` is a JAX checkpoint of any family exported to `.npz` by
tools/export_jax_checkpoint.py (its config_json names the family), or a
port training checkpoint; without one the weights are random from `--seed`
(a smoke test of the pipeline), of the context model of `--size` or of
`--preset`'s model (any family). `--vocoder_checkpoint` is an exported vocoder (`load_trained`:
the trained MagnitudeNet + Griffin-Lim, or a SoundStream decoder of
`--vocoder_base_channels`); without one, `--vocoder griffin_lim` is the
weights-free vocoder. Tokenization follows the experiment
(`SegmentSettings.for_experiment`); the JAX CLI fixes one velocity bin,
ties and 'full' programs, which agree with every `context_*` preset. The
network runs in the checkpoint's dtype (float32 for random weights); int8
serving is reached through
`infer.inference.InferenceModel(compute_dtype="int8")`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import preprocessors
from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import sequences
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies


@dataclasses.dataclass(frozen=True)
class SegmentSettings:
  """What `segment_midi` takes from the JAX package's data/tasks.Task."""
  audio_codec: codecs.MelGan
  codec: event_codec.Codec
  vocabulary: vocabularies.TokenVocabulary
  include_ties: bool = True
  onsets_only: bool = False
  program_granularity: str = "full"

  @staticmethod
  def for_experiment(experiment: cfg_lib.ExperimentConfig
                     ) -> "SegmentSettings":
    codec = vocabularies.build_codec(experiment.vocab_config())
    return SegmentSettings(
        audio_codec=codecs.get_codec(experiment.codec_name), codec=codec,
        vocabulary=vocabularies.vocabulary_from_codec(codec),
        include_ties=experiment.include_ties,
        onsets_only=experiment.onsets_only,
        program_granularity=experiment.program_granularity)


def segment_midi(ns: sequences.NoteSequence, settings: SegmentSettings,
                 task_lengths: Mapping[str, int]) -> List[np.ndarray]:
  """Tokenize a NoteSequence into per-segment encoder token arrays (each
  EOS-terminated, one per `targets` frames of the song)."""
  duration = ns.total_time + 0.5
  samples = np.zeros(int(duration * settings.audio_codec.sample_rate) + 1,
                     np.float32)  # silent audio, only timing matters
  ex = preprocessors.tokenize_example(
      ns=ns, samples=samples, audio_codec=settings.audio_codec,
      codec=settings.codec, onsets_only=settings.onsets_only,
      include_ties=settings.include_ties)
  ex = preprocessors.rekey_transcription_to_synthesis(ex)

  segments = []
  for seg in preprocessors.split_full_song(
      ex, feature_key="targets", max_tokens=task_lengths["targets"],
      audio_codec=settings.audio_codec,
      additional_feature_keys=["event_start_indices", "event_end_indices",
                               "state_event_indices"],
      passthrough_feature_keys=["inputs", "state_events"]):
    seg = preprocessors.note_representation_chain(
        seg, codec=settings.codec, include_ties=settings.include_ties,
        granularity_type=settings.program_granularity, feature_key="inputs")
    seg = preprocessors.tokenize_and_append_eos(
        seg, settings.vocabulary, keys=("inputs",))
    segments.append(seg["inputs"])
  return segments


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--midi", required=True)
  p.add_argument("--output", required=True)
  p.add_argument("--checkpoint", default=None,
                 help="a JAX checkpoint exported to .npz "
                      "(tools/export_jax_checkpoint.py), or a port training "
                      "checkpoint; default: random weights")
  p.add_argument("--size", default="small")
  p.add_argument("--preset", default=None,
                 help="a config preset (e.g. diffusion_base, ar_tiny) for "
                      "random weights; overrides --size")
  p.add_argument("--steps", type=int, default=None,
                 help="sampler steps override (default: the checkpoint's "
                      "configured count; 1000 with random weights)")
  p.add_argument("--sampler", default=None,
                 choices=["ddpm", "ddim", "dpm++", "sde-dpm++"],
                 help="sampler family override (default: the checkpoint's)")
  p.add_argument("--guidance_interval", default=None, metavar="LO,HI",
                 help="apply CFG only at noise times LO <= t <= HI; "
                      "steps outside run one conditional forward")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--vocoder", default="griffin_lim",
                 choices=["griffin_lim", "none"])
  p.add_argument("--vocoder_checkpoint", default=None,
                 help="a trained vocoder exported to .npz "
                      "(tools/export_jax_checkpoint.py); overrides --vocoder")
  p.add_argument("--vocoder_base_channels", type=int, default=512,
                 help="the width of a 'soundstream' --vocoder_checkpoint "
                      "whose config does not name it")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default) or 'cpu'")
  return p.parse_args(argv)


def build_model(args: argparse.Namespace):
  """The CLI's InferenceModel on `args.device`: `--checkpoint`'s weights
  and experiment, else random weights from `--seed` for `--preset` (or the
  context model of `--size`)."""
  from music_spectrogram_diffusion_tpu_torch.infer import inference
  interval = None
  if args.guidance_interval:
    lo, hi = args.guidance_interval.split(",")
    interval = (float(lo), float(hi))
  if args.checkpoint:
    return inference.load_checkpoint(
        args.checkpoint, device=args.device, sampler_steps=args.steps,
        sampler_name=args.sampler, guidance_interval=interval)
  experiment = (cfg_lib.preset(args.preset) if args.preset else
                cfg_lib.ExperimentConfig(size=args.size))
  experiment = inference.with_sampler(
      dataclasses.replace(experiment, dropout_rate=0.0),
      sampler_steps=args.steps or 1000, sampler_name=args.sampler,
      guidance_interval=interval)
  return inference.InferenceModel(experiment, seed=args.seed,
                                  device=args.device)


def build_vocoder(args: argparse.Namespace):
  """The CLI's vocoder on `args.device`: `--vocoder_checkpoint`'s trained
  vocoder (`load_trained`), else Griffin-Lim, else None."""
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder
  if args.vocoder_checkpoint:
    return vocoder.load_trained(args.vocoder_checkpoint,
                                base_channels=args.vocoder_base_channels,
                                device=args.device)
  if args.vocoder == "griffin_lim":
    return vocoder.GriffinLimVocoder(num_iters=32, device=args.device)
  return None


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
  from music_spectrogram_diffusion_tpu_torch.audio import wav_io
  from music_spectrogram_diffusion_tpu_torch.infer import synthesize
  from music_spectrogram_diffusion_tpu_torch.midi import midi_io

  args = parse_args(argv)
  model = build_model(args)
  if args.checkpoint:
    print(f"loaded {args.checkpoint} (step {model.step})")
  else:
    print("NOTE: no checkpoint given; random weights (smoke test).")
  print(f"reading {args.midi}")
  ns = midi_io.read_midi_file(args.midi)
  print(f"  {len(ns.notes)} notes, {ns.total_time:.1f}s")

  lengths = model.task_lengths
  settings = SegmentSettings.for_experiment(model.experiment)
  segments = segment_midi(ns, settings, lengths)
  codec = model.audio_codec
  print(f"  {len(segments)} segments of "
        f"{lengths['targets'] / codec.frame_rate:.2f}s")

  voc = build_vocoder(args)
  synth = model.synthesizer(voc)
  t0 = time.time()
  out = synth.render_song(
      segments, noise=synthesize.seeded_noise(args.seed, model.model.device),
      vocode=voc is not None)
  print(f"rendered in {time.time() - t0:.1f}s "
        f"({out.timings['prediction_seconds_per_audio_second']:.3f} "
        f"pred-s per audio-s)")

  if out.audio is not None:
    wav_io.write_wav(args.output, out.audio, codec.sample_rate)
    print(f"wrote {args.output} "
          f"({len(out.audio) / codec.sample_rate:.1f}s)")
  else:
    np.save(args.output, out.mel)
    print(f"wrote mel features to {args.output}")
  return out.timings


if __name__ == "__main__":
  main()
