"""Full-song evaluation CLI of the PyTorch port (single-host replacement
for the Beam pipeline).

  # Synthetic source (no dataset files needed):
  python -m music_spectrogram_diffusion_tpu_torch.cli.evaluate \
      --checkpoint model.npz --synthetic --output_dir /tmp/eval \
      [--steps 50] [--songs 4] [--vocode] [--always_mask_context] \
      [--prediction_source model|gt_encoded|gt_raw] \
      [--num_shards N --shard I] [--device cpu]

  # Real dataset (TFRecord shards mirrored locally; see data/registry):
  python -m music_spectrogram_diffusion_tpu_torch.cli.evaluate \
      --checkpoint model.npz --dataset maestrov3 --split validation \
      --data_root /data/mirror --output_dir /tmp/eval

Port of music_spectrogram_diffusion_tpu/cli/evaluate.py, with its flags
and defaults, and `--device` (default cuda). Songs render on the device
through the port's Synthesizer (captured sampler steps), are vocoded
there, and are scored by `infer/evaluation.py`: mel metrics, the
population FAD of every registered embedder (mel always; VGGish and TRILL
with `--vggish_weights` / `--trill_weights`, or $MSD_VGGISH_WEIGHTS /
$MSD_TRILL_WEIGHTS), and note-onset F1 with a transcriber
(`--mt3_checkpoint`, a T5X checkpoint exported to `.npz`, or
`--transcriber_checkpoint`, a cli/train_transcriber.py model dir or an
exported JAX one). `--checkpoint` is a JAX checkpoint exported to `.npz`
or a port training checkpoint; without one the weights are random from
seed 0, of `--preset`'s model, in `--compute_dtype` (the JAX CLI applies
that flag to checkpoints only).

Beside the JAX CLI's report it prints the seconds per song of each stage
(render, vocoder, each embedder, transcription). `score` is the run
without the aggregate and the files, for callers that aggregate the
per-song results themselves (`evaluation.aggregate`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--checkpoint", default=None)
  p.add_argument("--preset", default="context_small",
                 help="used when no checkpoint is given (random weights)")
  p.add_argument("--synthetic", action="store_true")
  p.add_argument("--synthetic_timbre", default="sine",
                 choices=["sine", "rich"],
                 help="'rich' = program-keyed harmonic stacks + noise "
                      "transients (same seeded note streams, richer "
                      "rendered texture)")
  p.add_argument("--synthetic_drums", type=float, default=0.0,
                 help="fraction of extra drum hits per song")
  p.add_argument("--dataset", default=None,
                 help="dataset config name (e.g. maestrov3); requires "
                      "TFRecord files reachable via --data_root")
  p.add_argument("--split", default="validation",
                 help="dataset split for --dataset")
  p.add_argument("--data_root", default=None,
                 help="local mirror root for gs:// dataset paths")
  p.add_argument("--songs", type=int, default=8)
  p.add_argument("--songs_per_batch", type=int, default=2)
  p.add_argument("--steps", type=int, default=None)
  p.add_argument("--sampler", default=None,
                 choices=["ddpm", "ddim", "dpm++", "sde-dpm++"],
                 help="override the sampler family (DDIM keeps quality "
                      "at far fewer steps; pair with --steps)")
  p.add_argument("--guidance_interval", default=None, metavar="LO,HI",
                 help="apply CFG only at noise times LO <= t <= HI; "
                      "steps outside run one conditional forward "
                      "(Kynkaanniemi et al. 2024)")
  p.add_argument("--vocode", action="store_true")
  p.add_argument("--vocoder_checkpoint", default=None,
                 help="a trained vocoder exported to .npz "
                      "(tools/export_jax_checkpoint.py); implies --vocode "
                      "and replaces the Griffin-Lim fallback")
  p.add_argument("--vocoder_base_channels", type=int, default=512)
  p.add_argument("--output_dir", default=None)
  p.add_argument("--prediction_source", default="model",
                 choices=["model", "gt_encoded", "gt_raw"])
  p.add_argument("--always_mask_context", action="store_true",
                 help="render every segment without context (ablation)")
  p.add_argument("--compute_dtype", default=None,
                 choices=["float32", "bfloat16", "int8"],
                 help="serving dtype: bf16 cast or weight-only int8 "
                      "(ops/quantize.py)")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--vggish_weights", default=None,
                 help="converted VGGish .npz (tools/convert_vggish.py); "
                      "enables VGGish-space FAD (also honours "
                      "$MSD_VGGISH_WEIGHTS)")
  p.add_argument("--trill_weights", default=None,
                 help="converted TRILL .npz (tools/convert_trill.py); "
                      "enables TRILL-space FAD (also honours "
                      "$MSD_TRILL_WEIGHTS)")
  p.add_argument("--mt3_checkpoint", default=None,
                 help="MT3 T5X checkpoint exported to .npz "
                      "(tools/export_jax_checkpoint.py); registers the "
                      "transcriber so rendered audio is scored with "
                      "note-onset F1 (reference TranscribeAudio stage); "
                      "implies --vocode")
  p.add_argument("--transcriber_checkpoint", default=None,
                 help="transcriber model_dir (cli/train_transcriber.py) "
                      "or an exported JAX one; same role as "
                      "--mt3_checkpoint for self-trained weights")
  p.add_argument("--transcriber_decode", default="greedy",
                 choices=["greedy", "beam"])
  # Work sharding across independent processes/hosts (the Beam
  # pipeline's shard parallelism): each process takes every
  # num_shards-th song.
  p.add_argument("--num_shards", type=int, default=1)
  p.add_argument("--shard", type=int, default=0)
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default) or 'cpu'")
  args = p.parse_args(argv)
  if not 0 <= args.shard < args.num_shards:
    p.error(f"--shard {args.shard} out of range [0, {args.num_shards})")
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  if not args.synthetic and not args.dataset:
    p.error("pick a source: --synthetic or --dataset NAME")
  if args.dataset and args.dataset not in datasets.ALL_DATASET_CONFIGS:
    p.error(f"unknown dataset {args.dataset!r}; "
            f"known: {sorted(datasets.ALL_DATASET_CONFIGS)}")
  args.interval = None
  if args.guidance_interval:
    parts = args.guidance_interval.split(",")
    if len(parts) != 2:
      p.error("--guidance_interval expects LO,HI (e.g. 0.1,0.8)")
    args.interval = (float(parts[0]), float(parts[1]))
  args.error = p.error
  return args


class Timed:
  """A callable that adds its calls' wall seconds to `seconds` (the
  device synchronized when it returns a CUDA tensor); other attributes
  are the wrapped callable's."""

  def __init__(self, fn):
    self.fn, self.seconds = fn, 0.0

  def __call__(self, *args, **kwargs):
    t0 = time.perf_counter()
    out = self.fn(*args, **kwargs)
    if isinstance(out, torch.Tensor) and out.is_cuda:
      torch.cuda.synchronize(out.device)
    self.seconds += time.perf_counter() - t0
    return out

  def __getattr__(self, name):
    return getattr(self.fn, name)


def build_model(args: argparse.Namespace):
  """The InferenceModel: `--checkpoint`'s, else `--preset`'s with random
  weights from seed 0, sampler overrides applied, in `--compute_dtype`."""
  import dataclasses

  from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
  from music_spectrogram_diffusion_tpu_torch.infer import inference
  overrides = dict(sampler_steps=args.steps, sampler_name=args.sampler,
                   guidance_interval=args.interval)
  if args.checkpoint:
    return inference.load_checkpoint(args.checkpoint, device=args.device,
                                     compute_dtype=args.compute_dtype,
                                     **overrides)
  experiment = inference.with_sampler(
      dataclasses.replace(cfg_lib.preset(args.preset), dropout_rate=0.0),
      **overrides)
  return inference.InferenceModel(experiment, seed=0, device=args.device,
                                  compute_dtype=args.compute_dtype)


def make_task(args: argparse.Namespace, experiment, codec):
  from music_spectrogram_diffusion_tpu_torch.data import (datasets, registry,
                                                          synthetic, tasks)
  if args.synthetic:
    return tasks.Task(
        name="eval", source_fn=lambda: synthetic.synthetic_source(
            args.songs, duration=10.0, seed=args.seed,
            timbre=args.synthetic_timbre,
            drum_fraction=args.synthetic_drums),
        audio_codec=codec,
        vocab_config=experiment.vocab_config(),
        note_rep=experiment.note_rep(),
        with_context=experiment.with_context,
        program_granularity=experiment.program_granularity)
  task = registry.make_dataset_task(
      datasets.ALL_DATASET_CONFIGS[args.dataset], args.split,
      vocab_config=experiment.vocab_config(),
      note_rep=experiment.note_rep(),
      program_granularity=experiment.program_granularity,
      with_context=experiment.with_context,
      data_root=args.data_root,
      audio_codec=codec)
  print(f"task: {task.name}")
  return task


def select_songs(args: argparse.Namespace, task, lengths):
  """The songs of the run (this shard's), grouped by id."""
  from music_spectrogram_diffusion_tpu_torch.infer import evaluation
  ds = task.full_song_dataset(lengths)
  if not args.synthetic and args.songs:
    # Bound song count by CUTTING the segment stream (take_while, not
    # filter: filter would keep tokenizing + mel-encoding the rest of
    # the split just to discard it); group_songs drops the trailing
    # partial song below. The seen-set is rebuilt per iteration so the
    # bounded dataset can be iterated more than once.
    def make_within_limit():
      songs_seen = set()

      def within_limit(ex):
        key = ex.get("id", "")
        key = key.decode() if isinstance(key, bytes) else str(key)
        songs_seen.add(key)
        return len(songs_seen) <= args.songs
      return within_limit
    ds = ds.take_while_stateful(make_within_limit)
  songs = evaluation.group_songs(ds)
  if args.num_shards > 1:
    keys = sorted(songs)
    songs = {k: songs[k] for k in keys[args.shard::args.num_shards]}
  return songs


def register_scorers(args: argparse.Namespace) -> None:
  """Register the embedders and the transcriber the flags ask for (the
  mel embedder on the run's device); may set args.vocode."""
  import functools

  from music_spectrogram_diffusion_tpu_torch.infer import (mt3,
                                                           postprocessors,
                                                           transcription,
                                                           trill, vggish)
  postprocessors.register_embedding_model("mel", functools.partial(
      postprocessors.mel_frame_embeddings, device=args.device))
  if vggish.register(args.vggish_weights, device=args.device):
    print("VGGish embeddings enabled (FAD in VGGish space)")
  elif args.vggish_weights:
    args.error(f"VGGish weights not found: {args.vggish_weights}")
  if trill.register(args.trill_weights, device=args.device):
    print("TRILL embeddings enabled (FAD in TRILL space)")
  elif args.trill_weights:
    args.error(f"TRILL weights not found: {args.trill_weights}")
  if args.mt3_checkpoint:
    mt3.register(args.mt3_checkpoint, device=args.device)
    print("MT3 transcriber enabled (note-onset F1 on rendered audio)")
    args.vocode = True
  elif args.transcriber_checkpoint:
    transcription.register_transcriber(mt3.load_trained_transcriber(
        args.transcriber_checkpoint, decode_mode=args.transcriber_decode,
        device=args.device))
    print("trained transcriber enabled (note-onset F1 on rendered audio)")
    args.vocode = True
  audio_embedders = set(postprocessors.EMBEDDING_MODELS) - {"mel"}
  if audio_embedders and not args.vocode:
    # Audio-embedding FAD needs rendered audio; without this the
    # requested metric would silently vanish from the report. ('mel'
    # operates on spectrograms and doesn't need audio.)
    print(f"audio-embedding models {sorted(audio_embedders)} registered "
          "-> enabling --vocode")
    args.vocode = True


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
  """Runs the evaluation, prints the aggregate and writes `--output_dir`'s
  files; returns `score`'s dict with the "aggregate"."""
  from music_spectrogram_diffusion_tpu_torch.infer import evaluation

  args = parse_args(argv)
  out = score(args)
  agg = evaluation.aggregate(out["results"])
  print(json.dumps(agg, indent=2))
  print("stage seconds per song: "
        + json.dumps(out["stage_seconds_per_song"]))
  if args.output_dir:
    evaluation.write_outputs(out["results"], args.output_dir,
                             sample_rate=out["sample_rate"])
    print(f"wrote artifacts to {args.output_dir}")
  return dict(out, aggregate=agg)


def score(args: argparse.Namespace) -> Dict[str, Any]:
  """Renders and scores the songs `args` (`parse_args`') select; returns
  {"results": [SongEval], "stage_seconds_per_song", "sample_rate"}. The
  results keep their arrays where `--output_dir` is given; `main` writes
  them there, `score` writes nothing."""
  from music_spectrogram_diffusion_tpu_torch.infer import (postprocessors,
                                                           transcription)

  model = build_model(args)
  experiment, lengths = model.experiment, model.task_lengths
  task = make_task(args, experiment, model.audio_codec)
  songs = select_songs(args, task, lengths)
  print(f"evaluating {len(songs)} songs"
        + (f" (shard {args.shard}/{args.num_shards})"
           if args.num_shards > 1 else ""))

  # The scorers are module globals: the run registers its own and puts
  # back what it found, so that in-process callers see no change.
  saved = (dict(postprocessors.EMBEDDING_MODELS),
           transcription.get_transcriber())
  try:
    return _evaluate(args, model, songs)
  finally:
    postprocessors.EMBEDDING_MODELS.clear()
    postprocessors.EMBEDDING_MODELS.update(saved[0])
    transcription.register_transcriber(saved[1])


def _evaluate(args: argparse.Namespace, model, songs) -> Dict[str, Any]:
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder
  from music_spectrogram_diffusion_tpu_torch.infer import (evaluation,
                                                           postprocessors,
                                                           transcription)
  register_scorers(args)
  if args.vocoder_checkpoint:
    args.vocode = True
    voc = vocoder.load_trained(args.vocoder_checkpoint,
                               base_channels=args.vocoder_base_channels,
                               device=args.device)
  else:
    voc = (vocoder.GriffinLimVocoder(num_iters=16, device=args.device)
           if args.vocode else None)

  # Every stage timed: the registered embedders and transcriber, the
  # vocoder, the render (whose time includes the vocoder's calls).
  timers = {name: Timed(fn)
            for name, fn in postprocessors.EMBEDDING_MODELS.items()}
  postprocessors.EMBEDDING_MODELS.update(timers)
  transcriber = transcription.get_transcriber()
  if transcriber is not None:
    timers["transcription"] = Timed(transcriber)
    transcription.register_transcriber(timers["transcription"])
  if voc is not None:
    voc = timers["vocoder"] = Timed(voc)
  synth = model.synthesizer(voc)
  synth.render_songs = render = Timed(synth.render_songs)

  results = evaluation.evaluate_songs(
      synth, songs, songs_per_batch=args.songs_per_batch,
      seed=args.seed, vocode=args.vocode,
      keep_arrays=args.output_dir is not None,
      prediction_source=args.prediction_source,
      always_mask_context=args.always_mask_context)

  n = max(len(results), 1)
  vocoder_s = timers["vocoder"].seconds if "vocoder" in timers else 0.0
  stage = {"render": (render.seconds
                      - (vocoder_s if render.seconds else 0.0)) / n}
  stage.update({name: t.seconds / n for name, t in timers.items()})
  return {"results": results, "stage_seconds_per_song": stage,
          "sample_rate": model.audio_codec.sample_rate}


if __name__ == "__main__":
  main()
