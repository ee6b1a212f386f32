"""Train a model of any family on the synthetic task.

  python -m music_spectrogram_diffusion_tpu_torch.cli.train --synthetic \
      --preset context_base --model_dir /tmp/run1 [--steps 1000] \
      [--batch 8] [--microbatches 2] [--remat] [--eval_batches 2 \
      --eval_period 1000] [--cache_root /tmp/cache] [--shuffle_buffer 256] \
      [--data_threads 8] [--device cpu]

Port of music_spectrogram_diffusion_tpu/cli/train.py for `--synthetic`:
generated songs (data/synthetic.py) are tokenized, chunked (with their
previous frames as context, for the context model) and mel-encoded on the
host, and the model of the preset's family (`context_*`, `diffusion_*`,
`ismir2021_*` or `ar_*`) takes Adafactor steps on the card (`--device`, default cuda; 'cpu' runs
the plain versions of the kernels). Checkpoints go to
<model_dir>/step_<N>/ and metrics to <model_dir>/metrics.jsonl; a run
resumes from the latest checkpoint there. As in the JAX CLI: `--remat`
rematerializes every layer; `--eval_batches N` scores N held-out batches
(synthetic songs from seed 1000) every `--eval_period` steps, logged as
eval/<metric>; `--cache_root` keeps each task's tokenized chunks there
(built on the first run, read on the next); `--shuffle_buffer` and
`--data_threads` set the data pipeline's shuffle and thread pool. The model
computes in the preset's dtype (the CLI, as JAX's, has no dtype flag).

Not ported, and refused: --dataset (the real datasets), --mesh and
--distributed.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Optional, Sequence

# Flags of the JAX CLI whose modules the port has not got; any value given
# is refused.
NOT_PORTED = ("dataset", "mesh", "distributed")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--preset", default="context_small")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--steps", type=int, default=None)
  p.add_argument("--batch", type=int, default=None)
  p.add_argument("--microbatches", type=int, default=None,
                 help="gradient-accumulation microbatches per update")
  p.add_argument("--checkpoint_period", type=int, default=None)
  p.add_argument("--log_period", type=int, default=100)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--synthetic", action="store_true",
                 help="train on the generated sine dataset (required: the "
                      "port has no other data source yet)")
  p.add_argument("--synthetic_examples", type=int, default=64)
  p.add_argument("--synthetic_seed", type=int, default=0,
                 help="base seed of the synthetic songs: seeds "
                      "[base, base + N)")
  p.add_argument("--synthetic_timbre", default="sine",
                 choices=["sine", "rich"])
  p.add_argument("--synthetic_drums", type=float, default=0.0)
  p.add_argument("--cache_root", default=None,
                 help="offline tokenization cache root: each task's chunks "
                      "are built there once and read from then on")
  p.add_argument("--shuffle_buffer", type=int, default=256)
  p.add_argument("--data_threads", type=int, default=8,
                 help="post-cache transform thread pool size")
  p.add_argument("--eval_batches", type=int, default=0,
                 help="run a held-out eval pass of N batches every "
                      "eval_period steps (0 = off)")
  p.add_argument("--eval_period", type=int, default=None,
                 help="override the preset's eval period")
  p.add_argument("--remat", action="store_true",
                 help="per-layer rematerialization (activation memory for "
                      "compute)")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (the default) or 'cpu'")
  for name in NOT_PORTED:
    flag = f"--{name}"
    if name == "distributed":
      p.add_argument(flag, action="store_true", help="not ported")
    else:
      p.add_argument(flag, default=None, help="not ported")
  args = p.parse_args(argv)
  given = [f"--{n}" for n in NOT_PORTED if getattr(args, n)]
  if given:
    p.error(f"{', '.join(given)}: not ported to the PyTorch package yet "
            "(it trains on --synthetic data, on one device)")
  if not args.synthetic:
    p.error("--synthetic is required: the port has no other data source "
            "yet")
  return args


def experiment_from_args(args: argparse.Namespace):
  from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
  experiment = cfg_lib.preset(args.preset)
  overrides = {"train_steps": args.steps, "batch_size": args.batch,
               "checkpoint_period": args.checkpoint_period,
               "eval_period": args.eval_period,
               "num_microbatches": args.microbatches}
  overrides = {k: v for k, v in overrides.items() if v}
  experiment = dataclasses.replace(
      experiment, train=dataclasses.replace(experiment.train, **overrides))
  if args.remat:
    experiment = dataclasses.replace(experiment, remat=True)
  return experiment


def main(argv: Optional[Sequence[str]] = None):
  """Runs the training; returns the final TrainState and the trainer."""
  args = parse_args(argv)
  import numpy as np
  from music_spectrogram_diffusion_tpu_torch.data import registry
  from music_spectrogram_diffusion_tpu_torch.train import loop, trainer

  experiment = experiment_from_args(args)
  model = trainer.build_model(experiment, seed=args.seed,
                              device=args.device)
  print(f"device: {model.device}")

  tl = experiment.task_lengths
  lengths = {"inputs": tl.inputs, "targets": tl.targets}
  if experiment.with_context:
    lengths["targets_context"] = tl.targets_context
  batch_size = experiment.train.batch_size

  def synthetic_task(prefix, num_examples, seed):
    # The cache key (the task's name) encodes the example count, vocab and
    # note representation, so another configuration builds its own cache.
    return registry.synthetic_cached_task(
        prefix,
        audio_codec=model.audio_codec,
        vocab_config=experiment.vocab_config(),
        note_rep=experiment.note_rep(),
        with_context=experiment.with_context,
        program_granularity=experiment.program_granularity,
        num_examples=num_examples,
        seed=seed,
        timbre=args.synthetic_timbre,
        drum_fraction=args.synthetic_drums,
        cache_root=args.cache_root)

  task = synthetic_task("train", args.synthetic_examples,
                        args.synthetic_seed)
  ds = (task.model_dataset(lengths, seed=args.seed,
                           shuffle_buffer_size=args.shuffle_buffer,
                           num_threads=args.data_threads)
        .repeat().batch(batch_size).prefetch(4, num_threads=2))

  t = trainer.Trainer(model, experiment.train)
  n_params = sum(p.numel() for p in model.module.parameters())
  print(f"params: {n_params / 1e6:.1f}M "
        f"({sum(p.numel() for p in t.params.values()) / 1e6:.1f}M trained)")

  # The held-out eval pass every eval_period steps, as the JAX CLI's: a
  # fixed set of batches from songs disjoint from training's (seed 1000),
  # scored with the loss metrics of Trainer.eval_step.
  eval_fn = None
  if args.eval_batches:
    eval_task = synthetic_task("eval", max(args.synthetic_examples // 8, 8),
                               1000)
    eval_set = list(itertools.islice(
        iter(eval_task.model_dataset(lengths, seed=1,
                                     num_threads=args.data_threads)
             .repeat().batch(batch_size)), args.eval_batches))

    def eval_fn(state):
      del state  # the parameters are the model's
      per_batch = [t.eval_step(b) for b in eval_set]
      return {k: float(np.mean([float(m[k]) for m in per_batch]))
              for k, v in per_batch[0].items() if v.numel() == 1}

  train_loop = loop.TrainLoop(trainer=t, experiment=experiment,
                              model_dir=args.model_dir,
                              log_period=args.log_period, eval_fn=eval_fn)
  state = train_loop.maybe_resume(t.create_state())
  state = train_loop.run(iter(ds), state, seed=args.seed + 1)
  return state, t


if __name__ == "__main__":
  main()
