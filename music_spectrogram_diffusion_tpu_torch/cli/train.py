"""Train the context model on the synthetic task.

  python -m music_spectrogram_diffusion_tpu_torch.cli.train --synthetic \
      --preset context_base --model_dir /tmp/run1 [--steps 1000] \
      [--batch 8] [--microbatches 2] [--device cpu]

Port of music_spectrogram_diffusion_tpu/cli/train.py for `--synthetic`:
generated songs (data/synthetic.py) are tokenized, chunked with their
previous frames as context and mel-encoded on the host, and the model
takes Adafactor steps on the card (`--device`, default cuda; 'cpu' runs
the plain versions of the kernels). Checkpoints go to
<model_dir>/step_<N>/ and metrics to <model_dir>/metrics.jsonl; a run
resumes from the latest checkpoint there.

Not ported, and refused: --dataset (the real datasets), --cache_root,
--mesh, --distributed, --remat and --eval_batches.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

# Flags of the JAX CLI whose modules the port has not got; any value given
# is refused.
NOT_PORTED = ("dataset", "cache_root", "mesh", "distributed", "remat",
              "eval_batches")
# The data pipeline's settings, the JAX CLI's defaults.
SHUFFLE_BUFFER, DATA_THREADS = 256, 8


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
  p.add_argument("--device", default="cuda",
                 help="'cuda' (the default) or 'cpu'")
  for name in NOT_PORTED:
    flag = f"--{name}"
    if name in ("distributed", "remat"):
      p.add_argument(flag, action="store_true", help="not ported")
    else:
      p.add_argument(flag, default=None, help="not ported")
  args = p.parse_args(argv)
  given = [f"--{n}" for n in NOT_PORTED if getattr(args, n)]
  if given:
    p.error(f"{', '.join(given)}: not ported to the PyTorch package yet "
            "(it trains on --synthetic data, on one device, without remat "
            "or an eval pass)")
  if not args.synthetic:
    p.error("--synthetic is required: the port has no other data source "
            "yet")
  return args


def experiment_from_args(args: argparse.Namespace):
  from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
  experiment = cfg_lib.preset(args.preset)
  overrides = {"train_steps": args.steps, "batch_size": args.batch,
               "checkpoint_period": args.checkpoint_period,
               "num_microbatches": args.microbatches}
  overrides = {k: v for k, v in overrides.items() if v}
  return dataclasses.replace(
      experiment, train=dataclasses.replace(experiment.train, **overrides))


def main(argv: Optional[Sequence[str]] = None):
  """Runs the training; returns the final TrainState and the trainer."""
  args = parse_args(argv)
  from music_spectrogram_diffusion_tpu_torch.data import registry
  from music_spectrogram_diffusion_tpu_torch.train import loop, trainer

  experiment = experiment_from_args(args)
  model = trainer.build_model(experiment, seed=args.seed,
                              device=args.device)
  print(f"device: {model.device}")

  tl = experiment.task_lengths
  lengths = {"inputs": tl.inputs, "targets": tl.targets,
             "targets_context": tl.targets_context}
  task = registry.synthetic_cached_task(
      "train",
      audio_codec=model.audio_codec,
      vocab_config=experiment.vocab_config(),
      note_rep=experiment.note_rep(),
      with_context=experiment.with_context,
      program_granularity=experiment.program_granularity,
      num_examples=args.synthetic_examples,
      seed=args.synthetic_seed,
      timbre=args.synthetic_timbre,
      drum_fraction=args.synthetic_drums)
  ds = (task.model_dataset(lengths, seed=args.seed,
                           shuffle_buffer_size=SHUFFLE_BUFFER,
                           num_threads=DATA_THREADS)
        .repeat().batch(experiment.train.batch_size)
        .prefetch(4, num_threads=2))

  t = trainer.Trainer(model, experiment.train)
  n_params = sum(p.numel() for p in model.module.parameters())
  print(f"params: {n_params / 1e6:.1f}M "
        f"({sum(p.numel() for p in t.params.values()) / 1e6:.1f}M trained)")
  train_loop = loop.TrainLoop(trainer=t, experiment=experiment,
                              model_dir=args.model_dir,
                              log_period=args.log_period)
  state = train_loop.maybe_resume(t.create_state())
  state = train_loop.run(iter(ds), state, seed=args.seed + 1)
  return state, t


if __name__ == "__main__":
  main()
