"""Train a model of any family on a dataset, the mega mixture or the
synthetic task.

  python -m music_spectrogram_diffusion_tpu_torch.cli.train \
      --preset context_base --model_dir /tmp/run1 \
      [--dataset maestrov3 | mega] [--data_root /data/mirror] \
      [--cache_root /data/cache] [--synthetic] [--steps 1000] [--batch 8] \
      [--microbatches 2] [--remat] [--eval_batches 2 --eval_period 1000] \
      [--shuffle_buffer 256] [--data_threads 8] [--device cpu] \
      [--mesh 4x2] [--distributed [--coordinator host:port \
      --num_processes N --process_id I]]

Port of music_spectrogram_diffusion_tpu/cli/train.py. The data: `--dataset`
(default maestrov3, as JAX's) names one of the seven dataset configs
(data/datasets.py), whose TFRecords are read under `--data_root` at their
published paths' suffixes; `--dataset mega` trains on the example-
proportional mixture of the six mixture datasets (data/registry.py
register_all_tasks); `--synthetic` trains on generated songs
(data/synthetic.py) instead. Songs are tokenized, chunked (with their
previous frames as context, for the context model) and mel-encoded on the
host, and the model of the preset's family (`context_*`, `diffusion_*`,
`ismir2021_*` or `ar_*`) takes Adafactor steps on the card (`--device`,
default cuda; 'cpu' runs the plain versions of the kernels). Checkpoints go
to <model_dir>/step_<N>/ and metrics to <model_dir>/metrics.jsonl; a run
resumes from the latest checkpoint there. As in the JAX CLI: `--remat`
rematerializes every layer; `--eval_batches N` scores N held-out batches
every `--eval_period` steps, logged as eval/<metric> (the dataset's
train_eval split, or synthetic songs from seed 1000; none for the mega
mixture); `--cache_root` reads each dataset task's tokenized chunks from
<cache_root>/<task name> where cli/cache_task.py built them (a synthetic
task's cache is built there on the first run); `--shuffle_buffer` and
`--data_threads` set the data pipeline's shuffle and thread pool. The model
computes in the preset's dtype (the CLI, as JAX's, has no dtype flag).

Parallelism, as JAX's flags: `--mesh DATAxMODEL` trains on a ('data',
'model') mesh over the processes (parallel/mesh.py: the batch over data,
the MLP, heads and vocab over model); `--distributed` joins the process
group first (parallel/multihost.py), through `--coordinator host:port`,
`--num_processes` and `--process_id`, or torchrun's environment without
them; one process a card, NCCL between cards (gloo with --device cpu).
Without --mesh a distributed run is data-parallel over every process. A
mesh that does not match the number of processes raises. With several
processes each feeds its data group's round-robin share of the examples
at the process-local batch size; only rank 0 writes checkpoints and
metrics, and a checkpoint holds the full tensors (it resumes on any mesh).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Optional, Sequence


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
                 help="train on the generated sine dataset")
  p.add_argument("--synthetic_examples", type=int, default=64)
  p.add_argument("--synthetic_seed", type=int, default=0,
                 help="base seed of the synthetic songs: seeds "
                      "[base, base + N)")
  p.add_argument("--synthetic_timbre", default="sine",
                 choices=["sine", "rich"])
  p.add_argument("--synthetic_drums", type=float, default=0.0)
  p.add_argument("--dataset", default="maestrov3",
                 help="dataset config name, or 'mega' for the full "
                      "example-proportional mixture (requires TFRecords)")
  p.add_argument("--data_root", default=None,
                 help="local mirror root for gs:// dataset paths")
  p.add_argument("--cache_root", default=None,
                 help="offline tokenization cache root (a dataset's: build "
                      "with cli.cache_task; a synthetic task's is built "
                      "there once) read from then on")
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
  p.add_argument("--mesh", default=None,
                 help="DATAxMODEL, e.g. 4x2 (data x tensor parallelism)")
  # Multi-process: run the same command in every process (see
  # parallel/multihost.py for the launch procedure).
  p.add_argument("--distributed", action="store_true",
                 help="join the torch.distributed process group "
                      "(multi-process training)")
  p.add_argument("--coordinator", default=None,
                 help="coordinator host:port (without torchrun)")
  p.add_argument("--num_processes", type=int, default=None)
  p.add_argument("--process_id", type=int, default=None)
  args = p.parse_args(argv)
  from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
  if args.mesh:
    try:
      mesh_lib.parse_mesh(args.mesh)
    except ValueError as e:
      p.error(str(e))
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  if (not args.synthetic and args.dataset != "mega"
      and args.dataset not in datasets.ALL_DATASET_CONFIGS):
    p.error(f"unknown dataset {args.dataset!r}; "
            f"known: {sorted(datasets.ALL_DATASET_CONFIGS)} or 'mega'")
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
  """Runs the training; returns the final TrainState and the trainer.
  With --distributed it joins the process group (unless the caller has)
  and leaves what it joined at the end."""
  args = parse_args(argv)
  import torch.distributed as dist
  from music_spectrogram_diffusion_tpu_torch.parallel import multihost

  if not (args.distributed and not dist.is_initialized()):
    return _train(args, args.device)
  device = multihost.initialize(coordinator_address=args.coordinator,
                                num_processes=args.num_processes,
                                process_id=args.process_id,
                                device=args.device)
  try:
    return _train(args, device)
  finally:
    multihost.shutdown()


def _train(args: argparse.Namespace, device):
  import numpy as np
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  from music_spectrogram_diffusion_tpu_torch.data import registry
  from music_spectrogram_diffusion_tpu_torch.data import tasks
  from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
  from music_spectrogram_diffusion_tpu_torch.parallel import multihost
  from music_spectrogram_diffusion_tpu_torch.train import loop, trainer

  mesh = None
  if args.mesh:
    mesh = multihost.global_mesh(*mesh_lib.parse_mesh(args.mesh))
  elif args.distributed:
    mesh = multihost.global_mesh(model=1)
  if mesh is not None:
    print(f"mesh: {mesh.shape} over {multihost.process_count()} "
          f"process(es), this one rank {multihost.process_index()}")

  experiment = experiment_from_args(args)
  model = trainer.build_model(experiment, seed=args.seed, device=device)
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

  def dataset_task(config, split):
    return registry.make_dataset_task(
        config, split,
        vocab_config=experiment.vocab_config(),
        note_rep=experiment.note_rep(),
        program_granularity=experiment.program_granularity,
        with_context=experiment.with_context,
        data_root=args.data_root,
        audio_codec=model.audio_codec,
        cache_root=args.cache_root)

  config = None  # the dataset's, when one dataset trains
  if args.synthetic:
    ds = synthetic_task("train", args.synthetic_examples,
                        args.synthetic_seed).model_dataset(
        lengths, seed=args.seed, shuffle_buffer_size=args.shuffle_buffer,
        num_threads=args.data_threads).repeat()
  elif args.dataset == "mega":
    registry.register_all_tasks(data_root=args.data_root,
                                with_context=experiment.with_context,
                                include_eval_splits=False,
                                cache_root=args.cache_root)
    mix_name = ("synthesis_with_context_mega" if experiment.with_context
                else "synthesis_mega")
    mixture = tasks.MIXTURE_REGISTRY[mix_name]
    print(f"mixture: {mix_name} over {len(mixture.task_names)} tasks")
    ds = mixture.dataset(lengths, training=True, seed=args.seed,
                         shuffle_buffer_size=args.shuffle_buffer,
                         num_threads=args.data_threads)
  else:
    config = datasets.ALL_DATASET_CONFIGS[args.dataset]
    task = dataset_task(config, config.train_split)
    print(f"task: {task.name}"
          + (" (cached)" if task.cache_dir else " (no cache: tokenizing "
             "online; build one with cli.cache_task)"))
    ds = task.model_dataset(lengths, seed=args.seed,
                            shuffle_buffer_size=args.shuffle_buffer,
                            num_threads=args.data_threads).repeat()
  # Several processes: each feeds its data group's round-robin share of the
  # stream at the process-local batch size (the ranks of a model group the
  # same rows).
  if multihost.process_count() > 1:
    ds = multihost.shard_for_host(ds, mesh=mesh)
    batch_size = multihost.process_local_batch_size(batch_size, mesh)
  ds = ds.batch(batch_size).prefetch(4, num_threads=2)

  t = trainer.Trainer(model, experiment.train, mesh=mesh)
  n_params = sum(p.numel() for p in model.module.parameters())
  print(f"params: {n_params / 1e6:.1f}M "
        f"({sum(p.numel() for p in t.params.values()) / 1e6:.1f}M trained)")

  # The held-out eval pass every eval_period steps, as the JAX CLI's: a
  # fixed set of batches from a disjoint source (synthetic songs from seed
  # 1000, or the dataset's train_eval split), scored with the loss metrics
  # of Trainer.eval_step. The mega mixture has none, as in JAX.
  eval_fn, eval_task = None, None
  if args.eval_batches:
    if args.synthetic:
      eval_task = synthetic_task(
          "eval", max(args.synthetic_examples // 8, 8), 1000)
    elif config is not None:
      eval_task = dataset_task(config, config.train_eval_split)
    else:
      print("--eval_batches: no held-out eval for the mega mixture (as the "
            "JAX CLI)")
  if eval_task is not None:
    # Every process makes the same global batches and scores its rows.
    eval_set = list(itertools.islice(
        iter(eval_task.model_dataset(lengths, seed=1,
                                     num_threads=args.data_threads)
             .repeat().batch(experiment.train.batch_size)),
        args.eval_batches))

    def eval_fn(state):
      del state  # the parameters are the model's
      per_batch = [t.eval_step(t.shard_batch(b)) for b in eval_set]
      return {k: float(np.mean([float(m[k]) for m in per_batch]))
              for k, v in per_batch[0].items() if v.numel() == 1}

  train_loop = loop.TrainLoop(trainer=t, experiment=experiment,
                              model_dir=args.model_dir,
                              log_period=args.log_period, eval_fn=eval_fn)
  state = train_loop.maybe_resume(t.create_state())
  batches = iter(ds)
  if mesh is not None and multihost.process_count() > 1:
    batches = (multihost.host_local_batch_to_global(b, mesh, model.device)
               for b in batches)
  state = train_loop.run(batches, state, seed=args.seed + 1)
  return state, t


if __name__ == "__main__":
  main()
