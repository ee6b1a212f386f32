"""Progressive distillation: halve the sampler's steps each round.

  python -m music_spectrogram_diffusion_tpu_torch.cli.distill \
      --teacher /path/to/step_500000 --model_dir /tmp/distilled \
      --rounds 2 --steps_per_round 10000 --synthetic [--device cpu] \
      [--mesh 4x2]

Port of music_spectrogram_diffusion_tpu/cli/distill.py, with its flags and
defaults (and `--device`, default cuda). Round r: the teacher at N steps
-> a student at N/2, which starts as the teacher and learns to match two
teacher DDIM half-steps with guidance folded in (train/distill.py); the
student then becomes the next round's teacher. The final checkpoint
samples with DDIM at N/2^rounds steps and NO classifier-free guidance
branch: 1000-step DDPM x 2 CFG forwards -> 250-step DDIM x 1 is about 8x
less sampling.

The teacher is a checkpoint `infer/inference.py load_checkpoint` reads (a
port step_<N> directory or its model directory, or a JAX checkpoint
exported to `.npz`), served in float32; a missing one raises. Each round
trains through TrainLoop into <model_dir>/round_<r>/step_<N>/, whose
config.json is the student's experiment (DDIM, N/2 steps,
eval_condition_weight 1), so `load_checkpoint` serves the student with
one forward a step. `--guidance_weight` (default: the teacher's
eval_condition_weight) applies in round 0 only; later rounds distill an
already-guided teacher at 1.0. Each round checks that its teacher's
weights did not change (`distill.param_digest`) and prints its seconds per
step and, on the card, its peak memory.

`--mesh DATAxMODEL` distills on a ('data', 'model') mesh over the
processes (parallel/mesh.py), the teacher and the student split by the
same rules; launched by torchrun (its environment joins the process group,
parallel/multihost.py), or in a process that has joined one. A mesh that
does not match the number of processes raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--teacher", required=True,
                 help="teacher checkpoint (step_<N> dir or parent, or an "
                      "exported .npz)")
  p.add_argument("--model_dir", required=True)
  p.add_argument("--rounds", type=int, default=2)
  p.add_argument("--steps_per_round", type=int, default=10_000)
  p.add_argument("--batch", type=int, default=None)
  p.add_argument("--mesh", default=None, help="DATAxMODEL, e.g. 4x2")
  p.add_argument("--synthetic", action="store_true",
                 help="distill on the synthetic sine dataset (smoke)")
  p.add_argument("--synthetic_examples", type=int, default=64,
                 help="synthetic dataset size (--synthetic only)")
  p.add_argument("--data_threads", type=int, default=8)
  p.add_argument("--dataset", default="maestrov3")
  p.add_argument("--data_root", default=None)
  p.add_argument("--cache_root", default=None)
  p.add_argument("--learning_rate", type=float, default=1e-4,
                 help="distillation LR (finetune-scale; the teacher's "
                      "training LR is too hot for a converged init)")
  p.add_argument("--warmup_steps", type=int, default=100)
  p.add_argument("--guidance_weight", type=float, default=None,
                 help="CFG weight folded into the student (default: the "
                      "teacher's eval_condition_weight)")
  p.add_argument("--log_period", type=int, default=100)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda",
                 help="'cuda' (the default) or 'cpu'")
  args = p.parse_args(argv)
  if args.mesh:
    from music_spectrogram_diffusion_tpu_torch.parallel import (
        mesh as mesh_lib)
    try:
      mesh_lib.parse_mesh(args.mesh)
    except ValueError as e:
      p.error(str(e))
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  if not args.synthetic and args.dataset not in datasets.ALL_DATASET_CONFIGS:
    p.error(f"unknown dataset {args.dataset!r}; "
            f"known: {sorted(datasets.ALL_DATASET_CONFIGS)}")
  return args


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
  """Runs the rounds; returns one summary a round: its step counts,
  directory, seconds, peak device memory (None on the CPU) and the
  teacher's `param_digest` (the same before and after the round). With
  --mesh under torchrun it joins the process group (unless the caller
  has) and leaves what it joined at the end."""
  args = parse_args(argv)
  import torch.distributed as dist
  from music_spectrogram_diffusion_tpu_torch.parallel import multihost

  if not os.path.exists(args.teacher):
    raise FileNotFoundError(f"no teacher checkpoint at {args.teacher}")
  if not (args.mesh and not dist.is_initialized()
          and "WORLD_SIZE" in os.environ):
    return _distill(args, args.device)
  device = multihost.initialize(device=args.device)
  try:
    return _distill(args, device)
  finally:
    multihost.shutdown()


def _distill(args: argparse.Namespace, device) -> List[dict]:
  import torch

  from music_spectrogram_diffusion_tpu_torch.data import datasets, registry
  from music_spectrogram_diffusion_tpu_torch.infer import inference
  from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
  from music_spectrogram_diffusion_tpu_torch.parallel import multihost
  from music_spectrogram_diffusion_tpu_torch.train import (distill, loop,
                                                           trainer)

  mesh = None
  if args.mesh:
    mesh = multihost.global_mesh(*mesh_lib.parse_mesh(args.mesh))
    print(f"mesh: {mesh.shape}, this process rank "
          f"{multihost.process_index()}")
  wrapper = inference.load_checkpoint(args.teacher, device=device,
                                      compute_dtype="float32", mesh=mesh)
  teacher_exp, teacher = wrapper.experiment, wrapper.model
  print(f"teacher: {args.teacher} (step {wrapper.step}; sampler "
        f"{teacher_exp.diffusion.sampler.name} "
        f"{teacher_exp.diffusion.sampler.num_steps}) on {teacher.device}")
  del wrapper
  on_card = teacher.device.type == "cuda"

  tl = teacher_exp.task_lengths
  lengths = {"inputs": tl.inputs, "targets": tl.targets}
  if teacher_exp.with_context:
    lengths["targets_context"] = tl.targets_context

  if args.synthetic:
    # The task's name (the cache key) encodes the teacher's vocab and note
    # representation, so a cache tokenized for one teacher family is never
    # reused for another.
    task = registry.synthetic_cached_task(
        "distill",
        audio_codec=teacher.audio_codec,
        vocab_config=teacher_exp.vocab_config(),
        note_rep=teacher_exp.note_rep(),
        with_context=teacher_exp.with_context,
        program_granularity=teacher_exp.program_granularity,
        num_examples=args.synthetic_examples,
        cache_root=args.cache_root)
  else:
    config = datasets.ALL_DATASET_CONFIGS[args.dataset]
    task = registry.make_dataset_task(
        config, config.train_split,
        vocab_config=teacher_exp.vocab_config(),
        note_rep=teacher_exp.note_rep(),
        program_granularity=teacher_exp.program_granularity,
        with_context=teacher_exp.with_context,
        data_root=args.data_root, cache_root=args.cache_root,
        audio_codec=teacher.audio_codec)

  batch_size = args.batch or teacher_exp.train.batch_size
  teacher_steps = teacher_exp.diffusion.sampler.num_steps
  summaries = []
  for round_idx in range(args.rounds):
    student_steps = teacher_steps // 2
    print(f"round {round_idx}: {teacher_steps} -> {student_steps} steps")
    if on_card:
      torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    student_exp = distill.student_experiment(teacher_exp, student_steps)
    student_exp = dataclasses.replace(
        student_exp, train=dataclasses.replace(
            student_exp.train, train_steps=args.steps_per_round,
            checkpoint_period=args.steps_per_round,
            learning_rate=args.learning_rate,
            warmup_steps=args.warmup_steps))
    digest = distill.param_digest(teacher.module.parameters())
    student = distill.new_student(student_exp, device)
    if mesh is not None:  # split as the teacher, before it loads its weights
      mesh_lib.shard_module_(student.module, mesh)
    dmodel = distill.DistillModel(
        student, teacher,
        student_steps,
        guidance_weight=(args.guidance_weight if round_idx == 0 else 1.0))
    ds = task.model_dataset(lengths, training=True,
                            seed=args.seed + round_idx,
                            num_threads=args.data_threads).repeat()
    local_batch = batch_size
    if mesh is not None and multihost.process_count() > 1:
      ds = multihost.shard_for_host(ds, mesh=mesh)
      local_batch = multihost.process_local_batch_size(batch_size, mesh)
    ds = ds.batch(local_batch).prefetch(4, num_threads=4)
    t = trainer.Trainer(dmodel, student_exp.train, mesh=mesh)
    round_dir = os.path.join(args.model_dir, f"round_{round_idx}")
    train_loop = loop.TrainLoop(trainer=t, experiment=student_exp,
                                model_dir=round_dir,
                                log_period=args.log_period)
    state = train_loop.run(iter(ds), t.create_state(),
                           num_steps=args.steps_per_round,
                           seed=args.seed + 1)
    if distill.param_digest(teacher.module.parameters()) != digest:
      raise RuntimeError(f"round {round_idx}: the teacher's weights changed")
    summaries.append(dict(
        round=round_idx, teacher_steps=teacher_steps,
        student_steps=student_steps, model_dir=round_dir,
        steps=state.step, seconds=time.perf_counter() - t0,
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if on_card
                  else None),
        teacher_digest=digest))
    # The student becomes the next teacher (guidance already folded in;
    # the next DistillModel freezes it); the old teacher, the optimizer
    # state and the data go first.
    student = dmodel.student
    del state, train_loop, t, dmodel, teacher, ds
    teacher = student
    if on_card:
      torch.cuda.empty_cache()
    teacher_exp, teacher_steps = student_exp, student_steps
    peak = summaries[-1]["peak_gib"]
    print(f"round {round_idx} done -> {round_dir} "
          f"({summaries[-1]['seconds']:.2f} s"
          + (f", peak memory {peak:.2f} GiB" if peak is not None else "")
          + ")")
  return summaries


if __name__ == "__main__":
  main()
