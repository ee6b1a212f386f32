"""Materialize and print examples from a task (debug tool).

Port of music_spectrogram_diffusion_tpu/cli/dump_task.py; the host does all
of it, no card is needed.

  # Synthetic source:
  python -m music_spectrogram_diffusion_tpu_torch.cli.dump_task \
      --synthetic [--full_song] [--n 2] [--decode_events]

  # Any registered task (TFRecords reachable via --data_root):
  python -m music_spectrogram_diffusion_tpu_torch.cli.dump_task \
      --task synthesis_maestrov3_... --data_root /data/mirror
  # or by dataset shorthand:
  python -m music_spectrogram_diffusion_tpu_torch.cli.dump_task \
      --dataset maestrov3 --split train --data_root /data/mirror

Equivalent of the reference dump_task.py (dumps any registered task,
reference dump_task.py:42).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--synthetic", action="store_true")
  p.add_argument("--task", default=None,
                 help="a registered task name (see data/registry.py)")
  p.add_argument("--dataset", default=None,
                 help="dataset config shorthand (e.g. maestrov3)")
  p.add_argument("--split", default="train")
  p.add_argument("--data_root", default=None,
                 help="local mirror root for gs:// dataset paths")
  p.add_argument("--velocity_bins", type=int, default=1,
                 help="vocab velocity bins for --dataset (1=mt3 family, "
                      "127=ismir2021 family)")
  p.add_argument("--full_song", action="store_true")
  p.add_argument("--n", type=int, default=2)
  p.add_argument("--decode_events", action="store_true",
                 help="decode the event tokens back to notes and print")
  p.add_argument("--inputs_length", type=int, default=2048)
  p.add_argument("--targets_length", type=int, default=256)
  args = p.parse_args(argv)

  import numpy as np

  from music_spectrogram_diffusion_tpu_torch.audio import codecs
  from music_spectrogram_diffusion_tpu_torch.data import synthetic, tasks
  from music_spectrogram_diffusion_tpu_torch.midi import (run_length, sequences,
                                                    vocabularies)

  if args.synthetic:
    task = tasks.Task(
        name="dump", source_fn=lambda: synthetic.synthetic_source(
            args.n, duration=8.0),
        audio_codec=codecs.MelGan(),
        vocab_config=vocabularies.VocabularyConfig(num_velocity_bins=1),
        note_rep=tasks.NoteRepresentationConfig(include_ties=True))
  elif args.task:
    from music_spectrogram_diffusion_tpu_torch.data import registry
    registry.register_all_tasks(data_root=args.data_root)
    if args.task not in tasks.TASK_REGISTRY:
      p.error(f"unknown task {args.task!r}; registered: "
              f"{sorted(tasks.TASK_REGISTRY)}")
    task = tasks.TASK_REGISTRY[args.task]
  elif args.dataset:
    from music_spectrogram_diffusion_tpu_torch.data import datasets, registry
    if args.dataset not in datasets.ALL_DATASET_CONFIGS:
      p.error(f"unknown dataset {args.dataset!r}; "
              f"known: {sorted(datasets.ALL_DATASET_CONFIGS)}")
    vocab_config = vocabularies.VocabularyConfig(
        num_velocity_bins=args.velocity_bins)
    if args.velocity_bins == 127:
      # ismir2021 family: the 127-bin vocab pairs with no-ties decoding
      # and 'flat' program granularity (registry.register_ismir2021_tasks,
      # reference gin/tasks/ismir2021.gin) — dump what that task trains on.
      note_rep = registry.ISMIR2021_NOTE_REP
      program_granularity = "flat"
    else:
      note_rep = None  # make_dataset_task default (mt3 family: ties)
      program_granularity = "full"
    task = registry.make_dataset_task(
        datasets.ALL_DATASET_CONFIGS[args.dataset], args.split,
        vocab_config=vocab_config, note_rep=note_rep,
        program_granularity=program_granularity,
        data_root=args.data_root)
    print(f"task: {task.name}")
  else:
    p.error("pick a source: --synthetic, --task NAME, or --dataset NAME")

  lengths = {"inputs": args.inputs_length,
             "targets": args.targets_length,
             "targets_context": args.targets_length}
  ds = (task.full_song_dataset(lengths) if args.full_song
        else task.train_dataset(lengths))

  for i, ex in enumerate(ds.take(args.n)):
    print(f"--- example {i} ---")
    for k, v in sorted(ex.items()):
      v = np.asarray(v) if not isinstance(v, (str, bytes,
                                              sequences.NoteSequence)) else v
      if isinstance(v, np.ndarray):
        desc = f"{v.dtype}{list(v.shape)}"
        if v.size and np.issubdtype(v.dtype, np.number):
          desc += f" [{v.min():.3g}, {v.max():.3g}]"
        print(f"  {k}: {desc}")
      else:
        print(f"  {k}: {type(v).__name__}")
    if args.decode_events:
      tokens = task.vocabulary.decode(np.asarray(ex["inputs"]))
      tokens = tokens[tokens >= 0]
      spec = (sequences.NoteEncodingWithTiesSpec
              if task.note_rep.include_ties
              else sequences.NoteEncodingSpec)
      state = spec.init_decoding_state_fn()
      spec.begin_decoding_segment_fn(state)
      invalid, dropped = run_length.decode_events(
          state, tokens, 0.0, None, task.codec, spec.decode_event_fn)
      try:
        ns = spec.flush_decoding_state_fn(state)
        print(f"  decoded: {len(ns.notes)} notes "
              f"(invalid={invalid}, dropped={dropped})")
        for note in ns.notes[:10]:
          print(f"    {note}")
      except ValueError as e:
        print(f"  decode flush error: {e}")


if __name__ == "__main__":
  main()
