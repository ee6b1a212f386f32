"""Build the offline tokenization cache for dataset tasks.

  python -m music_spectrogram_diffusion_tpu_torch.cli.cache_task \
      --dataset maestrov3 --data_root /data/mirror \
      --cache_root /data/cache [--split train]

Port of music_spectrogram_diffusion_tpu/cli/cache_task.py: writes the
pre-cache chain (tokenize -> rekey -> split into <=2000-frame chunks) to
TFRecord shards in `<cache_root>/<task name>`, the JAX package's names and
bytes (the reference does this with `seqio.CacheDatasetPlaceholder` and an
offline beam job, its tasks.py:38,325). `--dataset all` caches the six
datasets of the mega mixture. Training (`cli/train.py --cache_root`) then
streams the cache each epoch instead of tokenizing raw records. The host
does all of it: no card is needed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
  """Builds the caches; returns each one's metadata with its directory."""
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--dataset", required=True,
                 help="dataset config name, or 'all' for the mega-"
                      "mixture datasets")
  p.add_argument("--split", default=None,
                 help="dataset split (default: the train split)")
  p.add_argument("--data_root", default=None,
                 help="local mirror root for gs:// dataset paths")
  p.add_argument("--cache_root", required=True)
  p.add_argument("--examples_per_shard", type=int, default=128)
  args = p.parse_args(argv)

  from music_spectrogram_diffusion_tpu_torch.data import datasets, registry

  if args.dataset == "all":
    configs = list(datasets.SYNTH_MIXTURE_DATASET_CONFIGS)
  elif args.dataset in datasets.ALL_DATASET_CONFIGS:
    configs = [datasets.ALL_DATASET_CONFIGS[args.dataset]]
  else:
    p.error(f"unknown dataset {args.dataset!r}; "
            f"known: {sorted(datasets.ALL_DATASET_CONFIGS)} or 'all'")

  built = []
  for config in configs:
    split = args.split or config.train_split
    task = registry.make_dataset_task(
        config, split,
        vocab_config=registry.VOCAB_CONFIG_NOVELOCITY,
        data_root=args.data_root,
        cache_root=args.cache_root)
    cache_dir = os.path.join(args.cache_root, task.name)
    t0 = time.time()
    meta = task.build_cache(cache_dir,
                            examples_per_shard=args.examples_per_shard)
    print(f"{task.name}: cached {meta['num_examples']} examples in "
          f"{meta['num_shards']} shards -> {cache_dir} "
          f"({time.time() - t0:.1f}s)")
    built.append(dict(meta, cache_dir=cache_dir))
  return built


if __name__ == "__main__":
  main()
