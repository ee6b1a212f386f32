"""Merge sharded evaluation outputs into one report (the PyTorch port's
copy of music_spectrogram_diffusion_tpu/cli/merge_eval.py; host numpy).

  # Run the shards (independent processes/hosts, the reference Beam
  # pipeline's worker sharding — beam/evaluation.py:629-635):
  for i in 0 1 2 3; do
    python -m music_spectrogram_diffusion_tpu_torch.cli.evaluate \
      --checkpoint RUN --dataset maestrov3 --num_shards 4 --shard $i \
      --vocode --output_dir /out/shard$i &
  done; wait

  # Combine (the Beam CombineFn stage):
  python -m music_spectrogram_diffusion_tpu_torch.cli.merge_eval \
      --shards /out/shard0 /out/shard1 /out/shard2 /out/shard3 \
      --output /out/merged.json

Per-song metrics merge as means with bootstrap CIs over the union of
songs; population FAD is re-derived EXACTLY from each shard's per-song
moment statistics (fad_moments.npz — moments are additive across
shards), not approximated from per-shard FADs.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--shards", nargs="+", required=True,
                 help="per-shard --output_dir paths")
  p.add_argument("--output", required=True,
                 help="merged metrics JSON (a directory means "
                      "<dir>/metrics.json, matching a cell layout)")
  p.add_argument("--bootstrap", type=int, default=200)
  args = p.parse_args(argv)

  import os

  from music_spectrogram_diffusion_tpu_torch.infer import evaluation

  if os.path.isdir(args.output):
    args.output = os.path.join(args.output, "metrics.json")

  merged = evaluation.merge_shard_outputs(args.shards,
                                          bootstrap=args.bootstrap)
  with open(args.output, "w") as f:
    json.dump(merged, f, indent=2)
  agg = merged["aggregate"]
  print(f"merged {merged['num_shards']} shards, "
        f"{agg['num_songs']} songs")
  for k in sorted(agg):
    if not k.endswith(("_ci95_low", "_ci95_high")):
      v = agg[k]
      print(f"  {k} = {v:.4f}" if isinstance(v, float) else
            f"  {k} = {v}")
  print(f"wrote {args.output}")
  return merged


if __name__ == "__main__":
  main()
