"""A bf16 training step of context_base with kernel #2's two bf16 routes, in
turns on one card.

    python3 tools/torch_bwd_route_step.py [--batches 8 32] [--steps 3]

Builds `ops/csrc/flash_bwd.cu` as it is (bf16 calls at head_dim 64 on the
wgmma route) and as `tools/torch_attention_variants.py bwd_old_route`
builds it (every call on the mma.sync route), then, for each batch size,
trains context_base in bf16 with remat and dropout 0.1 (build_model,
Trainer.train_step, one batch made on the host once and moved to the card
in each step, as TrainLoop does) with each library in turns: old, new,
new, old. Each turn takes one warm-up step, then times `--steps` steps on
the host clock, ending in a synchronize, and profiles one more step
(chip_smoke.py `profile_step`: the card's busy ms, kernel #2's busy ms).
Prints the nvidia-smi name and power limit, each turn, and one line
`RESULT {json}` with every turn's numbers.

Needs nvcc and a card; imports torch, the port, chip_smoke.py and the
variants tool, not JAX.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
# pylint: disable=wrong-import-position
import chip_smoke as cs
import torch_attention_variants as variants
from music_spectrogram_diffusion_tpu_torch.ops import _build
from music_spectrogram_diffusion_tpu_torch.train import trainer

OLD = "bwd_old_route"
TURNS = (("old", OLD), ("new", None), ("new", None), ("old", OLD))
KERNEL_2 = "flash_bwd (kernel #2)"


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--batches", type=int, nargs="+", default=[8, 32])
  parser.add_argument("--steps", type=int, default=3)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU", file=sys.stderr)
    return 1
  card = cs.card_line()
  print(card, flush=True)
  work = Path(tempfile.mkdtemp())
  results = {}
  try:
    started = {name: variants.start_build(name, work) for name in (None, OLD)}
    libs = {name: variants.finish_build(name, procs)
            for name, procs in started.items()}
    for batch_size in args.batches:
      experiment = cs.bf16_training_experiment()
      model = trainer.build_model(experiment, seed=0, device="cuda")
      t = trainer.Trainer(model, experiment.train)
      state = t.create_state()
      batch = cs.training_batches(experiment, batch_size, 1, 0)[0]
      for label, name in TURNS:
        for lib, handle in {**libs[None], **libs[name]}.items():
          _build._libraries[lib] = handle  # pylint: disable=protected-access
        state, _ = t.train_step(state, batch, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
          state, metrics = t.train_step(state, batch, 0)
        cs.check(bool(torch.isfinite(metrics["loss"])), "a finite loss")
        torch.cuda.synchronize()
        s_per_step = (time.perf_counter() - t0) / args.steps
        prof = cs.profile_step(t, state, experiment, 0, card, batch_size)
        turn = dict(s_per_step=s_per_step, wall_ms=prof["wall_ms"],
                    busy_ms=prof["busy_ms"],
                    kernel_2_ms=prof["by_group"][KERNEL_2])
        print(f"batch {batch_size} {label} route: {s_per_step:.4f} s a step; "
              f"profiled step {turn['wall_ms']:.1f} ms, card busy "
              f"{turn['busy_ms']:.1f} ms, kernel #2 {turn['kernel_2_ms']:.1f} "
              f"ms", flush=True)
        results.setdefault(str(batch_size), {}).setdefault(label, []).append(
            turn)
      del model, t, state
      torch.cuda.empty_cache()
  finally:
    shutil.rmtree(work, ignore_errors=True)
  print("RESULT", json.dumps({"card": card, "steps": args.steps,
                              "turns": results}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
