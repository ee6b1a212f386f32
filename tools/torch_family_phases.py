"""chip_smoke.py's phases of the notes-only and autoregressive families,
alone (on the card).

    python3 tools/torch_family_phases.py
    python3 tools/torch_family_phases.py --serve_after_training

Both build the three kernels, write phase 7's MIDI file and time the
forward kernels at every serving shape and the int8 GEMM at phase 4's
shapes (phases 3-4's checks, which the serving phases' per-segment kernel
sums read). The first form then runs phases 22-25 as chip_smoke.py runs
them: the backward at the families' shapes, notes-only `diffusion_base`
and `ar_base` in int8 from the MIDI file, and both families' training. The
second serves (phases 23-24) before and after the training phases (25 and
21) in one process, with the live thread count, to show whether the
training phases' data workers slow the host-bound serving after them.
Each prints chip_smoke's lines, and writes its numbers to
chiprun_out/family_phases.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--serve_after_training", action="store_true")
  args = p.parse_args(argv)
  sys.path.insert(0, ROOT)
  import torch
  import chip_smoke as cs
  from music_spectrogram_diffusion_tpu_torch.ops import _build, attention
  from music_spectrogram_diffusion_tpu_torch.ops import quantize
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = cs.card_line()
  print(card, flush=True)
  _build.build("flash_fwd", "qmm", "flash_bwd")
  attention._library("flash_fwd")
  attention._library("flash_bwd")
  quantize._library()
  gen = torch.Generator("cuda").manual_seed(0)
  capture = torch.cuda.Stream()
  os.makedirs("out", exist_ok=True)
  experiment = cs.serving_experiment()
  cs.midi_song(0, os.path.join("out", "chip_smoke_seed0.mid"),
               cs.SEGMENTS * experiment.task_lengths.targets / 50.0 - 1.3)
  rows = cs.kernel_phase(gen, capture, cs.SHAPES + cs.FAMILY_SHAPES)
  qmm_rows = cs.qmm_phase(cs.qmm_shapes(
      experiment, experiment.task_lengths.inputs), gen, capture)
  out = {}

  def serve(tag):
    out[tag] = dict(threads=threading.active_count())
    out[tag]["notes_only"] = cs.notes_only_phase(0, card, rows, qmm_rows)
    torch.cuda.empty_cache()
    out[tag]["autoregressive"] = cs.ar_phase(0, card, rows, qmm_rows, gen,
                                             capture)[0]
    torch.cuda.empty_cache()
    print(tag, json.dumps(out[tag], default=str), flush=True)

  if args.serve_after_training:
    serve("before training")
  else:
    serve("serving")
    out["backward"] = cs.bwd_kernel_phase(gen, cs.TRAIN_BATCH,
                                          cs.FAMILY_SHAPES)
  out["training"] = {preset: cs.family_train_phase(0, card, preset)
                     for preset in ("diffusion_base", "ar_base")}
  if args.serve_after_training:
    cs.cli_train_phase(card, 0)
    serve("after training")
  os.makedirs("chiprun_out", exist_ok=True)
  with open(os.path.join("chiprun_out", "family_phases.json"), "w") as f:
    json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
  main()
