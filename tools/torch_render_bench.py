"""Render time of the port's serving path on the card, PERF.md section 2's
protocol.

    python3 tools/torch_render_bench.py [--dtype int8|float32|bfloat16]
                                        [--seed 0]

Builds context_base (random weights from --seed) in the asked serving
dtype (default int8), the serving sampler (SDE-DPM++, 100 steps, CFG 5 on
t in [0.1, 0.8]) and the repo's trained vocoder, and renders chip_smoke.py
phase 7's seeded MIDI song (3 chained segments, batch 1, the longest in
the 2048-token bucket) twice through `Synthesizer.render_song`, the
sampler's steps as captured CUDA graphs (the default). The first render
captures the step graphs (and, in a fresh checkout, waits for nvcc to
build the kernels); the second is the measured one. Prints one line
`RESULT {json}`: the realtime factor (audio s / wall s of the second
render, sampler and vocoder), the first render's, the steady segment's
seconds, the capture seconds (first render), the vocoder's seconds, the
peak device memory, and the card's name and power limit as nvidia-smi
gives them.

Needs a card and nvcc (the kernels build on first use). Imports torch, the
port and chip_smoke.py, not JAX.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from music_spectrogram_diffusion_tpu_torch.audio import vocoder  # noqa: E402
from music_spectrogram_diffusion_tpu_torch.cli import synthesize_midi  # noqa: E402
from music_spectrogram_diffusion_tpu_torch.infer import inference  # noqa: E402
from music_spectrogram_diffusion_tpu_torch.midi import midi_io  # noqa: E402


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--dtype", default="int8",
                      choices=("int8", "float32", "bfloat16"))
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print("torch_render_bench: no CUDA device", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  experiment = chip_smoke.serving_experiment()
  model = inference.InferenceModel(experiment, seed=args.seed, device="cuda",
                                   compute_dtype=args.dtype)
  seg_seconds = experiment.task_lengths.targets / 50.0  # 50 frames/s
  with tempfile.TemporaryDirectory() as tmp:
    midi = os.path.join(tmp, "song.mid")
    chip_smoke.midi_song(args.seed, midi,
                         chip_smoke.SEGMENTS * seg_seconds - 1.3)
    segments = synthesize_midi.segment_midi(
        midi_io.read_midi_file(midi),
        synthesize_midi.SegmentSettings.for_experiment(experiment),
        model.task_lengths)
  synth = model.synthesizer(vocoder.load_trained(vocoder.TRAINED_MAGNITUDE_GL,
                                                 device="cuda"))
  renders = []
  for _ in range(2):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    render = synth.render_song(segments)
    renders.append((render, time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated() / 2**30))
  (first, first_wall, _), (render, wall, peak) = renders
  tm = render.timings
  print("RESULT " + json.dumps({
      "dtype": args.dtype, "segments": len(segments),
      "realtime_factor": tm["audio_seconds"] / wall,
      "realtime_factor_first_render": tm["audio_seconds"] / first_wall,
      "steady_segment_s": tm["steady_segment_seconds"],
      "capture_s": first.timings["capture_seconds"],
      "vocoder_s": tm["audio_decode_seconds"],
      "peak_gib": peak,
      "card": chip_smoke.card_line(),
  }))
  return 0


if __name__ == "__main__":
  sys.exit(main())
