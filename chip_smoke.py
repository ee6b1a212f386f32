"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own line with its seconds:
  1. device   the card, as nvidia-smi names it with its power limit;
  2. build    nvcc builds the three kernels from ops/csrc/ (flash_fwd.cu,
              qmm.cu and flash_bwd.cu with its wgmma route, and phase 19's
              planted fault: four compilers started together) and reports
              ptxas's registers and spills of every instantiation; no
              kernel may spill;
  3. kernel   flash attention against its plain PyTorch version at the
              four attention shapes of the serving path, at b=2 and b=1, in
              float32 and bfloat16: error and tolerance, in float32 the
              softmax statistics against theirs, two launches bitwise
              equal, the split-KV count, kernel / plain / SDPA (yardstick
              only) times on the card (CUDA graphs), the kernel's eager
              time a call, and the least time the card could take; then
              the kernels' TF32 rounding against cvt.rna.tf32.f32, and a
              NaN in q, v or dO giving NaN where the plain versions do;
  4. kernel   the weight-only int8 GEMM against its plain version at every
              (M, K, N, dtype) of the int8 path: the plan's route and K
              splits, error and tolerance, two launches bitwise equal,
              kernel / plain / bf16-matmul (yardstick only) times from CUDA
              graphs over weights that do not fit the L2, the kernel's
              eager time a call (host clock), and the bound;
  5. main     float32 context_base at full width (random weights from
              --seed) renders one song of 3 chained segments of event
              tokens with the serving sampler (100-step sde-dpm++, CFG 5 in
              t in [0.1, 0.8], its steps replayed as CUDA graphs) and
              vocodes it with Griffin-Lim (PGHI init,
              32 iterations) into out/chip_smoke_seed<seed>.wav; the
              attention kernel's launch count must match the config's;
              PGHI's host seconds with the C++ heap and the Python heap;
  6. check    one float32 decoder step on the card against the same step
              on the CPU (plain versions there);
  7. main     int8 context_base (bf16 network, int8 weights from the same
              seed) renders a seeded MIDI file of 3 segments, written to
              and read back from out/chip_smoke_seed<seed>.mid and cut by
              the port's segment_midi, under the same sampler, vocoded by
              the repo's trained vocoder (the committed export
              assets/magnitude_gl_step4000.npz through load_trained:
              MagnitudeNet hidden 512, PGHI, 32 FGLA iterations at 0.9);
              both kernels' launch counts must match the config's;
  8. check    one int8 decoder step on the card against the same step on
              the CPU;
  9. bf16     bf16 context_base (compute_dtype="bfloat16", same seed): every
              projection stores its kernel in the dtype it computes in, one
              CFG-pair decoder forward is timed eager and as a CUDA graph,
              and the song's first segment is rendered (phase 26);
 10. kernel   the flash-attention backward against its plain version and
              against autograd through the plain forward, at the four
              attention shapes of training at its batch (float32, key masks
              with an all-masked row): error and tolerance, finite, two
              launches bitwise equal, kernel / plain / SDPA-backward
              (yardstick only) times and the bound;
 11. main     float32 context_base at full width trains 5 steps through
              cli/train.py --synthetic (tasks 2048/256/256, batch 8, dropout
              0.1): loss and grad_norm of each step finite, seconds per step,
              target frames/s, peak memory; both attention kernels' launch
              counts must match the config's;
 12. check    one training step at full width (batch 1, injected draws, no
              dropout) on the card against the same step on the CPU: the
              loss and every parameter's gradient;
 13. check    2 steps, a checkpoint, a resumed trainer and 2 more steps
              against 4 steps straight through;
 14. vocoder  the trained vocoder on phase 7's song: the net (with the
              mel-consistency projection) on the card, PGHI on the host
              with the C++ heap and the Python heap, Griffin-Lim on the
              card, the whole vocoder, phase 7's realtime factor with it;
              card (TF32 off) vs CPU: the magnitude, and the audio from the
              same magnitude and initial phase (the end to end reported);
 15. quality  cli/eval_vocoder.py --synthetic --clips 16 --seed 1000 on the
              card: trained's spectral convergence within 2% of the JAX
              package's on the CPU, and better than griffin_lim's;
 16. main     stream_song on phase 7's song: each segment's mel equal to
              the batch render's bit for bit, its audio one segment;
 17. main     cli/synthesize_midi.py --vocoder_checkpoint <the export> on
              the card: a finite WAV of the song's length;
 18. check    SoundStreamDecoder at full width (base 512, strides 8.5.4.2)
              on random weights from --seed: card vs CPU, timed;
 19. kernel   the flash-attention backward in bfloat16 against its plain
              bf16 version at the four training shapes at batch 8 (key
              masks with an all-masked row): the route rule as the built
              library applies it against `attention.bwd_route`, the wgmma
              route's kernels (ptxas), and at each shape the route taken
              (wgmma) and its dq key split, error against 2^-6 x max
              |plain| and relative RMS of dq, dk, dv, finite, two launches
              bitwise equal, kernel / plain / SDPA bf16 backward (yardstick
              only) times and the bound; a planted fault in the wgmma
              route (dq without the second key tile of each key range,
              built in phase 2) must exceed the limit;
 20. main     context_base trains 5 steps in bfloat16 with remat and
              dropout 0.1 at batch 8 through build_model, Trainer and
              TrainLoop: finite losses, s per step, frames/s, peak memory
              beside phase 11's, 96 forward (48 and their recompute) and 48
              bf16 backward launches a step, one profiled step; one bf16
              step at batch 1 (injected draws, no dropout), kernels vs
              plain attention on the card; remat on vs off at batch 2 with
              dropout (the largest gradient difference); then 3 steps at
              batch 32 (launches, s per step, frames/s, peak memory, one
              profiled step);
 21. main     cli/train.py --remat --eval_batches 2 --eval_period 2
              --cache_root at batch 64 in float32 (2 steps): eval/loss
              logged, both caches built and read, peak memory;
 22. kernel   the attention kernels at the shapes only the notes-only and
              autoregressive families run (phase 3's and phase 10's checks):
              the forward at 256x2048 with a key mask (cached K/V) and at
              an unmasked 2048x2048, at b=2 and b=1, in float32 and bf16;
              the float32 backward at both shapes at batch 8;
 23. main     notes-only diffusion_base in int8 (bf16 network) renders
              phase 7's MIDI file, 3 independent segments, with the serving
              sampler and the trained vocoder: both kernels' launch counts
              must match the config's; s per segment, realtime factor; one
              float32 decoder step, card vs CPU;
 24. main     ar_base in int8 (bf16 network) generates the song's first 2
              segments, 256 frames each by the cached decode, vocoded by
              the trained vocoder: the int8 GEMM against its plain version
              at the decode steps' one-row shapes, both kernels' launch
              counts against the config's, s per segment and frames/s; the
              generated frames fed back through the teacher-forced forward
              reproduce the cached outputs; in float32 the encoder and the
              first 8 decode steps, card vs CPU;
 25. main     cli/train.py --synthetic --preset diffusion_base and --preset
              ar_base, batch 8, 3 steps each, float32: finite losses, s per
              step, peak memory, both attention kernels' launch counts;
 26. graphs   every serving render above replays CUDA graphs of its
              sampler's (or the decode's) steps, the default on the card;
              the explicit eager render (graphs=False) of the same segments
              is made first in phases 5, 7, 9, 23 and 24, where the models
              are: int8 context_base (phase 7's 3 segments), and the first
              segment of float32 and bfloat16 context_base, notes-only and
              autoregressive int8. The captured renders (the phase's own
              where its bucket is the same, else one made there: their
              first segment captures; then one that replays every step)
              must equal it bit for bit, and launch kernels #1 and #3 as
              often, each graph's launches a replay x its replays; printed
              per case: eager and captured s a steady segment, capture s,
              peak memory without and with graphs.
Then the vocoder phases' numbers as one JSON line, the families' phases'
as another, phase 26's as another, one JSON line of the kernels, the
nvidia-smi line again, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with its
traceback and prints no result. Needs CUDA; it refuses to run without it.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.audio import wav_io
from music_spectrogram_diffusion_tpu_torch.cli import synthesize_midi
from music_spectrogram_diffusion_tpu_torch.cli import train as train_cli
from music_spectrogram_diffusion_tpu_torch.data import registry
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.midi import midi_io
from music_spectrogram_diffusion_tpu_torch.midi import note_tokens
from music_spectrogram_diffusion_tpu_torch.midi import sequences
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model as diffusion_model, network as diffusion_network)
from music_spectrogram_diffusion_tpu_torch.ops import _build
from music_spectrogram_diffusion_tpu_torch.ops import attention
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops
from music_spectrogram_diffusion_tpu_torch.ops import quantize
from music_spectrogram_diffusion_tpu_torch.ops import stft
from music_spectrogram_diffusion_tpu_torch.train import loop as train_loop
from music_spectrogram_diffusion_tpu_torch.train import trainer

# H100 SXM, dense, at the 700 W limit (NVIDIA data sheet): the bf16 and
# TF32 tensor cores.
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 495e12}
# The peak of each attention kernel's route: bf16 products on the bf16
# tensor cores; f32 products as three TF32 products each (3xTF32, the
# route that keeps f32's 1e-4 limits), so a third of the TF32 peak.
ROUTE_FLOPS = {torch.float32: PEAK_FLOPS["tf32"] / 3,
               torch.bfloat16: PEAK_FLOPS[torch.bfloat16]}
HBM_BYTES_PER_S = 3.35e12
SEGMENTS = 3
# (name, q_len, kv_len, key mask, kv_transposed): the serving path's
# attentions. Each runs at b=2 (the 2 CFG rows of one song) and at b=1 (the
# encoders and cross-attention see one row on the main path, and so does
# self-attention outside the guidance interval), in f32 (the float32 path)
# and bf16 (the int8 path).
SHAPES = (
    ("encoder_self_2048x2048", 2048, 2048, True, False),
    ("context_self_256x256", 256, 256, True, False),
    ("decoder_self_256x256", 256, 256, False, False),
    ("cross_256x2304", 256, 2304, True, True),
)
# The attention shapes that only the notes-only and autoregressive families
# run: the notes-only cross-attention over 2048 token keys (cached K/V when
# serving), and the autoregressive encoder's self-attention, whose mask is
# all ones (padding attended, as the reference). The autoregressive
# cross-attention of its teacher-forced pass and of training is the first
# shape over K/V in [b, l, h, d]; phase 22 runs the forward with cached
# K/V and the backward with uncached.
FAMILY_SHAPES = (
    ("notes_cross_256x2048", 256, 2048, True, True),
    ("ar_encoder_self_2048x2048_unmasked", 2048, 2048, False, False),
)
RUNS = ((2, torch.float32), (2, torch.bfloat16), (1, torch.float32),
        (1, torch.bfloat16))
HEADS, HEAD_DIM = 12, 64
# The forward against its plain version, max |kernel - plain| (see
# fwd_tolerance). f32: 1e-4 absolute; the kernel's 3xTF32 products and
# sums run in another order than cuBLAS's (observed <= 7.5e-6 at these
# inputs, PERF.md §6). bf16: 2^-6 x max |plain|, between 2 and 4 bf16
# steps at the output's largest magnitude. p is rounded to bf16 before p.v
# and both outputs are rounded to bf16, so a sound kernel stays within a
# step or so (observed 9.8e-4 to 3.9e-3, one step, at most 0.34 of the
# limit); keys 64-127 left out move the output by 0.104 to 0.789, 30x the
# limit or more, and the last split left out of the combine 54x or more
# (tools/torch_attention_variants.py fault_skip_tile, fault_drop_split;
# PERF.md §6).
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# The int8 GEMM against its plain version, relative to the output's max:
# f32 out, the same exact products summed in another order; bf16 out, one
# rounding step of the output, which that order can flip (observed at most
# 0.4 of the limit at these inputs). Planted faults land far past it at
# every shape they touch: 64 K rows left out 17x (bf16) and 13700x (f32)
# the limit or more, the last split left out of the split-K sum 33x and
# 37700x (tools/torch_qmm_times.py --faults, PERF.md §6).
QMM_TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# Distinct weights cycled through in a timed run: more bytes than the 50 MB
# L2, so each call reads its weight from HBM, as the main path does.
L2_BYTES = 50 * 2 ** 20
# The MIDI song of the int8 path: a dense multi-instrument arrangement, so
# that its longest segment needs the task's full 2048 input tokens.
MIDI_PROGRAMS = (0, 24, 32, 40, 48, 56, 65, 73)
MIDI_NOTES_PER_SECOND = 36.0
# The training path (phases 10-13): the batch, steps and synthetic songs of
# the full-width run, and the batch of the resume check.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SONGS, RESUME_BATCH = 8, 5, 16, 2
# The backward kernel against its plain version and autograd, max abs
# error over max(1, the gradient's max): float32 products and sums in
# another order (observed <= 5.2e-6 at these shapes).
BWD_TOLERANCE = 1e-4
# Kernel #2's bf16 configuration against its plain bf16 version (phase 19),
# max |kernel - plain| over the gradient's max |plain|: the bf16 forward's
# limit. p and dS are rounded to bf16 on both sides, so a rounding that the
# sums' order flips moves a gradient by a step or so, and the outputs are
# rounded to bf16 once (observed at most 0.24 of the limit at these shapes
# on an H100 80GB HBM3 at 700 W, PERF.md §6); the planted fault (dq
# without one 32-key tile) lands 34-61x past it there.
BWD_BF16_TOLERANCE = 2.0 ** -6
# One bf16 step with remat (phase 20), the kernels vs their plain versions
# on the card: the loss relative, and each gradient's max |diff| over its
# max and its relative RMS, within these or within twice the plain bf16
# path's own distance from the float32 step, whichever is larger. Two bf16
# paths that round in other places (sums in other orders, p rounded before
# p.v in the forward kernel only) differ by about bf16's own error,
# which at tiny size on the CPU already reaches 3.3% / 2.2% (JAX's bf16
# step against its float32 one, L2 loss; 8.2% / 6.7% with the preset's L1
# loss, whose sign turns a one-ulp change of a prediction into a full
# gradient term; tools/bf16_step_noise.py). The step takes an L2 loss for
# that reason. A kernel fault moves gradients far more (phase 19).
BF16_STEP_LOSS_TOLERANCE = 1e-2
BF16_GRAD_MAX_TOLERANCE = 0.025
BF16_GRAD_RMS_TOLERANCE = 0.02
# The remat check's batch (phase 20), and the CLI's batch with remat (phase
# 21): without remat, float32 activations take about 1.9 GiB an example.
REMAT_BATCH, CLI_BATCH = 2, 64
# Phase 20's second bf16 run: a batch whose step the host does not bound
# (bf16 with remat takes about 0.6 GiB an example), for a few steps.
BF16_LARGE_BATCH, BF16_LARGE_STEPS = 32, 3
# One training step, card vs CPU (phase 12). The timing embedding takes
# sin/cos of arguments up to 2e4 rad (0.37 x 2e4 = 7400 in the check, where
# one ulp is 4.9e-4 rad), so the card's and the CPU's float32 exp move it
# by up to ~5e-4; that moves the prediction, and where it flips the sign of
# an L1 residual it moves every gradient by ~2e-3 (measured: one flip of
# 32768). So the step as configured holds its loss to STEP_LOSS_TOLERANCE
# relative and reports its gradients' gap and flips, and the gradients are
# held card vs CPU with the CPU's timing embedding on both sides.
STEP_LOSS_TOLERANCE = 1e-4
# Each gradient's relative RMS: card vs CPU with the same timing embedding
# (measured <= 1.43e-5), and the kernels vs the plain attention on the card
# (measured <= 1.45e-5). float32 on both sides, sums in other orders, the
# kernels' products as 3xTF32 (PERF.md §7).
STEP_GRAD_TOLERANCE = 1e-4
# Resumed vs straight through, the relative RMS of each parameter's total
# update over the 4 steps and the step losses relative: the same
# arithmetic, but the embedding's backward on CUDA adds with atomics.
RESUME_TOLERANCE = 1e-3
# The trained vocoder (phases 7, 14-16): the repo's magnitude_gl
# checkpoint exported from JAX. The JAX package's own report on the CPU,
# from
#   JAX_PLATFORMS=cpu python -m music_spectrogram_diffusion_tpu.cli.eval_vocoder \
#       --checkpoint results/round3/vocoder_ckpt --synthetic --clips 16 \
#       --seed 1000 --output <dir>
# (spectral convergence, log-magnitude, mel round trip, SNR dB):
JAX_EVAL_VOCODER = {
    "griffin_lim": (0.22553573548793793, 0.34683001041412354,
                    0.6951680779457092, -6.399318695068359),
    "griffin_lim_zero": (0.413283109664917, 0.473969429731369,
                         0.8348754048347473, -12.388628959655762),
    "trained": (0.16026504337787628, 0.3254931569099426,
                0.7812255620956421, -3.0962748527526855),
}
# trained's spectral convergence on the card within 2% of the JAX value.
QUALITY_TOLERANCE = 0.02
# The trained vocoder, card (TF32 off) vs CPU: the magnitude after the
# projection, max abs over the max; the Griffin-Lim audio from the same
# magnitude and initial phase, max abs from the second frame on over the
# peak (the first frame's window-envelope division scales float error by
# up to 1e4). float32 convs, matmuls and FFTs in other orders: measured
# 2.05e-6 and 1.32e-4 on an H100 80GB HBM3 at 700 W (PERF.md §6; the
# limits are the CPU tests' against JAX, tests/test_torch_vocoder.py). The
# audio end to end is reported, not held: PGHI's heap order follows the
# magnitude's ulps, so the card's and the CPU's initial phases differ
# (9954 of 393984 bins there) and the audio with them.
VOCODER_MAG_TOLERANCE = 1e-5
VOCODER_AUDIO_TOLERANCE = 1e-3
# SoundStream at full width, card (TF32 off) vs CPU, max abs on its tanh
# output: float32 convs in other orders through 17 conv layers (measured
# 1.45e-7 at an output max of 0.113 on an H100 80GB HBM3 at 700 W).
SOUNDSTREAM_TOLERANCE = 1e-5
# The softmax statistics of the f32 forward against softmax_stats_reference:
# the row max m to 1e-4 x max(1, |m|), the row sum l to 1e-4 relative
# (3xTF32 scores against f32 ones; -1e10 on an all-masked row is exact).
STATS_TOLERANCE = 1e-4
def log(line: str) -> None:
  print(line, flush=True)


def check(ok: bool, what: str) -> None:
  if not ok:
    raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]


def ptxas_usage(name: str) -> list:
  """Registers and spills of each compiled kernel of `csrc/<name>.cu`, from
  its `-Xptxas -v` report, one line per entry function."""
  return ptxas_lines(_build.compiler_report(name))


def ptxas_lines(report: str) -> list:
  """Registers and spills of each entry function of an `-Xptxas -v`
  report, one line each."""
  lines, entry, stack = [], None, ""
  for line in report.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
      # Drop the anonymous namespace and the Params argument; name the
      # template arguments.
      entry = re.sub(r"ILi(\d+)E", r"<\1>", re.sub(
          r"^_ZN\d+_GLOBAL__N_\w*?_cu_[0-9a-f]{8}\d+|EEvNS_\d+ParamsE$",
          "", m.group(1)))
      entry = re.sub(r"(>|I)(f|13__nv_bfloat16)$", lambda t: (
          ", " if t.group(1) == ">" else "<") + (
              "f32" if t.group(2) == "f" else "bf16") + ">", entry)
      entry = re.sub(r"^(\w+_kernel)E\w*$", r"\1", entry)  # no template
      entry = re.sub(r"^_ZN9bwd_wgmma\d+", "bwd_wgmma::", entry)
      entry = re.sub(r"(?:<(\d+)>|I)Lb([01])EEEv\w*$", lambda t: "<" + (
          f"{t.group(1)}, " if t.group(1) else "") + (
              "bias" if t.group(2) == "1" else "no bias") + ">", entry)
    elif entry and "spill" in line:
      stack = line.split(":", 1)[-1].strip() if ":" in line else line.strip()
    elif entry and "registers" in line:
      lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {stack}")
      entry, stack = None, ""
  return lines


def cuda_ms(fn, iters: int) -> float:
  """Mean ms of fn() over `iters` launches, after a warm-up."""
  for _ in range(2):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def attention_inputs(batch, q_len, kv_len, masked, transposed, dtype, gen):
  dev = "cuda"
  q = torch.randn(batch, q_len, HEADS, HEAD_DIM, device=dev, generator=gen)
  kv_shape = ((batch, HEADS, kv_len, HEAD_DIM) if transposed else
              (batch, kv_len, HEADS, HEAD_DIM))
  k = torch.randn(kv_shape, device=dev, generator=gen)
  v = torch.randn(kv_shape, device=dev, generator=gen)
  mask = None
  if masked:
    mask = torch.rand(batch, kv_len, device=dev, generator=gen) > 0.25
    if batch > 1:
      mask[-1] = False  # one batch row whose keys are all masked
  # q scaled as the model's query init does (no 1/sqrt(d) on the scores).
  return (q * HEAD_DIM ** -0.5).to(dtype), k.to(dtype), v.to(dtype), mask


def bound_ms(batch, q_len, kv_len, masked, dtype):
  """max(operations / the route's peak, bytes / HBM rate) for one call, and
  the same at the bf16 peak."""
  flops = 4.0 * batch * HEADS * q_len * kv_len * HEAD_DIM
  elt = torch.finfo(dtype).bits // 8
  nbytes = (2 * batch * q_len + 2 * batch * kv_len) * HEADS * HEAD_DIM * elt
  nbytes += batch * kv_len if masked else 0
  t_ops, t_bytes = flops / ROUTE_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
  bf16_ops = flops / PEAK_FLOPS[torch.bfloat16]
  return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
          else "bytes", 1e3 * max(bf16_ops, t_bytes))


def fwd_tolerance(dtype, plain) -> float:
  """The forward's limit on max |kernel - plain| (TOLERANCE): absolute in
  f32, relative to max |plain| in bf16."""
  scale = 1.0 if dtype == torch.float32 else plain.float().abs().max().item()
  return TOLERANCE[dtype] * scale


def kernel_phase(gen, stream, shapes=SHAPES):
  rows = []
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  for name, q_len, kv_len, masked, transposed in shapes:
    for batch, dtype in RUNS:
      q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked,
                                       transposed, dtype, gen)

      def kernel(_=0):
        return attention.flash_attention(q, k, v, kv_mask=mask,
                                         kv_transposed=transposed)

      def plain(_=0):
        return attention.attention_reference(q, k, v, kv_mask=mask,
                                             kv_transposed=transposed)

      got, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                             kv_transposed=transposed,
                                             return_stats=True)
      again = kernel()
      torch.cuda.synchronize()
      want = plain()
      diff = got.float() - want.float()
      err = diff.abs().max().item()
      rms = (diff.pow(2).mean() / want.float().pow(2).mean()).sqrt().item()
      tol = fwd_tolerance(dtype, want)
      check(bool(torch.isfinite(got).all()), f"{name} {dtype} finite")
      check(err <= tol, f"{name} {dtype}: max |kernel - plain| {err} > {tol}")
      check(torch.equal(got, again), f"{name} b={batch} {dtype}: two "
            "launches differ")
      stats_note = ""
      if dtype == torch.float32:
        want_stats = attention.softmax_stats_reference(
            q, k, kv_mask=mask, kv_transposed=transposed)
        m_err = ((stats[0] - want_stats[0]).abs()
                 / want_stats[0].abs().clamp(min=1.0)).max().item()
        l_err = ((stats[1] - want_stats[1]).abs()
                 / want_stats[1]).max().item()
        check(m_err <= STATS_TOLERANCE and l_err <= STATS_TOLERANCE,
              f"{name} b={batch}: statistics off by {m_err} (max), "
              f"{l_err} (sum) > {STATS_TOLERANCE}")
        stats_note = (f"; statistics max {m_err:.3g}, sum {l_err:.3g} "
                      f"(tol {STATS_TOLERANCE})")
      splits, _ = attention.kv_split(batch, HEADS, q_len, kv_len, sms,
                                     *attention.fwd_tile(dtype))
      # SDPA yardstick on the same inputs: [b, h, l, d], additive mask.
      qs = q.transpose(1, 2).contiguous()
      ks, vs = ((k, v) if transposed else
                (k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous()))
      bias = None
      if mask is not None:
        bias = ((mask.float() - 1.0) * 1e10)[:, None, None, :].to(dtype)

      def library(_=0):
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias,
                                              scale=1.0)

      # The card's time: calls captured in a CUDA graph and replayed, so
      # that a short call is not timed by the host's launch overhead; and
      # the kernel's time a call as the eager main path launches it.
      iters = 20 if q_len > 256 else 100
      ms, plain_ms, lib_ms = (graph_ms(kernel, iters, stream),
                              graph_ms(plain, iters, stream),
                              graph_ms(library, iters, stream))
      eager_ms = cuda_ms(kernel, iters)
      bound, bound_by, bound_bf16 = bound_ms(batch, q_len, kv_len, masked,
                                             dtype)
      dt = str(dtype).replace("torch.", "")
      route = "3xTF32" if dtype == torch.float32 else "bf16"
      log(f"  {name} b={batch} h={HEADS} d={HEAD_DIM} {dt}: max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), relative RMS {rms:.3g}{stats_note}; "
          f"bitwise reproducible; "
          f"{splits} split(s); on the card (CUDA graph): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; kernel eager "
          f"{eager_ms:.4f} ms a call; bound {bound:.4f} ms ({bound_by}, "
          f"{route} peak), {bound_bf16:.4f} ms at the bf16 peak")
      rows.append(dict(shape=name, dtype=dt, batch=batch, q_len=q_len,
                       kv_len=kv_len, splits=splits, max_abs_err=err,
                       tolerance=tol, rel_rms=rms, ms=ms, eager_ms=eager_ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by=bound_by, bound_bf16_ms=bound_bf16))
  return rows


# f32 bit patterns for the TF32 rounding check: zeros, the smallest
# subnormal, a tie and its neighbours, the largest finite value and those
# that round up to inf, inf, and NaNs with payloads low and high (the card's
# canonical 0x7fffffff among them), of both signs.
TF32_SPECIAL_BITS = (
    0x00000000, 0x00000001, 0x00000FFF, 0x00001000, 0x3F801000, 0x3F800FFF,
    0x3F801001, 0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF, 0x7F800000, 0x7F800001,
    0x7FC00000, 0x7FFFEFFF, 0x7FFFF000, 0x7FFFFFFF)


def tf32_rounding_check(gen) -> str:
  """The kernels' TF32 rounding against cvt.rna.tf32.f32 on the card: the
  same bits for every finite and infinite input; and the split's small
  term NaN for every NaN input (where neither rounding keeps NaN)."""
  special = torch.tensor(TF32_SPECIAL_BITS, dtype=torch.int64)
  special = torch.cat([special, special | 0x80000000])
  special = torch.where(special >= 2 ** 31, special - 2 ** 32, special)
  bits = torch.cat([special.to(torch.int32).cuda(), torch.randint(
      -2 ** 31, 2 ** 31, (1 << 22,), device="cuda", generator=gen,
      dtype=torch.int64).to(torch.int32)])
  ours, cvt, small = attention.tf32_round_probe(bits)

  def hex_(t, i):
    return f"{t[i].item() & 0xFFFFFFFF:#010x}"

  nan = torch.isnan(bits.view(torch.float32))
  bad = ((ours != cvt) & ~nan).nonzero().flatten()[:8].tolist()
  check(not bad, "round_tf32 differs from cvt.rna.tf32.f32 at " + ", ".join(
      f"{hex_(bits, i)} -> {hex_(ours, i)} (cvt {hex_(cvt, i)})"
      for i in bad))
  lost = (nan & ~torch.isnan(small.view(torch.float32))).nonzero()
  check(not len(lost), "split_tf32 loses the NaN " + ", ".join(
      f"{hex_(bits, i)} (small {hex_(small, i)})"
      for i in lost.flatten()[:8].tolist()))

  def not_nan(t):
    return int((nan & ~torch.isnan(t.view(torch.float32))).sum())

  return (f"{bits.numel()} f32 patterns ({len(special)} special, "
          f"{int(nan.sum())} NaN): round_tf32 gives cvt.rna.tf32.f32's bits "
          f"for every finite and infinite one (0x7f7fffff -> "
          f"{hex_(cvt, TF32_SPECIAL_BITS.index(0x7F7FFFFF))}); of the NaNs, "
          f"cvt.rna turns {not_nan(cvt)} and round_tf32 {not_nan(ours)} into "
          f"numbers, split_tf32's small term none")


def nan_check(gen) -> str:
  """A NaN (0x7fffffff or 0xffffffff, the card's own) planted in q, in v
  and, for the backward, in dO comes out NaN where the plain versions'
  does, and nowhere else, in the split-KV and one-split forwards and in the
  backward."""
  notes = []
  for name, q_len, kv_len, masked, transposed in (SHAPES[2], SHAPES[3]):
    for batch, dtype in ((1, torch.float32), (1, torch.bfloat16),
                         (8, torch.float32)):
      for where in ("query", "value"):
        q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked,
                                         transposed, dtype, gen)
        t = q if where == "query" else v
        word = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
        nan_bits = (0x7FFF, -1) if dtype == torch.bfloat16 else (
            0x7FFFFFFF, -1)
        word.view(-1)[7] = nan_bits[0]
        word.view(-1)[t.numel() // 2 + 3] = nan_bits[1]
        got = attention.flash_attention(q, k, v, kv_mask=mask,
                                        kv_transposed=transposed)
        want = attention.attention_reference(q, k, v, kv_mask=mask,
                                             kv_transposed=transposed)
        check(torch.equal(torch.isnan(got), torch.isnan(want))
              and bool(torch.isnan(want).any()),
              f"{name} b={batch} {dtype}: NaN in {where} gives NaN at "
              f"{int(torch.isnan(got).sum())} outputs, plain at "
              f"{int(torch.isnan(want).sum())}")
        notes.append(f"{name} b={batch} {str(dtype)[6:]} {where} "
                     f"{int(torch.isnan(got).sum())}")
    q, k, v, mask = attention_inputs(TRAIN_BATCH, q_len, kv_len, masked,
                                     False, torch.float32, gen)
    out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                           return_stats=True)
    dout = torch.randn(out.shape, device="cuda", generator=gen)
    dout.view(torch.int32).view(-1)[11] = 0x7FFFFFFF
    got = attention.flash_attention_bwd(q, k, v, None, mask, out, stats, dout)
    want = attention.flash_attention_bwd_reference(q, k, v, None, mask, out,
                                                   stats, dout)
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
      check(torch.equal(torch.isnan(g), torch.isnan(w))
            and bool(torch.isnan(w).any()),
            f"{name} backward: NaN in dO gives NaN at "
            f"{int(torch.isnan(g).sum())} of {what}, plain at "
            f"{int(torch.isnan(w).sum())}")
    notes.append(f"{name} backward dO {sum(int(torch.isnan(g).sum()) for g in got)}")
  return "; ".join(notes)


def graph_ms(fn, iters: int, stream: torch.cuda.Stream) -> float:
  """Mean ms of fn(i) for i in range(iters), captured in one CUDA graph and
  replayed: the device's time without the host's launch overhead.

  Every capture and warm-up runs on the caller's one `stream`: cuBLAS keeps
  a workspace for each stream it ever ran on, so a new stream per capture
  would hold on to device memory for the rest of the run.
  """
  stream.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(stream):
    for i in range(2):
      fn(i)
  torch.cuda.current_stream().wait_stream(stream)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph, stream=stream):
    for i in range(iters):
      fn(i)
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  graph.replay()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def guided_steps(experiment):
  """(paired, single): sampler steps inside the guidance interval (the
  two-row CFG forward) and outside it (one conditional row)."""
  sampler = experiment.diffusion.sampler
  lo, hi = (np.float32(x) for x in experiment.diffusion.guidance.interval)
  times = (np.arange(sampler.num_steps, dtype=np.float32) + 1) / np.float32(
      sampler.num_steps)
  paired = int(((times >= lo) & (times <= hi)).sum())
  return paired, sampler.num_steps - paired


def qmm_shapes(experiment, l_in: int) -> list:
  """Every int8 GEMM of one segment of the int8 path, from the config:
  [(M, K, N, dtype, launches per segment, what)], one row per distinct
  (M, K, N, dtype). Batch 1; the CFG pair doubles the decoder's rows
  inside the guidance interval, and cross-attention runs on the
  conditional rows only, its K/V projected once per segment."""
  net = experiment.network()
  tl = experiment.task_lengths
  e, hd, f, c = (net.emb_dim, net.num_heads * net.head_dim, net.mlp_dim,
                 4 * net.emb_dim)
  n_wi = len(net.mlp_activations)
  bf16, f32 = torch.bfloat16, torch.float32
  rows = []

  def add(m, k, n, dtype, count, what):
    rows.append((m, k, n, dtype, count, what))

  stacks = [(l_in, "token encoder")]
  if experiment.with_context:
    stacks.append((tl.targets_context, "context encoder"))
  for m, stack in stacks:
    layers_ = net.num_encoder_layers
    add(m, e, hd, bf16, 3 * layers_, f"{stack} q/k/v")
    add(m, hd, e, bf16, layers_, f"{stack} attention out")
    add(m, e, f, bf16, n_wi * layers_, f"{stack} mlp wi")
    add(m, f, e, bf16, layers_, f"{stack} mlp wo")
  add(l_in + (tl.targets_context if experiment.with_context else 0), e, hd,
      bf16, 2 * net.num_decoder_layers, "cross K/V (once a segment)")
  t, dec = tl.targets, net.num_decoder_layers
  for rows_, steps in zip((2, 1), guided_steps(experiment)):
    tag = "CFG pair" if rows_ == 2 else "cond row"
    add(rows_ * t, e, hd, bf16, 3 * dec * steps, f"decoder self q/k/v, {tag}")
    add(rows_ * t, hd, e, bf16, dec * steps, f"decoder self out, {tag}")
    add(t, e, hd, bf16, dec * steps, "decoder cross q (cond rows)")
    add(t, hd, e, bf16, dec * steps, "decoder cross out (cond rows)")
    add(rows_ * t, e, f, bf16, n_wi * dec * steps, f"decoder mlp wi, {tag}")
    add(rows_ * t, f, e, bf16, dec * steps, f"decoder mlp wo, {tag}")
    add(rows_, c, 2 * e, f32, 2 * dec * steps, f"FiLM, {tag} (f32)")
    add(rows_, e, c, bf16, steps, f"time_emb_dense0, {tag}")
    add(rows_, c, c, bf16, steps, f"time_emb_dense1, {tag}")
  return merge_qmm_rows(rows)


def merge_qmm_rows(rows) -> list:
  """One row per distinct (M, K, N, dtype), its launches summed, largest M
  first; every shape must be one quantize_params quantizes."""
  merged = {}
  for m, k, n, dtype, count, what in rows:
    if count == 0:
      continue
    check(quantize.quantizable("kernel", torch.empty(k, n, device="meta")),
          f"{what}: {k}x{n} is not quantized by quantize_params")
    key = (m, k, n, dtype)
    old = merged.get(key, (0, []))
    merged[key] = (old[0] + count, old[1] + [what])
  return [(m, k, n, dtype, count, "; ".join(sorted(set(whats))))
          for (m, k, n, dtype), (count, whats) in sorted(
              merged.items(), key=lambda kv: (-kv[0][0], kv[0][1:3]))]


def qmm_bound_ms(m, k, n, dtype):
  """max(2MKN at the bf16 tensor-core peak, bytes at the HBM rate): x and
  the output in `dtype`, the weight int8, the scales f32."""
  elt = torch.finfo(dtype).bits // 8
  nbytes = m * k * elt + k * n + 4 * n + m * n * elt
  t_ops = 2.0 * m * k * n / PEAK_FLOPS[torch.bfloat16]
  t_bytes = nbytes / HBM_BYTES_PER_S
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def eager_ms(fn, iters: int) -> float:
  """Mean host-clock ms of fn(i) over back-to-back calls, synchronized: a
  call as the main path makes it, the wrapper's host time included."""
  for i in range(3):
    fn(i)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(iters):
    fn(i)
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - t0) / iters


def qmm_phase(shapes, gen, stream):
  rows = []
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  for m, k, n, dtype, per_segment, what in shapes:
    copies = int(np.ceil(L2_BYTES / (k * n))) + 1
    q, s = quantize.quantize_kernel(
        torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5)
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    ss = [s] + [s.clone() for _ in range(copies - 1)]
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    got = quantize.quantized_matmul(x, q, s)
    again = quantize.quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    want = quantize.qmm_reference(x, q, s)
    check(bool(torch.isfinite(got).all()), f"qmm {m}x{k}x{n} finite")
    err = (got.float() - want.float()).abs().max().item()
    tol = QMM_TOLERANCE[dtype] * want.float().abs().max().item()
    check(err <= tol, f"qmm M={m} K={k} N={n} {dtype}: max |kernel - "
          f"plain| {err} > {tol}")
    check(torch.equal(got, again), f"qmm M={m} K={k} N={n} {dtype}: two "
          "launches differ")
    plan = quantize.plan(m, k, n, sms)
    route = ("gemv" if plan.route == quantize.GEMV else "wgmma") + (
        f" {plan.rows}x{plan.cols}")
    wb = [quantize.dequantize_kernel(qi, si, torch.bfloat16)
          for qi, si in zip(qs, ss)]
    xb = x.to(torch.bfloat16)
    iters = max(2 * copies, 50)
    ms = graph_ms(lambda i: quantize.quantized_matmul(
        x, qs[i % copies], ss[i % copies]), iters, stream)
    eager = eager_ms(lambda i: quantize.quantized_matmul(
        x, qs[i % copies], ss[i % copies]), iters)
    plain_ms = graph_ms(lambda i: quantize.qmm_reference(
        x, qs[i % copies], ss[i % copies]), iters, stream)
    lib_ms = graph_ms(lambda i: xb @ wb[i % copies], iters, stream)
    bound, bound_by = qmm_bound_ms(m, k, n, dtype)
    dt = str(dtype).replace("torch.", "")
    log(f"  M={m} K={k} N={n} {dt} ({what}; {per_segment} per segment): "
        f"{route}, {plan.splits} split(s); max_abs_err {err:.3g} (tol "
        f"{tol:.3g}), two launches bitwise equal; kernel {ms:.4f} ms, eager "
        f"{eager:.4f} ms a call, plain {plain_ms:.4f} ms, bf16 matmul "
        f"{lib_ms:.4f} ms; bound {bound:.5f} ms ({bound_by})")
    rows.append(dict(m=m, k=k, n=n, dtype=dt, what=what,
                     launches_per_segment=per_segment, route=route,
                     splits=plan.splits, max_abs_err=err, tolerance=tol,
                     bitwise_repeat=True, ms=ms, eager_ms=eager,
                     plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                     bound_by=bound_by))
    del qs, ss, wb
  return rows


def midi_song(seed: int, path: str, seconds: float) -> sequences.NoteSequence:
  """A seeded multi-instrument song, written as a MIDI file."""
  rng = np.random.default_rng(seed)
  ns = sequences.NoteSequence()
  for _ in range(int(seconds * MIDI_NOTES_PER_SECOND)):
    start = float(rng.uniform(0.0, seconds - 0.3))
    ns.add(start_time=start,
           end_time=start + float(rng.uniform(0.1, min(1.5,
                                                       seconds - start))),
           pitch=int(rng.integers(36, 96)),
           velocity=int(rng.integers(40, 128)),
           program=int(rng.choice(MIDI_PROGRAMS)), is_drum=False)
  midi_io.write_midi_file(ns, path)
  return ns


def forward_ms(model, tokens: np.ndarray, stream: torch.cuda.Stream,
               iters: int = 20):
  """One CFG-pair decoder forward of the main path (2 rows, cached cross
  K/V), as the sampler calls it eagerly (host clock, synchronized) and as
  the card runs it alone (one forward captured in a CUDA graph and
  replayed): the gap is the host's launch overhead. Returns the two ms
  and the forward's output."""
  l_in = model.task_lengths["inputs"]
  padded = np.zeros((1, l_in), np.int64)
  padded[0, :len(tokens)] = tokens[:l_in]
  batch = {"encoder_input_tokens": torch.as_tensor(padded, device="cuda"),
           "encoder_continuous_inputs": torch.full(
               (1, 256, 128), model.audio_codec.pad_value, device="cuda"),
           "encoder_continuous_mask": torch.ones(1, 256, dtype=torch.bool,
                                                 device="cuda")}
  z = torch.randn(2, 256, 128, device="cuda")
  time_ = torch.full((2,), 0.5, device="cuda")
  counts = (attention.flash_attention.launches,
            quantize.quantized_matmul.launches)
  with torch.inference_mode():
    enc = model.model.encode(batch)
    kv = model.model.module.precompute_cross_kv(enc)

    def forward():
      return model.model.module.decode(enc, z, time_, cross_kv=kv,
                                       cond_rows=1)

    for _ in range(3):
      out = forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
      forward()
    torch.cuda.synchronize()
    eager = 1e3 * (time.perf_counter() - t0) / iters
    replay = graph_ms(lambda i: forward(), iters, stream)
  # These launches measure the path; they are not the main path's.
  attention.flash_attention.launches, quantize.quantized_matmul.launches = (
      counts)
  return eager, replay, out


def zero_counts() -> None:
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0


def launch_counts() -> tuple:
  return (attention.flash_attention.launches,
          quantize.quantized_matmul.launches)


def eager_render(synth, segments) -> dict:
  """The explicit eager render (`graphs=False`) of `segments`, vocoder off:
  the reference that a captured render of the same segments must equal bit
  for bit (they set the input bucket; another bucket sums over other
  padding). It runs
  before its model captures anything, so its peak memory is the one
  without graphs, and on the model's step-graph stream, where every
  sampler loop of the model runs (one cuBLAS workspace for both)."""
  zero_counts()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  render = synth.render_song(segments, vocode=False, graphs=False)
  wall = time.perf_counter() - t0
  return dict(mel=render.mel, wall_s=wall, launches=launch_counts(),
              steady_segment_s=render.timings["steady_segment_seconds"],
              peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def graph_name(key) -> str:
  """A step graph's kind: the sampler's pair or conditional step (first,
  last), or the autoregressive decode step."""
  kind = key[-1]
  if not isinstance(kind, dops.StepKind):
    return "decode"
  return (("pair" if kind.pair else "cond") + ("-first" if kind.first else "")
          + ("-last" if kind.last else ""))


def encoder_attention_launches(experiment) -> int:
  """Flash-attention launches of a segment outside its steps: each
  encoder layer's self-attention, once a segment."""
  net = experiment.network()
  return net.num_encoder_layers * (2 if experiment.with_context else 1)


def graph_check(label: str, card: str, synth, segments, eager: dict,
                experiment, main=None) -> dict:
  """Phase 26, one case: captured renders of `segments` against their
  eager render `eager` (`eager_render`), bit for bit. The first captured
  render is `main` = (segments, render), the phase's own render, where
  its first segment runs in the same input bucket (so that its first
  segment captured the step graphs); else a render of `segments` made
  here, which captures where their bucket is new. A second captured render
  replays every step: its mel must equal the eager one too, and its
  launches of kernels #1 and #3 the eager render's: each graph's launches
  a replay x its replays, and outside the graphs the encoders' (their
  attention `encoder_attention_launches` a segment; in int8 also their
  GEMMs and the cross-attention K/V's)."""
  def bucket(segs):
    return synth._input_length(max(len(x) for x in segs))

  frames = eager["mel"].shape[0]
  if main is not None and bucket(main[0]) == bucket(segments):
    first, what = main[1], "the phase's render"
  else:
    zero_counts()
    first, what = synth.render_song(segments, vocode=False), "a render"
    check(launch_counts() == eager["launches"],
          f"{label}: captured launches {launch_counts()}, eager "
          f"{eager['launches']}")
  capture_s = first.timings["capture_seconds"]
  check(np.array_equal(first.mel[:frames], eager["mel"]),
        f"{label}: the captured render differs from the eager one: max abs "
        f"{np.abs(first.mel[:frames] - eager['mel']).max()}")
  graphs = synth.model.step_graphs
  before = {key: c.replays for key, c in graphs.graphs.items()}
  zero_counts()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  render = synth.render_song(segments, vocode=False)
  wall = time.perf_counter() - t0
  launches = launch_counts()
  peak = torch.cuda.max_memory_allocated() / 2**30
  check(np.array_equal(render.mel, eager["mel"]),
        f"{label}: the replayed render differs from the eager one: max abs "
        f"{np.abs(render.mel - eager['mel']).max()}")
  replayed = [(graph_name(key), c.launches, c.replays - before.get(key, 0))
              for key, c in graphs.graphs.items()]
  replayed = [r for r in replayed if r[2]]
  from_graphs = tuple(sum(n[j] * r for _, n, r in replayed)
                      for j in range(len(launches)))
  outside = tuple(a - g for a, g in zip(launches, from_graphs))
  int8 = launches[1] > 0
  check(launches == eager["launches"]
        and outside[0] == len(segments) * encoder_attention_launches(
            experiment) and (from_graphs[1] > 0 or not int8),
        f"{label}: launches (flash_attention, quantized_matmul) captured "
        f"{launches} (from the graphs {from_graphs}, outside them "
        f"{outside}), eager {eager['launches']}")
  summary = dict(
      case=label, segments=len(segments), equal=True,
      eager_steady_segment_s=eager["steady_segment_s"],
      captured_steady_segment_s=render.timings["steady_segment_seconds"],
      eager_wall_s=eager["wall_s"], captured_wall_s=wall,
      capture_s=capture_s, eager_peak_gib=eager["peak_gib"],
      captured_peak_gib=peak, launches_eager=eager["launches"],
      launches_captured=launches, launches_outside_graphs=outside,
      graphs=[dict(kind=name, launches=n, replays=r)
              for name, n, r in replayed])
  log(f"  [{card}] {label}, {len(segments)} segment(s): captured mel equal "
      f"to eager bit for bit ({what}, capturing, and one replaying); "
      f"steady segment eager {eager['steady_segment_s']:.3f} s, captured "
      f"{summary['captured_steady_segment_s']:.3f} s; capture "
      f"{capture_s:.3f} s; peak memory eager {eager['peak_gib']:.2f} GiB, "
      f"with graphs {peak:.2f} GiB; launches (flash_attention, "
      f"quantized_matmul) eager {eager['launches']} = captured " + " + ".join(
          f"{name} {n} x {r}" for name, n, r in replayed)
      + f" + {outside} outside the graphs (the encoders, the K/V)")
  return summary


def song_tokens(seed: int, experiment) -> list:
  codec = vocabularies.build_codec(experiment.vocab_config())
  vocab = vocabularies.vocabulary_from_codec(codec)
  seg_seconds = experiment.task_lengths.targets / 50.0  # 50 frames/s
  notes = note_tokens.random_notes(seed, SEGMENTS * seg_seconds)
  return note_tokens.segment_tokens(
      notes, num_segments=SEGMENTS, segment_seconds=seg_seconds,
      max_tokens=experiment.task_lengths.inputs, codec=codec, vocab=vocab)


def attention_ms_per_segment(rows, experiment, dtype: str) -> dict:
  """Kernel time per segment from phase 3's call times in `dtype` and the
  main path's launches."""
  ms = {(r["shape"], r["batch"]): r["ms"] for r in rows
        if r["dtype"] == dtype}
  net = experiment.network()
  sampler = experiment.diffusion.sampler
  paired, single = guided_steps(experiment)
  context = experiment.with_context
  return {
      "encoders": net.num_encoder_layers * (
          ms["encoder_self_2048x2048", 1]
          + (ms["context_self_256x256", 1] if context else 0.0)),
      "decoder_self": net.num_decoder_layers * (
          paired * ms["decoder_self_256x256", 2]
          + single * ms["decoder_self_256x256", 1]),
      "cross": net.num_decoder_layers * sampler.num_steps
               * ms["cross_256x2304" if context else "notes_cross_256x2048",
                    1],
  }


def qmm_ms_per_segment(qmm_rows, shapes) -> float:
  """Kernel #3's time of one segment: each shape's call time (phase 4's
  rows, and phase 24's) x its launches a segment."""
  ms = {shape_key(r): r["ms"] for r in qmm_rows}
  return sum(ms[shape_key(r)] * r[4] for r in shapes)


def serving_experiment(preset: str = "context_base"):
  return inference.with_sampler(
      config.preset(preset), sampler_steps=100,
      sampler_name="sde-dpm++", guidance_interval=(0.1, 0.8))


def attention_launches(experiment) -> int:
  """Flash-attention launches of one segment of a diffusion model: each
  encoder's self-attention once a segment (the token encoder, and the
  context encoder of the context model), the decoder's self- and
  cross-attention every step."""
  net = experiment.network()
  encoders = 2 if experiment.with_context else 1
  return (encoders * net.num_encoder_layers + 2 * net.num_decoder_layers
          * experiment.diffusion.sampler.num_steps)


def main_phase(seed: int, card: str, rows, stream):
  experiment = serving_experiment()
  t0 = time.perf_counter()
  model = inference.InferenceModel(experiment, seed=seed, device="cuda")
  log(f"  context_base built from seed {seed} on the card "
      f"({time.perf_counter() - t0:.2f} s)")
  segments = song_tokens(seed, experiment)
  voc = vocoder.GriffinLimVocoder(num_iters=32, device="cuda")
  synth = model.synthesizer(voc)
  eager = eager_render(synth, segments[:1])
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  render = synth.render_song(segments)
  wall = time.perf_counter() - t0
  launches = attention.flash_attention.launches
  check(quantize.quantized_matmul.launches == 0,
        f"the float32 path launched the int8 GEMM "
        f"{quantize.quantized_matmul.launches} times")
  net = experiment.network()
  steps = experiment.diffusion.sampler.num_steps
  expected = SEGMENTS * attention_launches(experiment)
  n_frames = SEGMENTS * experiment.task_lengths.targets
  hop = model.audio_codec.hop_size
  check(render.mel.shape == (n_frames, 128), f"mel shape {render.mel.shape}")
  check(bool(np.isfinite(render.mel).all()), "mel finite")
  check(render.audio.shape == (n_frames * hop,),
        f"audio shape {render.audio.shape}")
  check(bool(np.isfinite(render.audio).all()), "audio finite")
  check(launches > 0 and launches == expected,
        f"flash_attention launches {launches}, expected {expected}")
  tm = render.timings
  audio_s = tm["audio_seconds"]
  log(f"  mel {render.mel.shape} finite, audio {render.audio.shape} finite "
      f"({audio_s:.2f} s of audio)")
  log(f"  flash_attention launches {launches} = expected {expected} "
      f"({SEGMENTS} segments x (2 encoders x {net.num_encoder_layers} "
      f"self-attention layers + {net.num_decoder_layers} decoder layers x 2 "
      f"attentions x {steps} steps))")
  parts = attention_ms_per_segment(rows, experiment, "float32")
  log(f"  [{card}] attention kernel per segment, from phase 3's f32 call "
      f"times x launches: {sum(parts.values()):.1f} ms (" + ", ".join(
          f"{k} {v:.1f} ms" for k, v in parts.items()) + ") of the steady "
      f"segment's {1e3 * tm['steady_segment_seconds']:.1f} ms")
  log(f"  [{card}] sampler {tm['prediction_seconds']:.3f} s for "
      f"{SEGMENTS} segments (steady {tm['steady_segment_seconds']:.3f} s per "
      f"{experiment.task_lengths.targets / 50.0:.2f} s segment; capturing "
      f"the step graphs {tm['capture_seconds']:.3f} s of the first); vocoder "
      f"{tm['audio_decode_seconds']:.3f} s; realtime factor "
      f"{audio_s / wall:.3f} (audio s / wall s, {wall:.3f} s wall); peak "
      f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
      f"({resident:.2f} GiB of it allocated before the render)")
  case = graph_check("float32 context_base", card, synth, segments[:1],
                     eager, experiment, (segments, render))
  eager, replay, _ = forward_ms(model, segments[0], stream)
  log(f"  [{card}] one CFG-pair decoder forward: {eager:.3f} ms eager "
      f"(host clock), {replay:.3f} ms on the card alone (CUDA graph); "
      f"x {experiment.diffusion.sampler.num_steps} steps")
  os.makedirs("out", exist_ok=True)
  wav = os.path.join("out", f"chip_smoke_seed{seed}.wav")
  peak = max(float(np.abs(render.audio).max()), 1e-9)
  wav_io.write_wav(wav, render.audio / peak, model.audio_codec.sample_rate)
  log(f"  wrote {wav} (peak-normalized; the weights are random)")
  mag = voc.magnitude(torch.as_tensor(render.mel[None], device="cuda"))
  cpp_s, py_s = pghi_seconds(mag, voc.stft_params)
  log(f"  [{card}'s host] PGHI alone on the {n_frames} x 513 magnitude: "
      f"C++ heap {cpp_s:.3f} s, Python heap {py_s:.3f} s")
  return model, segments, launches, case


def int8_phase(seed: int, card: str, rows, qmm_rows, stream):
  """The int8 path from a MIDI file; returns the model, the segments and
  the two kernels' launch counts."""
  experiment = serving_experiment()
  t0 = time.perf_counter()
  model = inference.InferenceModel(experiment, seed=seed, device="cuda",
                                   compute_dtype="int8")
  total, int8 = quantize.quantized_bytes(model.model.module.state_dict())
  log(f"  int8 context_base built from seed {seed} on the card "
      f"({time.perf_counter() - t0:.2f} s): weights {total / 2**30:.3f} GiB, "
      f"{int8 / 2**30:.3f} GiB of it int8 (quantized_bytes)")
  os.makedirs("out", exist_ok=True)
  midi = os.path.join("out", f"chip_smoke_seed{seed}.mid")
  seg_seconds = experiment.task_lengths.targets / 50.0  # 50 frames/s
  # segment_midi covers the song's end + 0.5 s: 3 segments of 5.12 s.
  midi_song(seed, midi, SEGMENTS * seg_seconds - 1.3)
  t0 = time.perf_counter()
  ns = midi_io.read_midi_file(midi)
  segments = synthesize_midi.segment_midi(
      ns, synthesize_midi.SegmentSettings.for_experiment(experiment),
      model.task_lengths)
  host_s = time.perf_counter() - t0
  check(len(segments) == SEGMENTS, f"{len(segments)} segments from {midi}")
  log(f"  wrote and read back {midi}: {len(ns.notes)} notes, "
      f"{ns.total_time:.2f} s; segment_midi gave {len(segments)} segments "
      f"of {[len(x) for x in segments]} tokens ({host_s:.2f} s on the host)")
  t0 = time.perf_counter()
  voc = vocoder.load_trained(vocoder.TRAINED_MAGNITUDE_GL, device="cuda")
  log(f"  trained vocoder loaded from {vocoder.TRAINED_MAGNITUDE_GL} "
      f"(magnitude_gl, hidden {voc.net.hidden}, n_fft "
      f"{voc.stft_params['fft_length']}, hop {voc.hop_length}, FGLA "
      f"{voc.momentum}, {voc.num_iters} iterations; "
      f"{time.perf_counter() - t0:.2f} s)")
  synth = model.synthesizer(voc)
  l_in = synth._input_length(max(len(x) for x in segments))
  check(l_in == experiment.task_lengths.inputs,
        f"the song's longest segment runs at {l_in} input tokens, not the "
        f"task's {experiment.task_lengths.inputs}")
  eager = eager_render(synth, segments)
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  render = synth.render_song(segments)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              quantize.quantized_matmul.launches)
  expected = (SEGMENTS * attention_launches(experiment),
              SEGMENTS * sum(r["launches_per_segment"] for r in qmm_rows))
  n_frames = SEGMENTS * experiment.task_lengths.targets
  check(render.mel.shape == (n_frames, 128), f"mel shape {render.mel.shape}")
  check(bool(np.isfinite(render.mel).all()), "mel finite")
  check(render.audio.shape == (n_frames * model.audio_codec.hop_size,),
        f"audio shape {render.audio.shape}")
  check(bool(np.isfinite(render.audio).all()), "audio finite")
  check(launches[0] > 0 and launches[0] == expected[0],
        f"flash_attention launches {launches[0]}, expected {expected[0]}")
  check(launches[1] > 0 and launches[1] == expected[1],
        f"quantized_matmul launches {launches[1]}, expected {expected[1]}")
  tm = render.timings
  audio_s = tm["audio_seconds"]
  log(f"  mel {render.mel.shape} finite, audio {render.audio.shape} finite "
      f"({audio_s:.2f} s of audio)")
  log(f"  flash_attention launches {launches[0]} = expected {expected[0]} "
      f"(bf16); quantized_matmul launches {launches[1]} = expected "
      f"{expected[1]} ({SEGMENTS} x {expected[1] // SEGMENTS} per segment, "
      f"from phase 4's shapes)")
  parts = attention_ms_per_segment(rows, experiment, "bfloat16")
  log(f"  [{card}] attention kernel per segment, from phase 3's bf16 call "
      f"times x launches: {sum(parts.values()):.1f} ms (" + ", ".join(
          f"{k} {v:.1f} ms" for k, v in parts.items()) + ")")
  qmm_ms = sum(r["ms"] * r["launches_per_segment"] for r in qmm_rows)
  log(f"  [{card}] int8 GEMM kernel per segment, from phase 4's call times x "
      f"launches: {qmm_ms:.1f} ms of the steady segment's "
      f"{1e3 * tm['steady_segment_seconds']:.1f} ms")
  log(f"  [{card}] sampler {tm['prediction_seconds']:.3f} s for "
      f"{SEGMENTS} segments (steady {tm['steady_segment_seconds']:.3f} s per "
      f"{seg_seconds:.2f} s segment; capturing the step graphs "
      f"{tm['capture_seconds']:.3f} s of the first); vocoder "
      f"{tm['audio_decode_seconds']:.3f} s; realtime factor "
      f"{audio_s / wall:.3f} (audio s / wall s, {wall:.3f} s wall); peak "
      f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
      f"({resident:.2f} GiB of it allocated before the render)")
  case = graph_check("int8 context_base (the MIDI song)", card, synth,
                     segments, eager, experiment, (segments, render))
  eager, replay, _ = forward_ms(model, segments[0], stream)
  log(f"  [{card}] one CFG-pair decoder forward: {eager:.3f} ms eager "
      f"(host clock), {replay:.3f} ms on the card alone (CUDA graph); "
      f"x {experiment.diffusion.sampler.num_steps} steps")
  wav = os.path.join("out", f"chip_smoke_seed{seed}_int8.wav")
  peak = max(float(np.abs(render.audio).max()), 1e-9)
  wav_io.write_wav(wav, render.audio / peak, model.audio_codec.sample_rate)
  log(f"  wrote {wav} (peak-normalized; the diffusion weights are random)")
  return model, segments, launches, synth, render, audio_s / wall, case


def bf16_phase(seed: int, card: str, segments, stream) -> dict:
  """The bf16 serving cast at full width: what each projection stores, one
  CFG-pair decoder forward on the card, and the first segment of phase 7's
  song rendered eagerly and then captured (phase 26's case)."""
  tokens = segments[0]
  experiment = serving_experiment()
  t0 = time.perf_counter()
  model = inference.InferenceModel(experiment, seed=seed, device="cuda",
                                   compute_dtype="bfloat16")
  module = model.model.module
  n_f32 = 0
  for name, sub in module.named_modules():
    if isinstance(sub, layers.DenseGeneral):
      check(not sub.is_int8 and sub.kernel.dtype == sub.dtype,
            f"{name} computes in {sub.dtype} but stores {sub.kernel.dtype}")
      n_f32 += sub.dtype == torch.float32
  nbytes = sum(t.numel() * t.element_size()
               for t in module.state_dict().values())
  log(f"  bf16 context_base built from seed {seed} on the card "
      f"({time.perf_counter() - t0:.2f} s): weights {nbytes / 2**30:.3f} GiB;"
      f" every projection stores the dtype it computes in ({n_f32} float32: "
      f"FiLM and spec_out_dense)")
  eager, replay, out = forward_ms(model, tokens, stream)
  check(out.shape == (2, experiment.task_lengths.targets, 128)
        and out.dtype == torch.bfloat16, f"bf16 forward gave {out.dtype} "
        f"{tuple(out.shape)}")
  check(bool(torch.isfinite(out).all()), "bf16 forward finite")
  log(f"  [{card}] one CFG-pair decoder forward (bf16): {eager:.3f} ms eager "
      f"(host clock), {replay:.3f} ms on the card alone (CUDA graph); "
      f"output {tuple(out.shape)} bf16 finite")
  synth = model.synthesizer()
  return graph_check("bfloat16 context_base", card, synth, segments[:1],
                     eager_render(synth, segments[:1]), experiment)


def reference_phase(model, segments, tolerance):
  """One CFG decoder step at full width on the card (kernels) and on the
  CPU (plain versions); `tolerance(output max)` bounds the max abs diff."""
  l_in = model.task_lengths["inputs"]
  tokens = np.zeros((1, l_in), np.int64)
  tokens[0, :len(segments[0])] = segments[0][:l_in]
  batch = {"encoder_input_tokens": torch.as_tensor(tokens),
           "encoder_continuous_inputs": torch.full(
               (1, 256, 128), model.audio_codec.pad_value),
           "encoder_continuous_mask": torch.zeros(1, 256, dtype=torch.bool)}
  z = torch.randn(2, 256, 128, generator=torch.Generator().manual_seed(1))
  time_ = torch.tensor([0.5, 0.5])
  cpu_model = copy.copy(model.model)
  cpu_model.module = copy.deepcopy(model.model.module).cpu()
  outs = []
  for m, dev in ((model.model, "cuda"), (cpu_model, "cpu")):
    with torch.inference_mode():
      b = {k: v.to(dev) for k, v in batch.items()}
      enc = m.encode(b)
      kv = m.module.precompute_cross_kv(enc)
      outs.append(m.module.decode(enc, z.to(dev), time_.to(dev),
                                  cross_kv=kv, cond_rows=1).cpu().float())
  err = (outs[0] - outs[1]).abs().max().item()
  rms = ((outs[0] - outs[1]).pow(2).mean() / outs[1].pow(2).mean()).sqrt()
  scale = outs[1].abs().max().item()
  check(bool(torch.isfinite(outs[0]).all()), "card decoder output finite")
  tol, why = tolerance(scale)
  check(err <= tol, f"card vs CPU decoder step: max abs diff {err} > {tol}")
  log(f"  decoder CFG step ({model.experiment.dtype}), card vs CPU: max abs "
      f"diff {err:.3g}, relative RMS {rms.item():.3g} (output max "
      f"{scale:.3g}; tol {why} = {tol:.3g})")


def f32_tolerance(scale):
  # The FiLM time embedding takes sin/cos of up to 1e4 rad at t = 0.5,
  # where one ulp of exp in an inverse timescale (the two devices' float32
  # exp differ there) moves the argument by ~6e-4.
  return 3e-4 * scale + 1e-4, "3e-4 x max + 1e-4"


def int8_tolerance(scale):
  # The same weights and arithmetic, but bf16 activations: the kernels sum
  # in another order than the CPU and the flash kernel rounds p to bf16
  # before p.v, so values differ by bf16 rounding steps (2^-8 relative),
  # carried through 24 residual layers.
  return 5e-2 * scale, "5e-2 x max"


def training_experiment():
  """context_base as cli/train.py --preset context_base trains it."""
  return config.preset("context_base")


def bwd_bound_ms(batch, q_len, kv_len, dtype=torch.float32):
  """max(10 b h q kv d FLOPs at the route's peak for `dtype` (3xTF32 for
  f32), bytes at the HBM rate): q, out, dO, dQ and k, v, dK, dV in
  `dtype`, the f32 statistics and the key mask; and the operations at the
  bf16 peak."""
  flops = 10.0 * batch * HEADS * q_len * kv_len * HEAD_DIM
  elt = torch.finfo(dtype).bits // 8
  nbytes = elt * (4 * batch * q_len + 4 * batch * kv_len) * HEADS * HEAD_DIM
  nbytes += 4 * 2 * batch * HEADS * q_len + batch * kv_len
  t_ops, t_bytes = flops / ROUTE_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
  t_bf16 = max(flops / PEAK_FLOPS[torch.bfloat16], t_bytes)
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes"), 1e3 * t_bf16


def sdpa_backward_ms(q, k, v, mask, dout, iters: int) -> float:
  """The yardstick: ms of the backward of one SDPA call on the same inputs
  in their dtype, [b, h, l, d], with the boolean mask (its all-masked row
  gives NaN; it is timed, not used)."""
  sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_()
                for x in (q, k, v))
  bool_mask = None if mask is None else mask[:, None, None, :]
  out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bool_mask,
                                       scale=1.0)
  dout = dout.transpose(1, 2).contiguous()
  return cuda_ms(lambda: torch.autograd.grad(out, (sq, sk, sv), dout,
                                             retain_graph=True), iters)


def bwd_kernel_phase(gen, batch: int, shapes=SHAPES):
  """The backward kernel at the attention shapes of training (`shapes`;
  the context model's four by default)."""
  rows = []
  for name, q_len, kv_len, masked, _ in shapes:
    # Training attends over uncached K/V in [b, l, h, d].
    q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked, False,
                                     torch.float32, gen)
    out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                           return_stats=True)
    dout = torch.randn(out.shape, device="cuda", generator=gen)

    def kernel():
      return attention.flash_attention_bwd(q, k, v, None, mask, out, stats,
                                           dout)

    def plain():
      return attention.flash_attention_bwd_reference(q, k, v, None, mask,
                                                     out, stats, dout)

    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    want = plain()
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    attention.attention_reference(*qkv, kv_mask=mask).backward(dout)
    errs, worst = [], 0.0  # worst: the largest error over its tolerance
    for what, g, w_plain, w_auto in zip("qkv", got, want, qkv):
      check(bool(torch.isfinite(g).all()), f"{name} d{what} finite")
      if mask is not None:
        check(bool(torch.isfinite(g[-1]).all()),
              f"{name} d{what} finite on the all-masked row")
      for ref_name, ref in (("plain", w_plain), ("autograd", w_auto.grad)):
        err = (g - ref).abs().max().item()
        tol = BWD_TOLERANCE * max(1.0, ref.abs().max().item())
        check(err <= tol, f"{name} d{what}: max |kernel - {ref_name}| {err} "
              f"> {tol}")
        errs.append(err)
        worst = max(worst, err / tol)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two launches differ")
    del want, qkv
    iters = 3 if q_len > 256 else 20
    ms, plain_ms, lib_ms = (cuda_ms(kernel, iters), cuda_ms(plain, iters),
                            sdpa_backward_ms(q, k, v, mask, dout, iters))
    # The training forward at this batch: the forward kernel with the
    # statistics output.
    fwd_ms = cuda_ms(lambda: attention.flash_attention(
        q, k, v, kv_mask=mask, return_stats=True), iters)
    bound, bound_by, bound_bf16 = bwd_bound_ms(batch, q_len, kv_len)
    log(f"  {name} b={batch} h={HEADS} d={HEAD_DIM} float32: max_abs_err "
        f"{max(errs):.3g} (tol {BWD_TOLERANCE} x max(1, |grad| max); at "
        f"worst {worst:.3g} of it), "
        f"finite{' with an all-masked row' if masked else ''}, bitwise "
        f"reproducible; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms; bound "
        f"{bound:.4f} ms ({bound_by}, 3xTF32 peak), {bound_bf16:.4f} ms at "
        f"the bf16 peak; the forward kernel with statistics {fwd_ms:.4f} ms")
    rows.append(dict(shape=name, batch=batch, q_len=q_len, kv_len=kv_len,
                     max_abs_err=max(errs), ms=ms,
                     plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                     bound_by=bound_by, bound_bf16_ms=bound_bf16,
                     forward_ms=fwd_ms))
  return rows


def attention_calls_per_step(experiment) -> int:
  """Flash-attention calls (so backward launches) of one training step,
  once per layer: of a diffusion model each encoder's self-attention, the
  decoder's self-attention and its cross-attention modules; of the
  autoregressive model the encoder's self-attention and the decoder's
  cross-attention (its causal self-attention is plain einsums)."""
  net = experiment.network()
  if experiment.model_family == "autoregressive":
    return net.num_encoder_layers + net.num_decoder_layers
  encoders = 2 if experiment.with_context else 1
  n_cross = 1 if net.cross_attend_style == "concat_encodings" else 2
  return (encoders * net.num_encoder_layers
          + (1 + n_cross) * net.num_decoder_layers)


def train_phase(seed: int, card: str, bwd_rows):
  """cli/train.py --synthetic at full width on the card."""
  experiment = training_experiment()
  model_dir = os.path.join("out", "chip_smoke_train")
  shutil.rmtree(model_dir, ignore_errors=True)
  argv = ["--synthetic", "--preset", "context_base", "--model_dir",
          model_dir, "--steps", str(TRAIN_STEPS), "--batch",
          str(TRAIN_BATCH), "--log_period", "1", "--seed", str(seed),
          "--synthetic_examples", str(TRAIN_SONGS), "--device", "cuda"]
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  attention.flash_attention_bwd.launches = 0
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  state, t = train_cli.main(argv)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  check(quantize.quantized_matmul.launches == 0,
        "the training path launched the int8 GEMM")
  peak = torch.cuda.max_memory_allocated() / 2**30
  expected = TRAIN_STEPS * attention_calls_per_step(experiment)
  check(launches[0] == expected and launches[1] == expected,
        f"training launched flash_fwd {launches[0]} and flash_bwd "
        f"{launches[1]} times, expected {expected} each")
  check(state.step == TRAIN_STEPS, f"trained {state.step} steps")
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  check([m["step"] for m in lines] == list(range(1, TRAIN_STEPS + 1)),
        f"logged steps {[m['step'] for m in lines]}")
  for m in lines:
    check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
          f"step {m['step']}: loss {m['loss']}, grad_norm {m['grad_norm']}")
  final = os.path.join(model_dir, f"step_{TRAIN_STEPS}")
  check(os.path.exists(os.path.join(final, "METADATA")),
        "no final checkpoint")
  shutil.rmtree(final)  # 1.6 GB of weights; the metrics stay
  steady = lines[1:]
  s_per_step = float(np.mean([m["timing/seconds_per_step"] for m in steady]))
  frames_per_s = float(np.mean([m["timing/target_frames_per_second"]
                                for m in steady]))
  log("  " + "; ".join(
      f"step {m['step']} loss {m['loss']:.6g} grad_norm {m['grad_norm']:.6g}"
      for m in lines))
  log(f"  launches: flash_fwd {launches[0]}, flash_bwd {launches[1]} = "
      f"expected {expected} ({TRAIN_STEPS} steps x "
      f"{attention_calls_per_step(experiment)} attention calls)")
  per_step_bwd = experiment.network().num_encoder_layers * sum(
      r["ms"] for r in bwd_rows)
  log(f"  [{card}] {s_per_step:.3f} s per step after the first (first "
      f"{lines[0]['timing/seconds_per_step']:.3f} s), "
      f"{frames_per_s:.1f} target frames/s, batch {TRAIN_BATCH}; backward "
      f"kernel {per_step_bwd:.1f} ms a step from phase 10's call times; "
      f"peak memory {peak:.2f} GiB; {wall:.2f} s in all (model, data, "
      f"steps, checkpoint)")
  summary = dict(seconds_per_step=s_per_step,
                 target_frames_per_second=frames_per_s, peak_gib=peak,
                 losses=[m["loss"] for m in lines],
                 grad_norms=[m["grad_norm"] for m in lines],
                 backward_kernel_ms_per_step=per_step_bwd)
  summary["profile"] = profile_step(t, state, experiment, seed, card)
  return t, launches, summary


def profile_step(t, state, experiment, seed: int, card: str,
                 batch_size: int = TRAIN_BATCH) -> dict:
  """One more training step under torch.profiler: the card's busy time by
  kernel, summed into groups, against the step's wall time."""
  from torch.profiler import ProfilerActivity, profile
  batch = training_batches(experiment, batch_size, 1, seed)[0]
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    _, metrics = t.train_step(state, batch, seed)
    check(np.isfinite(metrics["loss"].item()), "profiled step's loss")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  groups = {"flash_bwd (kernel #2)": ("flash_bwd", "bwd_wgmma"),
            "flash_fwd (kernel #1)": ("flash_fwd",),
            "matmul (cuBLAS)": ("gemm", "cutlass", "xmma", "gemv", "nvjet"),
            "other": ("",)}
  busy = {g: 0.0 for g in groups}
  # The kernels themselves (CPU-side operator events also carry their
  # kernels' device time; counting them too would count it twice).
  device_events = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
  for e in device_events:
    key = e.key.lower()
    group = next(g for g, words in groups.items()
                 if any(w in key for w in words))
    busy[group] += e.self_device_time_total / 1e3
  total = sum(busy.values())
  check(total > 0, "the profiler saw no device time")
  top = sorted(device_events, key=lambda e: -e.self_device_time_total)[:6]
  log(f"  [{card}] one profiled step: {1e3 * wall:.1f} ms wall, the card "
      f"busy {total:.1f} ms, idle {100 * (1 - total / (1e3 * wall)):.1f}% "
      f"of the step; busy by kernel group: " + ", ".join(
          f"{g} {v:.1f} ms" for g, v in busy.items()))
  log("  largest kernels: " + "; ".join(
      f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
      for e in top))
  return dict(wall_ms=1e3 * wall, busy_ms=total, by_group=busy)


def training_batches(experiment, batch: int, count: int, seed: int):
  tl = experiment.task_lengths
  task = registry.synthetic_cached_task(
      "train", audio_codec=codecs.get_codec(experiment.codec_name),
      vocab_config=experiment.vocab_config(),
      note_rep=experiment.note_rep(), with_context=True,
      program_granularity=experiment.program_granularity,
      num_examples=TRAIN_SONGS, seed=seed)
  ds = task.model_dataset({"inputs": tl.inputs, "targets": tl.targets,
                           "targets_context": tl.targets_context},
                          seed=seed, num_threads=8)
  return list(ds.repeat().batch(batch).take(count))


def rel_rms(a, b) -> float:
  denom = b.float().pow(2).mean().sqrt().item()
  diff = (a.float() - b.float()).pow(2).mean().sqrt().item()
  return diff / denom if denom > 0 else diff


def step_check_phase(t, seed: int):
  """One full-width step (batch 1, injected draws, no dropout) from the
  same weights: on the card with the kernels, on the card with the plain
  attention in their place, and on the CPU; then again on the card and the
  CPU with the CPU's timing embedding on both."""
  experiment = training_experiment()
  batch = training_batches(experiment, 1, 1, seed)[0]
  gen = torch.Generator().manual_seed(seed)
  target_shape = tuple(batch["decoder_target_tokens"].shape)
  eps = torch.randn(target_shape, generator=gen)
  time_ = torch.tensor([0.37])
  include = torch.tensor([True])
  cpu_model = copy.copy(t.model)
  cpu_model.module = copy.deepcopy(t.model.module).cpu()
  device_embedding = dops.timing_embedding

  def cpu_embedding(position, *args, **kwargs):
    return device_embedding(position.cpu(), *args, **kwargs).to(
        position.device)

  def step(m, plain=False, embedding=device_embedding):
    """(loss, gradients, the network's output, backward launches)."""
    dev = m.device
    draws = lambda x0, cfg: (eps.to(dev), time_.to(dev), include.to(dev))
    outputs = []
    hook = m.module.register_forward_hook(
        lambda module, args, out: outputs.append(out.detach().cpu()))
    launches = attention.flash_attention_bwd.launches
    kernel_fn = attention.flash_attention_diff
    if plain:
      attention.flash_attention_diff = attention.attention_reference
    dops.timing_embedding = embedding
    try:
      metrics, grads = trainer.Trainer(m, experiment.train).loss_and_grads(
          trainer.batch_to_device(batch, dev), draws, None)
    finally:
      attention.flash_attention_diff = kernel_fn
      dops.timing_embedding = device_embedding
      hook.remove()
    used = attention.flash_attention_bwd.launches - launches
    attention.flash_attention_bwd.launches = launches  # not the main path's
    return (metrics["loss"].item(), {n: g.cpu() for n, g in grads.items()},
            outputs[0], used)

  def worst(a, b):
    return max((rel_rms(a[n], b[n]), n) for n in b)

  card_loss, card_g, card_out, used = step(t.model)
  check(used == attention_calls_per_step(experiment),
        f"the card step launched the backward kernel {used} times")
  plain_loss, plain_g, _, used = step(t.model, plain=True)
  check(used == 0, "the plain card step launched the kernel")
  cpu_loss, cpu_g, cpu_out, _ = step(cpu_model)
  same_loss, same_g, same_out, _ = step(t.model, embedding=cpu_embedding)
  ref_loss, ref_g, ref_out, _ = step(cpu_model, embedding=cpu_embedding)
  del cpu_model

  position = time_ * experiment.network().max_decoder_noise_time
  emb_args = (experiment.network().emb_dim,)
  emb_kwargs = dict(max_timescale=experiment.network().max_decoder_noise_time)
  emb_err = (device_embedding(position.to(t.model.device), *emb_args,
                              **emb_kwargs).cpu()
             - device_embedding(position, *emb_args, **emb_kwargs)
             ).abs().max().item()
  flips = int((torch.sign(card_out - eps) != torch.sign(cpu_out - eps)).sum())
  same_flips = int((torch.sign(same_out - eps)
                    != torch.sign(ref_out - eps)).sum())
  loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
  same_loss_err = abs(same_loss - ref_loss) / abs(ref_loss)
  check(np.isfinite(card_loss), "card loss finite")
  check(loss_err <= STEP_LOSS_TOLERANCE,
        f"card vs CPU loss {card_loss} vs {cpu_loss}")
  check(same_loss_err <= STEP_LOSS_TOLERANCE,
        f"card vs CPU loss, the same timing embedding: {same_loss} vs "
        f"{ref_loss}")
  for name, g in card_g.items():
    check(bool(torch.isfinite(g).all()), f"{name} grad finite")
  kernel_err, kernel_leaf = worst(card_g, plain_g)
  check(kernel_err <= STEP_GRAD_TOLERANCE,
        f"kernels vs plain attention on the card, gradient of {kernel_leaf}: "
        f"relative RMS {kernel_err} above {STEP_GRAD_TOLERANCE}")
  same_err, same_leaf = worst(same_g, ref_g)
  check(same_err <= STEP_GRAD_TOLERANCE,
        f"card vs CPU with the same timing embedding, gradient of "
        f"{same_leaf}: relative RMS {same_err} above {STEP_GRAD_TOLERANCE}")
  config_err, config_leaf = worst(card_g, cpu_g)
  config_median = float(np.median([rel_rms(card_g[n], g)
                                   for n, g in cpu_g.items()]))
  log(f"  one step, card vs CPU (batch 1, {len(cpu_g)} parameters, loss "
      f"{experiment.diffusion.loss_norm}): loss {card_loss:.7g} vs "
      f"{cpu_loss:.7g} (relative {loss_err:.3g}, tol "
      f"{STEP_LOSS_TOLERANCE}); plain attention on the card: loss "
      f"{plain_loss:.7g}")
  log(f"  gradient relative RMS, largest (tol {STEP_GRAD_TOLERANCE}): "
      f"kernels vs plain attention on the card {kernel_err:.3g} "
      f"({kernel_leaf}); card vs CPU with the CPU's timing embedding on "
      f"both {same_err:.3g} ({same_leaf}; loss relative "
      f"{same_loss_err:.3g}, L1 sign flips {same_flips})")
  log(f"  as configured, each device's timing embedding (max abs apart "
      f"{emb_err:.3g} at position {position.item():g}): prediction "
      f"relative RMS {rel_rms(card_out, cpu_out):.3g}, L1 sign flips "
      f"{flips} of {card_out.numel()}, gradient relative RMS largest "
      f"{config_err:.3g} ({config_leaf}), median {config_median:.3g}")
  return dict(loss_rel=loss_err, grad_rel_rms_same_embedding=same_err,
              grad_rel_rms_kernel_vs_plain=kernel_err,
              grad_rel_rms_as_configured=config_err,
              l1_sign_flips=flips, timing_embedding_max_abs=emb_err)


def resume_phase(t, seed: int):
  """4 steps straight through against 2 steps, a checkpoint, a trainer
  resumed from it and 2 more steps on the continuation of the stream."""
  experiment = dataclasses.replace(
      training_experiment(), train=dataclasses.replace(
          training_experiment().train, batch_size=RESUME_BATCH,
          train_steps=4, checkpoint_period=2))
  batches = training_batches(experiment, RESUME_BATCH, 4, seed)
  model_dir = os.path.join("out", "chip_smoke_resume")
  shutil.rmtree(model_dir, ignore_errors=True)
  start = {n: p.detach().clone() for n, p in t.params.items()}

  def run(subdir, state, stream, num_steps, init=True):
    if init:
      with torch.no_grad():
        for n, p in t.params.items():
          p.copy_(start[n])
    trainer_ = trainer.Trainer(t.model, experiment.train)
    runner = train_loop.TrainLoop(trainer=trainer_, experiment=experiment,
                                  model_dir=os.path.join(model_dir, subdir),
                                  log_period=1)
    if state is None:
      state = runner.maybe_resume(trainer_.create_state())
    return runner.run(stream, state, num_steps=num_steps, seed=seed)

  fresh = trainer.Trainer(t.model, experiment.train).create_state
  state_a = run("straight", fresh(), iter(batches), 4)
  straight = {n: p.detach().clone() for n, p in t.params.items()}
  stream = iter(batches)
  run("resumed", fresh(), stream, 2)
  with torch.no_grad():  # the resumed trainer must restore the weights
    for p in t.params.values():
      p.zero_()
  state_b = run("resumed", None, stream, 4, init=False)
  check(state_a.step == state_b.step == 4, f"steps {state_b.step}")
  worst = (0.0, "")
  for n, p in t.params.items():
    want = straight[n] - start[n]
    denom = want.pow(2).mean().sqrt().item()
    rel = ((p - start[n]) - want).pow(2).mean().sqrt().item() / max(
        denom, 1e-30)
    worst = max(worst, (rel, n))
  losses = []
  for sub in ("straight", "resumed"):
    with open(os.path.join(model_dir, sub, "metrics.jsonl")) as f:
      losses.append([json.loads(l)["loss"] for l in f])
  check(len(losses[0]) == len(losses[1]) == 4, f"losses {losses}")
  loss_rel = max(abs(a - b) / abs(a) for a, b in zip(*losses))
  check(worst[0] <= RESUME_TOLERANCE and loss_rel <= RESUME_TOLERANCE,
        f"resumed vs straight: update relative RMS {worst[0]} ({worst[1]}), "
        f"loss relative {loss_rel}")
  log(f"  batch {RESUME_BATCH}: resumed vs straight through, largest "
      f"relative RMS of a parameter's 4-step update {worst[0]:.3g} "
      f"({worst[1]}), step losses relative {loss_rel:.3g} (tol "
      f"{RESUME_TOLERANCE}); losses {losses[1]}")
  shutil.rmtree(model_dir, ignore_errors=True)
  return dict(update_rel_rms=worst[0], loss_rel=loss_rel)


def pghi_seconds(magnitude: torch.Tensor, stft_params) -> tuple:
  """Host seconds of PGHI on `magnitude` [1, frames, bins]: the C++ heap
  (`pghi_phase`, the main path's) and the Python heap (`_pghi_heap_py`, its
  plain version), each with the gradients it needs."""
  mag = magnitude.float().cpu().numpy()
  t0 = time.perf_counter()
  stft.pghi_phase(mag, **stft_params)
  cpp = time.perf_counter() - t0
  t0 = time.perf_counter()
  log_mag = np.log(np.maximum(mag, 1e-12))
  tgrad, fgrad = stft._pghi_gradients(log_mag, **stft_params)
  for b in range(mag.shape[0]):
    stft._pghi_heap_py(mag[b], tgrad[b], fgrad[b], 1e-6)
  return cpp, time.perf_counter() - t0


def host_s(fn):
  """Seconds of fn() on the host clock, synchronized; and its result."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return time.perf_counter() - t0, out


def vocoder_phase(card: str, voc, render, realtime: float) -> dict:
  """The trained vocoder on phase 7's song: its split (the net with the
  projection on the card, PGHI on the host in C++ and in Python, Griffin-
  Lim on the card), and the card against the CPU with TF32 off: the
  magnitude, and the audio from the same magnitude and initial phase."""
  mel = torch.as_tensor(render.mel[None], device="cuda")  # [1, frames, 128]
  frames = mel.shape[1]
  with torch.inference_mode():
    net_ms = cuda_ms(lambda: voc.magnitude(mel), 10)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
      net_tf32_ms = cuda_ms(lambda: voc.magnitude(mel), 10)
    finally:
      torch.backends.cudnn.allow_tf32 = False
      torch.backends.cuda.matmul.allow_tf32 = False
    mag = voc.magnitude(mel)
    cpp_s, py_s = pghi_seconds(mag, voc.stft_params)
    init = voc.initial_phase(mag)
    gl_ms = cuda_ms(lambda: voc.griffin_lim(mag, init), 3)
    audio = voc.griffin_lim(mag, init)
  total_s, full = host_s(lambda: voc(mel))
  check(tuple(full.shape) == (1, frames * voc.hop_length)
        and bool(torch.isfinite(full).all()), "trained vocoder audio")
  cpu = vocoder.load_trained(vocoder.TRAINED_MAGNITUDE_GL, device="cpu")
  mag_cpu = cpu.magnitude(mel.cpu())
  mag_err = float((mag.cpu() - mag_cpu).abs().max() / mag_cpu.abs().max())
  audio_cpu = cpu.griffin_lim(mag.cpu(), init.cpu())
  skip = voc.stft_params["frame_length"]
  audio_err = float((audio.cpu() - audio_cpu)[..., skip:].abs().max()
                    / audio_cpu[..., skip:].abs().max())
  end_to_end = cpu(mel.cpu())
  e2e_err = float((full.cpu() - end_to_end)[..., skip:].abs().max()
                  / end_to_end[..., skip:].abs().max())
  phase_diff = int((init.cpu() != cpu.initial_phase(mag_cpu)).sum())
  check(mag_err <= VOCODER_MAG_TOLERANCE,
        f"vocoder magnitude card vs CPU {mag_err} > {VOCODER_MAG_TOLERANCE}")
  check(audio_err <= VOCODER_AUDIO_TOLERANCE,
        f"vocoder GL audio card vs CPU {audio_err} > "
        f"{VOCODER_AUDIO_TOLERANCE}")
  audio_s = frames / 50.0
  log(f"  [{card}] trained vocoder on the int8 song ({frames} frames, "
      f"{audio_s:.2f} s): magnitude net + projection {net_ms:.3f} ms on the "
      f"card ({net_tf32_ms:.3f} ms with TF32 on, the CLIs' default); PGHI on "
      f"the host: C++ heap {cpp_s:.3f} s, Python heap {py_s:.3f} s; "
      f"Griffin-Lim ({voc.num_iters} FGLA iterations) {gl_ms:.3f} ms on the "
      f"card; the vocoder end to end {total_s:.3f} s; realtime factor of "
      f"phase 7 with it {realtime:.3f}")
  log(f"  card vs CPU (TF32 off): magnitude after projection max abs "
      f"{mag_err:.3g} of the max (tol {VOCODER_MAG_TOLERANCE}); GL audio "
      f"from the same magnitude and initial phase {audio_err:.3g} of the "
      f"peak (tol {VOCODER_AUDIO_TOLERANCE}); reported, not gated: the "
      f"vocoder end to end {e2e_err:.3g} of the peak, PGHI phases that "
      f"differ between the card's and the CPU's magnitude {phase_diff} of "
      f"{init.numel()}")
  return dict(net_ms=net_ms, net_tf32_ms=net_tf32_ms, pghi_cpp_s=cpp_s,
              pghi_python_s=py_s, gl_ms=gl_ms, total_s=total_s,
              realtime_factor=realtime, magnitude_err=mag_err,
              audio_err=audio_err, end_to_end_err=e2e_err,
              pghi_phases_differing=phase_diff)


def quality_phase(card: str) -> dict:
  """cli/eval_vocoder.py --synthetic --clips 16 --seed 1000 with the
  committed export, on the card, against the JAX package's CPU report."""
  from music_spectrogram_diffusion_tpu_torch.cli import eval_vocoder
  os.makedirs("out", exist_ok=True)
  seconds, report = host_s(lambda: eval_vocoder.main([
      "--checkpoint", vocoder.TRAINED_MAGNITUDE_GL, "--synthetic",
      "--clips", "16", "--seed", "1000", "--device", "cuda", "--output",
      os.path.join("out", "chip_smoke_eval_vocoder.json")]))
  names = ("spectral_convergence", "log_magnitude", "mel_roundtrip_l2",
           "snr_db")
  for method, want in JAX_EVAL_VOCODER.items():
    got = report["methods"][method]
    log(f"  [{card}] {method}: " + ", ".join(
        f"{k} {got[k]:.4f} (JAX CPU {w:.4f})" for k, w in zip(names, want)))
  trained = report["methods"]["trained"]["spectral_convergence"]
  want = JAX_EVAL_VOCODER["trained"][0]
  gl = report["methods"]["griffin_lim"]["spectral_convergence"]
  rel = abs(trained - want) / want
  check(rel <= QUALITY_TOLERANCE, f"trained spectral convergence {trained} "
        f"vs JAX {want}: {rel:.3%} > {QUALITY_TOLERANCE:.0%}")
  check(trained < gl, f"trained spectral convergence {trained} does not "
        f"beat griffin_lim's {gl}")
  log(f"  trained spectral convergence {trained:.5f}, {rel:.3%} from the JAX "
      f"package's {want:.5f} (tol {QUALITY_TOLERANCE:.0%}), beats "
      f"griffin_lim's {gl:.5f}; 16 clips x 3 vocoders in {seconds:.2f} s")
  return dict(report["methods"], seconds=seconds)


def stream_phase(card: str, synth, segments, render, experiment) -> tuple:
  """stream_song on phase 7's song with phase 7's noise: each segment's mel
  equals the batch render's bit for bit, and its audio is one segment."""
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  firsts, mels = [], []
  for gi, mel, audio in synth.stream_song(segments):
    firsts.append(time.perf_counter() - t0)
    mels.append(mel)
    check(audio.shape == (experiment.task_lengths.targets * 320,)
          and bool(np.isfinite(audio).all()),
          f"streamed segment {gi} audio {audio.shape}")
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              quantize.quantized_matmul.launches)
  streamed = np.concatenate(mels)
  check(np.array_equal(streamed, render.mel),
        f"streamed mel differs from the batch render: max abs "
        f"{np.abs(streamed - render.mel).max()}")
  per_segment = attention_launches(experiment)
  check(launches[0] == SEGMENTS * per_segment,
        f"streaming flash_attention launches {launches[0]}")
  check(launches[1] > 0, "streaming launched no int8 GEMM")
  log(f"  [{card}] {len(mels)} segments streamed, mel equal to phase 7's "
      f"batch render bit for bit, each audio {256 * 320} samples finite; "
      f"audio of segment i out after " + ", ".join(
          f"{t:.3f}" for t in firsts) + f" s ({wall:.3f} s in all); launches "
      f"flash_attention {launches[0]}, quantized_matmul {launches[1]}")
  return launches, wall


def cli_phase(card: str, seed: int, experiment) -> int:
  """cli/synthesize_midi.py on the card with --vocoder_checkpoint: phase
  7's MIDI file, float32 context_base with random weights, the serving
  sampler; a finite WAV of the song's length."""
  midi = os.path.join("out", f"chip_smoke_seed{seed}.mid")
  wav = os.path.join("out", f"chip_smoke_seed{seed}_cli.wav")
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0
  seconds, timings = host_s(lambda: synthesize_midi.main([
      "--midi", midi, "--output", wav, "--size", "base", "--steps", "100",
      "--sampler", "sde-dpm++", "--guidance_interval", "0.1,0.8",
      "--vocoder_checkpoint", vocoder.TRAINED_MAGNITUDE_GL, "--device",
      "cuda", "--seed", str(seed)]))
  launches = attention.flash_attention.launches
  check(quantize.quantized_matmul.launches == 0, "the CLI launched int8")
  check(launches == SEGMENTS * attention_launches(experiment),
        f"CLI flash_attention launches {launches}")
  rate, audio = wav_io.decode_wav(open(wav, "rb").read())
  want = SEGMENTS * experiment.task_lengths.targets * 320
  check(rate == 16000 and audio.shape == (want,)
        and bool(np.isfinite(audio).all()), f"CLI wrote {audio.shape}")
  log(f"  [{card}] wrote {wav}: {audio.shape[0]} samples at {rate} Hz, "
      f"finite; {seconds:.2f} s in all (vocoder "
      f"{timings['audio_decode_seconds']:.3f} s, TF32 off in this run); "
      f"flash_attention launches {launches}")
  return launches


def soundstream_phase(card: str, seed: int, mel: np.ndarray) -> dict:
  """SoundStreamDecoder at full width (base 512, strides 8.5.4.2) on
  random weights from the seed: one forward on the card against the CPU,
  timed."""
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(seed)
    decoder = vocoder.SoundStreamDecoder()
  cpu = copy.deepcopy(decoder).eval()
  voc = vocoder.SoundStreamVocoder(decoder, device="cuda")
  x = torch.as_tensor(mel[None])
  with torch.inference_mode():
    out = voc(x)
    ms = cuda_ms(lambda: voc(x), 5)
    want = cpu(x)
  err = float((out.cpu() - want).abs().max())
  check(tuple(out.shape) == (1, mel.shape[0] * 320)
        and bool(torch.isfinite(out).all()), f"SoundStream {out.shape}")
  check(err <= SOUNDSTREAM_TOLERANCE,
        f"SoundStream card vs CPU {err} > {SOUNDSTREAM_TOLERANCE}")
  params = sum(p.numel() for p in decoder.parameters())
  log(f"  [{card}] SoundStream base {decoder.config.base_channels}, strides "
      f"{decoder.config.strides}, {params / 1e6:.2f}M parameters: "
      f"{mel.shape[0]} frames -> {out.shape[1]} samples in {ms:.3f} ms on "
      f"the card (TF32 off); card vs CPU max abs {err:.3g} (tol "
      f"{SOUNDSTREAM_TOLERANCE}; output max {float(want.abs().max()):.3g})")
  return dict(ms=ms, max_abs_err=err)


# The planted fault of phase 19: the wgmma route's dq pass leaves out the
# second key tile of each of its key ranges (keys 64-127 of the range: their
# dS taken as 0), built from a copy of the sources in phase 2.
BWD_FAULT_AT = "sc[i] = pv * (dp[i] - dl[r]);"
BWD_FAULT = "sc[i] = it == 1 ? 0.f : pv * (dp[i] - dl[r]);"
BWD_FAULT_FILE = "flash_bwd_wgmma.cuh"


def start_fault_build(work: str):
  """nvcc on a copy of csrc/ whose wgmma route carries BWD_FAULT, started
  now and joined by `finish_fault_build`: (library path, process)."""
  shutil.rmtree(work, ignore_errors=True)
  shutil.copytree(_build.CSRC, work, ignore=shutil.ignore_patterns("build"))
  path = os.path.join(work, BWD_FAULT_FILE)
  with open(path) as f:
    text = f.read()
  check(text.count(BWD_FAULT_AT) == 1, f"the fault's line is not in "
        f"{BWD_FAULT_FILE} once")
  with open(path, "w") as f:
    f.write(text.replace(BWD_FAULT_AT, BWD_FAULT))
  src = os.path.join(work, "flash_bwd.cu")
  out = os.path.join(work, "libflash_bwd_fault.so")
  return out, subprocess.Popen(
      [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_fault_build(build) -> ctypes.CDLL:
  out, proc = build
  stdout, stderr = proc.communicate()
  check(proc.returncode == 0, f"nvcc on the planted fault failed:\n{stdout}"
        f"{stderr}")
  return ctypes.CDLL(out)


def bwd_bf16_tolerance(plain) -> float:
  """The bf16 backward's limit on max |kernel - plain|: BWD_BF16_TOLERANCE
  of the gradient's max |plain|."""
  return BWD_BF16_TOLERANCE * plain.float().abs().max().item()


def route_rule_check() -> str:
  """The backward's route rule as the built library applies it
  (msd_flash_bwd_route) against its mirror `attention.bwd_route`, over
  every dtype, head_dim 1-128 and alignment; and the key-split plan's
  tile against the library's."""
  lib = attention._library("flash_bwd")  # pylint: disable=protected-access
  cases = 0
  for dtype, code in attention._DTYPE_CODES.items():  # pylint: disable=protected-access
    for head_dim in range(1, attention.MAX_HEAD_DIM + 1):
      for aligned in (False, True):
        built = ("wgmma" if lib.msd_flash_bwd_route(code, head_dim,
                                                     int(aligned))
                 else "mma_sync")
        check(built == attention.bwd_route(dtype, head_dim, aligned),
              f"route of {dtype} d={head_dim} aligned={aligned}: the "
              f"library's {built}, bwd_route's "
              f"{attention.bwd_route(dtype, head_dim, aligned)}")
        cases += 1
  tiles = {q: attention.bwd_tile(q) for q in (256, 2048)}
  check(all(t[1] == attention.WGMMA_HEAD_DIM for t in tiles.values()),
        f"the wgmma route's tiles {tiles}")
  return (f"{cases} (dtype, head_dim, alignment) cases route as bwd_route "
          f"says; dq item rows and tile by q_len {tiles}")


def bwd_bf16_phase(gen, batch: int, fault_lib) -> list:
  """Kernel #2's bf16 configuration at the four attention shapes of
  training, against its plain bf16 version; the planted fault against the
  same limit."""
  rows = []
  log(f"  route rule: {route_rule_check()}")
  kernels = [line for line in ptxas_usage("flash_bwd") if "wgmma" in line
             or "prologue" in line or "combine" in line]
  log("  the wgmma route's kernels (ptxas): " + " | ".join(kernels))

  def usage(q_len: int) -> str:
    """Registers and spill stores of the dkdv and dq kernels that a call
    with q_len queries (no bias) launches."""
    wanted = ("dkdv_wgmma_kernel<no bias>",
              f"dq_wgmma_kernel<{attention.bwd_tile(q_len)[0] // 64}, no bias>")
    out = []
    for name in wanted:
      line = next(l for l in kernels if name in l)
      regs = re.search(r"Used (\d+) registers", line).group(1)
      spills = re.search(r"(\d+) bytes spill stores", line).group(1)
      out.append(f"{name.split('_wgmma')[0]} {regs} registers, {spills} "
                 f"bytes spilled")
    return ", ".join(out)

  sms = torch.cuda.get_device_properties(0).multi_processor_count
  for name, q_len, kv_len, masked, _ in SHAPES:
    q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked, False,
                                     torch.bfloat16, gen)
    out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                           return_stats=True)
    dout = torch.randn(out.shape, device="cuda",
                       generator=gen).to(torch.bfloat16)
    args = (q, k, v, None, mask, out, stats, dout)
    route = attention.bwd_route(q.dtype, HEAD_DIM)
    check(route == "wgmma", f"{name}: bf16 training takes the {route} route")
    splits = attention.dq_key_split(batch, HEADS, q_len, kv_len, sms,
                                    *attention.bwd_tile(q_len))

    def kernel():
      return attention.flash_attention_bwd(*args)

    def plain():
      return attention.flash_attention_bwd_reference(*args)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    errs, rmss, worst = [], [], 0.0
    for what, g, w in zip("qkv", got, want):
      check(g.dtype == torch.bfloat16, f"{name} d{what} is {g.dtype}")
      check(bool(torch.isfinite(g).all()), f"{name} d{what} finite")
      err = (g.float() - w.float()).abs().max().item()
      tol = bwd_bf16_tolerance(w)
      check(err <= tol, f"{name} d{what}: max |kernel - plain| {err} > {tol}")
      errs.append(err)
      rmss.append(((g.float() - w.float()).pow(2).mean()
                   / w.float().pow(2).mean()).sqrt().item())
      worst = max(worst, err / tol)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two launches differ")
    # The planted fault, against the same limit (its launches are not the
    # main path's).
    launches = attention.flash_attention_bwd.launches
    kept = _build._libraries["flash_bwd"]  # pylint: disable=protected-access
    _build._libraries["flash_bwd"] = fault_lib  # pylint: disable=protected-access
    try:
      faulty = kernel()[0]
    finally:
      _build._libraries["flash_bwd"] = kept  # pylint: disable=protected-access
      attention.flash_attention_bwd.launches = launches
    fault_err = (faulty.float() - want[0].float()).abs().max().item()
    fault_ratio = fault_err / bwd_bf16_tolerance(want[0])
    check(fault_ratio > 1.0, f"{name}: the planted fault (dq without the "
          f"second key tile of each range) within the limit, "
          f"{fault_ratio:.3g} of it")
    del want, faulty
    iters = 3 if q_len > 256 else 20
    ms, plain_ms, lib_ms = (cuda_ms(kernel, iters), cuda_ms(plain, iters),
                            sdpa_backward_ms(q, k, v, mask, dout, iters))
    bound, bound_by, _ = bwd_bound_ms(batch, q_len, kv_len, torch.bfloat16)
    log(f"  {name} b={batch} h={HEADS} d={HEAD_DIM} bfloat16, {route} "
        f"route ({usage(q_len)}), dq key split {splits[0]} x {splits[1]} "
        f"keys: max_abs_err "
        f"dq/dk/dv {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol "
        f"{BWD_BF16_TOLERANCE:.6g} x max |plain|; at worst {worst:.3g} of "
        f"it), relative RMS {max(rmss):.3g}, finite"
        f"{' with an all-masked row' if masked else ''}, bitwise "
        f"reproducible; planted fault {fault_ratio:.3g}x the limit; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} "
        f"ms; bound {bound:.4f} ms ({bound_by}, bf16 peak)")
    rows.append(dict(shape=name, batch=batch, q_len=q_len, kv_len=kv_len,
                     route=route, dq_splits=splits[0],
                     max_abs_err=max(errs), worst_of_tolerance=worst,
                     rel_rms=max(rmss), fault_of_tolerance=fault_ratio,
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound, bound_by=bound_by))
  return rows


def bf16_training_experiment():
  """context_base as a user trains it in bf16 with remat."""
  return dataclasses.replace(training_experiment(), dtype="bfloat16",
                             remat=True)


def bf16_train_phase(seed: int, card: str, f32_peak: float,
                     batch_size: int = TRAIN_BATCH, steps: int = TRAIN_STEPS,
                     checks: bool = True):
  """build_model, Trainer and TrainLoop on context_base in bf16 with remat
  and dropout 0.1: `steps` steps at `batch_size`; with `checks` also the
  one-step check against the plain versions and the remat check."""
  experiment = dataclasses.replace(
      bf16_training_experiment(), train=dataclasses.replace(
          training_experiment().train, batch_size=batch_size,
          train_steps=steps, checkpoint_period=10 * steps))
  batches = training_batches(experiment, batch_size, steps, seed)
  model_dir = os.path.join("out", f"chip_smoke_train_bf16_b{batch_size}")
  shutil.rmtree(model_dir, ignore_errors=True)
  model = trainer.build_model(experiment, seed=seed, device="cuda")
  check(all(p.dtype == torch.float32 for p in model.module.parameters()),
        "bf16 training keeps float32 parameters")
  t = trainer.Trainer(model, experiment.train)
  runner = train_loop.TrainLoop(trainer=t, experiment=experiment,
                                model_dir=model_dir, log_period=1)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  attention.flash_attention_bwd.launches = 0
  quantize.quantized_matmul.launches = 0
  state = runner.run(iter(batches), t.create_state(), seed=seed)
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  peak = torch.cuda.max_memory_allocated() / 2**30
  calls = attention_calls_per_step(experiment)
  check(quantize.quantized_matmul.launches == 0,
        "bf16 training launched the int8 GEMM")
  check(launches == (2 * calls * steps, calls * steps),
        f"bf16 training with remat launched flash_fwd {launches[0]} and "
        f"flash_bwd {launches[1]} times, expected {2 * calls * steps} "
        f"({calls} and their recompute a step) and {calls * steps}")
  check(state.step == steps, f"trained {state.step} steps")
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  for m in lines:
    check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
          f"bf16 step {m['step']}: loss {m['loss']}, grad_norm "
          f"{m['grad_norm']}")
  shutil.rmtree(model_dir, ignore_errors=True)  # the final checkpoint too
  steady = lines[1:]
  s_per_step = float(np.mean([m["timing/seconds_per_step"] for m in steady]))
  frames_per_s = float(np.mean([m["timing/target_frames_per_second"]
                                for m in steady]))
  log("  " + "; ".join(
      f"step {m['step']} loss {m['loss']:.6g} grad_norm {m['grad_norm']:.6g}"
      for m in lines))
  log(f"  launches: flash_fwd {launches[0]} ({2 * calls} a step: {calls} "
      f"and their recompute), flash_bwd {launches[1]} ({calls} a step, "
      f"bf16)")
  log(f"  [{card}] {s_per_step:.3f} s per step after the first (first "
      f"{lines[0]['timing/seconds_per_step']:.3f} s), {frames_per_s:.1f} "
      f"target frames/s, batch {batch_size}; peak memory {peak:.2f} GiB "
      f"(phase 11, float32 without remat: {f32_peak:.2f} GiB)")
  summary = dict(seconds_per_step=s_per_step,
                 target_frames_per_second=frames_per_s, peak_gib=peak,
                 losses=[m["loss"] for m in lines],
                 grad_norms=[m["grad_norm"] for m in lines])
  summary["profile"] = profile_step(t, state, experiment, seed, card,
                                    batch_size)
  if checks:
    summary["step_check"] = bf16_step_check(t, experiment, seed)
    summary["remat_check"] = remat_check(t, experiment, seed)
  return launches, summary


def grad_gaps(grads, ref) -> dict:
  """Per parameter: (max |a - b| / max |b|, relative RMS) of `grads`
  against `ref`; parameters whose reference gradient is 0 are left out."""
  gaps = {}
  for n, g in grads.items():
    scale = ref[n].abs().max().item()
    if scale > 0:
      gaps[n] = ((g.float() - ref[n].float()).abs().max().item() / scale,
                 rel_rms(g, ref[n]))
  return gaps


class _PlainAttentionFn(torch.autograd.Function):
  """The attention kernels' plain versions on any device: forward
  `attention_reference` with `softmax_stats_reference`, backward
  `flash_attention_bwd_reference` (in bf16 it rounds p and dS where the
  kernel does). What flash_attention_diff runs on CPU tensors in bf16."""

  @staticmethod
  def forward(ctx, query, key, value, bias, kv_mask, kv_transposed):
    out = attention.attention_reference(query, key, value, bias, kv_mask,
                                        kv_transposed=kv_transposed)
    stats = attention.softmax_stats_reference(query, key, bias, kv_mask,
                                              kv_transposed=kv_transposed)
    ctx.save_for_backward(query, key, value, bias, kv_mask, out, stats)
    ctx.kv_transposed = kv_transposed
    return out

  @staticmethod
  def backward(ctx, dout):
    grads = attention.flash_attention_bwd_reference(
        *ctx.saved_tensors, dout, kv_transposed=ctx.kv_transposed)
    return (*grads, None, None, None)


def plain_attention_diff(query, key, value, bias=None, kv_mask=None, *,
                         kv_transposed=False):
  return _PlainAttentionFn.apply(query, key, value, bias, kv_mask,
                                 kv_transposed)


def bf16_step_check(t, experiment, seed: int) -> dict:
  """One bf16 step at batch 1 (injected draws, no dropout, remat on, an L2
  loss: see BF16_GRAD_MAX_TOLERANCE) with the kernels, with their plain
  versions in their place (`plain_attention_diff`) and with autograd through
  the plain forward, each held against the same step in float32 with the
  kernels, on the card."""
  batch = trainer.batch_to_device(training_batches(experiment, 1, 1, seed)[0],
                                  "cuda")
  gen = torch.Generator().manual_seed(seed)
  eps = torch.randn(tuple(batch["decoder_target_tokens"].shape),
                    generator=gen).cuda()
  draws = lambda x0, cfg: (eps, torch.tensor([0.37], device="cuda"),
                           torch.tensor([True], device="cuda"))
  l2 = dataclasses.replace(experiment.diffusion, loss_norm="l2")
  f32_module = diffusion_network.ContextTransformer(dataclasses.replace(
      experiment, dtype="float32").network())
  f32_module.load_state_dict(t.model.module.state_dict())
  models = {"bf16": copy.copy(t.model), "f32": diffusion_model.
            ContextDiffusionModel(f32_module.cuda().train(), l2,
                                  t.model.audio_codec)}
  models["bf16"].diffusion_config = l2

  def step(which, plain=None):
    launches = attention.flash_attention_bwd.launches
    kernel_fn = attention.flash_attention_diff
    if plain is not None:
      attention.flash_attention_diff = plain
    try:
      metrics, grads = trainer.Trainer(
          models[which], experiment.train).loss_and_grads(batch, draws, None)
    finally:
      attention.flash_attention_diff = kernel_fn
    used = attention.flash_attention_bwd.launches - launches
    attention.flash_attention_bwd.launches = launches  # not the main path's
    return metrics["loss"].item(), grads, used

  loss, grads, used = step("bf16")
  check(used == attention_calls_per_step(experiment),
        f"the bf16 step launched the backward kernel {used} times")
  plain_loss, plain_grads, used = step("bf16", plain_attention_diff)
  check(used == 0, "the plain bf16 step launched the kernel")
  auto_loss, auto_grads, _ = step("bf16", attention.attention_reference)
  f32_loss, f32_grads, _ = step("f32")
  del models, f32_module
  loss_rel = abs(loss - plain_loss) / abs(plain_loss)
  check(np.isfinite(loss) and loss_rel <= BF16_STEP_LOSS_TOLERANCE,
        f"bf16 step, kernels vs plain attention: loss {loss} vs {plain_loss}")
  for n, g in grads.items():
    check(bool(torch.isfinite(g).all()), f"bf16 step: {n} grad finite")
  gaps = grad_gaps(grads, plain_grads)
  own = grad_gaps(plain_grads, f32_grads)  # bf16's own error, plain path
  kernel_own = grad_gaps(grads, f32_grads)
  auto_own = grad_gaps(auto_grads, f32_grads)
  auto_gaps = grad_gaps(grads, auto_grads)
  worst = (0.0, "")
  for n, (gap_max, gap_rms) in gaps.items():
    limit_max = max(BF16_GRAD_MAX_TOLERANCE, 2 * own[n][0])
    limit_rms = max(BF16_GRAD_RMS_TOLERANCE, 2 * own[n][1])
    worst = max(worst, (max(gap_max / limit_max, gap_rms / limit_rms), n))
  check(worst[0] <= 1.0, f"bf16 step, kernels vs plain attention: the "
        f"gradient of {worst[1]} {gaps[worst[1]]} (max rel, rel RMS) past "
        f"its limit, {worst[0]:.3g} of it; plain bf16 vs f32 there "
        f"{own[worst[1]]}")

  def top(g):
    return (max(v[0] for v in g.values()), max(v[1] for v in g.values()),
            float(np.median([v[1] for v in g.values()])))

  log(f"  one bf16 step at batch 1 (injected draws, no dropout, L2 loss), "
      f"on the card: loss kernels {loss:.7g}, their plain versions "
      f"{plain_loss:.7g} (relative {loss_rel:.3g}, tol "
      f"{BF16_STEP_LOSS_TOLERANCE}), autograd through the plain forward "
      f"{auto_loss:.7g}, float32 with the kernels {f32_loss:.7g}")
  log(f"  gradients, largest max-rel / largest relative RMS / median "
      f"relative RMS: kernels vs plain versions in bf16 %.3g / %.3g / %.3g; "
      f"plain versions bf16 vs float32 %.3g / %.3g / %.3g; kernels bf16 vs "
      f"float32 %.3g / %.3g / %.3g; autograd bf16 vs float32 %.3g / %.3g / "
      f"%.3g; kernels vs autograd in bf16 %.3g / %.3g / %.3g; the worst "
      f"gradient ({worst[1]}) at {worst[0]:.3g} of its limit "
      f"(max({BF16_GRAD_MAX_TOLERANCE}, 2 x the plain bf16 path's own) "
      f"max-rel, max({BF16_GRAD_RMS_TOLERANCE}, 2 x its own) relative RMS)"
      % (*top(gaps), *top(own), *top(kernel_own), *top(auto_own),
         *top(auto_gaps)))
  return dict(loss_rel=loss_rel, kernel_vs_plain=top(gaps),
              plain_vs_f32=top(own), kernel_vs_f32=top(kernel_own),
              autograd_vs_f32=top(auto_own), kernel_vs_autograd=top(auto_gaps),
              worst_of_limit=worst[0])


def set_remat(module, on: bool) -> None:
  """Turn the network's per-layer remat on or off in place (the encoders'
  and the decoder's config)."""
  for part in (module.token_encoder, module.continuous_encoder,
               module.decoder):
    part.cfg = dataclasses.replace(part.cfg, remat=on)


def remat_check(t, experiment, seed: int) -> dict:
  """A bf16 step at REMAT_BATCH with dropout, remat on against remat off
  from the same weights, draws and dropout generator."""
  batch = trainer.batch_to_device(
      training_batches(experiment, REMAT_BATCH, 1, seed)[0], "cuda")
  results = []
  for on in (True, False):
    set_remat(t.model.module, on)
    draws_gen, dropout_gen = trainer.step_generators(seed, 0, "cuda")
    torch.cuda.reset_peak_memory_stats()
    metrics, grads = t.loss_and_grads(batch, dops.generator_draws(draws_gen),
                                      dropout_gen)
    results.append((metrics["loss"].item(), grads,
                    torch.cuda.max_memory_allocated() / 2**30))
  set_remat(t.model.module, True)
  (loss_on, g_on, peak_on), (loss_off, g_off, peak_off) = results
  equal = sum(torch.equal(g_on[n], g_off[n]) for n in g_on)
  largest = max((g_on[n].float() - g_off[n].float()).abs().max().item()
                for n in g_on)
  worst = max(rel_rms(g_on[n], g_off[n]) for n in g_on)
  check(loss_on == loss_off, f"remat on vs off: loss {loss_on} vs {loss_off}")
  check(worst <= RESUME_TOLERANCE,
        f"remat on vs off: a gradient's relative RMS {worst}")
  log(f"  remat on vs off, bf16 at batch {REMAT_BATCH} with dropout "
      f"{experiment.dropout_rate}: loss {loss_on:.7g} both; {equal} of "
      f"{len(g_on)} gradients bitwise equal, largest difference {largest:.3g} "
      f"(relative RMS at worst {worst:.3g}); peak memory {peak_on:.2f} GiB "
      f"on, {peak_off:.2f} GiB off")
  return dict(bitwise_equal=equal, leaves=len(g_on), largest_diff=largest,
              peak_gib_on=peak_on, peak_gib_off=peak_off)


def cli_train_phase(card: str, seed: int) -> dict:
  """cli/train.py with --remat, --eval_batches, --eval_period and
  --cache_root at a batch that could not fit without remat, float32."""
  from music_spectrogram_diffusion_tpu_torch.data import cache as cache_lib
  model_dir = os.path.join("out", "chip_smoke_train_cli")
  cache_root = os.path.join("out", "chip_smoke_cache")
  for d in (model_dir, cache_root):
    shutil.rmtree(d, ignore_errors=True)
  argv = ["--synthetic", "--preset", "context_base", "--remat", "--batch",
          str(CLI_BATCH), "--steps", "2", "--eval_batches", "2",
          "--eval_period", "2", "--cache_root", cache_root, "--model_dir",
          model_dir, "--log_period", "1", "--seed", str(seed),
          "--synthetic_examples", str(TRAIN_SONGS), "--device", "cuda"]
  reads, read_cache = [], cache_lib.read_cache

  def counted_read(cache_dir):
    reads.append(os.path.basename(cache_dir))
    return read_cache(cache_dir)

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  attention.flash_attention_bwd.launches = 0
  cache_lib.read_cache = counted_read
  t0 = time.perf_counter()
  try:
    state, t = train_cli.main(argv)
  finally:
    cache_lib.read_cache = read_cache
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  peak = torch.cuda.max_memory_allocated() / 2**30
  check(state.step == 2, f"the CLI trained {state.step} steps")
  del t
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  evals = [m for m in lines if "eval/loss" in m]
  check(len(evals) == 1 and evals[0]["step"] == 2
        and np.isfinite(evals[0]["eval/loss"]),
        f"eval lines {evals}")
  train_lines = [m for m in lines if "loss" in m]
  for m in train_lines:
    check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
          f"CLI step {m['step']}: loss {m['loss']}")
  built = sorted(os.listdir(cache_root))
  check(len(built) == 2 and all(cache_lib.cache_exists(
      os.path.join(cache_root, d)) for d in built), f"caches {built}")
  check(sorted(set(reads)) == built, f"caches read {reads}, built {built}")
  calls = attention_calls_per_step(training_experiment())
  # 2 steps of the forward, its recompute and the backward; the eval pass's
  # 2 batches of the forward.
  check(launches == (2 * 2 * calls + 2 * calls, 2 * calls),
        f"the CLI launched flash_fwd {launches[0]} and flash_bwd "
        f"{launches[1]} times, expected {6 * calls} and {2 * calls}")
  shutil.rmtree(model_dir, ignore_errors=True)
  log(f"  batch {CLI_BATCH}, float32, remat: losses "
      f"{[round(m['loss'], 3) for m in train_lines]}, eval/loss "
      f"{evals[0]['eval/loss']:.6g} at step 2; caches built and read: "
      f"{', '.join(built)}; launches flash_fwd {launches[0]}, flash_bwd "
      f"{launches[1]}")
  log(f"  [{card}] {train_lines[-1]['timing/seconds_per_step']:.3f} s for "
      f"step 2, peak memory {peak:.2f} GiB; {wall:.2f} s in all (model, "
      f"caches, data, steps, eval, checkpoint)")
  return dict(launches=launches, peak_gib=peak, wall_s=wall,
              eval_loss=evals[0]["eval/loss"],
              seconds_per_step=train_lines[-1]["timing/seconds_per_step"])


# ---------------------------------------------------------------------------
# Phases 22-25: the notes-only diffusion and autoregressive families.
# ---------------------------------------------------------------------------

# The autoregressive path's segments (each 256 frames, one decode step a
# frame), and the steps of each family's training run.
AR_SEGMENTS, FAMILY_TRAIN_STEPS = 2, 3
# Decode steps held card vs CPU in float32 (phase 24).
AR_CHECK_STEPS = 8
# The autoregressive model's cached decode (phase 24, int8 weights on a
# bf16 network) fed its own frames back through the teacher-forced forward:
# max |diff| within 2.5% of the output's max and relative RMS within 2%,
# the limits of a bf16 network against its reference
# (tests/test_torch_quantize.py). The two passes compute the same
# function in other orders and routes: the teacher-forced cross-attention
# through the flash kernel (p rounded to bf16 before p.v), each decode
# step's in f32 einsums; the int8 GEMM's tensor-core route at 256 rows
# against its GEMV route at one; each a bf16 rounding step (2^-8) carried
# through 24 residual layers.
AR_TF_MAX_REL, AR_TF_RMS_REL = 2.5e-2, 2e-2
# Card vs CPU in float32 (phase 24), max |diff| over the output's max: the
# attention kernels' 3xTF32 products and every sum in another order, no
# time embedding in this family (the context decoder's card-vs-CPU gap
# without it was 3.0e-6, PERF.md §6).
AR_F32_TOLERANCE = 1e-4


def ar_qmm_shapes(experiment, l_in: int, rows: int = 1) -> list:
  """Every int8 GEMM of one segment of the autoregressive int8 path: the
  encoder at l_in rows, the cross-attention K/V once, then each of the
  `targets` decode steps at `rows` rows (the batch): self q/k/v and cross
  q, self and cross out, the MLP. The continuous input projection (128
  wide) stays bf16 and the output projection f32."""
  net = experiment.network()
  e, hd, f = net.emb_dim, net.num_heads * net.head_dim, net.mlp_dim
  n_wi, enc = len(net.mlp_activations), net.num_encoder_layers
  dec, steps = net.num_decoder_layers, experiment.task_lengths.targets
  bf16 = torch.bfloat16
  return merge_qmm_rows([
      (l_in, e, hd, bf16, 3 * enc, "AR encoder q/k/v"),
      (l_in, hd, e, bf16, enc, "AR encoder attention out"),
      (l_in, e, f, bf16, n_wi * enc, "AR encoder mlp wi"),
      (l_in, f, e, bf16, enc, "AR encoder mlp wo"),
      (l_in, e, hd, bf16, 2 * dec, "AR cross K/V (once a segment)"),
      (rows, e, hd, bf16, 4 * dec * steps,
       "AR decode step self q/k/v, cross q"),
      (rows, hd, e, bf16, 2 * dec * steps, "AR decode step self, cross out"),
      (rows, e, f, bf16, n_wi * dec * steps, "AR decode step mlp wi"),
      (rows, f, e, bf16, dec * steps, "AR decode step mlp wo")])


def shape_key(row) -> tuple:
  """(M, K, N, dtype) of a qmm_shapes tuple or a qmm_phase row."""
  return tuple(row[:4]) if isinstance(row, tuple) else (
      row["m"], row["k"], row["n"], getattr(torch, row["dtype"]))


def midi_segments(seed: int, experiment, model) -> list:
  """Phase 7's MIDI file, cut by segment_midi for `experiment`."""
  midi = os.path.join("out", f"chip_smoke_seed{seed}.mid")
  return synthesize_midi.segment_midi(
      midi_io.read_midi_file(midi),
      synthesize_midi.SegmentSettings.for_experiment(experiment),
      model.task_lengths)


def notes_only_phase(seed: int, card: str, rows, qmm_rows) -> dict:
  """diffusion_base (notes only) in int8 renders phase 7's MIDI file: 3
  independent segments, the serving sampler, the trained vocoder; then one
  float32 decoder step, card vs CPU."""
  experiment = serving_experiment("diffusion_base")
  t0 = time.perf_counter()
  model = inference.InferenceModel(experiment, seed=seed, device="cuda",
                                   compute_dtype="int8")
  total, int8 = quantize.quantized_bytes(model.model.module.state_dict())
  check(isinstance(model.model, diffusion_model.DiffusionModel),
        f"diffusion_base built a {type(model.model).__name__}")
  log(f"  int8 diffusion_base built from seed {seed} on the card "
      f"({time.perf_counter() - t0:.2f} s): weights {total / 2**30:.3f} GiB, "
      f"{int8 / 2**30:.3f} GiB of it int8")
  segments = midi_segments(seed, experiment, model)
  check(len(segments) == SEGMENTS, f"{len(segments)} segments")
  synth = model.synthesizer(vocoder.load_trained(
      vocoder.TRAINED_MAGNITUDE_GL, device="cuda"))
  check(not synth._uses_context, "the notes-only model chained context")
  l_in = synth._input_length(max(len(x) for x in segments))
  check(l_in == experiment.task_lengths.inputs, f"bucket {l_in}")
  shapes = qmm_shapes(experiment, l_in)
  held = {shape_key(r) for r in qmm_rows}
  check(all(shape_key(r) in held for r in shapes),
        "a notes-only int8 GEMM shape that phase 4 did not hold")
  eager = eager_render(synth, segments[:1])
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  render = synth.render_song(segments)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              quantize.quantized_matmul.launches)
  expected = (SEGMENTS * attention_launches(experiment),
              SEGMENTS * sum(r[4] for r in shapes))
  n_frames = SEGMENTS * experiment.task_lengths.targets
  check(render.mel.shape == (n_frames, 128), f"mel {render.mel.shape}")
  check(bool(np.isfinite(render.mel).all()), "mel finite")
  check(render.audio.shape == (n_frames * 320,)
        and bool(np.isfinite(render.audio).all()), "audio finite")
  check(launches == expected, f"launches flash_attention, quantized_matmul "
        f"{launches}, expected {expected}")
  tm = render.timings
  audio_s = tm["audio_seconds"]
  summary = dict(launches=launches, realtime_factor=audio_s / wall,
                 wall_s=wall, prediction_s=tm["prediction_seconds"],
                 steady_segment_s=tm["steady_segment_seconds"],
                 capture_s=tm["capture_seconds"],
                 vocoder_s=tm["audio_decode_seconds"],
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  log(f"  mel {render.mel.shape}, audio {render.audio.shape} finite; "
      f"launches flash_attention {launches[0]} = expected {expected[0]} "
      f"({SEGMENTS} x ({experiment.network().num_encoder_layers} encoder + "
      f"2 x {experiment.network().num_decoder_layers} decoder layers x "
      f"{experiment.diffusion.sampler.num_steps} steps)), quantized_matmul "
      f"{launches[1]} = expected {expected[1]}")
  parts = attention_ms_per_segment(rows, experiment, "bfloat16")
  summary.update(attention_ms_per_segment=sum(parts.values()),
                 qmm_ms_per_segment=qmm_ms_per_segment(qmm_rows, shapes))
  log(f"  [{card}] sampler {tm['prediction_seconds']:.3f} s for {SEGMENTS} "
      f"independent segments (steady {tm['steady_segment_seconds']:.3f} s "
      f"per 5.12 s segment; capture {tm['capture_seconds']:.3f} s); vocoder "
      f"{tm['audio_decode_seconds']:.3f} s; "
      f"realtime factor {audio_s / wall:.3f} ({wall:.3f} s wall); peak "
      f"memory {summary['peak_gib']:.2f} GiB; the kernels a segment, from "
      f"phases 3, 4 and 22's call times x launches: attention "
      f"{summary['attention_ms_per_segment']:.1f} ms, int8 GEMM "
      f"{summary['qmm_ms_per_segment']:.1f} ms")
  case = graph_check("int8 diffusion_base (notes only)", card, synth,
                     segments[:1], eager, experiment, (segments, render))
  del model, synth
  f32 = inference.InferenceModel(experiment, seed=seed, device="cuda")
  reference_phase(f32, segments, f32_tolerance)
  return summary, case


def ar_reference_check(model, tokens: np.ndarray) -> dict:
  """The float32 autoregressive model's encoder and first AR_CHECK_STEPS
  decode steps (each fed the previous output), card vs CPU."""
  cpu = copy.deepcopy(model.model.module).cpu()
  outs = []
  for module, dev in ((model.model.module, "cuda"), (cpu, "cpu")):
    with torch.inference_mode():
      t = torch.as_tensor(tokens, device=dev)
      enc = module.encode(t)
      cache = module.init_cache(enc, t, AR_CHECK_STEPS)
      frame = torch.zeros(1, 1, 128, device=dev)
      steps = []
      for i in range(AR_CHECK_STEPS):
        frame = module.decode_step(cache, frame,
                                   torch.tensor([i], device=dev))
        steps.append(frame)
      outs.append((enc.cpu(), torch.cat(steps, dim=1).cpu()))
  errs = {}
  for what, got, want in zip(("encoder", "decode steps"), *outs):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(bool(torch.isfinite(got).all()), f"AR {what} finite")
    check(err <= AR_F32_TOLERANCE * scale, f"AR f32 {what}, card vs CPU: "
          f"{err} > {AR_F32_TOLERANCE} x {scale}")
    errs[what] = err / scale
  log(f"  ar_base float32, card vs CPU: encoder max |diff| / max "
      f"{errs['encoder']:.3g}, the first {AR_CHECK_STEPS} decode steps "
      f"{errs['decode steps']:.3g} (tol {AR_F32_TOLERANCE})")
  return errs


def ar_phase(seed: int, card: str, rows, qmm_rows, gen, stream) -> dict:
  """ar_base in int8 (bf16 network) generates AR_SEGMENTS segments of phase
  7's MIDI file by the cached decode, vocoded; the frames fed back through
  the teacher-forced forward reproduce the cached outputs; the new int8
  GEMM shapes (the decode steps' one row) against their plain version; in
  float32 the encoder and the first decode steps, card vs CPU."""
  experiment = config.preset("ar_base")
  t0 = time.perf_counter()
  model = inference.InferenceModel(experiment, seed=seed, device="cuda",
                                   compute_dtype="int8")
  check(experiment.ar_output == "deterministic",
        f"ar_base's head is {experiment.ar_output}")
  log(f"  int8 ar_base built from seed {seed} on the card "
      f"({time.perf_counter() - t0:.2f} s)")
  segments = midi_segments(seed, experiment, model)[:AR_SEGMENTS]
  synth = model.synthesizer(vocoder.load_trained(
      vocoder.TRAINED_MAGNITUDE_GL, device="cuda"))
  check(not synth._uses_context, "the autoregressive model chained context")
  l_in = synth._input_length(max(len(x) for x in segments))
  shapes = ar_qmm_shapes(experiment, l_in)
  held = {shape_key(r) for r in qmm_rows}
  new_rows = qmm_phase([r for r in shapes if shape_key(r) not in held],
                       gen, stream)
  check(bool(new_rows), "the AR path has no int8 GEMM shape of its own")
  eager = eager_render(synth, segments[:1])
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  render = synth.render_song(segments)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              quantize.quantized_matmul.launches)
  net = experiment.network()
  expected = (AR_SEGMENTS * net.num_encoder_layers,
              AR_SEGMENTS * sum(r[4] for r in shapes))
  frames = experiment.task_lengths.targets
  check(render.mel.shape == (AR_SEGMENTS * frames, 128),
        f"mel {render.mel.shape}")
  check(bool(np.isfinite(render.mel).all()), "mel finite")
  check(render.audio.shape == (AR_SEGMENTS * frames * 320,)
        and bool(np.isfinite(render.audio).all()), "audio finite")
  check(launches == expected, f"launches flash_attention, quantized_matmul "
        f"{launches}, expected {expected}")
  tm = render.timings
  seg_s = tm["prediction_seconds"] / AR_SEGMENTS
  encoder_ms = {r["batch"]: r["ms"] for r in rows
                if r["shape"] == "ar_encoder_self_2048x2048_unmasked"
                and r["dtype"] == "bfloat16"}[1]
  summary = dict(launches=launches, wall_s=wall, segment_s=seg_s,
                 attention_ms_per_segment=net.num_encoder_layers * encoder_ms,
                 qmm_ms_per_segment=qmm_ms_per_segment(
                     list(qmm_rows) + new_rows, shapes),
                 steady_segment_s=tm["steady_segment_seconds"],
                 capture_s=tm["capture_seconds"],
                 frames_per_s=frames / tm["steady_segment_seconds"],
                 vocoder_s=tm["audio_decode_seconds"],
                 realtime_factor=tm["audio_seconds"] / wall,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
  log(f"  mel {render.mel.shape}, audio {render.audio.shape} finite; "
      f"launches flash_attention {launches[0]} = expected {expected[0]} "
      f"(the encoder's self-attention; the decode steps attend in plain "
      f"einsums), quantized_matmul {launches[1]} = expected {expected[1]} "
      f"({AR_SEGMENTS} x {expected[1] // AR_SEGMENTS}: {frames} decode steps "
      f"x {9 * net.num_decoder_layers} one-row GEMMs, the encoder and the "
      f"cross K/V)")
  log(f"  [{card}] {seg_s:.3f} s a segment of {frames} frames "
      f"({tm['prediction_seconds']:.3f} s for "
      f"{AR_SEGMENTS}; steady {tm['steady_segment_seconds']:.3f} s, "
      f"{summary['frames_per_s']:.1f} frames/s; capture "
      f"{tm['capture_seconds']:.3f} s); vocoder "
      f"{tm['audio_decode_seconds']:.3f} s; realtime factor "
      f"{summary['realtime_factor']:.3f}; peak memory "
      f"{summary['peak_gib']:.2f} GiB; the kernels a segment, from phases 4, "
      f"22 and 24's call times x launches: attention "
      f"{summary['attention_ms_per_segment']:.1f} ms, int8 GEMM "
      f"{summary['qmm_ms_per_segment']:.1f} ms")
  # The cached decode against the teacher-forced forward: the generated
  # frames (the deterministic head's outputs) fed back, shifted by one.
  tokens = np.zeros((1, l_in), np.int64)
  tokens[0, :len(segments[0])] = segments[0]
  mel = torch.as_tensor(render.mel[:frames][None], device="cuda")
  inputs = torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)
  with torch.inference_mode():
    forced = model.model.module(torch.as_tensor(tokens, device="cuda"),
                                inputs).float()
  diff = (forced - mel).abs()
  max_rel = diff.max().item() / mel.abs().max().item()
  rms = rel_rms(forced, mel)
  check(max_rel <= AR_TF_MAX_REL and rms <= AR_TF_RMS_REL,
        f"teacher-forced vs cached: max {max_rel} (tol {AR_TF_MAX_REL}), "
        f"relative RMS {rms} (tol {AR_TF_RMS_REL})")
  log(f"  cached decode vs the teacher-forced forward on its frames "
      f"(bf16 network): max |diff| / max {max_rel:.3g} (tol "
      f"{AR_TF_MAX_REL}), relative RMS {rms:.3g} (tol {AR_TF_RMS_REL})")
  summary.update(teacher_forced_max_rel=max_rel, teacher_forced_rms=rms)
  case = graph_check("int8 ar_base", card, synth, segments[:1], eager,
                     experiment, (segments, render))
  del model, synth
  f32 = inference.InferenceModel(experiment, seed=seed, device="cuda")
  summary["f32_card_vs_cpu"] = ar_reference_check(f32, tokens)
  return summary, new_rows, case


def family_train_phase(seed: int, card: str, preset: str) -> dict:
  """cli/train.py --synthetic --preset <preset> at full width, batch 8,
  FAMILY_TRAIN_STEPS steps in float32: finite losses, s per step, peak
  memory, both attention kernels' launches."""
  experiment = config.preset(preset)
  model_dir = os.path.join("out", f"chip_smoke_train_{preset}")
  shutil.rmtree(model_dir, ignore_errors=True)
  argv = ["--synthetic", "--preset", preset, "--model_dir", model_dir,
          "--steps", str(FAMILY_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
          "--log_period", "1", "--seed", str(seed), "--synthetic_examples",
          str(TRAIN_SONGS), "--device", "cuda"]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  attention.flash_attention_bwd.launches = 0
  t0 = time.perf_counter()
  state, t = train_cli.main(argv)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  peak = torch.cuda.max_memory_allocated() / 2**30
  family = type(t.model).__name__
  del t
  expected = FAMILY_TRAIN_STEPS * attention_calls_per_step(experiment)
  check(launches == (expected, expected), f"{preset} training launched "
        f"flash_fwd {launches[0]}, flash_bwd {launches[1]}; expected "
        f"{expected} each")
  check(state.step == FAMILY_TRAIN_STEPS, f"trained {state.step} steps")
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  for m in lines:
    check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
          f"{preset} step {m['step']}: loss {m['loss']}")
  shutil.rmtree(model_dir, ignore_errors=True)  # the weights; logged above
  s_per_step = float(np.mean([m["timing/seconds_per_step"]
                              for m in lines[1:]]))
  log(f"  {preset} ({family}): " + "; ".join(
      f"step {m['step']} loss {m['loss']:.6g} grad_norm {m['grad_norm']:.6g}"
      for m in lines) + f"; launches flash_fwd {launches[0]}, flash_bwd "
      f"{launches[1]} = expected {expected} ({FAMILY_TRAIN_STEPS} steps x "
      f"{attention_calls_per_step(experiment)} attention calls)")
  log(f"  [{card}] {preset}: {s_per_step:.3f} s per step after the first "
      f"(first {lines[0]['timing/seconds_per_step']:.3f} s), batch "
      f"{TRAIN_BATCH}, float32; peak memory {peak:.2f} GiB; {wall:.2f} s in "
      f"all")
  return dict(launches=launches, seconds_per_step=s_per_step, peak_gib=peak,
              losses=[m["loss"] for m in lines], wall_s=wall)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this run needs "
          "an NVIDIA GPU", file=sys.stderr)
    return 1
  # float32 means float32: no TF32 in matmuls or convolutions.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gen = torch.Generator("cuda").manual_seed(args.seed)
  capture = torch.cuda.Stream()  # every CUDA-graph timing runs on it

  t0 = time.perf_counter()
  card = card_line()
  log(card)
  log(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
      f"{torch.__version__}, CUDA {torch.version.cuda} "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  # 4 nvcc processes at once: the three kernels, and phase 19's fault.
  fault_build = start_fault_build(os.path.join("out", "chip_smoke_fault"))
  _build.build("flash_fwd", "qmm", "flash_bwd")
  attention._library("flash_fwd")
  attention._library("flash_bwd")
  quantize._library()
  fault_lib = finish_fault_build(fault_build)
  log(f"phase 2 build: flash_fwd.cu, qmm.cu and flash_bwd.cu with nvcc, "
      f"and flash_bwd.cu with phase 19's planted fault "
      f"({time.perf_counter() - t0:.2f} s)")
  for name in ("flash_fwd", "qmm", "flash_bwd"):
    usage = ptxas_usage(name)
    check(bool(usage), f"no ptxas report for {name}.cu")
    for line in usage:
      log(f"  ptxas {name}: {line}")
      check(" 0 bytes spill stores" in line, f"{name}.cu spills: {line}")

  t0 = time.perf_counter()
  rows = kernel_phase(gen, capture)
  # The checks draw from a generator of their own, so that the phases
  # after them see the inputs they saw without them.
  check_gen = torch.Generator("cuda").manual_seed(args.seed + 1)
  log(f"  TF32 rounding: {tf32_rounding_check(check_gen)}")
  log(f"  NaN in, NaN out where the plain version's is (NaN outputs): "
      f"{nan_check(check_gen)}")
  log(f"phase 3 attention kernel vs plain: {len(rows)} checks passed "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  # The int8 path's input length: its MIDI song is made dense enough that
  # the longest segment needs all of the task's input tokens (phase 7
  # checks that it does).
  experiment = serving_experiment()
  shapes = qmm_shapes(experiment, experiment.task_lengths.inputs)
  qmm_rows = qmm_phase(shapes, gen, capture)
  log(f"phase 4 int8 GEMM kernel vs plain: {len(qmm_rows)} shapes passed "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  model, segments, f32_launches, f32_case = main_phase(args.seed, card, rows,
                                                      capture)
  log(f"phase 5 main path, float32 from event tokens "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  reference_phase(model, segments, f32_tolerance)
  log(f"phase 6 reference check, float32 ({time.perf_counter() - t0:.2f} s)")
  del model
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  model, segments, int8_launches, synth, render, realtime, int8_case = (
      int8_phase(args.seed, card, rows, qmm_rows, capture))
  log(f"phase 7 main path, int8 from a MIDI file "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  reference_phase(model, segments, int8_tolerance)
  log(f"phase 8 reference check, int8 ({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  bf16_case = bf16_phase(args.seed, card, segments, capture)
  log(f"phase 9 bf16 decoder forward and render "
      f"({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  bwd_rows = bwd_kernel_phase(gen, TRAIN_BATCH)
  log(f"phase 10 attention backward kernel vs plain: {len(bwd_rows)} shapes "
      f"passed ({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  t, train_launches, train_summary = train_phase(args.seed, card, bwd_rows)
  log(f"phase 11 main path, training float32 from cli/train.py --synthetic "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  step_check = step_check_phase(t, args.seed)
  log(f"phase 12 reference check, one training step "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  resume = resume_phase(t, args.seed)
  log(f"phase 13 resume check ({time.perf_counter() - t0:.2f} s)")
  del t
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  vocoder_summary = vocoder_phase(card, synth.vocoder, render, realtime)
  log(f"phase 14 trained vocoder on the int8 song, card vs CPU "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  quality = quality_phase(card)
  log(f"phase 15 vocoder quality, cli/eval_vocoder.py --synthetic "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  stream_launches, stream_wall = stream_phase(card, synth, segments, render,
                                              experiment)
  log(f"phase 16 main path, int8 streamed with stream_song "
      f"({time.perf_counter() - t0:.2f} s)")
  del model, synth
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  cli_launches = cli_phase(card, args.seed, experiment)
  log(f"phase 17 main path, cli/synthesize_midi.py with the trained vocoder "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  soundstream = soundstream_phase(card, args.seed,
                                  render.mel[:experiment.task_lengths.targets])
  log(f"phase 18 SoundStream at full width, card vs CPU "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  bwd_bf16_rows = bwd_bf16_phase(gen, TRAIN_BATCH, fault_lib)
  log(f"phase 19 attention backward kernel in bf16 vs plain: "
      f"{len(bwd_bf16_rows)} shapes passed ({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  bf16_launches, bf16_summary = bf16_train_phase(args.seed, card,
                                                 train_summary["peak_gib"])
  torch.cuda.empty_cache()
  bf16_large_launches, bf16_summary["batch_32"] = bf16_train_phase(
      args.seed, card, train_summary["peak_gib"], BF16_LARGE_BATCH,
      BF16_LARGE_STEPS, checks=False)
  log(f"phase 20 main path, training bfloat16 with remat through "
      f"build_model, Trainer and TrainLoop at batch {TRAIN_BATCH} and "
      f"{BF16_LARGE_BATCH} ({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  cli_train = cli_train_phase(card, args.seed)
  log(f"phase 21 main path, cli/train.py --remat --eval_batches "
      f"--eval_period --cache_root at batch {CLI_BATCH} "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  family_rows = kernel_phase(gen, capture, FAMILY_SHAPES)
  family_bwd_rows = bwd_kernel_phase(gen, TRAIN_BATCH, FAMILY_SHAPES)
  log(f"phase 22 attention kernels at the notes-only and autoregressive "
      f"shapes: {len(family_rows)} forward and {len(family_bwd_rows)} "
      f"backward checks passed ({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  notes_summary, notes_case = notes_only_phase(
      args.seed, card, rows + family_rows, qmm_rows)
  log(f"phase 23 main path, notes-only diffusion_base int8 from the MIDI "
      f"file ({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  ar_summary, ar_qmm_rows, ar_case = ar_phase(
      args.seed, card, family_rows, qmm_rows, gen, capture)
  log(f"phase 24 main path, autoregressive ar_base int8 from the MIDI file "
      f"({time.perf_counter() - t0:.2f} s)")
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  family_train = {preset: family_train_phase(args.seed, card, preset)
                  for preset in ("diffusion_base", "ar_base")}
  log(f"phase 25 main path, training diffusion_base and ar_base with "
      f"cli/train.py ({time.perf_counter() - t0:.2f} s)")

  graph_cases = [f32_case, int8_case, bf16_case, notes_case, ar_case]
  log(f"phase 26 captured renders vs eager: {len(graph_cases)} cases equal "
      f"bit for bit, kernels #1 and #3 launched as often (checked in phases "
      f"5, 7, 9, 23 and 24, where their models are)")
  for c in graph_cases:
    log(f"  {c['case']}: steady segment eager "
        f"{c['eager_steady_segment_s']:.3f} s, captured "
        f"{c['captured_steady_segment_s']:.3f} s "
        f"({c['eager_steady_segment_s'] / c['captured_steady_segment_s']:.2f}"
        f"x); capture {c['capture_s']:.3f} s; peak memory "
        f"{c['eager_peak_gib']:.2f} / {c['captured_peak_gib']:.2f} GiB")

  # Each kernel's numbers: one call at each of its main-path shapes (the
  # attention kernel's f32 calls at b=2), summed.
  # The context model's int8 path, a segment (phase 7).
  qmm_ms_segment = sum(r["ms"] * r["launches_per_segment"] for r in qmm_rows)
  rows = rows + family_rows
  bwd_rows = bwd_rows + family_bwd_rows
  qmm_rows = qmm_rows + ar_qmm_rows
  f32 = [r for r in rows if r["dtype"] == "float32" and r["batch"] == 2]

  def total(key, rows_):
    values = [r[key] for r in rows_]
    return None if None in values else sum(values)

  kernels = {"kernels": [{
      "name": "flash_attention_fwd",
      "route": "cuda",
      "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/flash_fwd.cu",
      "replaces": "music_spectrogram_diffusion_tpu/ops/attention.py:441",
      "launches": (f32_launches + int8_launches[0] + train_launches[0]
                   + stream_launches[0] + cli_launches + bf16_launches[0]
                   + bf16_large_launches[0] + cli_train["launches"][0]
                   + notes_summary["launches"][0]
                   + ar_summary["launches"][0]
                   + sum(v["launches"][0] for v in family_train.values())),
      "launches_by_path": {"float32": f32_launches,
                           "int8": int8_launches[0],
                           "training": train_launches[0],
                           "int8_streamed": stream_launches[0],
                           "cli_float32": cli_launches,
                           "training_bf16_remat": bf16_launches[0],
                           "training_bf16_remat_batch_32":
                               bf16_large_launches[0],
                           "cli_training_remat": cli_train["launches"][0],
                           "notes_only_int8": notes_summary["launches"][0],
                           "autoregressive_int8": ar_summary["launches"][0],
                           **{f"training_{k}": v["launches"][0]
                              for k, v in family_train.items()}},
      "max_abs_err": max(r["max_abs_err"] for r in f32),
      "ms": total("ms", f32),
      "plain_ms": total("plain_ms", f32),
      "bound_ms": total("bound_ms", f32),
      "bound_by": "operations" if all(
          r["bound_by"] == "operations" for r in f32) else "bytes",
      "library_ms": total("library_ms", f32),
      "per_shape": rows,
  }, {
      "name": "int8_weight_only_gemm",
      "route": "cuda",
      "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/qmm.cu",
      "replaces": "music_spectrogram_diffusion_tpu/ops/quantize.py:114",
      "launches": (int8_launches[1] + stream_launches[1]
                   + notes_summary["launches"][1]
                   + ar_summary["launches"][1]),
      "launches_by_path": {"int8": int8_launches[1],
                           "int8_streamed": stream_launches[1],
                           "notes_only_int8": notes_summary["launches"][1],
                           "autoregressive_int8": ar_summary["launches"][1]},
      "max_abs_err": max(r["max_abs_err"] for r in qmm_rows),
      "ms": total("ms", qmm_rows),
      "plain_ms": total("plain_ms", qmm_rows),
      "bound_ms": total("bound_ms", qmm_rows),
      "bound_by": "operations" if all(
          r["bound_by"] == "operations" for r in qmm_rows) else "bytes",
      "library_ms": total("library_ms", qmm_rows),
      "ms_per_segment": qmm_ms_segment,
      "per_shape": qmm_rows,
  }, {
      "name": "flash_attention_bwd",
      "route": "cuda",
      "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/flash_bwd.cu",
      "replaces": "music_spectrogram_diffusion_tpu/ops/attention.py:708",
      "launches": (train_launches[1] + bf16_launches[1]
                   + bf16_large_launches[1] + cli_train["launches"][1]
                   + sum(v["launches"][1] for v in family_train.values())),
      "launches_by_path": {"training": train_launches[1],
                           "training_bf16_remat": bf16_launches[1],
                           "training_bf16_remat_batch_32":
                               bf16_large_launches[1],
                           "cli_training_remat": cli_train["launches"][1],
                           **{f"training_{k}": v["launches"][1]
                              for k, v in family_train.items()}},
      "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
      "ms": total("ms", bwd_rows),
      "plain_ms": total("plain_ms", bwd_rows),
      "bound_ms": total("bound_ms", bwd_rows),
      "bound_by": "operations" if all(
          r["bound_by"] == "operations" for r in bwd_rows) else "bytes",
      "library_ms": total("library_ms", bwd_rows),
      "per_shape": bwd_rows,
      "training": dict(train_summary, step_check=step_check,
                       resume=resume),
      # The bf16 configuration (phases 19-20), summed as above.
      "bf16": {"launches": bf16_launches[1] + bf16_large_launches[1],
               "max_abs_err": max(r["max_abs_err"] for r in bwd_bf16_rows),
               "ms": total("ms", bwd_bf16_rows),
               "plain_ms": total("plain_ms", bwd_bf16_rows),
               "bound_ms": total("bound_ms", bwd_bf16_rows),
               "bound_by": "operations" if all(
                   r["bound_by"] == "operations" for r in bwd_bf16_rows)
               else "bytes",
               "library_ms": total("library_ms", bwd_bf16_rows),
               "per_shape": bwd_bf16_rows,
               "training": bf16_summary},
      "cli_training_remat": cli_train,
      "family_training": family_train,
  }]}
  log("vocoder " + json.dumps(dict(vocoder_summary, quality=quality,
                                   soundstream=soundstream,
                                   stream_wall_s=stream_wall)))
  log("graphs " + json.dumps(graph_cases))
  log("families " + json.dumps(dict(notes_only=notes_summary,
                                    autoregressive=ar_summary,
                                    training=family_train)))
  print(json.dumps(kernels))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
