"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own line with its seconds:
  1. device   the card, as nvidia-smi names it with its power limit;
  2. build    nvcc builds the three kernels from ops/csrc/ (flash_fwd.cu
              and flash_bwd.cu each with its wgmma routes, bf16 and f32,
              qmm.cu, and the wgmma routes' four planted-fault builds:
              seven compilers started together; phases 27 and 28's host
              data start in the background) and reports ptxas's registers
              and spills of every instantiation, and its warnings; no
              kernel may spill;
  3. kernel   flash attention against its plain PyTorch version at the
              four attention shapes of the serving path, at b=2 and b=1, in
              float32 and bfloat16: the forward's route rule as the built
              library applies it against `attention.fwd_route`, each call's
              route (every call on the wgmma route: bf16, and f32 as 3xTF32
              on tf32 wgmma), error and tolerance, in float32 the softmax
              statistics against theirs, two launches bitwise equal, the
              wgmma routes' planted faults (built in phase 2) past the
              limit at every call: the second K/V tile of each key range
              left out, and at the f32 calls plain TF32 (the split's small
              terms zeroed), the split-KV count, kernel / plain / SDPA
              (yardstick only) times on the card (CUDA graphs), the
              kernel's eager time a call, and the least time the card
              could take; then the kernels' TF32 rounding against
              cvt.rna.tf32.f32, a NaN in q, v or dO giving NaN where the
              plain versions do, and the f32 forward calls that stay on
              the mma.sync route (a bias, head_dim 32);
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
              with an all-masked row): the route (wgmma: 3xTF32 on tf32
              wgmma) and dq key split, error and tolerance, finite, two
              launches bitwise equal, both planted faults past the limit,
              kernel / plain / SDPA-backward (yardstick only) times and the
              bound; then the f32 backward at head_dim 32 (mma.sync route)
              and with a bias (wgmma route);
 11. main     float32 context_base at full width trains 5 steps through
              cli/train.py --synthetic (tasks 2048/256/256, batch 8, dropout
              0.1): loss and grad_norm of each step finite, seconds per step,
              target frames/s, peak memory; both attention kernels' launch
              counts must match the config's; its final checkpoint is phase
              29's teacher;
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
              an unmasked 2048x2048, at b=2 and b=1, in float32 and bf16
              (the planted faults past the limit at each call); the
              float32 backward at both shapes at batch 8 (its faults too);
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
 27. main     the dataset pipeline: records in the seven published TFRecord
              schemas (data/dataset_records.py, 3 songs of 39.5 s in each
              train and validation shard, MAESTRO's and MusicNet's audio at
              44.1 kHz), written under out/chip_smoke_data/ at the published
              paths' suffixes by processes started in phase 2;
              cli/cache_task.py --dataset all; cli/train.py --preset
              context_base --dataset mega --cache_root at batch 8, 2 steps,
              float32 (finite losses, every cache read, kernels #1 and #2
              launched as attention_calls_per_step predicts); the first
              maestrov3 validation_subset song's full_song_dataset segments
              (3) rendered by phase 7's int8 synthesizer (realtime factor,
              kernels #1 and #3 launched as the config predicts);
              cli/eval_vocoder.py --dataset maestrov3 --split
              validation_subset with the trained vocoder (finite metrics);
              the host's examples/s of the mega mixture at context_base's
              lengths, from raw records and from the caches at 1 and 8
              threads, beside the examples/s this run's training steps eat
              (phases 11 and 20).
 28. main     evaluation: MT3 at its published geometry (random weights
              from --seed, float32) on a 10.24 s synthetic clip (5
              segments of 256 frames): kernel #1 at its encoder's 256x256
              shape with 6 heads and the frames key mask against its plain
              version; greedy and beam (4) decodes of 1024 tokens, captured
              against eager bit for bit, their seconds per segment batch
              eager and captured and the capture's; the teacher-forced
              logits, card against CPU; MT3Transcriber (greedy) on a 3 s
              clip whose second segment is part padding, card against CPU:
              the same tokens (or, where one differs, a CPU logit margin
              under the tolerance there) and the same NoteSequence; the
              beam transcriber on clips of 10.24, 3 and 36 s: device
              memory flat across them (one captured step serves every
              length). Kernel #2 at the transcriber's training shapes
              (batch 32, 4 heads: 256x256 and 512x256);
              cli/train_transcriber.py --synthetic_examples 128 --steps
              600 --batch 32 (its data generated on the host by a process
              started at the phase's start): finite losses, kernels #1 and
              #2 launched as predicted, s per step; the trained
              transcriber on 4 new 8 s songs: tens of notes on each, a
              mean onset F1 above 0 against their notes, the first song's
              notes on the card equal to the CPU's. cli/evaluate.py
              --synthetic --preset context_base --compute_dtype int8
              --songs 4 --songs_per_batch 2 through `evaluate.score`,
              aggregated without CIs (each CI resample costs a host sqrtm
              a space), with the trained vocoder, VGGish and TRILL on
              random weights written by the phase, and the transcriber just
              trained: finite mel metrics, mel / VGGish / TRILL FAD and
              onset F1, kernels #1 and #3 launched as predicted, the seconds
              per song of each stage; then --prediction_source gt_encoded
              unsharded and in 2 shards merged by cli/merge_eval.py: the
              merged per-song metrics equal the unsharded run's.
 29. main     distillation and vocoder training. cli/distill.py --teacher
              phase 11's checkpoint (context_base at full width, f32)
              --synthetic --rounds 2 --steps_per_round 3 --batch 8: DDPM
              1000 -> DDIM 500 -> DDIM 250, finite losses, the teacher's
              weights unchanged in each round (its digest, and round 0's
              against the checkpoint file), kernels #1 and #2 launched as
              the config predicts (per step the teacher's encoders and two
              decoder passes under no_grad, the student's forward and
              backward; no int8 GEMM), s a step and peak memory by round
              (flat across rounds; also above what earlier phases hold);
              one step profiled through
              utils/profiling.trace and timed with CUDA events (the
              teacher's target against the whole step); one step at batch
              1 with injected draws, card vs CPU (phase 12's tolerances).
              The round-1 student through load_checkpoint in int8 renders
              phase 7's first segment with DDIM 250: one forward of one row
              a step (no CFG pair), launches as predicted, captured equal
              to eager bit for bit, s a segment beside phase 7's.
              cli/train_vocoder.py at full width (SoundStream base 512,
              batch 8, 64 frames): reconstruction 3 steps, --adversarial
              --resume (the generator warm-started) 2, --resume again (the
              whole GAN state) 2, --arch magnitude_gl 3, --dataset
              maestrov3 on phase 27's records 2: finite losses, s a step,
              peak memory; one step of each trainer card vs CPU (metrics,
              gradients and updated weights; SoundStream's from seeded
              weights, the MagnitudeNet's from the trained export: from
              seeded weights only its loss is held, and its gradient's
              rounding-decided L1 signs are counted, card vs CPU and
              float32 vs float64); the magnitude_gl checkpoint through
              load_trained vocodes phase 7's mel to finite audio.
 30. main     the ('data', 'model') mesh and the native reader. (a) Kernels
              #1 and #2 at the local heads of the 1x2 and 1x4 meshes (6
              and 3 of 12) at the four attention shapes (phase 3's and
              phase 10's checks), and #3 on every column shard (N / 2,
              N / 4) and row shard (K / 2, K / 4, the float32 partial) of
              the int8 path, each against its plain version, timed and
              bounded. (b) Full-width context_base float32 training, 3
              steps at global batch 8 with the preset's dropout, at 2x1
              and at 1x2 over two gloo ranks sharing the card
              (torch.multiprocessing), from the same seed and batches as
              the one-rank run: each parameter's update, the loss,
              n_frames and grad_norm held to the one-rank run's; s a step
              and each rank's peak memory and launches. (c) cli/train.py
              --distributed --mesh 1x1 as one rank over NCCL (coordinator
              on localhost), 2 steps. (d) int8 context_base renders one
              segment eagerly with InferenceModel(mesh=1x2) over the two
              gloo ranks, held to the one-rank eager render at the int8
              network tolerance; s a segment and each rank's launches of
              #1 and #3. (e) The C++ TFRecord splitter and the plain Python
              reader on phase 27's records, with and without the CRC check:
              MB/s and records a second, the records equal. Two ranks on
              one card say nothing of NVLink or NCCL scaling.
Every float32 main path (phases 5, 11, 12, 21, 25, 28 and 30's training)
checks by `attention.route_launches` that each of its f32 calls of
kernels #1 and #2 took the wgmma route (`f32_routes`).
Then the vocoder phases' numbers as one JSON line, the families' phases'
as another, phase 26's as another, phase 27's as another, phase 28's as
another, phase 29's as another, phase 30's as another, one JSON line of
the kernels (kernel #1's `bf16` entry names its wgmma route and holds
phases 3 and 22's bf16 numbers; #1's and #2's `f32` entries name their
f32 route and its planted faults' least ratios), the nvidia-smi line
again, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with its
traceback and prints no result. Needs CUDA; it refuses to run without it.
"""

from __future__ import annotations

import argparse
import atexit
import collections
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
      entry = qualified(entry)
      entry = re.sub(r"^(\w+::\w+_kernel)E\w*$", r"\1", entry)  # no template
      entry = re.sub(r"(<\d+>)EEv\w*$", r"\1", entry)
      entry = re.sub(r"(?:<(\d+)>|I)Lb([01])EEEv\w*$", lambda t: "<" + (
          f"{t.group(1)}, " if t.group(1) else "") + (
              "bias" if t.group(2) == "1" else "no bias") + ">", entry)
    elif entry and "spill" in line:
      stack = line.split(":", 1)[-1].strip() if ":" in line else line.strip()
    elif entry and "registers" in line:
      lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {stack}")
      entry, stack = None, ""
  return lines


def qualified(name: str) -> str:
  """`ns::name` and the rest for a mangled `_ZN<length><ns><length><name>`
  (the wgmma routes' namespaces); any other name as it is."""
  m = re.match(r"_ZN(\d+)", name)
  if not m:
    return name
  end = m.end() + int(m.group(1))
  rest = name[end:]
  n = re.match(r"\d+", rest)
  if not n:
    return name
  stop = n.end() + int(n.group())
  return f"{name[m.end():end]}::{rest[n.end():stop]}{rest[stop:]}"


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


def attention_inputs(batch, q_len, kv_len, masked, transposed, dtype, gen,
                     heads=HEADS):
  dev = "cuda"
  q = torch.randn(batch, q_len, heads, HEAD_DIM, device=dev, generator=gen)
  kv_shape = ((batch, heads, kv_len, HEAD_DIM) if transposed else
              (batch, kv_len, heads, HEAD_DIM))
  k = torch.randn(kv_shape, device=dev, generator=gen)
  v = torch.randn(kv_shape, device=dev, generator=gen)
  mask = None
  if masked:
    mask = torch.rand(batch, kv_len, device=dev, generator=gen) > 0.25
    if batch > 1:
      mask[-1] = False  # one batch row whose keys are all masked
  # q scaled as the model's query init does (no 1/sqrt(d) on the scores).
  return (q * HEAD_DIM ** -0.5).to(dtype), k.to(dtype), v.to(dtype), mask


def bound_ms(batch, q_len, kv_len, masked, dtype, heads=HEADS):
  """max(operations / the route's peak, bytes / HBM rate) for one call, and
  the same at the bf16 peak."""
  flops = 4.0 * batch * heads * q_len * kv_len * HEAD_DIM
  elt = torch.finfo(dtype).bits // 8
  nbytes = (2 * batch * q_len + 2 * batch * kv_len) * heads * HEAD_DIM * elt
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


def kernel_phase(gen, stream, shapes=SHAPES, runs=RUNS, faults=None):
  """The forward kernel at `shapes` ((name, q_len, kv_len, masked,
  transposed[, heads]); HEADS where heads is not given), each at the
  (batch, dtype) of `runs`. Every call must take the wgmma route (bf16 or
  f32), as both the built library and `attention.fwd_route` route it; with
  `faults` (the forward's planted faults: "flash_fwd", a key tile left
  out, and "flash_fwd_plain", plain TF32) each must land past the limit at
  each call (plain TF32 at the f32 calls)."""
  rows = []
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  lib = attention._library("flash_fwd")  # pylint: disable=protected-access
  for name, q_len, kv_len, masked, transposed, *more in shapes:
    heads = more[0] if more else HEADS
    for batch, dtype in runs:
      q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked,
                                       transposed, dtype, gen, heads)

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
      aligned = all(x.data_ptr() % attention.WGMMA_ALIGN == 0 for x in (
          q, k, v, got, *(() if mask is None else (mask,))))
      route = attention.fwd_route(dtype, HEAD_DIM, aligned)
      built = ("wgmma" if lib.msd_flash_fwd_route(
          attention._DTYPE_CODES[dtype], HEAD_DIM, int(aligned), 0)  # pylint: disable=protected-access
               else "mma_sync")
      check(built == route, f"{name} {dtype}: the library routes to {built}, "
            f"fwd_route to {route}")
      check(route == "wgmma", f"{name} b={batch} {dtype} takes the {route} "
            "route")
      splits, _ = attention.fwd_key_split(
          batch, heads, q_len, kv_len, sms,
          *attention.fwd_wgmma_tile(q_len, dtype))
      fault_note, fault_ratio, plain_ratio = "", None, None
      if faults is not None:
        faulty = with_library("flash_fwd", faults["flash_fwd"], kernel)
        fault_ratio = (faulty.float() - want.float()).abs().max().item() / tol
        check(fault_ratio > 1.0, f"{name} b={batch}: the planted fault (the "
              f"second K/V tile of each key range left out) within the "
              f"limit, {fault_ratio:.3g} of it")
        fault_note = f"; planted fault {fault_ratio:.3g}x the limit"
        if dtype == torch.float32:
          faulty = with_library("flash_fwd", faults["flash_fwd_plain"],
                                kernel)
          plain_ratio = (faulty - want).abs().max().item() / tol
          check(plain_ratio > 1.0, f"{name} b={batch}: plain TF32 (the "
                f"planted fault) within the limit, {plain_ratio:.3g} of it")
          fault_note += f", plain TF32 {plain_ratio:.3g}x"
        del faulty
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
                                             dtype, heads)
      dt = str(dtype).replace("torch.", "")
      peak = "3xTF32" if dtype == torch.float32 else "bf16"
      log(f"  {name} b={batch} h={heads} d={HEAD_DIM} {dt}, {route} route: "
          f"max_abs_err {err:.3g} (tol {tol:.3g}), relative RMS "
          f"{rms:.3g}{stats_note}; bitwise reproducible{fault_note}; "
          f"{splits} split(s); on the card (CUDA graph): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; kernel eager "
          f"{eager_ms:.4f} ms a call; bound {bound:.4f} ms ({bound_by}, "
          f"{peak} peak), {bound_bf16:.4f} ms at the bf16 peak")
      rows.append(dict(shape=name, dtype=dt, batch=batch, heads=heads,
                       q_len=q_len, kv_len=kv_len, route=route, splits=splits,
                       max_abs_err=err, tolerance=tol, rel_rms=rms,
                       fault_of_tolerance=fault_ratio,
                       plain_tf32_of_tolerance=plain_ratio, ms=ms,
                       eager_ms=eager_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                       bound_bf16_ms=bound_bf16))
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


def mma_sync_f32_check(gen, which: str) -> str:
  """The f32 calls that stay on the mma.sync route, which the models never
  make: `which` "fwd", the forward with a bias and at head_dim 32; "bwd",
  the backward at head_dim 32 (and, on the wgmma route, with a bias). Each
  routed as the library and fwd_route / bwd_route say, held against its
  plain version at the f32 limits, two launches bitwise equal."""
  notes, dev, b, q_len, kv_len, h = [], "cuda", 2, 256, 256, 4
  cases = (((64, True), (32, False)) if which == "fwd"
           else ((32, False), (64, True)))
  for head_dim, with_bias in cases:
    q = torch.randn(b, q_len, h, head_dim, device=dev,
                    generator=gen) * head_dim ** -0.5
    k, v = (torch.randn(b, kv_len, h, head_dim, device=dev, generator=gen)
            for _ in range(2))
    mask = torch.rand(b, kv_len, device=dev, generator=gen) > 0.25
    bias = (torch.randn(b, h, q_len, kv_len, device=dev, generator=gen)
            if with_bias else None)
    attention.route_launches.clear()
    if which == "fwd":
      route = attention.fwd_route(torch.float32, head_dim, True, with_bias)
      got = attention.flash_attention(q, k, v, bias, mask)
      again = attention.flash_attention(q, k, v, bias, mask)
      torch.cuda.synchronize()
      errs = [(got - attention.attention_reference(q, k, v, bias, mask))
              .abs().max().item() / TOLERANCE[torch.float32]]
      same = torch.equal(got, again)
    else:
      route = attention.bwd_route(torch.float32, head_dim)
      out, stats = attention.flash_attention(q, k, v, bias, mask,
                                             return_stats=True)
      dout = torch.randn(out.shape, device=dev, generator=gen)
      args = (q, k, v, bias, mask, out, stats, dout)
      attention.route_launches.clear()
      got = attention.flash_attention_bwd(*args)
      again = attention.flash_attention_bwd(*args)
      torch.cuda.synchronize()
      errs = [(g - w).abs().max().item()
              / (BWD_TOLERANCE * max(1.0, w.abs().max().item()))
              for g, w in zip(got, attention.flash_attention_bwd_reference(
                  *args))]
      same = all(torch.equal(x, y) for x, y in zip(got, again))
    routed = attention.route_launches[which, "float32", route]
    check(routed == 2, f"{which} d={head_dim} bias={with_bias}: {routed} of 2 "
          f"calls on the {route} route ({dict(attention.route_launches)})")
    check(max(errs) <= 1.0, f"{which} d={head_dim} bias={with_bias}, {route} "
          f"route: error {max(errs):.3g} of the f32 limit")
    check(same, f"{which} d={head_dim} bias={with_bias}: two launches differ")
    notes.append(f"d={head_dim}{' with a bias' if with_bias else ''}, {route} "
                 f"route, {max(errs):.3g} of the f32 limit, bitwise "
                 f"reproducible")
  attention.route_launches.clear()
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
  two-row CFG forward) and outside it (one conditional row); at guidance
  weight 1 (a distilled student) every step is one conditional forward."""
  sampler = experiment.diffusion.sampler
  guidance = experiment.diffusion.guidance
  if guidance.eval_condition_weight == 1.0:
    return 0, sampler.num_steps  # guidance folded in: one forward a step
  if guidance.interval is None:
    return sampler.num_steps, 0
  lo, hi = (np.float32(x) for x in guidance.interval)
  times = (np.arange(sampler.num_steps, dtype=np.float32) + 1) / np.float32(
      sampler.num_steps)
  paired = int(((times >= lo) & (times <= hi)).sum())
  return paired, sampler.num_steps - paired


def qmm_shapes(experiment, l_in: int) -> list:
  """Every int8 GEMM of one segment of the int8 path, from the config:
  [(M, K, N, dtype, launches per segment, what)], one row per distinct
  (M, K, N, dtype)."""
  return merge_qmm_rows(qmm_calls(experiment, l_in))


def qmm_calls(experiment, l_in: int) -> list:
  """`qmm_shapes`' rows before they are merged, one a projection. Batch
  1; the CFG pair doubles the decoder's rows inside the guidance
  interval, and cross-attention runs on the conditional rows only, its
  K/V projected once per segment."""
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
  return [r for r in rows if r[4]]


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


def qmm_bound_ms(m, k, n, dtype, out_dtype=None):
  """max(2MKN at the bf16 tensor-core peak, bytes at the HBM rate): x in
  `dtype` and the output in `out_dtype` (default `dtype`), the weight
  int8, the scales f32."""
  elt = torch.finfo(dtype).bits // 8
  out_elt = torch.finfo(out_dtype or dtype).bits // 8
  nbytes = m * k * elt + k * n + 4 * n + m * n * out_elt
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
  """The int8 GEMM at `shapes` ((M, K, N, x dtype, launches a segment,
  what[, out dtype]); the output in x's dtype where none is given)."""
  rows = []
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  for m, k, n, dtype, per_segment, what, *more in shapes:
    out_dtype = more[0] if more else dtype
    copies = int(np.ceil(L2_BYTES / (k * n))) + 1
    q, s = quantize.quantize_kernel(
        torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5)
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    ss = [s] + [s.clone() for _ in range(copies - 1)]
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    got = quantize.quantized_matmul(x, q, s, out_dtype=out_dtype)
    again = quantize.quantized_matmul(x, q, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = quantize.qmm_reference(x, q, s, out_dtype)
    check(bool(torch.isfinite(got).all()), f"qmm {m}x{k}x{n} finite")
    err = (got.float() - want.float()).abs().max().item()
    tol = QMM_TOLERANCE[out_dtype] * want.float().abs().max().item()
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
        x, qs[i % copies], ss[i % copies], out_dtype=out_dtype), iters,
                  stream)
    eager = eager_ms(lambda i: quantize.quantized_matmul(
        x, qs[i % copies], ss[i % copies], out_dtype=out_dtype), iters)
    plain_ms = graph_ms(lambda i: quantize.qmm_reference(
        x, qs[i % copies], ss[i % copies], out_dtype), iters, stream)
    lib_ms = graph_ms(lambda i: xb @ wb[i % copies], iters, stream)
    bound, bound_by = qmm_bound_ms(m, k, n, dtype, out_dtype)
    dt = str(dtype).replace("torch.", "")
    if out_dtype != dtype:
      dt += " -> " + str(out_dtype).replace("torch.", "")
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
  attention.route_launches.clear()
  quantize.quantized_matmul.launches = 0


def launch_counts() -> tuple:
  return (attention.flash_attention.launches,
          quantize.quantized_matmul.launches)


def f32_routes(label: str) -> str:
  """The f32 calls of kernels #1 and #2 by route since the route counts
  were last cleared: none may have taken the mma.sync route, and #1 must
  have run on the wgmma route at least once."""
  counts = attention.route_launches
  sync = {k: v for k, v in counts.items()
          if k[1] == "float32" and k[2] == "mma_sync" and v}
  check(not sync, f"{label}: f32 calls on the mma.sync route {sync}")
  check(counts["fwd", "float32", "wgmma"] > 0,
        f"{label}: no f32 call of #1 on the wgmma route")
  return (f"f32 calls by route: #1 wgmma {counts['fwd', 'float32', 'wgmma']}, "
          f"#2 wgmma {counts['bwd', 'float32', 'wgmma']}, mma.sync none")


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
  attention.route_launches.clear()
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
  log(f"  {f32_routes('phase 5')} (replays add none: each captured call "
      f"was counted once)")
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
  attention.route_launches.clear()
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


def bwd_bound_ms(batch, q_len, kv_len, dtype=torch.float32, heads=HEADS):
  """max(10 b h q kv d FLOPs at the route's peak for `dtype` (3xTF32 for
  f32), bytes at the HBM rate): q, out, dO, dQ and k, v, dK, dV in
  `dtype`, the f32 statistics and the key mask; and the operations at the
  bf16 peak."""
  flops = 10.0 * batch * heads * q_len * kv_len * HEAD_DIM
  elt = torch.finfo(dtype).bits // 8
  nbytes = elt * (4 * batch * q_len + 4 * batch * kv_len) * heads * HEAD_DIM
  nbytes += 4 * 2 * batch * heads * q_len + batch * kv_len
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


def bwd_kernel_phase(gen, batch: int, shapes=SHAPES, faults=None):
  """The backward kernel at the attention shapes of training (`shapes`;
  the context model's four by default; an optional sixth entry gives the
  heads), every call on the wgmma route (f32, as the built library and
  `attention.bwd_route` route it); with `faults` (the backward's planted
  faults: "flash_bwd", a key tile of each dq key range left out, and
  "flash_bwd_plain", plain TF32) each must land past the limit at each
  shape."""
  rows = []
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  lib = attention._library("flash_bwd")  # pylint: disable=protected-access
  for name, q_len, kv_len, masked, _, *more in shapes:
    heads = more[0] if more else HEADS
    # Training attends over uncached K/V in [b, l, h, d].
    q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked, False,
                                     torch.float32, gen, heads)
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
    aligned = all(x.data_ptr() % attention.WGMMA_ALIGN == 0
                  for x in (q, k, v, out, dout))
    route = attention.bwd_route(q.dtype, HEAD_DIM, aligned)
    built = ("wgmma" if lib.msd_flash_bwd_route(0, HEAD_DIM, int(aligned))
             else "mma_sync")
    check(route == built == "wgmma", f"{name}: f32 training takes the "
          f"{built} route (bwd_route: {route})")
    splits = attention.dq_key_split(batch, heads, q_len, kv_len, sms,
                                    *attention.bwd_tile(q_len, q.dtype))
    fault_note, fault_ratio, plain_ratio = "", None, None
    if faults is not None:
      ratios = []
      for fault in ("flash_bwd", "flash_bwd_plain"):
        faulty = with_library("flash_bwd", faults[fault], kernel)
        ratios.append(max(
            (g - w).abs().max().item()
            / (BWD_TOLERANCE * max(1.0, w.abs().max().item()))
            for g, w in zip(faulty, want)))
        del faulty
      fault_ratio, plain_ratio = ratios
      check(fault_ratio > 1.0, f"{name}: the planted fault (a key tile of "
            f"each dq key range left out) within the limit, "
            f"{fault_ratio:.3g} of it")
      check(plain_ratio > 1.0, f"{name}: plain TF32 (the planted fault) "
            f"within the limit, {plain_ratio:.3g} of it")
      fault_note = (f"; planted faults {fault_ratio:.3g}x (a key tile) and "
                    f"{plain_ratio:.3g}x (plain TF32) the limit")
    del want, qkv
    iters = 3 if q_len > 256 else 20
    ms, plain_ms, lib_ms = (cuda_ms(kernel, iters), cuda_ms(plain, iters),
                            sdpa_backward_ms(q, k, v, mask, dout, iters))
    # The training forward at this batch: the forward kernel with the
    # statistics output.
    fwd_ms = cuda_ms(lambda: attention.flash_attention(
        q, k, v, kv_mask=mask, return_stats=True), iters)
    bound, bound_by, bound_bf16 = bwd_bound_ms(batch, q_len, kv_len,
                                               heads=heads)
    log(f"  {name} b={batch} h={heads} d={HEAD_DIM} float32, {route} route, "
        f"dq key split {splits[0]} x {splits[1]} keys: max_abs_err "
        f"{max(errs):.3g} (tol {BWD_TOLERANCE} x max(1, |grad| max); at "
        f"worst {worst:.3g} of it), "
        f"finite{' with an all-masked row' if masked else ''}, bitwise "
        f"reproducible{fault_note}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa backward {lib_ms:.4f} ms; bound "
        f"{bound:.4f} ms ({bound_by}, 3xTF32 peak), {bound_bf16:.4f} ms at "
        f"the bf16 peak; the forward kernel with statistics {fwd_ms:.4f} ms")
    rows.append(dict(shape=name, batch=batch, heads=heads, q_len=q_len,
                     kv_len=kv_len, route=route, dq_splits=splits[0],
                     max_abs_err=max(errs), worst_of_tolerance=worst,
                     fault_of_tolerance=fault_ratio,
                     plain_tf32_of_tolerance=plain_ratio, ms=ms,
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
  attention.route_launches.clear()
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
  log(f"  {f32_routes('phase 11')}")
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
  # The final checkpoint (1.6 GB) is phase 29's teacher; it goes there.
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
  groups = {"flash_bwd (kernel #2)": ("flash_bwd", "bwd_wgmma", "bwd_tf32"),
            "flash_fwd (kernel #1)": ("flash_fwd", "fwd_wgmma", "fwd_tf32"),
            "tf32 split (the f32 routes' prologue, #1 and #2)": (
                "tf32_split",),
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
    attention.route_launches.clear()
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
    if not plain and str(dev).startswith("cuda"):
      f32_routes("phase 12")
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
  attention.route_launches.clear()
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
  attention.route_launches.clear()
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


# The planted faults of the wgmma routes, each built from a copy of the
# sources in phase 2: by name, (library, [(header, the line, its faulty
# form), ...]). "flash_fwd" (phases 3 and 22): the forward leaves out the
# second K/V tile of each key range (keys 64-127 of the range: their p
# taken as 0), in the bf16 and the f32 route. "flash_bwd" (phases 10, 19
# and 22): the backward's dq pass leaves out the second key tile of each of
# its key ranges (their dS taken as 0: keys 64-127 in bf16, keys 32-63 in
# f32). "flash_fwd_plain" and "flash_bwd_plain" (phases 3, 10 and 22, f32):
# the split's small terms taken as 0 (attention_mma.cuh `split_tf32`), so
# the two correction products of every 3xTF32 product add nothing: plain
# TF32.
PLAIN_TF32 = ("attention_mma.cuh",
              "return {big, round_tf32(__int_as_float(min(rest, 0x7fffefff)))};",
              "return {big, 0u * rest};")
FAULTS = {
    "flash_fwd": ("flash_fwd", [
        ("flash_fwd_wgmma.cuh", "sc[i] = msd::exp2_ftz(sc[i] - m_run[r]);",
         "sc[i] = it == 1 ? 0.f : msd::exp2_ftz(sc[i] - m_run[r]);"),
        ("flash_fwd_tf32.cuh",
         "sc[i] = msd::exp2_ftz((sc[i] - m_run[r]) * msd::kLog2e);",
         "sc[i] = it == 1 ? 0.f : msd::exp2_ftz((sc[i] - m_run[r]) * "
         "msd::kLog2e);")]),
    "flash_bwd": ("flash_bwd", [
        (header, "sc[i] = pv * (dp[i] - dl[r]);",
         "sc[i] = it == 1 ? 0.f : pv * (dp[i] - dl[r]);")
        for header in ("flash_bwd_wgmma.cuh", "flash_bwd_tf32.cuh")]),
    "flash_fwd_plain": ("flash_fwd", [PLAIN_TF32]),
    "flash_bwd_plain": ("flash_bwd", [PLAIN_TF32]),
}


def start_fault_build(work: str, name: str):
  """nvcc on a copy of csrc/ whose library carries the FAULTS entry
  `name`, started now and joined by `finish_fault_build`: (library path,
  process)."""
  lib, edits = FAULTS[name]
  shutil.rmtree(work, ignore_errors=True)
  shutil.copytree(_build.CSRC, work, ignore=shutil.ignore_patterns("build"))
  for header, line, fault in edits:
    path = os.path.join(work, header)
    with open(path) as f:
      text = f.read()
    check(text.count(line) == 1, f"the fault's line is not in {header} once")
    with open(path, "w") as f:
      f.write(text.replace(line, fault))
  src = os.path.join(work, f"{lib}.cu")
  out = os.path.join(work, f"lib{name}_fault.so")
  return out, subprocess.Popen(
      [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_fault_build(build) -> ctypes.CDLL:
  out, proc = build
  stdout, stderr = proc.communicate()
  check(proc.returncode == 0, f"nvcc on the planted fault failed:\n{stdout}"
        f"{stderr}")
  return ctypes.CDLL(out)


def with_library(name: str, lib: ctypes.CDLL, fn):
  """fn() with the kernel library `name` replaced by `lib` (a planted
  fault), its launches not counted as the main path's."""
  counter = (attention.flash_attention if name == "flash_fwd"
             else attention.flash_attention_bwd)
  launches, routes = counter.launches, attention.route_launches.copy()
  kept = _build._libraries[name]  # pylint: disable=protected-access
  _build._libraries[name] = lib  # pylint: disable=protected-access
  try:
    return fn()
  finally:
    _build._libraries[name] = kept  # pylint: disable=protected-access
    counter.launches = launches
    attention.route_launches.clear()
    attention.route_launches.update(routes)


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
  tiles = {(q, str(dtype)[6:]): attention.bwd_tile(q, dtype)
           for q in (256, 2048) for dtype in attention._DTYPE_CODES}  # pylint: disable=protected-access
  check(all(t[1] == (attention.WGMMA_HEAD_DIM if dt == "bfloat16" else 32)
            for (_, dt), t in tiles.items()),
        f"the wgmma route's tiles {tiles}")
  return (f"{cases} (dtype, head_dim, alignment) cases route as bwd_route "
          f"says; dq item rows and tile by (q_len, dtype) {tiles}")


def fwd_route_rule_check() -> str:
  """The forward's route rule as the built library applies it
  (msd_flash_fwd_route) against its mirror `attention.fwd_route`, over
  every dtype, head_dim 1-128, alignment and bias; and the key-split
  plan's tile against the library's."""
  lib = attention._library("flash_fwd")  # pylint: disable=protected-access
  cases = 0
  for dtype, code in attention._DTYPE_CODES.items():  # pylint: disable=protected-access
    for head_dim in range(1, attention.MAX_HEAD_DIM + 1):
      for aligned in (False, True):
        for bias in (False, True):
          built = ("wgmma" if lib.msd_flash_fwd_route(
              code, head_dim, int(aligned), int(bias)) else "mma_sync")
          mirror = attention.fwd_route(dtype, head_dim, aligned, bias)
          check(built == mirror, f"route of {dtype} d={head_dim} aligned="
                f"{aligned} bias={bias}: the library's {built}, "
                f"fwd_route's {mirror}")
          cases += 1
  tiles = {(q, str(dtype)[6:]): attention.fwd_wgmma_tile(q, dtype)
           for q in (256, 2048) for dtype in attention._DTYPE_CODES}  # pylint: disable=protected-access
  check(all(t[1] == attention.WGMMA_HEAD_DIM for t in tiles.values()),
        f"the wgmma route's tiles {tiles}")
  return (f"{cases} (dtype, head_dim, alignment, bias) cases route as "
          f"fwd_route says; item rows and tile keys by (q_len, dtype) "
          f"{tiles}")


def bwd_bf16_phase(gen, batch: int, fault_lib) -> list:
  """Kernel #2's bf16 configuration at the four attention shapes of
  training, against its plain bf16 version; the planted fault against the
  same limit."""
  rows = []
  log(f"  route rule: {route_rule_check()}")
  kernels = [line for line in ptxas_usage("flash_bwd")
             if line.startswith("bwd_wgmma::")]
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
    # The planted fault, against the same limit.
    faulty = with_library("flash_bwd", fault_lib, kernel)[0]
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
  attention.route_launches.clear()
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
  attention.route_launches.clear()
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
  log(f"  {f32_routes('phase 21')}")
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
  attention.route_launches.clear()
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
  attention.route_launches.clear()
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
  attention.route_launches.clear()
  attention.flash_attention_bwd.launches = 0
  t0 = time.perf_counter()
  state, t = train_cli.main(argv)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  log(f"  {preset}: {f32_routes(f'phase 25, {preset}')}")
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


# ---------------------------------------------------------------------------
# Phase 27: the dataset pipeline on the card.
# ---------------------------------------------------------------------------

# Records in the seven published schemas, written under DATA_ROOT at the
# published paths' suffixes by DATA_WORKERS processes started with phase 2's
# build: DATA_SONGS songs of DATA_SECONDS each in every train and validation
# shard. 39.5 s is one full cached chunk a song (1976 of the 2000 frames), so
# that a raw example costs the tokenizing of a chunk, as a long recording's
# chunks each do; MAESTRO's and MusicNet's audio is at 44.1 kHz (resampled).
DATA_ROOT = os.path.join("out", "chip_smoke_data")
DATA_CACHE = os.path.join("out", "chip_smoke_data_cache")
DATA_SONGS, DATA_SECONDS, DATA_WORKERS = 3, 39.5, 3
# The full-song render's segments (the first validation_subset song's).
FULL_SONG_SEGMENTS = 3
# Each host rate's window: examples drawn after the first few, for at least
# this long.
RATE_SECONDS, RATE_WARMUP = 4.0, 4


def start_dataset_records():
  """The records' writer, started now and joined in phase 27: (process,
  start time)."""
  shutil.rmtree(DATA_ROOT, ignore_errors=True)
  proc = subprocess.Popen(
      [sys.executable, "-m",
       "music_spectrogram_diffusion_tpu_torch.data.dataset_records",
       "--data_root", DATA_ROOT, "--songs", str(DATA_SONGS), "--seconds",
       str(DATA_SECONDS), "--workers", str(DATA_WORKERS)],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
  atexit.register(proc.kill)
  return proc, time.perf_counter()


def finish_dataset_records(records) -> dict:
  """Waits for the writer; returns {dataset: {split: path}}."""
  from music_spectrogram_diffusion_tpu_torch.data import dataset_records
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  proc, started = records
  stdout, stderr = proc.communicate()
  check(proc.returncode == 0, f"writing the records failed:\n{stderr}")
  paths = {}
  for name, config in datasets.ALL_DATASET_CONFIGS.items():
    paths[name] = {split: dataset_records.shard_path(config, split,
                                                     DATA_ROOT)
                   for split in ("train", "validation")}
    for path in paths[name].values():
      check(os.path.exists(path), f"no shard {path}")
  size = sum(os.path.getsize(p) for v in paths.values() for p in v.values())
  log(f"  records of the 7 schemas under {DATA_ROOT}: {DATA_SONGS} songs of "
      f"{DATA_SECONDS} s in each train and validation shard, "
      f"{size / 2**20:.1f} MiB; {DATA_WORKERS} processes started in phase 2 "
      f"{stdout.strip().splitlines()[-1]} on the host, in the background "
      f"(joined {time.perf_counter() - started:.1f} s after their start)")
  return paths


def host_rate(make, threads: int) -> dict:
  """Examples/s that `make(threads)`'s stream yields on the host, after
  RATE_WARMUP examples, over at least RATE_SECONDS."""
  it = iter(make(threads))
  for _ in range(RATE_WARMUP):
    next(it)
  n, t0 = 0, time.perf_counter()
  while time.perf_counter() - t0 < RATE_SECONDS or n < 4:
    next(it)
    n += 1
  wall = time.perf_counter() - t0
  return dict(examples=n, seconds=wall, examples_per_s=n / wall)


def dataset_phase(card: str, seed: int, synth, qmm_rows, records,
                  demand: dict) -> dict:
  """cli/cache_task.py --dataset all; cli/train.py --dataset mega on the
  caches at full width; a validation song's full_song_dataset segments
  rendered in int8 by phase 7's synthesizer; cli/eval_vocoder.py --dataset;
  and the host's examples/s from raw records and from the caches beside the
  training steps' demand."""
  from music_spectrogram_diffusion_tpu_torch.cli import cache_task
  from music_spectrogram_diffusion_tpu_torch.cli import eval_vocoder
  from music_spectrogram_diffusion_tpu_torch.data import cache as cache_lib
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  from music_spectrogram_diffusion_tpu_torch.data import tasks
  summary = {}
  finish_dataset_records(records)

  shutil.rmtree(DATA_CACHE, ignore_errors=True)
  seconds, built = host_s(lambda: cache_task.main([
      "--dataset", "all", "--data_root", DATA_ROOT, "--cache_root",
      DATA_CACHE]))
  names = sorted(os.path.basename(b["cache_dir"]) for b in built)
  check(len(built) == 6 and all(b["num_examples"] == DATA_SONGS
                                for b in built),
        f"cache_task built {[(b['cache_dir'], b['num_examples']) for b in built]}")
  log(f"  cli/cache_task.py --dataset all: {len(built)} caches of "
      f"{DATA_SONGS} chunks each in {seconds:.2f} s on the host: "
      f"{', '.join(names)}")
  summary["cache_s"] = seconds

  # Training context_base on the mega mixture, from the caches.
  experiment = training_experiment()
  model_dir = os.path.join("out", "chip_smoke_train_mega")
  shutil.rmtree(model_dir, ignore_errors=True)
  argv = ["--preset", "context_base", "--dataset", "mega", "--data_root",
          DATA_ROOT, "--cache_root", DATA_CACHE, "--steps", "2", "--batch",
          str(TRAIN_BATCH), "--model_dir", model_dir, "--log_period", "1",
          "--seed", str(seed), "--device", "cuda"]
  reads, read_cache = [], cache_lib.read_cache

  def counted_read(cache_dir):
    reads.append(os.path.basename(cache_dir))
    return read_cache(cache_dir)

  tasks.TASK_REGISTRY.clear()
  tasks.MIXTURE_REGISTRY.clear()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  attention.route_launches.clear()
  attention.flash_attention_bwd.launches = 0
  quantize.quantized_matmul.launches = 0
  cache_lib.read_cache = counted_read
  t0 = time.perf_counter()
  try:
    state, t = train_cli.main(argv)
  finally:
    cache_lib.read_cache = read_cache
  wall = time.perf_counter() - t0
  train_launches = (attention.flash_attention.launches,
                    attention.flash_attention_bwd.launches)
  peak = torch.cuda.max_memory_allocated() / 2**30
  check(quantize.quantized_matmul.launches == 0,
        "the training path launched the int8 GEMM")
  check(state.step == 2, f"the CLI trained {state.step} steps")
  del t, state
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  check([m["step"] for m in lines] == [1, 2], f"logged {lines}")
  for m in lines:
    check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
          f"mega step {m['step']}: loss {m['loss']}")
  check(sorted(set(reads)) == names, f"caches read {reads}, built {names}")
  calls = attention_calls_per_step(experiment)
  check(train_launches == (2 * calls, 2 * calls),
        f"the mega run launched flash_fwd {train_launches[0]} and flash_bwd "
        f"{train_launches[1]} times, expected {2 * calls} each")
  shutil.rmtree(model_dir, ignore_errors=True)
  log(f"  cli/train.py --preset context_base --dataset mega --cache_root: "
      f"losses {[round(m['loss'], 4) for m in lines]}, grad norms "
      f"{[round(m['grad_norm'], 4) for m in lines]}, finite; all 6 caches "
      f"read, no raw record; launches flash_fwd {train_launches[0]}, "
      f"flash_bwd {train_launches[1]} = expected 2 steps x {calls}")
  log(f"  [{card}] {lines[-1]['timing/seconds_per_step']:.3f} s for step 2 "
      f"at batch {TRAIN_BATCH}, float32; peak memory {peak:.2f} GiB; "
      f"{wall:.2f} s in all (model, mixture, steps, checkpoint)")
  summary["training"] = dict(
      launches=train_launches, losses=[m["loss"] for m in lines],
      seconds_per_step=lines[-1]["timing/seconds_per_step"], peak_gib=peak,
      wall_s=wall)
  torch.cuda.empty_cache()

  # A validation song's full-song segments, rendered in int8.
  serving = serving_experiment()
  tl = serving.task_lengths
  lengths = {"inputs": tl.inputs, "targets": tl.targets,
             "targets_context": tl.targets_context}
  task = registry.make_dataset_task(
      datasets.MAESTROV3_CONFIG, "validation_subset",
      vocab_config=serving.vocab_config(), note_rep=serving.note_rep(),
      program_granularity=serving.program_granularity, with_context=True,
      data_root=DATA_ROOT, audio_codec=synth.model.audio_codec)
  t0 = time.perf_counter()
  segments, song_id = [], None
  for ex in task.model_dataset(lengths, training=False,
                               passthrough_keys=("id",)):
    if song_id is not None and ex["id"] != song_id:
      break
    song_id = ex["id"]
    segments.append(np.trim_zeros(ex["encoder_input_tokens"], "b"))
    if len(segments) == FULL_SONG_SEGMENTS:
      break
  host = time.perf_counter() - t0
  check(len(segments) == FULL_SONG_SEGMENTS,
        f"{len(segments)} segments of {song_id}")
  attention.flash_attention.launches = 0
  attention.route_launches.clear()
  quantize.quantized_matmul.launches = 0
  t0 = time.perf_counter()
  render = synth.render_song(segments)
  render_wall = time.perf_counter() - t0
  render_launches = (attention.flash_attention.launches,
                     quantize.quantized_matmul.launches)
  n = len(segments)
  expected = (n * attention_launches(serving),
              n * sum(r["launches_per_segment"] for r in qmm_rows))
  n_frames = n * tl.targets
  check(render.mel.shape == (n_frames, 128) and bool(
      np.isfinite(render.mel).all()), f"mel {render.mel.shape} finite")
  check(render.audio.shape == (n_frames * 320,) and bool(
      np.isfinite(render.audio).all()), f"audio {render.audio.shape}")
  check(render_launches == expected, f"the full-song render launched "
        f"{render_launches}, expected {expected}")
  tm = render.timings
  realtime = tm["audio_seconds"] / render_wall
  log(f"  full_song_dataset of maestrov3 validation_subset ({song_id}): "
      f"{n} segments of {[len(x) for x in segments]} tokens ({host:.2f} s "
      f"on the host), rendered by phase 7's int8 synthesizer through its "
      f"captured step graphs: mel {render.mel.shape}, audio "
      f"{render.audio.shape}, finite; launches flash_attention "
      f"{render_launches[0]}, quantized_matmul {render_launches[1]} = "
      f"expected")
  log(f"  [{card}] realtime factor {realtime:.3f} ({tm['audio_seconds']:.2f}"
      f" s of audio in {render_wall:.3f} s; steady segment "
      f"{tm['steady_segment_seconds']:.3f} s, capturing "
      f"{tm['capture_seconds']:.3f} s, vocoder "
      f"{tm['audio_decode_seconds']:.3f} s)")
  summary["full_song"] = dict(
      launches=render_launches, segments=n, realtime_factor=realtime,
      wall_s=render_wall, steady_segment_s=tm["steady_segment_seconds"],
      capture_s=tm["capture_seconds"], host_s=host)

  # The vocoders on the dataset's audio.
  seconds, report = host_s(lambda: eval_vocoder.main([
      "--checkpoint", vocoder.TRAINED_MAGNITUDE_GL, "--dataset",
      "maestrov3", "--split", "validation_subset", "--data_root", DATA_ROOT,
      "--clips", str(DATA_SONGS), "--device", "cuda", "--output",
      os.path.join("out", "chip_smoke_eval_vocoder_maestrov3.json")]))
  check(report["clips"] == DATA_SONGS, f"{report['clips']} clips")
  for method, metrics in report["methods"].items():
    check(all(np.isfinite(v) for v in metrics.values()),
          f"{method}: {metrics}")
  log(f"  cli/eval_vocoder.py --dataset maestrov3 --split validation_subset "
      f"({report['clips']} clips of {report['clip_seconds']} s, resampled "
      f"from 44.1 kHz): " + "; ".join(
          f"{m} spectral convergence {v['spectral_convergence']:.4f}, mel "
          f"round trip {v['mel_roundtrip_l2']:.4f}"
          for m, v in report["methods"].items()) + f" ({seconds:.2f} s)")
  summary["eval_vocoder"] = dict(report["methods"], seconds=seconds)

  # The host's rates at context_base's lengths, the mega mixture as the
  # training CLI draws it, from the raw records and from the caches.
  train_lengths = {"inputs": experiment.task_lengths.inputs,
                   "targets": experiment.task_lengths.targets,
                   "targets_context": experiment.task_lengths.targets_context}

  def mixture(cache_root):
    tasks.TASK_REGISTRY.clear()
    tasks.MIXTURE_REGISTRY.clear()
    registry.register_all_tasks(data_root=DATA_ROOT,
                                include_eval_splits=False,
                                cache_root=cache_root)
    mix = tasks.MIXTURE_REGISTRY["synthesis_with_context_mega"]
    return lambda threads: mix.dataset(train_lengths, training=True, seed=0,
                                       num_threads=threads)

  rates = {}
  for source, cache_root in (("raw", None), ("cached", DATA_CACHE)):
    make = mixture(cache_root)
    for threads in (1, 8):
      rates[f"{source}_{threads}"] = host_rate(make, threads)
  tasks.TASK_REGISTRY.clear()
  tasks.MIXTURE_REGISTRY.clear()
  log(f"  [{card}'s host, {os.cpu_count()} CPUs] examples/s of the mega "
      f"mixture at context_base's lengths (2048/256/256): " + "; ".join(
          f"{k.replace('_', ', ')} thread(s) {v['examples_per_s']:.1f} "
          f"({v['examples']} in {v['seconds']:.2f} s)"
          for k, v in rates.items()))
  log("  the training steps eat (this run's step times): " + "; ".join(
      f"{k} {v:.1f} examples/s" for k, v in demand.items()) + "; "
      + "; ".join(f"{k} covers {name} {rates[k]['examples_per_s'] / v:.2f}x"
                  for k in rates for name, v in demand.items()))
  summary["host_rates"] = rates
  summary["demand_examples_per_s"] = demand
  return summary



# Phase 28: evaluation. MT3 at its published geometry (MT3Config's
# defaults, random weights) on a 10.24 s clip: 5 segments of 256 frames.
# The evaluations are aggregated without CIs (bootstrap 0): each CI
# resample takes one host sqrtm per embedding space (0.6 s in TRILL's 512
# dims), 200 of them about 2 minutes an aggregate; the CIs are held
# against JAX's on the CPU (tests/test_torch_evaluation.py).
MT3_CLIP_SECONDS = 10.24
MT3_BEAM = 4
# Card vs CPU, the teacher-forced logits of one segment and its first
# MT3_CHECK_TOKENS greedy tokens, max |card - CPU| relative to max |CPU|:
# the card's attention kernels (3xTF32) and cuBLAS f32 (TF32 off) against
# the CPU's plain f32, summed in other orders over 8 + 8 layers; the CPU
# tests hold the port to JAX within the same 1e-4.
MT3_LOGIT_TOLERANCE = 1e-4
MT3_CHECK_TOKENS = 256
# MT3Transcriber card vs CPU: a 3 s clip (375 frames: 2 segments, the
# second 119 frames and 137 of padding), greedy, MT3_CHECK_TOKENS tokens a
# segment. The beam transcriber's device memory across clip lengths (5, 2
# and 18 segments: one decode batch, one padded, two), MT3_CHECK_TOKENS
# tokens; allocated and peak bytes of each call within MT3_MEMORY_SLACK of
# the first's.
MT3_TRANSCRIBE_SECONDS = 3.0
MT3_MEMORY_CLIPS = (10.24, 3.0, 36.0)
MT3_MEMORY_SLACK = 0.01
# Kernel #1's new shapes (name, q_len, kv_len, key mask, cached K/V,
# heads): MT3's encoder self-attention with the frames key mask; the
# transcriber's training (cli/train_transcriber.py's defaults: emb 256, 4
# heads of 64, 512 target tokens; an all-ones frames mask, so no key mask)
# runs its encoder's self-attention and the teacher-forced
# cross-attention through kernels #1 and #2.
MT3_SHAPES = (("mt3_encoder_self_256x256", 256, 256, True, False, 6),)
TRANSCRIBER_SHAPES = (
    ("transcriber_encoder_self_256x256", 256, 256, False, False, 4),
    ("transcriber_cross_512x256", 512, 256, False, False, 4))
TRANSCRIBER_DIR = os.path.join("out", "chip_smoke_transcriber")
TRANSCRIBER_DATA = os.path.join("out", "chip_smoke_transcriber_data.npz")
# The transcriber trains long enough to transcribe: at 20 steps (its
# warm-up's first tenth) it emitted no notes, so the card-vs-CPU check of
# its transcription compared one note a side; at 200-800 steps on 64 songs
# it emits 22-29 notes on an 8 s song of 24 with an onset F1 of 0-0.08,
# memorizing its songs (train accuracy 1.0; measured on one H100 80GB
# HBM3 at 700 W). 128 songs and 600 steps: about 30 s on the card.
TRANSCRIBER_SONGS, TRANSCRIBER_STEPS, TRANSCRIBER_BATCH = 128, 600, 32
# Its check (trained_transcription_check): songs of the kind it trained on
# (8 s, TRANSCRIBER_CHECK_SONGS of them): tens of notes, an onset F1 above
# 0 against their notes on average; the first song's notes card vs CPU.
TRANSCRIBER_CHECK_SONGS, TRANSCRIBER_CHECK_SECONDS = 4, 8.0
TRANSCRIBER_LAYERS = 4  # cli/train_transcriber.py --num_layers default
EVAL_DIR = os.path.join("out", "chip_smoke_eval")
EVAL_SONGS, EVAL_SONGS_PER_BATCH = 4, 2
F1_KEYS = tuple(f"{who} Onset + program precision/recall/F1 (flat) F1"
                for who in ("Model", "GT"))


def start_transcriber_data(seed: int):
  """The transcriber's segment set (--gen_only --data_cache), generated on
  the host by a process (one BLAS thread) started at phase 28's start and
  joined before the transcriber trains."""
  os.makedirs(os.path.dirname(TRANSCRIBER_DATA), exist_ok=True)
  if os.path.exists(TRANSCRIBER_DATA):
    os.remove(TRANSCRIBER_DATA)
  proc = subprocess.Popen(
      [sys.executable, "-m",
       "music_spectrogram_diffusion_tpu_torch.cli.train_transcriber",
       "--model_dir", TRANSCRIBER_DIR, "--synthetic_examples",
       str(TRANSCRIBER_SONGS), "--seed", str(seed), "--gen_only",
       "--data_cache", TRANSCRIBER_DATA],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
      env=dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1"))
  atexit.register(proc.kill)
  return proc, time.perf_counter()


def synced_s(fn):
  """(fn(), wall seconds with the card synchronized before and after)."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def mt3_phase(card: str, seed: int, gen, stream) -> dict:
  """MT3 at full geometry: kernel #1 at its encoder's shape against the
  plain version; greedy and beam decodes of 1024 tokens, captured against
  eager bit for bit; the teacher-forced logits, card against CPU."""
  from music_spectrogram_diffusion_tpu_torch.infer import mt3
  rows = kernel_phase(gen, stream, MT3_SHAPES)
  vocab_size = vocabularies.num_embeddings(vocabularies.vocabulary_from_codec(
      vocabularies.build_codec(vocabularies.VocabularyConfig(
          num_velocity_bins=1))))
  cfg = mt3.MT3Config(vocab_size=vocab_size)
  module = mt3.build_module(cfg, seed=seed, device="cuda")
  n_params = sum(p.numel() for p in module.parameters())
  spec = mt3.spectrogram(mt3_clip(seed, MT3_CLIP_SECONDS))
  n_seg = len(spec) // mt3.INPUT_FRAMES
  check(n_seg * mt3.INPUT_FRAMES == len(spec) == 1280,
        f"the clip has {len(spec)} frames")
  segs = torch.as_tensor(spec.reshape(n_seg, mt3.INPUT_FRAMES, -1),
                         device="cuda")
  mask = torch.ones(n_seg, mt3.INPUT_FRAMES, dtype=torch.bool,
                    device="cuda")
  decodes = {
      "greedy": lambda g: mt3.greedy_decode(
          module, segs, mask, mt3.MAX_OUTPUT_TOKENS, graphs=g),
      f"beam{MT3_BEAM}": lambda g: mt3.beam_decode(
          module, segs, mask, mt3.MAX_OUTPUT_TOKENS, beam_size=MT3_BEAM,
          graphs=g)}
  out, launches = {}, 0
  for kind, decode in decodes.items():
    eager, eager_s = synced_s(lambda: decode(False))
    captures = module.step_graphs.capture_seconds
    zero_counts()
    first, first_s = synced_s(lambda: decode(True))
    capture_s = module.step_graphs.capture_seconds - captures
    replay, replay_s = synced_s(lambda: decode(True))
    counts = launch_counts()
    launches += counts[0]
    check(counts == (2 * cfg.num_encoder_layers, 0),
          f"MT3 {kind}: launches {counts}, expected "
          f"({2 * cfg.num_encoder_layers}, 0)")
    check(torch.equal(first, eager) and torch.equal(replay, eager),
          f"MT3 {kind}: captured tokens differ from eager")
    lengths = [int(np.argmax(r == 1)) + 1 if (r == 1).any() else len(r)
               for r in eager.cpu().numpy()]
    log(f"  MT3 {kind} ({cfg.emb_dim} emb, {cfg.num_heads} heads, "
        f"{cfg.num_encoder_layers}+{cfg.num_decoder_layers} layers, "
        f"{n_params / 1e6:.1f}M params, random weights from --seed): "
        f"{n_seg} segments x {mt3.MAX_OUTPUT_TOKENS} tokens, captured equal "
        f"to eager bit for bit (the capturing call and a replay); tokens to "
        f"EOS {lengths}; [{card}] seconds per segment batch: eager "
        f"{eager_s:.3f}, captured {replay_s:.3f} ({eager_s / replay_s:.1f}x; "
        f"the capturing call {first_s:.3f}, capture {capture_s:.3f}); "
        f"flash_attention launches {counts[0]} ({2} decodes x "
        f"{cfg.num_encoder_layers} encoder layers)")
    out[kind] = dict(eager_s=eager_s, captured_s=replay_s,
                     capturing_call_s=first_s, capture_s=capture_s,
                     tokens_to_eos=lengths)
  # Card vs CPU: the teacher-forced logits of the first segment on its
  # greedy tokens.
  tokens = decodes["greedy"](True)[:1, :MT3_CHECK_TOKENS]
  inputs = F.pad(tokens, (1, 0))[:, :-1]
  with torch.inference_mode():
    card_logits = module(segs[:1], mask[:1], inputs, tokens).cpu()
    cpu = mt3.build_module(cfg, seed=seed, device="cpu")
    cpu_logits = cpu(segs[:1].cpu(), mask[:1].cpu(), inputs.cpu(),
                     tokens.cpu())
  err = (card_logits - cpu_logits).abs().max().item()
  scale = cpu_logits.abs().max().item()
  check(err <= MT3_LOGIT_TOLERANCE * scale,
        f"MT3 logits card vs CPU: {err} > {MT3_LOGIT_TOLERANCE} x {scale}")
  log(f"  MT3 teacher-forced logits (1 segment, {MT3_CHECK_TOKENS} greedy "
      f"tokens), card vs CPU: max |diff| {err:.3g} = {err / scale:.3g} of "
      f"max |logit| {scale:.3g} (tol {MT3_LOGIT_TOLERANCE})")
  transcribed = transcriber_card_vs_cpu(seed, module, cpu, cfg)
  memory = transcriber_memory(card, seed, module, cfg)
  launches += transcribed["launches"] + memory["launches"]
  del module, cpu
  torch.cuda.empty_cache()
  return dict(rows=rows, launches=launches, decode=out,
              logits_rel_err=err / scale, params=n_params,
              transcription=transcribed, memory=memory)


def mt3_clip(seed: int, seconds: float) -> np.ndarray:
  """A synthetic song's audio at MT3's rate, `seconds` long."""
  from music_spectrogram_diffusion_tpu_torch.data import synthetic
  from music_spectrogram_diffusion_tpu_torch.infer import mt3
  ns = synthetic.random_note_sequence(np.random.RandomState(seed),
                                      duration=seconds)
  return synthetic.render_note_sequence(ns, mt3.SAMPLE_RATE,
                                        duration=seconds)[
                                            :int(round(seconds
                                                       * mt3.SAMPLE_RATE))]


def mt3_transcriber(module, cfg, **kwargs):
  """An MT3Transcriber on `module`'s device with its weights."""
  from music_spectrogram_diffusion_tpu_torch.infer import mt3
  return mt3.MT3Transcriber(state_dict=module.state_dict(), config=cfg,
                            max_tokens=MT3_CHECK_TOKENS,
                            device=module.device, **kwargs)


def note_tuples(ns) -> list:
  return [(n.pitch, n.velocity, n.start_time, n.end_time, n.program,
           n.is_drum) for n in ns.notes]


def transcriber_card_vs_cpu(seed: int, module, cpu, cfg) -> dict:
  """MT3Transcriber (greedy) on one clip on the card and on the CPU with
  the same weights: the frames mask of a part-padded segment, the decode
  batch, the tokens and their notes at each segment's start time. The
  tokens must be equal, or, where a segment's first differ, the CPU's
  teacher-forced logits of the two tokens there must lie within the
  logit tolerance; equal tokens must give equal NoteSequences."""
  from music_spectrogram_diffusion_tpu_torch.infer import mt3
  audio = mt3_clip(seed + 1, MT3_TRANSCRIBE_SECONDS)
  seen, notes = {}, {}
  for name, m in (("card", module), ("cpu", cpu)):
    t = mt3_transcriber(m, cfg, decode_mode="greedy")

    def recorded(segs, mask, decode=t.decode, name=name):
      seen[name] = (segs, mask, decode(segs, mask))
      return seen[name][2]
    t.decode = recorded
    zero_counts()
    notes[name] = t(audio)
    if name == "card":
      launches = launch_counts()
      check(launches == (cfg.num_encoder_layers, 0),
            f"MT3Transcriber launched {launches}, expected one decode "
            f"batch's encoder ({cfg.num_encoder_layers}, 0)")
    del t
  segs, mask, cpu_tokens = seen["cpu"]
  card_tokens = seen["card"][2]
  frames = int(mask.sum())
  check(segs.shape[0] == 2 and 0 < frames - mt3.INPUT_FRAMES
        < mt3.INPUT_FRAMES, f"the clip's segments: {segs.shape}, {frames} "
        "frames")
  margins = token_margins(cpu, seen["cpu"], card_tokens, notes)
  equal = not margins
  lengths = [int(np.argmax(r == 1)) + 1 if (r == 1).any() else len(r)
             for r in card_tokens]
  log(f"  MT3Transcriber (greedy, {MT3_CHECK_TOKENS} tokens) on a "
      f"{MT3_TRANSCRIBE_SECONDS} s clip ({frames} frames: 2 segments, the "
      f"second {frames - mt3.INPUT_FRAMES} frames and "
      f"{2 * mt3.INPUT_FRAMES - frames} of padding, decoded as one batch "
      f"of {mt3.DECODE_BATCH}), card vs CPU: "
      + ("tokens equal, NoteSequences equal" if equal else
         f"tokens differ at (segment, step, CPU logit margin) {margins}, "
         f"each margin under the tolerance")
      + f"; tokens to EOS {lengths}; {len(notes['card'].notes)} notes on "
      f"the card, {len(notes['cpu'].notes)} on the CPU")
  return dict(launches=cfg.num_encoder_layers, tokens_equal=equal,
              notes=len(notes["card"].notes), margins=margins)


def token_margins(cpu, seen_cpu, card_tokens, notes) -> list:
  """Card against CPU tokens of one transcription: where a segment's
  first differ, the CPU module's teacher-forced logits of the two tokens
  there must lie within the logit tolerance; (segment, step, margin) of
  each. Equal tokens must give equal NoteSequences (`notes`: by device)."""
  segs, mask, cpu_tokens = seen_cpu
  margins = []
  for row in range(len(cpu_tokens)):
    diff = np.nonzero(card_tokens[row] != cpu_tokens[row])[0]
    if not len(diff):
      continue
    step = int(diff[0])
    targets = torch.as_tensor(cpu_tokens[row:row + 1])
    with torch.inference_mode():
      logits = cpu(torch.as_tensor(segs[row:row + 1]),
                   torch.as_tensor(mask[row:row + 1]),
                   F.pad(targets, (1, 0))[:, :-1],
                   torch.ones_like(targets))[0]
    pair = logits[step, [int(cpu_tokens[row, step]),
                         int(card_tokens[row, step])]]
    margin = abs(float(pair[0] - pair[1]))
    tol = MT3_LOGIT_TOLERANCE * float(logits.abs().max())
    check(margin < tol, f"MT3Transcriber segment {row}: card token "
          f"{card_tokens[row, step]} and CPU token {cpu_tokens[row, step]} "
          f"at step {step}, CPU logit margin {margin} >= {tol}")
    margins.append((row, step, margin))
  if not margins:
    check(note_tuples(notes["card"]) == note_tuples(notes["cpu"])
          and notes["card"].total_time == notes["cpu"].total_time,
          "MT3Transcriber: equal tokens, but the card's NoteSequence "
          "differs from the CPU's")
  return margins


def trained_transcription_check(card: str, seed: int) -> dict:
  """The transcriber phase 28 trained, on TRANSCRIBER_CHECK_SONGS new
  synthetic songs of the kind it trained on: it must emit tens of notes
  with an onset F1 above 0 on average against the songs' notes; the
  first song's transcription on the card must equal the CPU's (tokens,
  or the logit margin rule of `token_margins`, and notes)."""
  from music_spectrogram_diffusion_tpu_torch.data import synthetic
  from music_spectrogram_diffusion_tpu_torch.infer import mt3
  from music_spectrogram_diffusion_tpu_torch.infer import transcription
  t0 = time.perf_counter()
  songs = []
  for i in range(TRANSCRIBER_CHECK_SONGS):
    ns = synthetic.random_note_sequence(np.random.RandomState(seed + 500 + i),
                                        duration=TRANSCRIBER_CHECK_SECONDS)
    songs.append((ns, synthetic.render_note_sequence(
        ns, mt3.SAMPLE_RATE, duration=TRANSCRIBER_CHECK_SECONDS)))
  seen, notes, f1s, counts = {}, {}, [], []
  for device in ("cuda", "cpu"):
    t = mt3.load_trained_transcriber(TRANSCRIBER_DIR, device=device)

    def recorded(segs, mask, decode=t.decode, device=device):
      tokens = decode(segs, mask)
      seen.setdefault(device, (segs, mask, tokens))  # the first song's
      return tokens
    t.decode = recorded
    name = "card" if device == "cuda" else "cpu"
    notes[name] = t(songs[0][1])
    if device == "cuda":
      for i, (ns, audio) in enumerate(songs):
        est = notes["card"] if i == 0 else t(audio)
        counts.append(len(est.notes))
        f1s.append(transcription.note_onset_scores(ns, est)[
            "Onset + program precision/recall/F1 (flat) F1"])
    else:
      cpu_module = t.module
  margins = token_margins(cpu_module, seen["cpu"], seen["cuda"][2], notes)
  mean_f1 = float(np.mean(f1s))
  check(min(counts) >= 10, f"the trained transcriber emits {counts} notes "
        "on the check songs, not tens")
  check(mean_f1 > 0, f"the trained transcriber's onset F1 {f1s}: none "
        "above 0")
  seconds = time.perf_counter() - t0
  log(f"  [{card}] the trained transcriber on {TRANSCRIBER_CHECK_SONGS} new "
      f"{TRANSCRIBER_CHECK_SECONDS} s songs: notes "
      + ", ".join(map(str, counts)) + " (the songs "
      + ", ".join(str(len(ns.notes)) for ns, _ in songs)
      + f"), onset F1 " + ", ".join(f"{f:.3f}" for f in f1s)
      + f" (mean {mean_f1:.3f}); the first song card vs CPU: "
      + ("tokens equal, NoteSequences equal" if not margins else
         f"tokens differ at (segment, step, CPU logit margin) {margins}, "
         f"each margin under the tolerance")
      + f" ({len(notes['card'].notes)} notes on the card, "
      f"{len(notes['cpu'].notes)} on the CPU); {seconds:.1f} s")
  return dict(notes=counts, f1=f1s, tokens_equal=not margins,
              card_vs_cpu_notes=len(notes["card"].notes), seconds=seconds)


def transcriber_memory(card: str, seed: int, module, cfg) -> dict:
  """The beam transcriber on clips of different lengths: the first call
  captures the decode step, and every later one, whatever its length,
  ends with the memory allocated that the first left, and peaks within
  MT3_MEMORY_SLACK of the second's (its slot refilled, where the first
  filled it)."""
  from music_spectrogram_diffusion_tpu_torch.infer import mt3
  t = mt3_transcriber(module, cfg, decode_mode="beam", beam_size=MT3_BEAM)
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  calls, batches = [], 0
  zero_counts()
  for i, seconds in enumerate(MT3_MEMORY_CLIPS):
    audio = mt3_clip(seed + 2 + i, seconds)
    segments = -(-len(mt3.spectrogram(audio)) // mt3.INPUT_FRAMES)
    batches += -(-segments // mt3.DECODE_BATCH)
    torch.cuda.reset_peak_memory_stats()
    ns, wall = synced_s(lambda: t(audio))
    calls.append(dict(
        seconds=seconds, segments=segments, wall_s=wall,
        notes=len(ns.notes),
        allocated_gib=(torch.cuda.memory_allocated() - base) / 2**30,
        peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30))
  launches = launch_counts()
  expected = (batches * cfg.num_encoder_layers, 0)
  check(launches == expected, f"the beam transcriber launched {launches}, "
        f"expected {expected}")
  check(len(t.module._slots) == 1 and len(t.module.step_graphs.graphs) == 1,
        f"the beam transcriber keeps {len(t.module._slots)} slots and "
        f"{len(t.module.step_graphs.graphs)} graphs, expected 1 each")
  first, second = calls[0], calls[1]
  for c in calls[1:]:
    check(abs(c["allocated_gib"] - first["allocated_gib"])
          <= MT3_MEMORY_SLACK * first["allocated_gib"]
          and c["peak_gib"] <= (1 + MT3_MEMORY_SLACK) * second["peak_gib"],
          f"the beam transcriber's memory grows with the clip: {calls}")
  log(f"  MT3Transcriber (beam {MT3_BEAM}, {MT3_CHECK_TOKENS} tokens, "
      f"decode batches of {mt3.DECODE_BATCH} segments) on clips of "
      + ", ".join(f"{c['seconds']} s ({c['segments']} segments)"
                  for c in calls)
      + f": device memory above the phase's, GiB allocated after each call "
      + ", ".join(f"{c['allocated_gib']:.3f}" for c in calls)
      + ", peak " + ", ".join(f"{c['peak_gib']:.3f}" for c in calls)
      + f" (flat within {MT3_MEMORY_SLACK:.0%}; one slot, one graph); "
      f"[{card}] seconds " + ", ".join(f"{c['wall_s']:.3f}" for c in calls)
      + f"; notes " + ", ".join(str(c["notes"]) for c in calls)
      + f"; flash_attention launches {launches[0]} ({batches} decode "
      f"batches x {cfg.num_encoder_layers} encoder layers)")
  del t
  return dict(launches=launches[0], calls=calls)


def transcriber_phase(card: str, seed: int, data) -> dict:
  """cli/train_transcriber.py at its default geometry on the card, from
  the segment set the process started at phase 28's start generated."""
  from music_spectrogram_diffusion_tpu_torch.cli import train_transcriber
  proc, started = data
  stdout, stderr = proc.communicate()
  check(proc.returncode == 0, f"the transcriber's data failed:\n{stderr}")
  log(f"  segment set: {stdout.strip().splitlines()[0]} on the host in the "
      f"background (joined {time.perf_counter() - started:.1f} s after its "
      f"start)")
  shutil.rmtree(TRANSCRIBER_DIR, ignore_errors=True)
  zero_counts()
  attention.flash_attention_bwd.launches = 0
  torch.cuda.reset_peak_memory_stats()
  out, wall = synced_s(lambda: train_transcriber.main([
      "--model_dir", TRANSCRIBER_DIR, "--synthetic_examples",
      str(TRANSCRIBER_SONGS), "--steps", str(TRANSCRIBER_STEPS), "--batch",
      str(TRANSCRIBER_BATCH), "--seed", str(seed), "--data_cache",
      TRANSCRIBER_DATA, "--log_period", str(TRANSCRIBER_STEPS),
      "--checkpoint_period", str(TRANSCRIBER_STEPS), "--device", "cuda"]))
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  log(f"  {f32_routes('phase 28, the transcriber')}")
  # Each step: the encoder's self-attention and the decoder's
  # cross-attention in every layer, forward and backward; the one eval
  # (the last step: --log_period TRANSCRIBER_STEPS) forward only.
  calls = 2 * TRANSCRIBER_LAYERS
  expected = ((TRANSCRIBER_STEPS + 1) * calls, TRANSCRIBER_STEPS * calls)
  check(launches == expected, f"transcriber training launched {launches}, "
        f"expected {expected}")
  check(quantize.quantized_matmul.launches == 0, "training launched int8")
  for key in ("loss", "eval_loss"):
    check(np.isfinite(out[key]), f"transcriber {key} {out[key]}")
  peak = torch.cuda.max_memory_allocated() / 2**30
  log(f"  [{card}] {TRANSCRIBER_STEPS} steps at batch {TRANSCRIBER_BATCH}: "
      f"loss {out['loss']:.4f}, acc {out['acc']:.3f}, eval_loss "
      f"{out['eval_loss']:.4f}; {out['seconds_per_step']:.4f} s per step "
      f"after the first; {wall:.2f} s in all (model, data to the card, "
      f"steps, eval, checkpoint); peak memory {peak:.2f} GiB; launches "
      f"flash_fwd {launches[0]}, flash_bwd {launches[1]} = expected "
      f"({TRANSCRIBER_STEPS} steps + 1 eval) x {calls} and "
      f"{TRANSCRIBER_STEPS} x {calls}")
  return dict(launches=launches, peak_gib=peak, wall_s=wall,
              check=trained_transcription_check(card, seed),
              **{k: v for k, v in out.items()})


def evaluation_phase(card: str, seed: int, qmm_rows) -> dict:
  """cli/evaluate.py on the card: int8 context_base renders and is scored
  by every metric (`evaluate.score`, aggregated without CIs); then
  gt_encoded in 2 shards (`evaluate.main`) merged by cli/merge_eval.py
  against the unsharded run."""
  from music_spectrogram_diffusion_tpu_torch.cli import evaluate
  from music_spectrogram_diffusion_tpu_torch.cli import merge_eval
  from music_spectrogram_diffusion_tpu_torch.infer import (evaluation, trill,
                                                           vggish)
  shutil.rmtree(EVAL_DIR, ignore_errors=True)
  os.makedirs(EVAL_DIR)
  weights = {}
  for name, lib in (("vggish", vggish), ("trill", trill)):
    weights[name] = os.path.join(EVAL_DIR, f"{name}_random.npz")
    np.savez(weights[name], **lib.random_weights(seed))
  scorers = ["--vocoder_checkpoint", vocoder.TRAINED_MAGNITUDE_GL,
             "--vggish_weights", weights["vggish"], "--trill_weights",
             weights["trill"], "--transcriber_checkpoint", TRANSCRIBER_DIR,
             "--seed", str(seed), "--device", "cuda", "--synthetic",
             "--songs", str(EVAL_SONGS)]
  experiment = serving_experiment()
  zero_counts()
  out, wall = synced_s(lambda: evaluate.score(evaluate.parse_args(
      scorers + ["--preset", "context_base", "--compute_dtype", "int8",
                 "--songs_per_batch", str(EVAL_SONGS_PER_BATCH), "--steps",
                 "100", "--sampler", "sde-dpm++", "--guidance_interval",
                 "0.1,0.8", "--output_dir", os.path.join(EVAL_DIR,
                                                         "int8")])))
  launches = launch_counts()
  results = out["results"]
  agg = evaluation.aggregate(results, bootstrap=0)
  segments = [-(-len(r.mel_pred) // experiment.task_lengths.targets)
               for r in results]
  batches = sum(max(segments[i:i + EVAL_SONGS_PER_BATCH])
                for i in range(0, len(segments), EVAL_SONGS_PER_BATCH))
  # Kernel #1: the render's segment batches, and the transcriber's encoder
  # once per transcription (each song's audio and its ground truth).
  expected = (batches * attention_launches(experiment)
              + 2 * len(results) * TRANSCRIBER_LAYERS,
              batches * sum(r["launches_per_segment"] for r in qmm_rows))
  check(launches == expected, f"evaluation launched {launches}, expected "
        f"{expected}")
  need = ["mel_l1", "mel_l2", "mel_frechet", *F1_KEYS] + [
      f"frechet_audio_distance/{space}" for space in ("mel", "vggish",
                                                     "trill")]
  for key in need:
    check(key in agg and np.isfinite(agg[key]), f"aggregate {key}: "
          f"{agg.get(key)}")
  check(agg["num_songs"] == EVAL_SONGS, f"{agg['num_songs']} songs")
  stage = out["stage_seconds_per_song"]
  log(f"  int8 context_base, {EVAL_SONGS} songs ({sum(segments)} segments, "
      f"{batches} segment batches of {EVAL_SONGS_PER_BATCH} songs): " + ", "
      .join(f"{k} {agg[k]:.4g}" for k in need) + f"; launches {launches} = "
      f"expected ({batches} x {attention_launches(experiment)} + "
      f"{2 * len(results)} transcriptions x {TRANSCRIBER_LAYERS}, {batches} "
      f"x {expected[1] // batches})")
  log(f"  [{card}] seconds per song by stage: " + ", ".join(
      f"{k} {v:.3f}" for k, v in stage.items()) + f"; {wall:.2f} s in all "
      f"(the model's build and quantization, the songs' data, the scorers' "
      f"loading included)")
  # Shards: gt_encoded (the ground-truth mel, vocoded and scored) in 2
  # shards and unsharded; context_tiny is built only for its codec.
  shard_args = scorers + ["--preset", "context_tiny", "--prediction_source",
                          "gt_encoded"]
  zero_counts()
  whole = evaluate.score(evaluate.parse_args(shard_args))
  dirs = [os.path.join(EVAL_DIR, f"shard{i}") for i in range(2)]
  for i, d in enumerate(dirs):
    evaluate.main(shard_args + ["--num_shards", "2", "--shard", str(i),
                                "--output_dir", d])
  shard_launches = launch_counts()
  merged = merge_eval.main(["--shards", *dirs, "--bootstrap", "0",
                            "--output", os.path.join(EVAL_DIR,
                                                     "merged.json")])
  want = json.loads(json.dumps({r.song_id: r.metrics
                                for r in whole["results"]}))
  check(merged["per_song"] == want, "merged shards differ from the "
        "unsharded gt_encoded run")
  check(merged["aggregate"]["num_songs"] == EVAL_SONGS, "merged songs")
  expected_shards = (2 * 2 * EVAL_SONGS * TRANSCRIBER_LAYERS, 0)
  check(shard_launches == expected_shards, f"gt_encoded runs launched "
        f"{shard_launches}, expected {expected_shards}")
  m = merged["aggregate"]
  log(f"  gt_encoded, 2 shards merged by cli/merge_eval.py: per-song metrics "
      f"equal to the unsharded run's ({len(want)} songs); merged "
      f"frechet_audio_distance mel {m['frechet_audio_distance/mel']:.4g}, "
      f"vggish {m['frechet_audio_distance/vggish']:.4g}, trill "
      f"{m['frechet_audio_distance/trill']:.4g}, flat onset F1 model "
      f"{m[F1_KEYS[0]]:.4g}, GT {m[F1_KEYS[1]]:.4g}; launches "
      f"{shard_launches}")
  return dict(launches=launches, shard_launches=shard_launches,
              aggregate={k: agg[k] for k in need}, wall_s=wall,
              stage_seconds_per_song=stage, segment_batches=batches)


# Phase 29: distillation and vocoder training. Two rounds of 3 steps at
# batch 8 from phase 11's checkpoint (context_base, DDPM 1000 -> DDIM 500
# -> DDIM 250); the round-1 student served in int8; the vocoder trainers at
# full width (SoundStream base 512, batch 8, 64 frames).
DISTILL_DIR = os.path.join("out", "chip_smoke_distill")
DISTILL_ROUNDS, DISTILL_STEPS = 2, 3
# Peak device memory of round 1 within this share of round 0's: the old
# teacher goes before the next student is made.
DISTILL_MEMORY_TOLERANCE = 0.05
# One distillation step card vs CPU, at phase 12's tolerances (the loss
# relative, each gradient's relative RMS), with the CPU's timing embedding
# on both sides; the student's time is the grid's middle (t = 1/2).
DISTILL_CHECK_T = 0.5
VOCODER_TRAIN_DIR = os.path.join("out", "chip_smoke_vocoder_train")
VOCODER_TRAIN_BATCH, VOCODER_TRAIN_FRAMES = 8, 64
# One step of each vocoder trainer card (TF32 off) vs CPU, batch 2, from
# the same seeded weights: the metrics relative; each gradient's relative
# RMS, of the loss the step takes (the discriminator's at the starting
# generator's audio), at VOCODER_GRAD_TOLERANCE: the log-magnitude loss
# takes 1 / |STFT| at bins near its 1e-5 clamp, which turns the conv
# stacks' float32 rounding into 1e-4-scale gradient differences (measured
# 1.39e-4 for SoundStream's on an H100 at 700 W), and a discriminator
# pre-activation within rounding of a leaky ReLU's kink takes slope 1 on
# one side and 0.2 on the other (tests/test_torch_vocoder_train.py); and
# the updated weights. AdamW's first step moves a weight by lr x g / (|g| + 1e-8): a
# gradient within rounding of zero, or near 1e-8, turns its rounding into
# up to 2 x lr (measured 0.04-0.14% of the weights past 1e-3 lr there):
# at most VOCODER_STEP_FLIPS of a trainer's weights may differ by more
# than 1e-3 x lr, none by more than 2 x lr.
VOCODER_STEP_METRIC_TOLERANCE = 1e-4
VOCODER_GRAD_TOLERANCE = 1e-3
VOCODER_STEP_FLIPS = 1e-2


def distill_launches(experiment) -> tuple:
  """Kernels #1 and #2 launched by one distillation step: the teacher's
  encoders once and its decoder twice (two half-steps; the CFG pair is one
  forward, its cross-attention on the conditional rows only), under
  no_grad; the student's forward and backward, attention_calls_per_step
  each."""
  enc = encoder_attention_launches(experiment)
  dec = attention_calls_per_step(experiment) - enc
  student = attention_calls_per_step(experiment)
  return enc + 2 * dec + student, student


def metrics_lines(model_dir: str) -> list:
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    return [json.loads(l) for l in f]


def distill_phase(card: str, seed: int) -> dict:
  """(a) cli/distill.py, two rounds from phase 11's checkpoint; the
  teacher's digest against the checkpoint's file; launches, s a step,
  peak memory by round; one profiled step, the teacher's share."""
  from music_spectrogram_diffusion_tpu_torch.cli import distill as distill_cli
  from music_spectrogram_diffusion_tpu_torch.train import distill
  teacher_dir = os.path.join("out", "chip_smoke_train",
                             f"step_{TRAIN_STEPS}")
  check(os.path.exists(os.path.join(teacher_dir, "state.pt")),
        f"no teacher checkpoint at {teacher_dir} (phase 11's)")
  file_digest = distill.param_digest(torch.load(
      os.path.join(teacher_dir, "state.pt"), map_location="cpu",
      weights_only=True)["params"].values())
  shutil.rmtree(DISTILL_DIR, ignore_errors=True)
  experiment = training_experiment()
  argv = ["--teacher", teacher_dir, "--model_dir", DISTILL_DIR, "--rounds",
          str(DISTILL_ROUNDS), "--steps_per_round", str(DISTILL_STEPS),
          "--batch", str(TRAIN_BATCH), "--synthetic", "--synthetic_examples",
          str(TRAIN_SONGS), "--log_period", "1", "--seed", str(seed),
          "--device", "cuda"]
  attention.flash_attention.launches = 0
  attention.route_launches.clear()
  attention.flash_attention_bwd.launches = 0
  quantize.quantized_matmul.launches = 0
  resident = torch.cuda.memory_allocated() / 2**30
  t0 = time.perf_counter()
  rounds = distill_cli.main(argv)
  wall = time.perf_counter() - t0
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  check(quantize.quantized_matmul.launches == 0,
        "distillation launched the int8 GEMM")
  per_step = distill_launches(experiment)
  steps = DISTILL_ROUNDS * DISTILL_STEPS
  expected = (steps * per_step[0], steps * per_step[1])
  check(launches == expected,
        f"distillation launched flash_fwd {launches[0]} and flash_bwd "
        f"{launches[1]} times, expected {expected}")
  check(rounds[0]["teacher_digest"] == file_digest,
        "round 0's teacher differs from its checkpoint file")
  check([(r["teacher_steps"], r["student_steps"]) for r in rounds]
        == [(1000, 500), (500, 250)], f"rounds {rounds}")
  summary = dict(rounds=[], launches=launches, wall_s=wall,
                 resident_gib=resident)
  for r in rounds:
    lines = metrics_lines(r["model_dir"])
    check([m["step"] for m in lines] == list(range(1, DISTILL_STEPS + 1)),
          f"round {r['round']} logged {[m['step'] for m in lines]}")
    for m in lines:
      check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
            f"round {r['round']} step {m['step']}: loss {m['loss']}")
    s_step = float(np.mean([m["timing/seconds_per_step"]
                            for m in lines[1:]]))
    summary["rounds"].append(dict(
        round=r["round"], steps=f"{r['teacher_steps']} -> "
        f"{r['student_steps']}", losses=[m["loss"] for m in lines],
        seconds_per_step=s_step, peak_gib=r["peak_gib"],
        run_peak_gib=r["peak_gib"] - resident, seconds=r["seconds"]))
    log(f"  [{card}] round {r['round']} ({r['teacher_steps']} -> "
        f"{r['student_steps']} steps): losses "
        + ", ".join(f"{m['loss']:.6g}" for m in lines)
        + f"; {s_step:.3f} s a step after the first (first "
        f"{lines[0]['timing/seconds_per_step']:.3f} s), peak memory "
        f"{r['peak_gib'] - resident:.2f} GiB above the {resident:.2f} GiB "
        f"that earlier phases hold ({r['peak_gib']:.2f} in all), "
        f"{r['seconds']:.2f} s with the student's "
        f"build, data and checkpoint; the teacher's weights unchanged "
        f"(digest {r['teacher_digest']})")
  peaks = [r["peak_gib"] for r in rounds]
  check(abs(peaks[1] - peaks[0]) <= DISTILL_MEMORY_TOLERANCE * peaks[0],
        f"peak memory by round {peaks}: not flat")
  log(f"  launches: flash_fwd {launches[0]}, flash_bwd {launches[1]} = "
      f"expected ({steps} steps x ({per_step[0] - per_step[1]} teacher + "
      f"{per_step[1]} student forward), {steps} x {per_step[1]} backward)")
  return summary


def distill_models(experiment, student_steps: int, device):
  """Phase 11's checkpoint as a frozen f32 teacher on `device`, and a
  DistillModel of a student at `student_steps` (guidance 5 folded in)."""
  from music_spectrogram_diffusion_tpu_torch.train import distill
  teacher = inference.load_checkpoint(
      os.path.join("out", "chip_smoke_train", f"step_{TRAIN_STEPS}"),
      device=device, compute_dtype="float32")
  student_exp = distill.student_experiment(teacher.experiment,
                                           student_steps)
  return distill.DistillModel(distill.new_student(student_exp, device),
                              teacher.model, student_steps), student_exp


def distill_step_phase(card: str, seed: int) -> dict:
  """One distillation step (500 student steps, the CFG pair path) on the
  card: profiled through utils/profiling.trace (the teacher's and the
  student's device time), timed with CUDA events; then at batch 1 with
  injected draws, card vs CPU."""
  from music_spectrogram_diffusion_tpu_torch.train import distill
  from music_spectrogram_diffusion_tpu_torch.utils import profiling
  experiment = training_experiment()
  dm, student_exp = distill_models(experiment, 500, "cuda")
  t = trainer.Trainer(dm, student_exp.train)
  state = t.create_state()
  batch = training_batches(experiment, TRAIN_BATCH, 1, seed)[0]
  state, _ = t.train_step(state, batch, seed)  # the first step's set-up
  log_dir = os.path.join("out", "chip_smoke_distill_trace")
  shutil.rmtree(log_dir, ignore_errors=True)
  torch.cuda.synchronize()
  with profiling.trace(log_dir) as prof:
    t0 = time.perf_counter()
    state, metrics = t.train_step(state, batch, seed)
    check(np.isfinite(profiling.device_sync(metrics["loss"])),
          "profiled distillation step's loss")
    wall = time.perf_counter() - t0
  trace_files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
  check(len(trace_files) == 1, f"trace files {trace_files}")
  events = prof.key_averages()
  # The annotated regions appear on the device's timeline too: the kernels
  # alone make the busy time.
  regions = {e.key: e.device_time_total / 1e3 for e in events
             if e.key.startswith("distill/")}
  busy = sum(e.self_device_time_total for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.key not in regions) / 1e3
  check(busy > 0, "the profiler saw no device time")
  # The same split with CUDA events: the teacher's target alone, and the
  # whole step.
  b = trainer.batch_to_device(batch, "cuda")
  targets = dm.audio_codec.scale_features(
      b["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  gen = torch.Generator("cuda").manual_seed(seed)
  time_, eps = distill.generator_draws(gen)(targets, 500)
  alpha, sigma = distill._alpha_sigma(time_, dm.schedule, targets.shape)
  z_t = alpha * targets + sigma * eps
  teacher_ms = event_ms(lambda: dm.teacher_target(b, z_t, time_))
  step_ms = event_ms(lambda: t.train_step(state, batch, seed))
  log(f"  [{card}] one distillation step, batch {TRAIN_BATCH}, profiled "
      f"through utils/profiling.trace ({log_dir}/{trace_files[0]}): "
      f"{1e3 * wall:.1f} ms wall, the card busy {busy:.1f} ms; device ms "
      f"by region: " + ", ".join(f"{k} {v:.1f}" for k, v in regions.items())
      + f"; CUDA events: the teacher's target {teacher_ms:.1f} ms of a "
      f"{step_ms:.1f} ms step ({100 * teacher_ms / step_ms:.1f}%), the "
      f"student's forward, backward and Adafactor "
      f"{step_ms - teacher_ms:.1f} ms")
  profile = dict(wall_ms=1e3 * wall, busy_ms=busy, regions_ms=regions,
                 teacher_ms=teacher_ms, step_ms=step_ms,
                 teacher_share=teacher_ms / step_ms)
  del t, state, metrics, b, targets, z_t
  torch.cuda.empty_cache()

  # Card vs CPU: batch 1 (the batch's first row), the student time 1/2,
  # eps from a seed.
  one = {k: v[:1] for k, v in batch.items()}
  eps = torch.randn(tuple(one["decoder_target_tokens"].shape),
                    generator=torch.Generator().manual_seed(seed))
  time_ = torch.tensor([DISTILL_CHECK_T])
  cpu = distill.DistillModel(
      model_on_cpu(dm.student), model_on_cpu(dm.teacher), 500)
  # The card's student has taken the steps above: the CPU's takes its
  # weights (DistillModel started it as the teacher).
  cpu.module.load_state_dict(dm.module.state_dict())
  device_embedding = dops.timing_embedding

  def cpu_embedding(position, *args, **kwargs):
    return device_embedding(position.cpu(), *args, **kwargs).to(
        position.device)

  def step(m, embedding=device_embedding):
    dev = m.device
    draws = lambda x0, n: (time_.to(dev), eps.to(dev))
    dops.timing_embedding = embedding
    try:
      metrics, grads = trainer.Trainer(m, student_exp.train).loss_and_grads(
          trainer.batch_to_device(one, dev), draws, None)
    finally:
      dops.timing_embedding = device_embedding
    return metrics["loss"].item(), {n: g.cpu() for n, g in grads.items()}

  card_loss, card_g = step(dm)
  same_loss, same_g = step(dm, cpu_embedding)
  cpu_loss, cpu_g = step(cpu)
  del cpu
  loss_err = abs(same_loss - cpu_loss) / abs(cpu_loss)
  config_loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
  check(np.isfinite(card_loss), "card distillation loss finite")
  check(config_loss_err <= STEP_LOSS_TOLERANCE,
        f"distillation loss card vs CPU {card_loss} vs {cpu_loss}")
  check(loss_err <= STEP_LOSS_TOLERANCE,
        f"distillation loss card vs CPU, the same timing embedding: "
        f"{same_loss} vs {cpu_loss}")
  for name, g in card_g.items():
    check(bool(torch.isfinite(g).all()), f"{name} grad finite")
  same_err, same_leaf = max((rel_rms(same_g[n], g), n)
                            for n, g in cpu_g.items())
  check(same_err <= STEP_GRAD_TOLERANCE,
        f"distillation gradient of {same_leaf} card vs CPU: relative RMS "
        f"{same_err} above {STEP_GRAD_TOLERANCE}")
  config_err, config_leaf = max((rel_rms(card_g[n], g), n)
                                for n, g in cpu_g.items())
  log(f"  one distillation step card vs CPU (batch 1, t = "
      f"{DISTILL_CHECK_T}, CFG 5, {len(cpu_g)} parameters), with the CPU's "
      f"timing embedding on both: loss {same_loss:.7g} vs {cpu_loss:.7g} "
      f"(relative {loss_err:.3g}, tol {STEP_LOSS_TOLERANCE}), gradient "
      f"relative RMS largest {same_err:.3g} ({same_leaf}; tol "
      f"{STEP_GRAD_TOLERANCE}); as configured: loss {card_loss:.7g} "
      f"(relative {config_loss_err:.3g}, tol {STEP_LOSS_TOLERANCE}), "
      f"gradient relative RMS largest {config_err:.3g} ({config_leaf})")
  del dm
  torch.cuda.empty_cache()
  return dict(profile=profile, card_vs_cpu=dict(
      loss_rel=loss_err, grad_rel_rms=same_err,
      loss_rel_as_configured=config_loss_err,
      grad_rel_rms_as_configured=config_err))


def event_ms(fn) -> float:
  """ms of one call of fn() on the card (CUDA events; already warm)."""
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop)


def model_on_cpu(m):
  """A CPU copy of a diffusion model (its module deep-copied)."""
  out = copy.copy(m)
  out.module = copy.deepcopy(m.module).cpu()
  return out


def student_phase(card: str, segments, phase7_segment_s: float) -> dict:
  """(c) The round-1 student (DDIM 250, guidance folded in) served in int8
  through load_checkpoint: phase 7's first segment rendered eagerly (one
  conditional decoder forward of one row each step: no CFG pair) and
  captured (bit for bit, phase 26's checks), launches against the
  config's."""
  round_dir = os.path.join(DISTILL_DIR, f"round_{DISTILL_ROUNDS - 1}")
  t0 = time.perf_counter()
  served = inference.load_checkpoint(round_dir, device="cuda",
                                     compute_dtype="int8")
  load_s = time.perf_counter() - t0
  experiment = served.experiment
  sampler = experiment.diffusion.sampler
  check((sampler.name, sampler.num_steps) == ("ddim", 250)
        and experiment.diffusion.guidance.eval_condition_weight == 1.0,
        f"the student serves {sampler} at weight "
        f"{experiment.diffusion.guidance.eval_condition_weight}")
  synth = served.synthesizer()
  rows = []
  hook = served.model.module.decoder.register_forward_pre_hook(
      lambda module, args: rows.append(args[1].shape[0]))
  eager = eager_render(synth, segments[:1])
  hook.remove()
  check(rows == [1] * sampler.num_steps,
        f"the eager student ran decoder forwards of {sorted(set(rows))} "
        f"rows, {len(rows)} times: not one row a step")
  l_in = synth._input_length(len(segments[0]))
  shapes = qmm_shapes(experiment, l_in)
  expected = (attention_launches(experiment), sum(r[4] for r in shapes))
  check(eager["launches"] == expected,
        f"the student launched {eager['launches']}, expected {expected}")
  case = graph_check("int8 distilled student, DDIM 250", card, synth,
                     segments[:1], eager, experiment)
  log(f"  [{card}] the round-1 student (load_checkpoint {round_dir}, int8, "
      f"{load_s:.2f} s): {sampler.name} {sampler.num_steps} steps, one "
      f"forward of 1 row a step (no CFG pair); launches (flash_attention, "
      f"quantized_matmul) {eager['launches']} = expected {expected}; "
      f"segment captured {case['captured_wall_s']:.3f} s, eager "
      f"{eager['wall_s']:.3f} s, against phase 7's steady segment "
      f"{phase7_segment_s:.3f} s (100 steps, 71 CFG pairs)")
  return dict(case=case, launches=eager["launches"], expected=expected,
              segment_s=case["captured_wall_s"],
              phase7_segment_s=phase7_segment_s, load_s=load_s)


def vocoder_cli(card: str, label: str, argv) -> dict:
  """One cli/train_vocoder.py run on the card: s a step after the first,
  peak memory, finite losses."""
  from music_spectrogram_diffusion_tpu_torch.cli import train_vocoder
  model_dir = argv[argv.index("--model_dir") + 1]
  before = (len(metrics_lines(model_dir))
            if os.path.exists(os.path.join(model_dir, "metrics.jsonl"))
            else 0)
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated() / 2**30
  t0 = time.perf_counter()
  state, trainer_ = train_vocoder.main(argv + ["--device", "cuda"])
  wall = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated() / 2**30
  lines = metrics_lines(model_dir)[before:]
  check(bool(lines), f"{label}: no steps logged")
  for m in lines:
    for k, v in m.items():
      check(np.isfinite(v), f"{label} step {m['step']}: {k} = {v}")
  loss_key = "g_loss" if "g_loss" in lines[0] else "loss"
  s_step = float(np.mean([1.0 / m["steps_per_second"] for m in lines[1:]]))
  log(f"  [{card}] {label}: steps {[m['step'] for m in lines]}, {loss_key} "
      + ", ".join(f"{m[loss_key]:.5g}" for m in lines)
      + (", d_loss " + ", ".join(f"{m['d_loss']:.5g}" for m in lines)
         if "d_loss" in lines[0] else "")
      + f"; {s_step:.3f} s a step after the first, peak memory "
      f"{peak - resident:.2f} GiB above the {resident:.2f} GiB that earlier "
      f"phases hold ({peak:.2f} in all), {wall:.2f} s in all")
  return dict(steps=[m["step"] for m in lines],
              losses=[m[loss_key] for m in lines], seconds_per_step=s_step,
              peak_gib=peak, resident_gib=resident,
              run_peak_gib=peak - resident, wall_s=wall)


def vocoder_step_check(label: str, make, batch, seed=0) -> dict:
  """One step of a vocoder trainer, card vs CPU, from weights drawn from
  `seed` (None: those `make` gives): the gradients of its loss, the
  metrics, the updated weights."""
  results = []
  for device in ("cuda", "cpu"):
    trainer_ = make(device)
    state = trainer_.create_state(seed=seed)
    before = {k: v.detach().cpu().clone() for k, v in params_of(state)}
    grads = first_grads(trainer_, state, batch)
    state, metrics = trainer_.train_step(state, *batch)
    results.append(({k: v.item() for k, v in metrics.items()}, before,
                    {k: v.detach().cpu() for k, v in params_of(state)},
                    grads, trainer_))
  (card_m, card_0, card_1, card_g, t), (cpu_m, cpu_0, cpu_1, cpu_g, _) = (
      results)
  for k in card_0:
    check(torch.equal(card_0[k], cpu_0[k]), f"{label}: {k} seeded apart")
  metric_err = max(abs(card_m[k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu_m.items())
  check(metric_err <= VOCODER_STEP_METRIC_TOLERANCE,
        f"{label}: metrics card {card_m} vs CPU {cpu_m}")
  grad_err, grad_leaf = max((rel_rms(card_g[k], g), k)
                            for k, g in cpu_g.items())
  check(grad_err <= VOCODER_GRAD_TOLERANCE,
        f"{label}: gradient of {grad_leaf} card vs CPU: relative RMS "
        f"{grad_err}")
  lrs = lr_of(t)
  worst, flips, total = 0.0, 0, 0
  for k, v in cpu_1.items():
    lr = lrs[k]
    diff = (card_1[k] - v).abs()
    worst = max(worst, float(diff.max()) / lr)
    flips += int((diff > 1e-3 * lr).sum())
    total += v.numel()
  check(worst <= 2.0 + 1e-3, f"{label}: a weight moved {worst} x lr apart")
  check(flips <= VOCODER_STEP_FLIPS * total,
        f"{label}: {flips} of {total} weights apart by more than 1e-3 lr")
  log(f"  {label}, one step card vs CPU (batch {batch[0].shape[0]}): "
      f"metrics relative {metric_err:.3g} (tol "
      f"{VOCODER_STEP_METRIC_TOLERANCE}); gradient relative RMS largest "
      f"{grad_err:.3g} ({grad_leaf}; tol {VOCODER_GRAD_TOLERANCE}); "
      f"weights apart by more than 1e-3 lr {flips} of {total} "
      f"({100 * flips / total:.3f}%), largest {worst:.3g} lr")
  del results, t
  return dict(metric_rel=metric_err, grad_rel_rms=grad_err,
              grad_leaf=grad_leaf, weights_apart=flips, weights=total,
              largest_lr=worst)


def first_grads(t, state, batch) -> dict:
  """The gradients of the trainer's loss at its starting weights (the
  discriminator's at the starting generator's audio), on the CPU, by
  params_of's names."""
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder_train
  mel, audio = (vocoder_train._to(x, t.device) for x in batch)
  if hasattr(state, "params"):
    loss, _ = t.loss_fn(mel, audio)
    grads = vocoder_train._grads(loss, state.params)
    return {k: v.cpu() for k, v in grads.items()}
  g_loss, _ = t.g_loss_fn(mel, audio)
  out = {f"g.{k}": v.cpu()
         for k, v in vocoder_train._grads(g_loss, state.g_params).items()}
  d_grads = vocoder_train._grads(t.d_loss_fn(mel, audio), state.d_params)
  out.update({f"d.{k}": v.cpu() for k, v in d_grads.items()})
  return out


def trained_magnitude_net():
  """MagnitudeNet with the repo's trained weights (from seeded weights the
  gradient is ill-conditioned: zero_head_reading)."""
  from music_spectrogram_diffusion_tpu_torch import convert
  params, _, _ = convert.read_export(vocoder.TRAINED_MAGNITUDE_GL)
  net = vocoder.MagnitudeNet()
  net.load_state_dict(convert.flax_convs_to_state_dict(params["params"],
                                                       net))
  return net


def zero_head_reading(batch) -> dict:
  """MagnitudeTrainer's loss from seeded weights, card vs CPU and, on the
  CPU, float32 vs float64. The seeded head is zero, so the prediction is
  the mel pseudo-inverse, which gives back the target magnitude exactly
  (to rounding) at the low bins, where a mel filter spans about one STFT
  bin. There the sign of the log-magnitude L1 term, log(true) -
  log(pred), is decided by rounding, and each such bin adds +-4 / N to
  its conv_out.bias gradient (d log(pred) / d head is 4 at a zero head):
  the gradient differs between any two roundings, so vocoder_step_check
  starts the MagnitudeTrainer from the trained export. Checks the loss;
  reports, for both pairs, the bins whose L1 sign or 1e-5 clamp differs
  and conv_out's gradient relative RMS."""
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder_train
  from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops
  codec = codecs.MelGan()
  runs = {}
  for name, device, dtype in (("card", "cuda", torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("cpu64", "cpu", torch.float64)):
    t = vocoder_train.MagnitudeTrainer(vocoder.MagnitudeNet(), codec,
                                       device=device)
    t.create_state(seed=0)
    t.net.to(dtype)
    mel, audio = (torch.as_tensor(x, dtype=dtype, device=t.device)
                  for x in batch)
    loss, _ = t.loss_fn(mel, audio)
    grads = torch.autograd.grad(loss, [t.net.conv_out.weight,
                                       t.net.conv_out.bias])
    with torch.no_grad():
      pred = t.net(mel)
      true = stft_ops.stft_magnitude(
          audio, frame_length=t.frame_length, frame_step=codec.hop_size,
          fft_length=t.fft_length)
    n = min(pred.shape[1], true.shape[1])
    pred, true = pred[:, :n].double().cpu(), true[:, :n].double().cpu()
    runs[name] = dict(
        loss=loss.item(), grads=[g.double().cpu() for g in grads],
        pred=pred, l1=(torch.log(torch.clamp(true, min=1e-5))
                       - torch.log(torch.clamp(pred, min=1e-5))))
  exact = runs["cpu64"]["l1"].abs() < 1e-6
  out = dict(bins=exact.numel(), exact_bins=int(exact.sum()),
             exact_highest_bin=int(exact.nonzero()[:, 2].max()))
  for a, b in (("card", "cpu"), ("cpu", "cpu64")):
    ra, rb = runs[a], runs[b]
    out[f"{a}_vs_{b}"] = dict(
        loss_rel=abs(ra["loss"] - rb["loss"]) / abs(rb["loss"]),
        sign_flips=int((torch.sign(ra["l1"]) != torch.sign(rb["l1"])).sum()),
        clamp_flips=int(((ra["pred"] >= 1e-5)
                         != (rb["pred"] >= 1e-5)).sum()),
        conv_out_weight_grad_rel_rms=rel_rms(ra["grads"][0], rb["grads"][0]),
        conv_out_bias_grad_rel_rms=rel_rms(ra["grads"][1], rb["grads"][1]))
  check(out["card_vs_cpu"]["loss_rel"] <= VOCODER_STEP_METRIC_TOLERANCE,
        f"MagnitudeTrainer zero head: loss card {runs['card']['loss']} vs "
        f"CPU {runs['cpu']['loss']}")
  log(f"  MagnitudeTrainer from seeded weights (the zero head), batch "
      f"{batch[0].shape[0]}: {out['exact_bins']} of {out['bins']} bins "
      f"reconstructed to within 1e-6 in log by the pseudo-inverse (STFT "
      f"bins up to {out['exact_highest_bin']}); "
      + "; ".join(
          f"{pair.replace('_vs_', ' vs ')}: loss relative "
          f"{r['loss_rel']:.3g}, L1 sign flips {r['sign_flips']}, clamp "
          f"flips {r['clamp_flips']}, conv_out gradient relative RMS "
          f"{r['conv_out_weight_grad_rel_rms']:.3g} (weight), "
          f"{r['conv_out_bias_grad_rel_rms']:.3g} (bias)"
          for pair, r in out.items() if isinstance(r, dict)))
  return out


def params_of(state):
  if hasattr(state, "params"):
    return list(state.params.items())
  return ([(f"g.{k}", v) for k, v in state.g_params.items()]
          + [(f"d.{k}", v) for k, v in state.d_params.items()])


def lr_of(t) -> dict:
  """Each weight's learning rate (params_of's names)."""
  if hasattr(t, "optimizer"):
    lr = t.optimizer.learning_rate(0)
    return collections.defaultdict(lambda: lr)
  g, d = t.g_optimizer.learning_rate(0), t.d_optimizer.learning_rate(0)
  return {**{f"g.{k}": g for k, _ in t.decoder.named_parameters()},
          **{f"d.{k}": d for k, _ in t.disc.named_parameters()}}


def vocoder_train_phase(card: str, seed: int, mel: np.ndarray) -> dict:
  """(d) cli/train_vocoder.py at full width: reconstruction, the
  adversarial warm start, the full GAN restart, magnitude_gl and the
  dataset's audio; one step of each trainer card vs CPU; the magnitude_gl
  checkpoint served by load_trained on phase 7's mel."""
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder_train
  shutil.rmtree(VOCODER_TRAIN_DIR, ignore_errors=True)
  base = ["--batch", str(VOCODER_TRAIN_BATCH), "--segment_frames",
          str(VOCODER_TRAIN_FRAMES), "--log_period", "1", "--seed",
          str(seed)]
  gan = ["--model_dir", os.path.join(VOCODER_TRAIN_DIR, "soundstream"),
         "--synthetic"] + base
  mag = os.path.join(VOCODER_TRAIN_DIR, "magnitude_gl")
  runs = {
      "soundstream reconstruction": vocoder_cli(
          card, "soundstream reconstruction, 3 steps",
          gan + ["--steps", "3"]),
      "soundstream adversarial warm start": vocoder_cli(
          card, "--adversarial --resume (the generator warm-started), 2 "
          "steps", gan + ["--steps", "5", "--adversarial", "--resume"]),
      "soundstream adversarial restart": vocoder_cli(
          card, "--adversarial --resume (the whole GAN state), 2 steps",
          gan + ["--steps", "7", "--adversarial", "--resume"]),
      "magnitude_gl": vocoder_cli(
          card, "--arch magnitude_gl, 3 steps",
          ["--model_dir", mag, "--synthetic", "--arch", "magnitude_gl",
           "--steps", "3"] + base),
      "soundstream on maestrov3": vocoder_cli(
          card, "--dataset maestrov3 (phase 27's records), 2 steps",
          ["--model_dir", os.path.join(VOCODER_TRAIN_DIR, "dataset"),
           "--dataset", "maestrov3", "--data_root", DATA_ROOT, "--steps",
           "2"] + base)}
  check([runs[k]["steps"] for k in runs] == [[1, 2, 3], [4, 5], [6, 7],
                                             [1, 2, 3], [1, 2]],
        f"vocoder runs' steps {[runs[k]['steps'] for k in runs]}")
  disc = os.path.join(VOCODER_TRAIN_DIR, "soundstream", "disc", "step_7")
  check(os.path.exists(disc), f"no {disc}")

  codec = codecs.MelGan()
  r = np.random.RandomState(seed)
  frames = VOCODER_TRAIN_FRAMES
  audio = (r.randn(2, frames * codec.hop_size) * 0.1).astype(np.float32)
  batch = (codec.encode(torch.from_numpy(audio))[:, :frames].numpy(), audio)

  def soundstream():
    return vocoder.SoundStreamDecoder(vocoder.SoundStreamConfig())

  steps = {
      "VocoderTrainer": vocoder_step_check(
          "VocoderTrainer (base 512)", lambda dev: vocoder_train
          .VocoderTrainer(soundstream(), codec, device=dev), batch),
      "MagnitudeTrainer": vocoder_step_check(
          "MagnitudeTrainer (hidden 512, from the trained export)",
          lambda dev: vocoder_train.MagnitudeTrainer(trained_magnitude_net(),
                                                     codec, device=dev),
          batch, seed=None),
      "AdversarialVocoderTrainer": vocoder_step_check(
          "AdversarialVocoderTrainer (base 512)", lambda dev: vocoder_train
          .AdversarialVocoderTrainer(soundstream(), codec, device=dev),
          batch),
      "MagnitudeTrainer zero head": zero_head_reading(batch)}
  voc = vocoder.load_trained(mag, device="cuda")
  check(isinstance(voc, vocoder.HybridGLVocoder),
        f"load_trained({mag}) gave {type(voc).__name__}")
  audio = voc(torch.as_tensor(mel[None], device="cuda"))
  check(tuple(audio.shape) == (1, mel.shape[0] * codec.hop_size)
        and bool(torch.isfinite(audio).all()),
        f"the trained magnitude_gl's audio {tuple(audio.shape)}")
  log(f"  load_trained({mag}) -> HybridGLVocoder; phase 7's mel "
      f"{mel.shape} -> finite audio {tuple(audio.shape)}")
  shutil.rmtree(VOCODER_TRAIN_DIR, ignore_errors=True)
  return dict(runs=runs, card_vs_cpu=steps)



# Phase 30: the ('data', 'model') mesh (parallel/mesh.py) and the native
# TFRecord reader. The card is one H100, so the sharded runs are two ranks
# that share it over gloo (NCCL refuses two ranks on one device); their
# times say nothing of NVLink or NCCL scaling. One rank at 1x1 takes the
# NCCL path through cli/train.py --distributed.
SHARD_MODELS = (2, 4)  # the model groups of the 1x2 and 1x4 meshes
PARALLEL_DIR = os.path.join("out", "chip_smoke_parallel")
PARALLEL_STEPS = 3
PARALLEL_MESHES = ("2x1", "1x2")
# Sharded vs one-rank training at full width, float32, 3 steps with the
# preset's dropout (draws at the global shape): the steps' loss, n_frames
# and grad_norm relative within PARALLEL_METRIC_TOLERANCE (the same
# arithmetic summed in another order over the shards, and the embedding's
# backward adds with atomics on CUDA: measured 1.9e-6 at 2x1 on an H100
# 80GB HBM3 at 700 W), and each parameter's gap over its total update
# (relative RMS) within PARALLEL_UPDATE_TOLERANCE: Adafactor's g / sqrt(v)
# turns a gradient's last bits into a visible share of an update of 1e-5
# (measured 1.2e-3 at 2x1, at a norm scale; 2.9e-3 on the CPU against
# JAX, tests/test_torch_parallel.py).
PARALLEL_METRIC_TOLERANCE, PARALLEL_UPDATE_TOLERANCE = 1e-4, 1e-2
# Sharded vs one-rank int8 serving: one decoder forward (the CFG pair's
# rows) within the int8 network tolerance of tests/test_torch_quantize.py,
# 2.5% of the peak and 2% RMS (a row-parallel product's partials are summed
# in f32 and rounded to bf16 once, the one-rank kernel's sum likewise in
# another order); the rendered segment (100 SDE-DPM++ steps) within its 2%
# RMS, its largest bin reported: the sampler carries a forward's rounding
# flips through 100 steps into single bins (measured 6.1% of the peak at
# one bin, 0.74% RMS, on an H100 80GB HBM3 at 700 W).
PARALLEL_SERVE_MAX, PARALLEL_SERVE_RMS = 2.5e-2, 2e-2
# The native reader's share of phase 27's records.
READER_BYTES = 48 * 2 ** 20


def shard_qmm_shapes(experiment, l_in: int) -> list:
  """Kernel #3's calls on the shards of the 1x2 and 1x4 meshes, from the
  int8 path's (qmm_shapes): a projection split on N (q/k/v, the cross
  K/V, the MLP's wi: 'joined_kv' and 'mlp') on its columns, in the
  activations' dtype; one split on K (the attention outputs, wo, FiLM and
  the time embedding's: 'joined_kv', 'mlp' and 'vocab' inputs) on its
  rows, writing the float32 partial the model group sums."""
  rows = {}
  for m, k, n, dtype, count, what in qmm_calls(experiment, l_in):
    column = any(w in what for w in ("q/k/v", "cross K/V", "mlp wi",
                                     "cross q"))
    for model in SHARD_MODELS:
      if column:
        key = (m, k, n // model, dtype, dtype)
      else:
        key = (m, k // model, n, dtype, torch.float32)
      tag = f"1x{model} {'N' if column else 'K'} shard of {what}"
      old = rows.get(key, (0, []))
      rows[key] = (old[0] + count, old[1] + [tag])
  return [(m, k, n, dtype, count, "; ".join(tags), out)
          for (m, k, n, dtype, out), (count, tags) in sorted(
              rows.items(), key=lambda kv: (-kv[0][0], kv[0][1:3]))]


def shard_kernel_phase(gen, stream) -> dict:
  """Phase 30 (a): kernels #1 and #2 at the local heads of 1x2 and 1x4
  (6 and 3 of context_base's 12) at every attention shape, #3 on every
  column and row shard, each against its plain version."""
  fwd_shapes = [(f"{name}_{12 // model}h", q_len, kv_len, masked, tr,
                 12 // model) for model in SHARD_MODELS
                for name, q_len, kv_len, masked, tr in SHAPES]
  # Each shape at the CFG pair's b=2, in float32 and bfloat16.
  fwd = kernel_phase(gen, stream, fwd_shapes, RUNS[:2])
  bwd = bwd_kernel_phase(gen, TRAIN_BATCH, fwd_shapes)
  experiment = serving_experiment()
  qmm = qmm_phase(shard_qmm_shapes(experiment, experiment.task_lengths.inputs),
                  gen, stream)
  return dict(fwd=fwd, bwd=bwd, qmm=qmm)


def job_tag(job: dict) -> str:
  return f"{job['mesh']}_{job['kind']}"


def parallel_rank(rank: int, world: int, jobs: list) -> None:
  """One rank of phase 30's runs on the card (torch.multiprocessing):
  joins a gloo group of `world` ranks through a file under PARALLEL_DIR
  and runs each job ('train' or 'serve' on its 'mesh') in turn, freeing
  the card's memory between them; writes each job's numbers to
  PARALLEL_DIR/<mesh>_<kind>_rank<r>.json (rank 0 also its full result
  tensors, .pt)."""
  import gc
  from music_spectrogram_diffusion_tpu_torch.parallel import multihost
  from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  multihost.initialize(
      init_method="file://" + os.path.abspath(
          os.path.join(PARALLEL_DIR, "rendezvous")),
      num_processes=world, process_id=rank, backend="gloo", device="cuda")
  try:
    for job in jobs:
      mesh = multihost.global_mesh(*mesh_lib.parse_mesh(job["mesh"]))
      run = parallel_train if job["kind"] == "train" else parallel_serve
      torch.cuda.reset_peak_memory_stats()
      stats, tensors = run(mesh, job)
      out = os.path.join(PARALLEL_DIR, f"{job_tag(job)}_rank{rank}")
      with open(out + ".json", "w") as f:
        json.dump(stats, f)
      if rank == 0:
        torch.save(tensors, out + ".pt")
      del stats, tensors
      gc.collect()
      torch.cuda.empty_cache()
  finally:
    multihost.shutdown()


def load_batches(path: str) -> list:
  with np.load(path) as f:
    flat = {k: f[k] for k in f.files}
  count = 1 + max(int(k.split("/")[0]) for k in flat)
  return [{k.split("/", 1)[1]: v for k, v in flat.items()
           if k.startswith(f"{i}/")} for i in range(count)]


def train_steps(t, batches, seed: int) -> dict:
  """PARALLEL_STEPS steps (each rank its rows of the global batch): the
  metrics, s a step after the first, the launches of #1 and #2, peak
  memory."""
  state = t.create_state()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  attention.route_launches.clear()
  attention.flash_attention_bwd.launches = 0
  quantize.quantized_matmul.launches = 0
  rows, stamps = [], []
  for batch in batches:
    state, metrics = t.train_step(state, t.shard_batch(batch), seed)
    rows.append({k: float(metrics[k]) for k in
                 ("loss", "n_frames", "grad_norm", "loss_per_frame")})
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
  return dict(metrics=rows,
              s_per_step=(stamps[-1] - stamps[0]) / (len(stamps) - 1),
              launches=[attention.flash_attention.launches,
                        attention.flash_attention_bwd.launches,
                        quantize.quantized_matmul.launches],
              routes=f32_routes("phase 30, sharded training"),
              peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def parallel_train(mesh, job):
  experiment = training_experiment()
  model = trainer.build_model(experiment, seed=job["seed"], device="cuda")
  t = trainer.Trainer(model, experiment.train, mesh=mesh)
  stats = train_steps(t, load_batches(job["batches"]), job["seed"] + 1)
  params = {k: v.cpu() for k, v in t.full_params().items()}
  return stats, params


def serve_forward(served, batch, seed: int) -> torch.Tensor:
  """One decoder forward of `served` on `batch` (its CFG pair's rows: the
  conditional row and the unconditional one, which skips
  cross-attention) at t = 0.5 from seeded z: the output on the host."""
  model = served.model
  tensors = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
  tensors["encoder_input_tokens"] = tensors["encoder_input_tokens"].long()
  z = torch.randn(tensors["decoder_target_tokens"].shape, device="cuda",
                  generator=torch.Generator("cuda").manual_seed(seed))
  with torch.inference_mode():
    encodings = model.encode(tensors)
    out = model.module.decode(encodings, torch.cat([z, z]),
                              torch.full((2,), 0.5, device="cuda"),
                              cond_rows=1)
  return out.float().cpu()


def parallel_serve(mesh, job):
  served = inference.InferenceModel(serving_experiment(), seed=job["seed"],
                                    device="cuda", compute_dtype="int8",
                                    mesh=mesh)
  batch = dict(np.load(job["batch"]))
  forward = serve_forward(served, batch, job["seed"])
  torch.cuda.synchronize()
  zero_counts()
  t0 = time.perf_counter()
  mel = served.predict(batch, seed=job["seed"], graphs=False)
  wall = time.perf_counter() - t0
  return dict(segment_s=wall, launches=list(launch_counts()),
              peak_gib=torch.cuda.max_memory_allocated() / 2**30), {
                  "mel": torch.from_numpy(mel), "forward": forward}


def run_ranks(jobs: list) -> dict:
  """`jobs` on two ranks sharing the card, started once: {tag: (the
  job's stats by rank, rank 0's tensors)}."""
  import torch.multiprocessing as mp
  rendezvous = os.path.join(PARALLEL_DIR, "rendezvous")
  if os.path.exists(rendezvous):
    os.remove(rendezvous)
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  mp.start_processes(parallel_rank, args=(2, jobs), nprocs=2, join=True,
                     start_method="spawn")
  out = {}
  for job in jobs:
    tag = job_tag(job)
    stats = []
    for rank in range(2):
      with open(os.path.join(PARALLEL_DIR, f"{tag}_rank{rank}.json")) as f:
        stats.append(json.load(f))
    path = os.path.join(PARALLEL_DIR, f"{tag}_rank0.pt")
    out[tag] = (stats, torch.load(path, weights_only=True))
    os.remove(path)
  return out


def train_reference(seed: int) -> dict:
  """Phase 30 (b), one rank: full-width context_base, float32, 3 steps at
  batch 8 with the preset's dropout; the batches written for the ranks;
  the initial and final parameters on the host."""
  experiment = training_experiment()
  batches = training_batches(experiment, TRAIN_BATCH, PARALLEL_STEPS, seed)
  path = os.path.join(PARALLEL_DIR, "batches.npz")
  np.savez(path, **{f"{i}/{k}": np.asarray(v) for i, b in enumerate(batches)
                    for k, v in b.items()})
  model = trainer.build_model(experiment, seed=seed, device="cuda")
  start = {k: v.detach().cpu().clone()
           for k, v in model.module.state_dict().items()}
  t = trainer.Trainer(model, experiment.train)
  one = train_steps(t, batches, seed + 1)
  final = {k: v.detach().cpu() for k, v in model.module.state_dict().items()}
  del t, model
  torch.cuda.empty_cache()
  return dict(batches=path, start=start, final=final, one=one)


def check_training(card: str, mesh_spec: str, stats, params, ref) -> dict:
  """Phase 30 (b), a mesh's run over two gloo ranks sharing the card,
  from the same initial weights (the seed) and batches as the one-rank
  run: its updated parameters, loss, n_frames and grad_norm held to the
  one-rank run's."""
  start, final, one = ref["start"], ref["final"], ref["one"]
  worst, worst_name, param_gap = 0.0, None, 0.0
  for name, want in final.items():
    param_gap = max(param_gap, rel_rms(params[name], want))
    update = (want - start[name]).float()
    if not update.abs().max() > 0:
      check(torch.equal(params[name], want), f"{mesh_spec}: {name} "
            "moved where the one-rank run left it")
      continue
    gap = rel_rms(params[name] - start[name], update)
    if gap > worst:
      worst, worst_name = gap, name
  metric_gap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(stats[0]["metrics"], one["metrics"])
                   for k in ("loss", "n_frames", "grad_norm"))
  check(worst <= PARALLEL_UPDATE_TOLERANCE
        and metric_gap <= PARALLEL_METRIC_TOLERANCE,
        f"{mesh_spec} training vs one rank: parameter update gap {worst} "
        f"({worst_name}; tol {PARALLEL_UPDATE_TOLERANCE}), metrics "
        f"{metric_gap} (tol {PARALLEL_METRIC_TOLERANCE})")
  check(all(s["metrics"] == stats[0]["metrics"] for s in stats),
        f"{mesh_spec}: the ranks' metrics differ")
  launches = [sum(s["launches"][i] for s in stats) for i in range(3)]
  check(all(s["launches"][0] > 0 and s["launches"][1] > 0 for s in stats)
        and launches[2] == 0, f"{mesh_spec}: launches {stats}")
  out = dict(
      s_per_step=max(s["s_per_step"] for s in stats),
      peak_gib=[s["peak_gib"] for s in stats], launches=launches,
      launches_by_rank=[s["launches"] for s in stats],
      update_gap=worst, worst_param=worst_name, param_gap=param_gap,
      metric_gap=metric_gap,
      metrics=stats[0]["metrics"])
  log(f"  [{card}] {mesh_spec} over 2 gloo ranks on one card, "
      f"{PARALLEL_STEPS} steps at global batch {TRAIN_BATCH}: loss "
      + ", ".join(f"{m['loss']:.2f}" for m in stats[0]["metrics"])
      + f"; against one rank: parameter update gap {worst:.3g} "
      f"({worst_name}; tol {PARALLEL_UPDATE_TOLERANCE}), parameters "
      f"{param_gap:.3g} relative RMS, loss/n_frames/grad_norm "
      f"{metric_gap:.3g} (tol {PARALLEL_METRIC_TOLERANCE}); "
      f"{out['s_per_step']:.3f} s per "
      f"step (one rank: {one['s_per_step']:.3f}); peak memory by rank "
      + ", ".join(f"{p:.2f}" for p in out["peak_gib"])
      + f" GiB (one rank {one['peak_gib']:.2f}); launches by rank "
      f"(#1, #2, #3) {out['launches_by_rank']}")
  return out


def nccl_phase(card: str, seed: int) -> dict:
  """Phase 30 (c): cli/train.py --distributed --mesh 1x1 as one rank over
  NCCL (a coordinator on localhost), 2 steps of context_base."""
  import socket
  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
  model_dir = os.path.join(PARALLEL_DIR, "nccl")
  shutil.rmtree(model_dir, ignore_errors=True)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, "-m", "music_spectrogram_diffusion_tpu_torch.cli.train",
       "--synthetic", "--preset", "context_base", "--batch",
       str(TRAIN_BATCH), "--steps", "2", "--synthetic_examples",
       str(TRAIN_SONGS), "--log_period", "1", "--seed", str(seed),
       "--model_dir", model_dir, "--distributed", "--mesh", "1x1",
       "--coordinator", f"localhost:{port}", "--num_processes", "1",
       "--process_id", "0"], capture_output=True, text=True, timeout=600)
  wall = time.perf_counter() - t0
  check(proc.returncode == 0, f"cli/train.py over NCCL failed:\n"
        f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
  lines = metrics_lines(model_dir)
  check([m["step"] for m in lines] == [1, 2]
        and all(np.isfinite(m["loss"]) for m in lines),
        f"cli/train.py over NCCL logged {lines}")
  mesh_line = [l for l in proc.stdout.splitlines() if l.startswith("mesh:")]
  log(f"  [{card}] cli/train.py --distributed --mesh 1x1 over NCCL "
      f"(coordinator localhost): {mesh_line[0] if mesh_line else ''}; "
      f"losses " + ", ".join(f"{m['loss']:.2f}" for m in lines)
      + f"; {wall:.1f} s in all (a process: start, model, data, 2 steps)")
  shutil.rmtree(model_dir, ignore_errors=True)
  return dict(losses=[m["loss"] for m in lines], wall_s=wall)


def serve_reference(seed: int) -> dict:
  """Phase 30 (d), one rank: int8 context_base, one decoder forward and
  one segment rendered eagerly (timed after a first render); the batch
  written for the ranks."""
  experiment = serving_experiment()
  tl = experiment.task_lengths
  tokens = song_tokens(seed, experiment)[0]
  batch = {"encoder_input_tokens": np.zeros((1, tl.inputs), np.int32),
           "encoder_continuous_inputs": np.zeros(
               (1, tl.targets_context, 128), np.float32),
           "encoder_continuous_mask": np.zeros((1, tl.targets_context),
                                               bool),
           "decoder_target_tokens": np.zeros((1, tl.targets, 128),
                                             np.float32)}
  batch["encoder_input_tokens"][0, :len(tokens)] = tokens
  path = os.path.join(PARALLEL_DIR, "segment.npz")
  np.savez(path, **batch)
  served = inference.InferenceModel(experiment, seed=seed, device="cuda",
                                    compute_dtype="int8")
  want_forward = serve_forward(served, batch, seed)
  served.predict(batch, seed=seed, graphs=False)
  torch.cuda.synchronize()
  zero_counts()
  t0 = time.perf_counter()
  want = served.predict(batch, seed=seed, graphs=False)
  one_s = time.perf_counter() - t0
  one_launches = launch_counts()
  del served
  torch.cuda.empty_cache()
  return dict(batch=path, forward=want_forward, mel=want, one_s=one_s,
              launches=one_launches, tokens=len(tokens))


def check_serving(card: str, stats, tensors, ref) -> dict:
  """Phase 30 (d): the int8 render with InferenceModel(mesh=1x2) over the
  two gloo ranks (its single render, after one decoder forward, timed as
  it is: it takes seconds of all_reduces, a first call's own costs
  milliseconds) against the one-rank render."""
  want_forward, want = ref["forward"], ref["mel"]
  one_s, one_launches = ref["one_s"], ref["launches"]
  got_forward = tensors["forward"]
  f_err = (got_forward - want_forward).abs().max().item()
  f_peak = want_forward.abs().max().item()
  f_rms = rel_rms(got_forward, want_forward)
  check(f_err <= PARALLEL_SERVE_MAX * f_peak and f_rms <= PARALLEL_SERVE_RMS,
        f"1x2 int8 decoder forward vs one rank: max {f_err} (tol "
        f"{PARALLEL_SERVE_MAX} x {f_peak}), relative RMS {f_rms} (tol "
        f"{PARALLEL_SERVE_RMS})")
  got = tensors["mel"].numpy()
  peak = np.abs(want).max()
  err = np.abs(got - want).max()
  rms = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
  check(got.shape == want.shape and bool(np.isfinite(got).all()),
        f"sharded render {got.shape}")
  check(rms <= PARALLEL_SERVE_RMS, f"1x2 int8 render vs one rank: relative "
        f"RMS {rms} > {PARALLEL_SERVE_RMS}")
  for s in stats:
    check(s["launches"][0] == one_launches[0]
          and s["launches"][1] == one_launches[1],
          f"1x2 rank launches {s['launches']}, one rank {one_launches}")
  log(f"  [{card}] int8 context_base, one segment (tokens {ref['tokens']}), "
      f"eager, the serving sampler: 1x2 over 2 gloo ranks on one card "
      f"against one rank: one decoder forward max |diff| {f_err / f_peak:.3g}"
      f" of the peak (tol {PARALLEL_SERVE_MAX}), relative RMS {f_rms:.3g} "
      f"(tol {PARALLEL_SERVE_RMS}); the segment max |diff| {err:.3g} "
      f"({err / peak:.3g} of the peak, reported), relative RMS {rms:.3g} "
      f"(tol {PARALLEL_SERVE_RMS}); s a segment: 1x2 "
      + ", ".join(f"{s['segment_s']:.3f}" for s in stats)
      + f" by rank, one rank {one_s:.3f}; launches (#1, #3) by rank "
      + ", ".join(str(tuple(s["launches"])) for s in stats)
      + f", one rank {one_launches}; peak memory by rank "
      + ", ".join(f"{s['peak_gib']:.2f}" for s in stats) + " GiB")
  return dict(forward_max_rel_err=f_err / f_peak, forward_rel_rms=f_rms,
              max_rel_err=float(err / peak), rel_rms=rms,
              segment_s=[s["segment_s"] for s in stats], one_rank_s=one_s,
              launches_by_rank=[s["launches"] for s in stats],
              launches=[sum(s["launches"][i] for s in stats)
                        for i in range(2)],
              one_rank_launches=list(one_launches))


def native_reader_phase(card: str) -> dict:
  """Phase 30 (e): phase 27's records through the C++ splitter and the
  plain Python reader, with and without the CRC check: MB/s and records
  (examples) a second of each, on the host; the records equal."""
  import glob
  from music_spectrogram_diffusion_tpu_torch.data import datasets
  from music_spectrogram_diffusion_tpu_torch.data import native
  files = sorted(p for p in glob.glob(os.path.join(DATA_ROOT, "**", "*"),
                                      recursive=True)
                 if os.path.isfile(p) and ".tfrecord" in p)
  check(len(files) >= 14, f"phase 27's records: {len(files)} files")
  # The first files in path order up to READER_BYTES (the plain reader's
  # CRC takes 0.14 s a MB).
  paths, size = [], 0
  for p in files:
    if size and size + os.path.getsize(p) > READER_BYTES:
      break
    paths.append(p)
    size += os.path.getsize(p)
  rates = {}
  for verify in (False, True):
    for name, read in (("cpp", lambda p, v: native.split_tfrecords(
        open(p, "rb").read(), v)), ("python", lambda p, v: list(
            datasets.iter_tfrecords_py(p, v)))):
      t0 = time.perf_counter()
      records = [read(p, verify) for p in paths]
      wall = time.perf_counter() - t0
      rates[f"{name}{'_crc' if verify else ''}"] = dict(
          mb_per_s=size / 1e6 / wall,
          examples_per_s=sum(len(r) for r in records) / wall, seconds=wall)
      if name == "cpp":
        reference = records
      else:
        check(records == reference, f"the C++ and Python readers differ "
              f"(crc {verify})")
  n = sum(len(r) for r in reference)
  log(f"  [host] the TFRecord reader on phase 27's {len(paths)} files "
      f"({size / 2**20:.1f} MiB, {n} records), records equal: "
      + "; ".join(f"{k} {v['mb_per_s']:.1f} MB/s, {v['examples_per_s']:.1f} "
                  f"examples/s" for k, v in rates.items()))
  return dict(files=len(paths), bytes=size, records=n, rates=rates)


def parallel_phase(card: str, seed: int, gen, stream) -> dict:
  """Phase 30, (a) to (e). The one-rank references of (b) and (d) run
  here first; then two ranks started once run (b) at 2x1 and 1x2 and (d)
  at 1x2, one after the other."""
  shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
  os.makedirs(PARALLEL_DIR)
  t0 = time.perf_counter()
  kernels = shard_kernel_phase(gen, stream)
  times = {"kernels_s": time.perf_counter() - t0}
  t0 = time.perf_counter()
  train_ref, serve_ref = train_reference(seed), serve_reference(seed)
  times["one_rank_s"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  jobs = [dict(mesh=m, kind="train", seed=seed, batches=train_ref["batches"])
          for m in PARALLEL_MESHES]
  jobs.append(dict(mesh="1x2", kind="serve", seed=seed,
                   batch=serve_ref["batch"]))
  results = run_ranks(jobs)
  times["two_ranks_s"] = time.perf_counter() - t0
  training = {"1x1": train_ref["one"]}
  for m in PARALLEL_MESHES:
    training[m] = check_training(card, m, *results[f"{m}_train"], train_ref)
  serving = check_serving(card, *results["1x2_serve"], serve_ref)
  t0 = time.perf_counter()
  nccl = nccl_phase(card, seed)
  times["nccl_s"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  reader = native_reader_phase(card)
  times["reader_s"] = time.perf_counter() - t0
  shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
  torch.cuda.empty_cache()
  return dict(kernels=kernels, training=training, nccl=nccl,
              serving=serving, reader=reader, seconds=times)


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
  # 7 nvcc processes at once: the three kernels, and the wgmma routes'
  # four planted-fault builds; and phase 27's records, written in the
  # background.
  records = start_dataset_records()
  fault_builds = {name: start_fault_build(
      os.path.join("out", f"chip_smoke_fault_{name}"), name)
                  for name in FAULTS}
  _build.build("flash_fwd", "qmm", "flash_bwd")
  attention._library("flash_fwd")
  attention._library("flash_bwd")
  quantize._library()
  fault_libs = {name: finish_fault_build(build)
                for name, build in fault_builds.items()}
  log(f"phase 2 build: flash_fwd.cu (both routes), qmm.cu and flash_bwd.cu "
      f"(both routes) with nvcc, and flash_fwd.cu and flash_bwd.cu with "
      f"their wgmma routes' planted faults (a key tile left out; plain TF32) "
      f"({time.perf_counter() - t0:.2f} s)")
  for name in ("flash_fwd", "qmm", "flash_bwd"):
    usage = ptxas_usage(name)
    check(bool(usage), f"no ptxas report for {name}.cu")
    for line in usage:
      log(f"  ptxas {name}: {line}")
      check(" 0 bytes spill stores" in line, f"{name}.cu spills: {line}")
    warnings = [line.strip() for line in
                _build.compiler_report(name).splitlines() if "warn" in line]
    log(f"  ptxas {name} warnings: {' | '.join(warnings) or 'none'}")

  t0 = time.perf_counter()
  log(f"  forward route rule: {fwd_route_rule_check()}")
  rows = kernel_phase(gen, capture, faults=fault_libs)
  # The checks draw from a generator of their own, so that the phases
  # after them see the inputs they saw without them.
  check_gen = torch.Generator("cuda").manual_seed(args.seed + 1)
  log(f"  TF32 rounding: {tf32_rounding_check(check_gen)}")
  log(f"  NaN in, NaN out where the plain version's is (NaN outputs): "
      f"{nan_check(check_gen)}")
  log(f"  f32 forward calls outside the models: "
      f"{mma_sync_f32_check(check_gen, 'fwd')}")
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
  bwd_rows = bwd_kernel_phase(gen, TRAIN_BATCH, faults=fault_libs)
  log(f"  f32 backward calls outside the models: "
      f"{mma_sync_f32_check(check_gen, 'bwd')}")
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
  del model  # the synthesizer renders again in phase 27
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
  bwd_bf16_rows = bwd_bf16_phase(gen, TRAIN_BATCH, fault_libs["flash_bwd"])
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
  family_rows = kernel_phase(gen, capture, FAMILY_SHAPES, faults=fault_libs)
  family_bwd_rows = bwd_kernel_phase(gen, TRAIN_BATCH, FAMILY_SHAPES,
                                     faults=fault_libs)
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

  t0 = time.perf_counter()
  data = dataset_phase(card, args.seed, synth, qmm_rows, records, {
      f"float32 batch {TRAIN_BATCH} (phase 11)":
          TRAIN_BATCH / train_summary["seconds_per_step"],
      f"bfloat16 remat batch {BF16_LARGE_BATCH} (phase 20)":
          BF16_LARGE_BATCH / bf16_summary["batch_32"]["seconds_per_step"]})
  del synth
  torch.cuda.empty_cache()
  log(f"phase 27 main path, the dataset pipeline: the seven schemas' "
      f"records, their caches, context_base trained on the mega mixture, a "
      f"full-song render in int8, the vocoders on dataset audio, the host's "
      f"rates ({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  transcriber_data = start_transcriber_data(args.seed)
  mt3_summary = mt3_phase(card, args.seed, gen, capture)
  transcriber_bwd_rows = bwd_kernel_phase(gen, TRANSCRIBER_BATCH,
                                          TRANSCRIBER_SHAPES)
  transcriber = transcriber_phase(card, args.seed, transcriber_data)
  evaluation = evaluation_phase(card, args.seed, qmm_rows)
  torch.cuda.empty_cache()
  log(f"phase 28 main path, evaluation: MT3's captured greedy and beam "
      f"decodes, the transcriber trained with cli/train_transcriber.py, "
      f"cli/evaluate.py in int8 with every metric, 2 shards merged by "
      f"cli/merge_eval.py ({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  distillation = distill_phase(card, args.seed)
  distillation["step"] = distill_step_phase(card, args.seed)
  # Phase 11's final checkpoint served as the teacher; it goes now.
  shutil.rmtree(os.path.join("out", "chip_smoke_train",
                             f"step_{TRAIN_STEPS}"))
  distillation["student"] = student_phase(
      card, segments, int8_case["captured_steady_segment_s"])
  shutil.rmtree(DISTILL_DIR)  # 2 x 1.6 GB of students; logged above
  torch.cuda.empty_cache()
  distillation["vocoder_training"] = vocoder_train_phase(card, args.seed,
                                                         render.mel)
  torch.cuda.empty_cache()
  log(f"phase 29 main path, distillation and vocoder training: "
      f"cli/distill.py 2 rounds at full width, one step card vs CPU, the "
      f"round-1 student in int8 with DDIM 250, cli/train_vocoder.py's five "
      f"runs and each trainer card vs CPU ({time.perf_counter() - t0:.2f} "
      f"s)")
  student_launches = distillation["student"]["case"]["launches_captured"]

  t0 = time.perf_counter()
  parallel = parallel_phase(card, args.seed, gen, capture)
  log(f"phase 30 main path, the mesh and the native reader: kernels #1-#3 "
      f"at the 1x2 and 1x4 shards, context_base training at 2x1 and 1x2 "
      f"and int8 serving at 1x2 over two gloo ranks on one card, "
      f"cli/train.py over NCCL at 1x1, the C++ TFRecord splitter "
      f"({time.perf_counter() - t0:.2f} s: "
      + ", ".join(f"{k} {v:.1f}" for k, v in parallel["seconds"].items())
      + ")")
  sharded = {f"sharded_training_{m}": parallel["training"][m]["launches"]
             for m in PARALLEL_MESHES}
  sharded_serve = parallel["serving"]["launches"]

  # Each kernel's numbers: one call at each of its main-path shapes (the
  # attention kernel's f32 calls at b=2), summed.
  # The context model's int8 path, a segment (phase 7).
  qmm_ms_segment = sum(r["ms"] * r["launches_per_segment"] for r in qmm_rows)
  rows = rows + family_rows + mt3_summary["rows"] + parallel["kernels"]["fwd"]
  bwd_rows = (bwd_rows + family_bwd_rows + transcriber_bwd_rows
              + parallel["kernels"]["bwd"])
  qmm_rows = qmm_rows + ar_qmm_rows + parallel["kernels"]["qmm"]
  f32 = [r for r in rows if r["dtype"] == "float32" and r["batch"] == 2]
  # The forward's wgmma route: the bf16 calls at b=2 of phases 3 and 22
  # (the serving and training shapes).
  fwd_bf16 = [r for r in rows[:len(SHAPES) * len(RUNS)] + family_rows
              if r["dtype"] == "bfloat16" and r["batch"] == 2]
  # The paths whose network runs in bf16: all their forward calls take the
  # wgmma route (checked per shape above and in
  # tests/test_torch_attention_fwd_plan.py).
  bf16_paths = {"int8": int8_launches[0], "int8_streamed": stream_launches[0],
                "training_bf16_remat": bf16_launches[0],
                "training_bf16_remat_batch_32": bf16_large_launches[0],
                "notes_only_int8": notes_summary["launches"][0],
                "autoregressive_int8": ar_summary["launches"][0],
                "dataset_full_song_int8": data["full_song"]["launches"][0],
                "distilled_student_int8": student_launches[0],
                "sharded_serving_1x2_int8": sharded_serve[0]}

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
                   + sum(v["launches"][0] for v in family_train.values())
                   + data["training"]["launches"][0]
                   + data["full_song"]["launches"][0]
                   + mt3_summary["launches"] + transcriber["launches"][0]
                   + evaluation["launches"][0]
                   + evaluation["shard_launches"][0]
                   + distillation["launches"][0] + student_launches[0]
                   + sum(v[0] for v in sharded.values())
                   + sharded_serve[0]),
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
                              for k, v in family_train.items()},
                           "dataset_training_mega":
                               data["training"]["launches"][0],
                           "dataset_full_song_int8":
                               data["full_song"]["launches"][0],
                           "mt3_decode": mt3_summary["launches"],
                           "transcriber_training":
                               transcriber["launches"][0],
                           "evaluate_int8": evaluation["launches"][0],
                           "evaluate_gt_encoded_shards":
                               evaluation["shard_launches"][0],
                           "distillation": distillation["launches"][0],
                           "distilled_student_int8": student_launches[0],
                           **{k: v[0] for k, v in sharded.items()},
                           "sharded_serving_1x2_int8": sharded_serve[0]},
      "max_abs_err": max(r["max_abs_err"] for r in f32),
      "ms": total("ms", f32),
      "plain_ms": total("plain_ms", f32),
      "bound_ms": total("bound_ms", f32),
      "bound_by": "operations" if all(
          r["bound_by"] == "operations" for r in f32) else "bytes",
      "library_ms": total("library_ms", f32),
      "per_shape": rows,
      # The f32 route of the calls above (phases 3 and 22's planted faults
      # at its calls).
      "f32": {"route": "wgmma",
              "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/"
                        "flash_fwd_tf32.cuh",
              "worst_fault_of_tolerance": min(
                  r["fault_of_tolerance"] for r in f32
                  if r["fault_of_tolerance"] is not None),
              "worst_plain_tf32_of_tolerance": min(
                  r["plain_tf32_of_tolerance"] for r in f32
                  if r["plain_tf32_of_tolerance"] is not None)},
      # The bf16 route (phases 3 and 22), summed as above.
      "bf16": {"route": "wgmma",
               "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/"
                         "flash_fwd_wgmma.cuh",
               "launches": sum(bf16_paths.values()),
               "launches_by_path": bf16_paths,
               "max_abs_err": max(r["max_abs_err"] for r in fwd_bf16),
               "worst_fault_of_tolerance": min(
                   r["fault_of_tolerance"] for r in fwd_bf16),
               "ms": total("ms", fwd_bf16),
               "plain_ms": total("plain_ms", fwd_bf16),
               "bound_ms": total("bound_ms", fwd_bf16),
               "bound_by": "operations" if all(
                   r["bound_by"] == "operations" for r in fwd_bf16)
               else "bytes",
               "library_ms": total("library_ms", fwd_bf16)},
  }, {
      "name": "int8_weight_only_gemm",
      "route": "cuda",
      "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/qmm.cu",
      "replaces": "music_spectrogram_diffusion_tpu/ops/quantize.py:114",
      "launches": (int8_launches[1] + stream_launches[1]
                   + notes_summary["launches"][1]
                   + ar_summary["launches"][1]
                   + data["full_song"]["launches"][1]
                   + evaluation["launches"][1] + student_launches[1]
                   + sharded_serve[1]),
      "launches_by_path": {"int8": int8_launches[1],
                           "int8_streamed": stream_launches[1],
                           "notes_only_int8": notes_summary["launches"][1],
                           "autoregressive_int8": ar_summary["launches"][1],
                           "dataset_full_song_int8":
                               data["full_song"]["launches"][1],
                           "evaluate_int8": evaluation["launches"][1],
                           "distilled_student_int8": student_launches[1],
                           "sharded_serving_1x2_int8": sharded_serve[1]},
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
                   + sum(v["launches"][1] for v in family_train.values())
                   + data["training"]["launches"][1]
                   + transcriber["launches"][1]
                   + distillation["launches"][1]
                   + sum(v[1] for v in sharded.values())),
      "launches_by_path": {"training": train_launches[1],
                           "training_bf16_remat": bf16_launches[1],
                           "training_bf16_remat_batch_32":
                               bf16_large_launches[1],
                           "cli_training_remat": cli_train["launches"][1],
                           **{f"training_{k}": v["launches"][1]
                              for k, v in family_train.items()},
                           "dataset_training_mega":
                               data["training"]["launches"][1],
                           "transcriber_training":
                               transcriber["launches"][1],
                           "distillation": distillation["launches"][1],
                           **{k: v[1] for k, v in sharded.items()}},
      "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
      "ms": total("ms", bwd_rows),
      "plain_ms": total("plain_ms", bwd_rows),
      "bound_ms": total("bound_ms", bwd_rows),
      "bound_by": "operations" if all(
          r["bound_by"] == "operations" for r in bwd_rows) else "bytes",
      "library_ms": total("library_ms", bwd_rows),
      "per_shape": bwd_rows,
      # Every f32 call above took the wgmma route (phases 10 and 22's
      # planted faults at their shapes).
      "f32": {"route": "wgmma",
              "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/"
                        "flash_bwd_tf32.cuh",
              "worst_fault_of_tolerance": min(
                  r["fault_of_tolerance"] for r in bwd_rows
                  if r["fault_of_tolerance"] is not None),
              "worst_plain_tf32_of_tolerance": min(
                  r["plain_tf32_of_tolerance"] for r in bwd_rows
                  if r["plain_tf32_of_tolerance"] is not None)},
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
  log("datasets " + json.dumps(data))
  log("evaluation " + json.dumps(dict(
      mt3={k: v for k, v in mt3_summary.items() if k != "rows"},
      transcriber=transcriber, evaluate=evaluation)))
  log("distillation " + json.dumps(distillation))
  log("parallel " + json.dumps({k: v for k, v in parallel.items()
                                if k != "kernels"}))
  print(json.dumps(kernels))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
