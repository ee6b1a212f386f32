"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own line with its seconds:
  1. device   the card, as nvidia-smi names it with its power limit;
  2. build    nvcc builds the flash-attention kernel from ops/csrc/;
  3. kernel   the kernel against its plain PyTorch version at the three
              attention shapes of the serving path, in float32 and bfloat16:
              error and tolerance, kernel / plain / SDPA (yardstick only)
              times, and the least time the card could take;
  4. main     context_base at full width (random weights from --seed)
              renders one song of 3 chained segments with the serving
              sampler (100-step sde-dpm++, CFG 5 in t in [0.1, 0.8]) and
              vocodes it with Griffin-Lim (PGHI init, 32 iterations) into
              out/chip_smoke_seed<seed>.wav; the kernel's launch
              count must match the config's;
  5. check    one decoder step of the same model on the card against the
              same step on the CPU (plain attention there).
Then one JSON line of the kernels, the nvidia-smi line again, and last
{"ok": true, "device": {...}}. Any failure exits non-zero with its
traceback and prints no result. Needs CUDA; it refuses to run without it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.audio import wav_io
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.midi import note_tokens
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
from music_spectrogram_diffusion_tpu_torch.ops import _build
from music_spectrogram_diffusion_tpu_torch.ops import attention
from music_spectrogram_diffusion_tpu_torch.ops import stft

# H100 SXM, dense, at the 700 W limit (NVIDIA data sheet).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
SEGMENTS = 3
# (name, q_len, kv_len, key mask, kv_transposed): the serving path's
# attentions. Each runs at b=2 (the 2 CFG rows of one song) in f32 and
# bf16, and at b=1 in f32: the encoders and cross-attention see one row on
# the main path, and so does self-attention outside the guidance interval.
SHAPES = (
    ("encoder_self_2048x2048", 2048, 2048, True, False),
    ("decoder_self_256x256", 256, 256, False, False),
    ("cross_256x2304", 256, 2304, True, True),
)
RUNS = ((2, torch.float32), (2, torch.bfloat16), (1, torch.float32))
HEADS, HEAD_DIM = 12, 64
# f32: the kernel sums in another order than cuBLAS (observed <= 6e-6).
# bf16: p is rounded to bf16 before p.v and the output is stored in bf16,
# whose step at |x| in [2, 4) is 2^-6.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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
  """max(operations / peak, bytes / HBM rate) for one call."""
  flops = 4.0 * batch * HEADS * q_len * kv_len * HEAD_DIM
  elt = torch.finfo(dtype).bits // 8
  nbytes = (2 * batch * q_len + 2 * batch * kv_len) * HEADS * HEAD_DIM * elt
  nbytes += batch * kv_len if masked else 0
  t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
  bf16_ops = flops / PEAK_FLOPS[torch.bfloat16]
  return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
          else "bytes", 1e3 * max(bf16_ops, t_bytes))


def kernel_phase(gen):
  rows = []
  for name, q_len, kv_len, masked, transposed in SHAPES:
    for batch, dtype in RUNS:
      q, k, v, mask = attention_inputs(batch, q_len, kv_len, masked,
                                       transposed, dtype, gen)

      def kernel():
        return attention.flash_attention(q, k, v, kv_mask=mask,
                                         kv_transposed=transposed)

      def plain():
        return attention.attention_reference(q, k, v, kv_mask=mask,
                                             kv_transposed=transposed)

      got = kernel()
      torch.cuda.synchronize()
      err = (got.float() - plain().float()).abs().max().item()
      check(bool(torch.isfinite(got).all()), f"{name} {dtype} finite")
      check(err <= TOLERANCE[dtype],
            f"{name} {dtype}: max |kernel - plain| {err} > "
            f"{TOLERANCE[dtype]}")
      # SDPA yardstick on the same inputs: [b, h, l, d], additive mask.
      qs = q.transpose(1, 2).contiguous()
      ks, vs = ((k, v) if transposed else
                (k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous()))
      bias = None
      if mask is not None:
        bias = ((mask.float() - 1.0) * 1e10)[:, None, None, :].to(dtype)

      def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias,
                                              scale=1.0)

      iters = 20 if q_len > 256 else 100
      ms, plain_ms, lib_ms = (cuda_ms(kernel, iters),
                              cuda_ms(plain, iters), cuda_ms(library, iters))
      bound, bound_by, bound_bf16 = bound_ms(batch, q_len, kv_len, masked,
                                             dtype)
      dt = str(dtype).replace("torch.", "")
      log(f"  {name} b={batch} h={HEADS} d={HEAD_DIM} {dt}: max_abs_err "
          f"{err:.3g} (tol {TOLERANCE[dtype]}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; bound {bound:.4f} ms "
          f"({bound_by}, {dt} peak), {bound_bf16:.4f} ms at the bf16 peak")
      rows.append(dict(shape=name, dtype=dt, batch=batch, q_len=q_len,
                       kv_len=kv_len, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by=bound_by))
  return rows


def song_tokens(seed: int, experiment) -> list:
  codec = vocabularies.build_codec(experiment.vocab_config())
  vocab = vocabularies.vocabulary_from_codec(codec)
  seg_seconds = experiment.task_lengths.targets / 50.0  # 50 frames/s
  notes = note_tokens.random_notes(seed, SEGMENTS * seg_seconds)
  return note_tokens.segment_tokens(
      notes, num_segments=SEGMENTS, segment_seconds=seg_seconds,
      max_tokens=experiment.task_lengths.inputs, codec=codec, vocab=vocab)


def attention_ms_per_segment(rows, experiment) -> dict:
  """Kernel time per segment from phase 3's f32 call times and the main
  path's launches (the context encoder's masked 256x256 self-attention is
  timed as the decoder's 256x256 shape)."""
  ms = {(r["shape"], r["batch"]): r["ms"] for r in rows
        if r["dtype"] == "float32"}
  net = experiment.network()
  sampler = experiment.diffusion.sampler
  lo, hi = (np.float32(x) for x in experiment.diffusion.guidance.interval)
  times = (np.arange(sampler.num_steps, dtype=np.float32) + 1) / np.float32(
      sampler.num_steps)
  paired = int(((times >= lo) & (times <= hi)).sum())
  single = sampler.num_steps - paired
  return {
      "encoders": net.num_encoder_layers * (
          ms["encoder_self_2048x2048", 1] + ms["decoder_self_256x256", 1]),
      "decoder_self": net.num_decoder_layers * (
          paired * ms["decoder_self_256x256", 2]
          + single * ms["decoder_self_256x256", 1]),
      "cross": net.num_decoder_layers * sampler.num_steps
               * ms["cross_256x2304", 1],
  }


def main_phase(seed: int, card: str, rows):
  experiment = inference.with_sampler(
      config.preset("context_base"), sampler_steps=100,
      sampler_name="sde-dpm++", guidance_interval=(0.1, 0.8))
  t0 = time.perf_counter()
  model = inference.InferenceModel(experiment, seed=seed, device="cuda")
  log(f"  context_base built from seed {seed} on the card "
      f"({time.perf_counter() - t0:.2f} s)")
  segments = song_tokens(seed, experiment)
  voc = vocoder.GriffinLimVocoder(num_iters=32, device="cuda")
  synth = model.synthesizer(voc)
  torch.cuda.reset_peak_memory_stats()
  attention.flash_attention.launches = 0
  t0 = time.perf_counter()
  render = synth.render_song(segments)
  wall = time.perf_counter() - t0
  launches = attention.flash_attention.launches
  net = experiment.network()
  steps = experiment.diffusion.sampler.num_steps
  per_segment = 2 * net.num_encoder_layers + 2 * net.num_decoder_layers * steps
  expected = SEGMENTS * per_segment
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
  parts = attention_ms_per_segment(rows, experiment)
  log(f"  [{card}] attention kernel per segment, from phase 3's call times x "
      f"launches: {sum(parts.values()):.1f} ms (" + ", ".join(
          f"{k} {v:.1f} ms" for k, v in parts.items()) + ") of the steady "
      f"segment's {1e3 * tm['steady_segment_seconds']:.1f} ms")
  log(f"  [{card}] sampler {tm['prediction_seconds']:.3f} s for "
      f"{SEGMENTS} segments (steady {tm['steady_segment_seconds']:.3f} s per "
      f"{experiment.task_lengths.targets / 50.0:.2f} s segment); vocoder "
      f"{tm['audio_decode_seconds']:.3f} s; realtime factor "
      f"{audio_s / wall:.3f} (audio s / wall s, {wall:.3f} s wall); peak "
      f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
  os.makedirs("out", exist_ok=True)
  wav = os.path.join("out", f"chip_smoke_seed{seed}.wav")
  peak = max(float(np.abs(render.audio).max()), 1e-9)
  wav_io.write_wav(wav, render.audio / peak, model.audio_codec.sample_rate)
  log(f"  wrote {wav} (peak-normalized; the weights are random)")
  mag = stft.mel_to_linear(
      torch.exp(torch.as_tensor(render.mel, device="cuda")), voc.mel_basis)
  t0 = time.perf_counter()
  stft.pghi_phase(mag.cpu().numpy(), **voc.stft_params)
  log(f"  [{card}'s host] PGHI heap (Python) alone on the "
      f"{n_frames} x 513 magnitude: {time.perf_counter() - t0:.3f} s")
  return model, segments, launches


def reference_phase(model, segments):
  """One CFG decoder step at full width on the card (kernel) and on the
  CPU (plain attention, float32 matmuls on both)."""
  tokens = torch.as_tensor(segments[0][None].astype(np.int64))
  ctx = torch.full((1, 256, 128), model.audio_codec.pad_value)
  batch = {"encoder_input_tokens": tokens, "encoder_continuous_inputs": ctx,
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
                                  cross_kv=kv, cond_rows=1).cpu())
  err = (outs[0] - outs[1]).abs().max().item()
  scale = outs[1].abs().max().item()
  check(bool(torch.isfinite(outs[0]).all()), "card decoder output finite")
  # The FiLM time embedding takes sin/cos of up to 1e4 rad at t = 0.5,
  # where one ulp of exp in an inverse timescale (the two devices' float32
  # exp differ there) moves the argument by ~6e-4.
  tol = 3e-4 * scale + 1e-4
  check(err <= tol, f"card vs CPU decoder step: max abs diff {err} > {tol}")
  log(f"  decoder CFG step, card vs CPU: max abs diff {err:.3g} "
      f"(output max {scale:.3g}; tol 3e-4 x max + 1e-4 = {tol:.3g})")


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

  t0 = time.perf_counter()
  card = card_line()
  log(card)
  log(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch "
      f"{torch.__version__}, CUDA {torch.version.cuda} "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  attention._library()
  report = _build.compiler_report("flash_fwd")
  usage = [l.strip() for l in report.splitlines()
           if "registers" in l or "spill" in l]
  log(f"phase 2 build: flash_fwd.cu with nvcc "
      f"({time.perf_counter() - t0:.2f} s)")
  for line in usage[:4]:
    log(f"  ptxas: {line}")

  t0 = time.perf_counter()
  rows = kernel_phase(gen)
  log(f"phase 3 kernel vs plain: {len(rows)} checks passed "
      f"({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  model, segments, launches = main_phase(args.seed, card, rows)
  log(f"phase 4 main path ({time.perf_counter() - t0:.2f} s)")

  t0 = time.perf_counter()
  reference_phase(model, segments)
  log(f"phase 5 reference check ({time.perf_counter() - t0:.2f} s)")

  # The kernel line's numbers: one f32 call at each shape at b=2.
  f32 = [r for r in rows if r["dtype"] == "float32" and r["batch"] == 2]
  total = lambda key: sum(r[key] for r in f32)  # noqa: E731
  kernels = {"kernels": [{
      "name": "flash_attention_fwd",
      "route": "cuda",
      "source": "music_spectrogram_diffusion_tpu_torch/ops/csrc/flash_fwd.cu",
      "replaces": "music_spectrogram_diffusion_tpu/ops/attention.py:441",
      "launches": launches,
      "max_abs_err": max(r["max_abs_err"] for r in f32),
      "ms": total("ms"),
      "plain_ms": total("plain_ms"),
      "bound_ms": total("bound_ms"),
      "bound_by": "operations" if all(
          r["bound_by"] == "operations" for r in f32) else "bytes",
      "library_ms": total("library_ms"),
      "per_shape": rows,
  }]}
  print(json.dumps(kernels))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
