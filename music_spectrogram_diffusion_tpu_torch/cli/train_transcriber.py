"""Train a small MT3 transcriber (audio -> note events) with the PyTorch port.

  python -m music_spectrogram_diffusion_tpu_torch.cli.train_transcriber \
      --model_dir /tmp/transcriber --steps 16000 --batch 32 [--device cpu]

Port of music_spectrogram_diffusion_tpu/cli/train_transcriber.py, with its
flags and defaults (and `--device`, default cuda). It trains a compact
MT3Transformer (infer/mt3.py) on the synthetic task's (audio,
NoteSequence) pairs: the same event-token pipeline as the published model
(tokenize -> segment at 2.048 s -> tie-section prefix -> run-length
encoded shifts), a smaller trunk and single-instrument data. Register the
result at evaluation with `cli.evaluate --transcriber_checkpoint
MODEL_DIR` to light up the F1 columns.

What it computes as the JAX CLI does:
* the segment set, generated on the host with the same numpy calls, so
  that a `--data_cache` `.npz` is byte for byte the JAX CLI's;
* the training specs kept on the device rounded to bfloat16, each batch
  gathered there and cast back to float32;
* AdamW (weight decay 1e-4) under optax's
  `warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup + 1))`,
  both written out by hand (`train/trainer.py AdamW`, `lr_schedule`) as
  optax computes them;
* the loss: cross-entropy over tokens > 0, an all-ones frames mask (the
  attention kernels run without a key mask).
Its random numbers are its own: the initial weights (Flax's initializers
and scales, torch's draws), and SpecAugment, noise and gain drawn from a
`torch.Generator` seeded from (seed + 2, step), as JAX folds the step into
its key; the batch indices are JAX's (`RandomState(seed + 1)`).

Checkpoints are the port's (`train/checkpoints.py`), with the JAX CLI's
`config.json` sidecar (`kind: mt3_transcriber`); a rerun resumes from the
latest.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch.train.trainer import AdamW


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--model_dir", required=True)
  p.add_argument("--steps", type=int, default=2000)
  p.add_argument("--batch", type=int, default=32)
  p.add_argument("--synthetic_examples", type=int, default=4096,
                 help="number of synthetic songs (each yields several "
                      "2.048 s segments). Small sets memorize: at 256 "
                      "songs the model hits train acc 1.0 but eval token "
                      "acc 0.22; >=4096 songs is the validated recipe")
  p.add_argument("--song_seconds", type=float, default=8.0)
  p.add_argument("--max_tokens", type=int, default=512)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--learning_rate", type=float, default=1e-3)
  p.add_argument("--warmup_steps", type=int, default=200)
  p.add_argument("--emb_dim", type=int, default=256)
  p.add_argument("--num_layers", type=int, default=4)
  p.add_argument("--num_heads", type=int, default=4)
  p.add_argument("--mlp_dim", type=int, default=512)
  p.add_argument("--checkpoint_period", type=int, default=500)
  p.add_argument("--log_period", type=int, default=100)
  p.add_argument("--eval_fraction", type=float, default=0.1,
                 help="held-out fraction of segments for eval loss/acc")
  p.add_argument("--eval_segments", type=int, default=384,
                 help="cap on held-out segments (the eval forward runs "
                      "as ONE batch)")
  p.add_argument("--input_noise", type=float, default=0.5,
                 help="stddev of Gaussian noise added to the log-mel "
                      "inputs per train step (device-side augmentation; "
                      "the fixed synthetic set memorizes without it)")
  p.add_argument("--time_masks", type=int, default=2,
                 help="SpecAugment: number of random time masks per "
                      "example (0 disables)")
  p.add_argument("--time_mask_width", type=int, default=48)
  p.add_argument("--freq_masks", type=int, default=2,
                 help="SpecAugment: number of random mel-bin masks per "
                      "example (0 disables)")
  p.add_argument("--freq_mask_width", type=int, default=24)
  p.add_argument("--gain_jitter", type=float, default=0.5,
                 help="uniform +-X offset added to the whole log-mel "
                      "(audio gain is additive in log space)")
  p.add_argument("--program_granularity", default="flat",
                 choices=["flat", "midi_class", "full"],
                 help="program mapping for the training targets. The "
                      "synthetic render is timbre-less (pure sines), so "
                      "full program identity is unlearnable noise; "
                      "'flat' (the ismir2021 style) keeps the headline "
                      "flat-F1 metric exact while making every target "
                      "token predictable from audio")
  p.add_argument("--data_cache", default=None,
                 help=".npz path: reuse tokenized segments if it exists, "
                      "else write it after generation (host-side numpy; "
                      "--gen_only generates without training)")
  p.add_argument("--gen_only", action="store_true",
                 help="generate + cache the dataset, skip training")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default) or 'cpu'")
  return p.parse_args(argv)


def generate_segments(args: argparse.Namespace, codec, vocab
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
  """The JAX CLI's synthetic segment set: (specs [n, 256, 512] float32,
  targets [n, max_tokens] int32, segments skipped over --max_tokens)."""
  from music_spectrogram_diffusion_tpu_torch.data import (preprocessors,
                                                          synthetic)
  from music_spectrogram_diffusion_tpu_torch.infer import mt3

  # The MT3 frontend frames at hop 128 / 125 fps (mt3/spectrograms.py);
  # tokenize_example only needs hop/frame_rate from its codec argument.
  class _MT3Framing:
    hop_size = mt3.HOP_WIDTH
    frame_rate = mt3.FRAMES_PER_SECOND
    sample_rate = mt3.SAMPLE_RATE

  rng = np.random.RandomState(args.seed)
  specs, tokens_list = [], []
  skipped = 0
  for _ in range(args.synthetic_examples):
    ns = synthetic.random_note_sequence(rng, duration=args.song_seconds)
    audio = synthetic.render_note_sequence(
        ns, mt3.SAMPLE_RATE, duration=args.song_seconds)
    ex = preprocessors.tokenize_example(
        ns=ns, samples=audio, audio_codec=_MT3Framing(), codec=codec,
        onsets_only=False, include_ties=True)
    ex = preprocessors.rekey_transcription_to_synthesis(ex)
    for chunk in preprocessors.split_cached_frames(ex, mt3.INPUT_FRAMES):
      # Event tokens for this segment: tie-section prefix + RLE shifts
      # (the exact stream MT3Transcriber's decode inverts).
      chunk = preprocessors.note_representation_chain(
          chunk, codec, include_ties=True,
          granularity_type=args.program_granularity, feature_key="inputs")
      toks = vocab.encode(np.asarray(chunk["inputs"], np.int32))
      toks = np.concatenate([toks, [vocab.eos_id]]).astype(np.int32)
      if len(toks) > args.max_tokens:
        skipped += 1
        continue
      seg_audio = preprocessors.flatten_frames(np.asarray(chunk["targets"]))
      spec = mt3.spectrogram(seg_audio)[:mt3.INPUT_FRAMES]
      spec = np.pad(spec, ((0, mt3.INPUT_FRAMES - len(spec)), (0, 0)))
      specs.append(spec.astype(np.float32))
      tokens_list.append(np.pad(toks, (0, args.max_tokens - len(toks))))
  return np.stack(specs), np.stack(tokens_list), skipped


def lr_schedule(learning_rate: float, warmup: int,
                decay_steps: int) -> Callable[[int], float]:
  """optax.warmup_cosine_decay_schedule(0.0, learning_rate, warmup,
  decay_steps) (end value 0, exponent 1) at an optimizer count, in
  float32: a linear ramp from 0 over `warmup` counts, then a cosine
  decay to 0 over the remaining decay_steps - warmup."""
  f32 = np.float32

  def schedule(count: int) -> float:
    if count < warmup:
      frac = f32(1.0) - f32(count) / f32(warmup)
      return float((f32(0.0) - f32(learning_rate)) * frac
                   + f32(learning_rate))
    span = decay_steps - warmup
    frac = f32(min(count - warmup, span)) / f32(span)
    cosine = f32(0.5) * (f32(1.0) + f32(np.cos(f32(np.pi) * frac)))
    return float(f32(learning_rate) * cosine)
  return schedule


def shift_right(t: torch.Tensor) -> torch.Tensor:
  return F.pad(t, (1, 0))[:, :-1]


def loss_fn(module, spec_b: torch.Tensor, tgt_b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(loss, token accuracy) over targets > 0; every frame valid."""
  logits = module(spec_b, None, shift_right(tgt_b), tgt_b)
  weights = (tgt_b > 0).float()
  ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                       tgt_b.reshape(-1).long(),
                       reduction="none").reshape(tgt_b.shape)
  denom = torch.clamp(weights.sum(), min=1.0)
  loss = torch.sum(ce * weights) / denom
  acc = torch.sum((torch.argmax(logits, -1) == tgt_b).float() * weights)
  return loss, acc / denom


def augment(args: argparse.Namespace, spec_b: torch.Tensor,
            generator: torch.Generator) -> torch.Tensor:
  """SpecAugment (Park et al. 2019) + noise + gain on the device, as the
  JAX CLI's, drawn from `generator`: time masks, frequency masks, a gain
  offset, Gaussian noise, in that order; masks fill with the example's
  mean."""
  b, t, f = spec_b.shape
  dev = spec_b.device
  fill = torch.mean(spec_b, dim=(1, 2), keepdim=True)

  def apply_masks(x, axis_len, n_masks, max_width, axis):
    pos = torch.arange(axis_len, device=dev)
    pos = pos[None, :, None] if axis == 1 else pos[None, None, :]
    for _ in range(n_masks):
      width = torch.randint(0, max_width + 1, (b, 1, 1), generator=generator,
                            device=dev)
      start = torch.randint(0, max(axis_len - max_width, 1), (b, 1, 1),
                            generator=generator, device=dev)
      hit = (pos >= start) & (pos < start + width)
      x = torch.where(hit, fill, x)
    return x

  if args.time_masks:
    spec_b = apply_masks(spec_b, t, args.time_masks, args.time_mask_width, 1)
  if args.freq_masks:
    spec_b = apply_masks(spec_b, f, args.freq_masks, args.freq_mask_width, 2)
  if args.gain_jitter:
    gain = torch.rand((b, 1, 1), generator=generator, device=dev)
    spec_b = spec_b + (2.0 * gain - 1.0) * args.gain_jitter
  if args.input_noise:
    spec_b = spec_b + args.input_noise * torch.randn(
        spec_b.shape, generator=generator, device=dev)
  return spec_b


def step_generator(seed: int, step: int, device) -> torch.Generator:
  """The augmentation's generator of one step, seeded from (seed, step)."""
  state = np.random.SeedSequence((seed, step)).generate_state(1)
  return torch.Generator(device).manual_seed(int(state[0]))


def train_step(module, opt: AdamW, opt_state: Dict[str, Any],
               spec_all: torch.Tensor, tgt_all: torch.Tensor,
               idx: torch.Tensor, args: argparse.Namespace,
               generator: Optional[torch.Generator]):
  """One step on the batch `idx` of the device-resident set; returns
  (new opt state, loss, accuracy). No generator: no augmentation."""
  spec_b = spec_all.index_select(0, idx).float()
  tgt_b = tgt_all.index_select(0, idx)
  if generator is not None:
    spec_b = augment(args, spec_b, generator)
  params = dict(module.named_parameters())
  loss, acc = loss_fn(module, spec_b, tgt_b)
  grads = torch.autograd.grad(loss, list(params.values()))
  opt_state = opt.step_(params, dict(zip(params, grads)), opt_state)
  return opt_state, loss.detach(), acc.detach()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
  args = parse_args(argv)

  from music_spectrogram_diffusion_tpu_torch.infer import inference, mt3
  from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints

  vocab_config = vocabularies.VocabularyConfig(num_velocity_bins=1)
  codec = vocabularies.build_codec(vocab_config)
  vocab = vocabularies.vocabulary_from_codec(codec)
  vocab_size = vocabularies.num_embeddings(vocab)

  if args.data_cache and os.path.exists(args.data_cache):
    with np.load(args.data_cache) as cached:
      specs, targets = cached["specs"], cached["targets"]
    print(f"loaded {len(specs)} segments from {args.data_cache}")
  else:
    specs, targets, skipped = generate_segments(args, codec, vocab)
    print(f"generated {len(specs)} segments "
          f"({skipped} skipped over --max_tokens)")
    if args.data_cache:
      # Uncompressed, as the JAX CLI writes it.
      np.savez(args.data_cache, specs=specs, targets=targets)
      print(f"cached dataset to {args.data_cache}")
  if args.gen_only:
    return {}
  device = inference.resolve_device(args.device)
  n_eval = max(1, min(int(len(specs) * args.eval_fraction),
                      args.eval_segments))
  eval_specs, eval_targets = specs[:n_eval], targets[:n_eval]
  specs, targets = specs[n_eval:], targets[n_eval:]
  print(f"segments: {len(specs)} train / {n_eval} eval, "
        f"mean tokens {float((targets > 0).sum(1).mean()):.1f}")

  config = mt3.MT3Config(
      vocab_size=vocab_size, emb_dim=args.emb_dim,
      num_heads=args.num_heads, head_dim=64,
      num_encoder_layers=args.num_layers,
      num_decoder_layers=args.num_layers, mlp_dim=args.mlp_dim)
  module = mt3.MT3Transformer(config).init_weights(
      torch.Generator().manual_seed(args.seed)).to(device)
  n_params = sum(p.numel() for p in module.parameters())
  print(f"transcriber params: {n_params / 1e6:.1f}M")

  warmup = min(args.warmup_steps, max(args.steps // 2, 1))
  # decay_steps must exceed warmup (a --steps 1 run hit decay_steps=0
  # inside optax otherwise).
  opt = AdamW(lr_schedule(args.learning_rate, warmup,
                          max(args.steps, warmup + 1)), weight_decay=1e-4)
  opt_state = opt.init(dict(module.named_parameters()))

  start_step = 1
  latest = checkpoints.latest_checkpoint(args.model_dir)
  if latest is not None:
    restored = checkpoints.restore_checkpoint(latest, device=device)
    with torch.no_grad():
      module.load_state_dict(restored["params"], strict=True)
    if "opt_state" in restored:
      opt_state = restored["opt_state"]
      opt_state["count"] = int(opt_state["count"])
    start_step = int(restored.get("step", 0)) + 1
    print(f"resumed from {latest} (next step {start_step})")
    if start_step > args.steps:
      print("checkpoint already at target steps; nothing to do")
      return {}

  # The whole set stays on the device, the specs rounded to bfloat16 as
  # the JAX CLI stores them; batches are gathered there.
  specs_dev = torch.as_tensor(specs).to(device=device, dtype=torch.bfloat16)
  targets_dev = torch.as_tensor(targets, device=device)
  eval_specs_dev = torch.as_tensor(eval_specs, device=device)
  eval_targets_dev = torch.as_tensor(eval_targets, device=device)
  augmenting = bool(args.time_masks or args.freq_masks or args.gain_jitter
                    or args.input_noise)

  sidecar = json.dumps({
      "kind": "mt3_transcriber",
      "arch": {"emb_dim": args.emb_dim, "num_heads": args.num_heads,
               "num_encoder_layers": args.num_layers,
               "num_decoder_layers": args.num_layers,
               "mlp_dim": args.mlp_dim, "head_dim": 64},
      "vocab": dataclasses.asdict(vocab_config),
      "max_tokens": args.max_tokens,
  })

  data_rng = np.random.RandomState(args.seed + 1)
  out: Dict[str, float] = {}
  module.train()
  timed_from = None  # (step, time) after the first step, synchronized
  for step in range(start_step, args.steps + 1):
    if step == start_step + 1:
      _sync(device)
      timed_from = (step, time.perf_counter())
    idx = data_rng.randint(0, len(specs), args.batch).astype(np.int64)
    gen = (step_generator(args.seed + 2, step, device) if augmenting
           else None)
    opt_state, loss, acc = train_step(
        module, opt, opt_state, specs_dev, targets_dev,
        torch.as_tensor(idx, device=device), args, gen)
    if step % args.log_period == 0 or step == args.steps:
      with torch.no_grad():
        ev_loss, ev_acc = loss_fn(module, eval_specs_dev, eval_targets_dev)
      out = {"loss": float(loss), "acc": float(acc),
             "eval_loss": float(ev_loss), "eval_acc": float(ev_acc)}
      print(f"[step {step}] loss={out['loss']:.4f} acc={out['acc']:.3f} "
            f"eval_loss={out['eval_loss']:.4f} "
            f"eval_acc={out['eval_acc']:.3f}")
    if step % args.checkpoint_period == 0 or step == args.steps:
      path = checkpoints.save_checkpoint(
          args.model_dir, step, module.state_dict(), opt_state=opt_state,
          config_json=sidecar)
      print(f"saved checkpoint: {path}")
  if timed_from is not None:
    _sync(device)
    out["seconds_per_step"] = ((time.perf_counter() - timed_from[1])
                               / (args.steps + 1 - timed_from[0]))
    print(f"seconds per step after the first (logging and checkpoints "
          f"included): {out['seconds_per_step']:.4f}")
  return out


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


if __name__ == "__main__":
  main()
