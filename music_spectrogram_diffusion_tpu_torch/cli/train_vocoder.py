"""Train a mel inverter (vocoder): the SoundStream-style decoder or the
MagnitudeNet.

  python -m music_spectrogram_diffusion_tpu_torch.cli.train_vocoder \
      --model_dir /tmp/vocoder --synthetic --steps 1000 \
      [--adversarial] [--batch 8] [--segment_frames 64] [--device cpu]

  # Dataset audio (TFRecords mirrored locally):
  python -m music_spectrogram_diffusion_tpu_torch.cli.train_vocoder \
      --model_dir /tmp/vocoder --dataset maestrov3 --data_root /mirror

Port of music_spectrogram_diffusion_tpu/cli/train_vocoder.py, with its
flags and defaults (and `--device`, default cuda). Reconstruction objective
by default (multi-resolution STFT + waveform L1); --adversarial adds the
SoundStream GAN losses (audio/vocoder_train.py); --arch magnitude_gl trains
the MagnitudeNet of the HybridGLVocoder instead (not with --adversarial).

Checkpoints are the port's (train/checkpoints.py): <model_dir>/step_<N>/
with the JAX CLI's config.json sidecar ({"arch", ...}), read by
`audio/vocoder.py load_trained` (and so by cli/synthesize_midi.py
--vocoder_checkpoint and cli/eval_vocoder.py --checkpoint); an adversarial
run keeps the discriminator and its optimizer in <model_dir>/disc/.
`--resume` continues from the latest checkpoint as the JAX CLI does: a
reconstruction run restores its parameters and optimizer state; an
adversarial run whose disc/ holds the same step restores the whole GAN
state; an adversarial run over a reconstruction checkpoint warm-starts the
generator only. `--dataset` reads a dataset's audio through the port's
`registry.audio_source`, which adds the 'audio' key; the JAX CLI reads
`ex['audio']` from JAX's, which lacks it, and raises KeyError there.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--model_dir", required=True)
  p.add_argument("--synthetic", action="store_true")
  p.add_argument("--dataset", default=None,
                 help="dataset config name (e.g. maestrov3); audio is "
                      "read from its TFRecords via --data_root")
  p.add_argument("--split", default=None,
                 help="dataset split (default: the train split)")
  p.add_argument("--data_root", default=None,
                 help="local mirror root for gs:// dataset paths")
  p.add_argument("--steps", type=int, default=1000)
  p.add_argument("--batch", type=int, default=8)
  p.add_argument("--segment_frames", type=int, default=64)
  p.add_argument("--base_channels", type=int, default=512)
  p.add_argument("--arch", default="soundstream",
                 choices=["soundstream", "magnitude_gl"],
                 help="'soundstream': end-to-end waveform decoder. "
                      "'magnitude_gl': MagnitudeNet mel->linear-"
                      "magnitude inversion served with Griffin-Lim "
                      "phase (HybridGLVocoder)")
  p.add_argument("--adversarial", action="store_true")
  p.add_argument("--learning_rate", type=float, default=1e-4)
  p.add_argument("--waveform_weight", type=float, default=None,
                 help="weight of the sample-exact waveform L1 term "
                      "(default: the trainer's 10.0); 0 trains on the "
                      "phase-invariant multi-resolution STFT loss only")
  p.add_argument("--log_period", type=int, default=50)
  p.add_argument("--checkpoint_period", type=int, default=500)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--resume", action="store_true",
                 help="continue from the latest checkpoint in "
                      "--model_dir (params + opt state; the data "
                      "stream restarts from its seed)")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (the default) or 'cpu'")
  args = p.parse_args(argv)
  if not args.synthetic and not args.dataset:
    p.error("pick an audio source: --synthetic or --dataset NAME")
  if args.arch == "magnitude_gl" and args.adversarial:
    p.error("--adversarial applies to --arch soundstream only")
  return p, args


def _resume(args, trainer, state):
  """The state restored from model_dir's latest checkpoint (JAX's three
  cases), and its step (0 when there is none)."""
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints
  latest = checkpoints.latest_checkpoint(args.model_dir)
  if latest is None:
    print(f"--resume: no checkpoint under {args.model_dir}, starting fresh")
    return state, 0
  restored = checkpoints.restore_checkpoint(latest, device=trainer.device)
  start_step = int(restored.get("step", 0))
  if args.adversarial:
    # A sibling disc checkpoint at the same step: an adversarial run
    # resumed whole (generator, discriminator and both optimizers). A
    # reconstruction checkpoint has none: the generator's weights only.
    disc_dir = os.path.join(args.model_dir, "disc")
    disc_latest = checkpoints.latest_checkpoint(disc_dir)
    if (disc_latest is not None and int(checkpoints.checkpoint_metadata(
        disc_latest).get("step", -1)) == start_step):
      d_restored = checkpoints.restore_checkpoint(disc_latest,
                                                  device=trainer.device)
      trainer.decoder.load_state_dict(restored["params"])
      trainer.disc.load_state_dict(d_restored["params"])
      state.g_opt_state = restored["opt_state"]
      state.d_opt_state = d_restored["opt_state"]
      print(f"restored adversarial state from {disc_latest}")
    else:
      trainer.decoder.load_state_dict(restored["params"])
  else:
    trainer.net.load_state_dict(restored["params"])
    state.step = start_step
    state.opt_state = restored.get("opt_state", state.opt_state)
  print(f"resumed from {latest} (step {start_step})")
  return state, start_step


def main(argv: Optional[Sequence[str]] = None):
  """Trains; returns the final state and the trainer (None, None when the
  checkpoint already reached --steps)."""
  p, args = parse_args(argv)
  import numpy as np

  from music_spectrogram_diffusion_tpu_torch.audio import (codecs, vocoder,
                                                           vocoder_train)
  from music_spectrogram_diffusion_tpu_torch.data import synthetic
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints

  codec = codecs.MelGan()
  ww = {} if args.waveform_weight is None else {
      "waveform_weight": args.waveform_weight}
  if args.arch == "magnitude_gl":
    trainer = vocoder_train.MagnitudeTrainer(
        vocoder.MagnitudeNet(), codec, learning_rate=args.learning_rate,
        device=args.device)
    arch_config = {"arch": "magnitude_gl", "hidden": 512}
  else:
    decoder = vocoder.SoundStreamDecoder(
        vocoder.SoundStreamConfig(base_channels=args.base_channels))
    arch_config = {"arch": "soundstream",
                   "base_channels": args.base_channels}
    if args.adversarial:
      trainer = vocoder_train.AdversarialVocoderTrainer(
          decoder, codec, g_learning_rate=args.learning_rate,
          device=args.device, **ww)
    else:
      trainer = vocoder_train.VocoderTrainer(
          decoder, codec, learning_rate=args.learning_rate,
          device=args.device, **ww)
  state = trainer.create_state(args.seed)

  start_step = 0
  if args.resume:
    state, start_step = _resume(args, trainer, state)
  if start_step >= args.steps:
    print(f"checkpoint step {start_step} >= --steps {args.steps}; "
          "nothing to do")
    return None, None

  if args.synthetic:
    def clips():
      rng = np.random.RandomState(args.seed)
      while True:
        ns = synthetic.random_note_sequence(rng, duration=6.0)
        yield synthetic.render_note_sequence(ns, codec.sample_rate,
                                             duration=6.0)
  else:
    # The per-dataset tokenizers own the audio decode and resample rules;
    # the vocoder takes the 16 kHz 'audio' the port's audio_source adds.
    from music_spectrogram_diffusion_tpu_torch.data import registry
    try:
      source = registry.audio_source(args.dataset, args.split, codec,
                                     data_root=args.data_root)
    except ValueError as e:
      p.error(str(e))
    print(f"audio source: {args.dataset}/"
          f"{args.split or 'train split'}")

    def clips():
      while True:
        for ex in source:
          yield np.asarray(ex["audio"], np.float32)

  batches = vocoder_train.vocoder_batches(
      clips(), codec, segment_frames=args.segment_frames,
      batch_size=args.batch, seed=args.seed)
  # Host-side clip rendering and the mel encode overlap the device step.
  batches = vocoder_train.prefetch(batches, depth=4)

  os.makedirs(args.model_dir, exist_ok=True)
  log = open(os.path.join(args.model_dir, "metrics.jsonl"), "a")
  t0 = time.time()
  last_logged = start_step
  for step, (mel, audio) in enumerate(
      itertools.islice(batches, args.steps - start_step),
      start=start_step + 1):
    state, metrics = trainer.train_step(state, mel, audio)
    if step % args.log_period == 0 or step == args.steps:
      window = step - last_logged  # the last window may be short
      payload = {"step": step,
                 **{k: float(v) for k, v in metrics.items()},
                 "steps_per_second": window / max(time.time() - t0, 1e-9)}
      t0 = time.time()
      last_logged = step
      log.write(json.dumps(payload) + "\n")
      log.flush()
      print(" ".join(f"{k}={v:.5g}" for k, v in payload.items()))
    if step % args.checkpoint_period == 0 or step == args.steps:
      if args.adversarial:
        params, opt_state = trainer.decoder.state_dict(), state.g_opt_state
      else:
        params, opt_state = trainer.net.state_dict(), state.opt_state
      path = checkpoints.save_checkpoint(
          args.model_dir, step, params, opt_state=opt_state,
          config_json=json.dumps(arch_config))
      if args.adversarial:
        # The full GAN state: the discriminator and its optimizer in a
        # sibling directory, so a restart resumes the adversarial game.
        checkpoints.save_checkpoint(
            os.path.join(args.model_dir, "disc"), step,
            trainer.disc.state_dict(), opt_state=state.d_opt_state)
      print(f"saved {path}")
  log.close()
  return state, trainer


if __name__ == "__main__":
  main()
