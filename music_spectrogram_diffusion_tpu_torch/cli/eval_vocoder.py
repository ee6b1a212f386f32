"""Evaluate mel-inversion quality with the PyTorch port: trained vocoder vs
Griffin-Lim.

  python -m music_spectrogram_diffusion_tpu_torch.cli.eval_vocoder \
      --checkpoint music_spectrogram_diffusion_tpu_torch/assets/magnitude_gl_step4000.npz \
      --synthetic --clips 16 --seed 1000 [--output results.json] \
      [--device cpu]

Port of music_spectrogram_diffusion_tpu/cli/eval_vocoder.py: held-out
synthetic clips (the same clips: `np.random.RandomState(seed)`,
`random_note_sequence`, `render_note_sequence`) are encoded to log-mel,
inverted by each vocoder, and scored against the ground-truth audio with
the multi-resolution STFT loss (`audio/vocoder_train.py stft_loss`), the
mel round-trip L2 (re-encode and compare) and the time-domain SNR.
Griffin-Lim is always scored; `--checkpoint` (a vocoder exported to .npz
by tools/export_jax_checkpoint.py) adds `trained`. `--dataset` is not
ported (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--checkpoint", default=None,
                 help="a trained vocoder exported to .npz "
                      "(tools/export_jax_checkpoint.py); omit to score only "
                      "the Griffin-Lim baseline")
  p.add_argument("--base_channels", type=int, default=512)
  p.add_argument("--synthetic", action="store_true")
  p.add_argument("--dataset", default=None,
                 help="not ported (ROADMAP queue 1, item 5)")
  p.add_argument("--clips", type=int, default=16)
  p.add_argument("--clip_seconds", type=float, default=4.0)
  p.add_argument("--seed", type=int, default=1000,
                 help="held-out generator seed")
  p.add_argument("--griffin_lim_iters", type=int, default=32)
  p.add_argument("--gl_momentum", type=float, default=None,
                 help="FGLA extrapolation factor; default: each vocoder's "
                      "own (trained chain 0.9, pinv chain 0)")
  p.add_argument("--phase_init", default="pghi", choices=["pghi", "zero"],
                 help="Griffin-Lim phase initializer; with pghi the "
                      "zero-init baseline is also scored as griffin_lim_zero")
  p.add_argument("--batch", type=int, default=4)
  p.add_argument("--output", default=None, help="write metrics JSON here")
  p.add_argument("--wav_dir", default=None,
                 help="write reference + per-method reconstruction WAVs")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default) or 'cpu'")
  args = p.parse_args(argv)
  if args.dataset:
    raise NotImplementedError(
        "--dataset: the dataset pipeline is not ported yet (ROADMAP queue 1,"
        " item 5); use --synthetic")
  if not args.synthetic:
    p.error("pick an audio source: --synthetic")
  return args


def synthetic_clips(seed: int, clips: int, clip_seconds: float,
                    sample_rate: int, seg_samples: int) -> np.ndarray:
  """The JAX CLI's held-out clips: [clips, seg_samples] float32."""
  from music_spectrogram_diffusion_tpu_torch.data import synthetic
  rng = np.random.RandomState(seed)
  out = []
  while len(out) < clips:
    ns = synthetic.random_note_sequence(rng, duration=clip_seconds + 1.0)
    clip = synthetic.render_note_sequence(ns, sample_rate,
                                          duration=clip_seconds + 1.0)
    if len(clip) >= seg_samples:
      out.append(clip[:seg_samples])
  return np.stack(out)


def vocoders(args: argparse.Namespace) -> Dict[str, object]:
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder
  mom = {} if args.gl_momentum is None else {"momentum": args.gl_momentum}
  out = {"griffin_lim": vocoder.GriffinLimVocoder(
      num_iters=args.griffin_lim_iters, phase_init=args.phase_init,
      device=args.device, **mom)}
  if args.phase_init == "pghi":
    out["griffin_lim_zero"] = vocoder.GriffinLimVocoder(
        num_iters=args.griffin_lim_iters, phase_init="zero",
        device=args.device, **mom)
  if args.checkpoint:
    out["trained"] = vocoder.load_trained(
        args.checkpoint, base_channels=args.base_channels,
        num_iters=args.griffin_lim_iters, phase_init=args.phase_init,
        device=args.device, **mom)
  return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
  from music_spectrogram_diffusion_tpu_torch.audio import codecs
  from music_spectrogram_diffusion_tpu_torch.audio import vocoder_train
  from music_spectrogram_diffusion_tpu_torch.audio import wav_io

  args = parse_args(argv)
  codec = codecs.MelGan()
  seg_frames = int(args.clip_seconds * codec.sample_rate) // codec.hop_size
  seg_samples = seg_frames * codec.hop_size
  audio = synthetic_clips(args.seed, args.clips, args.clip_seconds,
                          codec.sample_rate, seg_samples)
  mel = codec.encode_np(audio)[:, :seg_frames]  # [N, frames, 128]
  methods = vocoders(args)
  device = next(iter(methods.values())).device
  target = torch.as_tensor(audio, device=device)

  report = {"clips": len(audio), "clip_seconds": args.clip_seconds,
            "seed": args.seed, "methods": {}}
  for name, voc in methods.items():
    recon = np.concatenate([
        voc(torch.as_tensor(mel[i:i + args.batch])).cpu().numpy()[
            :, :seg_samples]
        for i in range(0, len(audio), args.batch)])
    with torch.inference_mode():
      spec = {k: float(v) for k, v in sorted(vocoder_train.stft_loss(
          torch.as_tensor(recon, device=device), target).items())}
    mel_rt = codec.encode_np(recon)[:, :seg_frames]
    mel_l2 = float(np.sqrt(np.mean((mel_rt - mel) ** 2)))
    # Griffin-Lim invents phase, so its SNR is ~0 dB or below by design.
    noise = audio - recon
    snr_db = float(10 * np.log10(
        (np.sum(audio ** 2) + 1e-9) / (np.sum(noise ** 2) + 1e-9)))
    report["methods"][name] = {**spec, "mel_roundtrip_l2": mel_l2,
                               "snr_db": snr_db}
    if args.wav_dir:
      os.makedirs(args.wav_dir, exist_ok=True)
      for i in range(min(len(audio), 4)):
        wav_io.write_wav(os.path.join(args.wav_dir, f"clip{i}_{name}.wav"),
                         recon[i], codec.sample_rate)
        ref_path = os.path.join(args.wav_dir, f"clip{i}_ref.wav")
        if not os.path.exists(ref_path):
          wav_io.write_wav(ref_path, audio[i], codec.sample_rate)
    print(f"{name}: " + " ".join(
        f"{k}={v:.4f}" for k, v in report["methods"][name].items()))

  if "trained" in report["methods"]:
    g = report["methods"]["griffin_lim"]
    t = report["methods"]["trained"]
    # Lower is better for every key but snr_db; its sign is flipped so
    # that "negative = trained better" holds for every key.
    report["trained_vs_griffin_lim"] = {
        k: ((g[k] - t[k]) if k == "snr_db" else (t[k] - g[k]))
        / max(abs(g[k]), 1e-9) for k in g}
    print("relative delta (negative = trained better): " + " ".join(
        f"{k}={v:+.1%}" for k, v in
        report["trained_vs_griffin_lim"].items()))

  if args.output:
    with open(args.output, "w") as f:
      json.dump(report, f, indent=2)
    print(f"wrote {args.output}")
  return report


if __name__ == "__main__":
  main()
