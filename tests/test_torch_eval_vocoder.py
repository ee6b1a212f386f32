"""`cli/eval_vocoder.py --synthetic` of the port against the JAX package's
CLI: the same held-out clips, vocoders and metrics, 2 short clips, with
the repo's trained vocoder: the JAX CLI restores it from an orbax
checkpoint saved from the committed export's weights, the port reads the
export. Every metric within 1e-3 relative and SNR within 0.01 dB (float32
FFTs and convs in two libraries), but griffin_lim_zero's within 1e-2
relative: Griffin-Lim from a zero phase is ill-conditioned
(tests/test_torch_stft.py), and its log-magnitude and mel round trip
differ by 1.9e-3 and 3.0e-3 relative here (measured).
"""

import json
import sys

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu.cli import eval_vocoder as jax_cli
from music_spectrogram_diffusion_tpu.train import checkpoints as jax_ckpt
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.cli import eval_vocoder

ARGS = ["--synthetic", "--clips", "2", "--clip_seconds", "1.0",
        "--griffin_lim_iters", "4", "--seed", "1000"]


def test_eval_vocoder_report_matches_jax(tmp_path, monkeypatch):
  params, config_json, step = convert.read_export(
      vocoder.TRAINED_MAGNITUDE_GL)
  model_dir = str(tmp_path / "voc")
  jax_ckpt.save_checkpoint(model_dir, step, params, config_json=config_json)
  npz = vocoder.TRAINED_MAGNITUDE_GL

  jax_out = str(tmp_path / "jax.json")
  monkeypatch.setattr(sys, "argv", ["eval_vocoder", "--checkpoint",
                                    model_dir, "--output", jax_out] + ARGS)
  jax_cli.main()
  want = json.load(open(jax_out))
  port_out = str(tmp_path / "port.json")
  got = eval_vocoder.main(["--checkpoint", npz, "--output", port_out,
                           "--device", "cpu"] + ARGS)
  assert json.load(open(port_out)) == got
  assert {k: got[k] for k in ("clips", "clip_seconds", "seed")} == {
      "clips": 2, "clip_seconds": 1.0, "seed": 1000}
  assert {k: want[k] for k in ("clips", "clip_seconds", "seed")} == {
      k: got[k] for k in ("clips", "clip_seconds", "seed")}
  assert list(got["methods"]) == list(want["methods"]) == [
      "griffin_lim", "griffin_lim_zero", "trained"]
  for name, metrics in want["methods"].items():
    assert list(got["methods"][name]) == list(metrics)
    for key, value in metrics.items():
      rel = 1e-2 if name == "griffin_lim_zero" else 1e-3
      tol = 0.01 if key == "snr_db" else rel * abs(value)
      assert abs(got["methods"][name][key] - value) <= tol, (name, key)
  assert set(got["trained_vs_griffin_lim"]) == set(
      want["trained_vs_griffin_lim"])


def test_eval_vocoder_sources():
  with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
    eval_vocoder.parse_args(["--dataset", "maestro"])
  with pytest.raises(SystemExit):
    eval_vocoder.parse_args([])
  args = eval_vocoder.parse_args(["--synthetic"])
  assert (args.device, args.clips, args.seed, args.phase_init) == (
      "cuda", 16, 1000, "pghi")


def test_synthetic_clips_are_the_jax_clis(monkeypatch):
  """The same RandomState stream: the clips equal the JAX package's."""
  from music_spectrogram_diffusion_tpu.data import synthetic
  rng = np.random.RandomState(1000)
  want = []
  while len(want) < 2:
    ns = synthetic.random_note_sequence(rng, duration=2.0)
    want.append(synthetic.render_note_sequence(ns, 16000,
                                               duration=2.0)[:16000])
  got = eval_vocoder.synthetic_clips(1000, 2, 1.0, 16000, 16000)
  np.testing.assert_array_equal(got, np.stack(want))
