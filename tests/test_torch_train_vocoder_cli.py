"""cli/train_vocoder.py on the CPU, at tiny widths: the JAX CLI's resume
cases (tests/test_vocoder_train.py's: a reconstruction run resumed, an
adversarial warm start from it, then an adversarial run resumed whole),
the refusal of --adversarial with magnitude_gl, the checkpoints served by
`load_trained` (and scored by cli/eval_vocoder.py), and --dataset, which trains on the port where the JAX
CLI raises KeyError: 'audio'.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.cli import train_vocoder
from music_spectrogram_diffusion_tpu_torch.data import dataset_records
from music_spectrogram_diffusion_tpu_torch.train import checkpoints
# clean_registries and no_gcs_backend are autouse fixtures.
from torch_data_parity import clean_registries, no_gcs_backend  # noqa: F401


def _argv(model_dir, *extra):
  return ["--model_dir", model_dir, "--synthetic", "--batch", "1",
          "--segment_frames", "8", "--base_channels", "16", "--log_period",
          "1", "--checkpoint_period", "2", "--device", "cpu", *extra]


def test_resume_reconstruction(tmp_path, capsys):
  model_dir = str(tmp_path / "voc")
  train_vocoder.main(_argv(model_dir, "--steps", "2"))
  first = checkpoints.latest_checkpoint(model_dir)
  assert first.endswith("step_2")
  assert json.load(open(os.path.join(first, "config.json"))) == {
      "arch": "soundstream", "base_channels": 16}
  p2 = checkpoints.restore_checkpoint(first)
  assert p2["opt_state"]["count"] == 2

  state, trainer = train_vocoder.main(_argv(model_dir, "--steps", "4",
                                            "--resume"))
  out = capsys.readouterr().out
  assert "resumed from" in out and "step 2" in out
  assert state.step == 4 and state.opt_state["count"] == 4
  latest = checkpoints.latest_checkpoint(model_dir)
  assert latest.endswith("step_4")
  assert checkpoints.checkpoint_metadata(latest)["has_opt_state"]
  lines = [json.loads(l) for l in open(os.path.join(model_dir,
                                                    "metrics.jsonl"))]
  assert [m["step"] for m in lines] == [1, 2, 3, 4]
  assert all(np.isfinite(m["loss"]) for m in lines)

  # A third invocation with --steps already reached is a no-op.
  assert train_vocoder.main(_argv(model_dir, "--steps", "4",
                                  "--resume")) == (None, None)
  assert "nothing to do" in capsys.readouterr().out

  # The checkpoint serves, from the model dir (the latest) or a step.
  voc = vocoder.load_trained(model_dir, device="cpu")
  assert isinstance(voc, vocoder.SoundStreamVocoder)
  restored = checkpoints.restore_checkpoint(latest)["params"]
  for name, value in voc.decoder.state_dict().items():
    assert torch.equal(value, restored[name]), name
  audio = voc(torch.zeros(1, 4, 128))
  assert tuple(audio.shape) == (1, 4 * 320)


def test_adversarial_warm_start_then_full_restore(tmp_path, capsys):
  model_dir = str(tmp_path / "gan")
  train_vocoder.main(_argv(model_dir, "--steps", "2"))
  recon = checkpoints.restore_checkpoint(os.path.join(model_dir, "step_2"))
  # Adversarial leg 1: the generator warm-starts from the recon checkpoint.
  state, trainer = train_vocoder.main(_argv(
      model_dir, "--steps", "4", "--adversarial", "--resume",
      "--waveform_weight", "0"))
  out = capsys.readouterr().out
  assert "resumed from" in out
  assert "restored adversarial state" not in out  # recon warm start
  assert state.g_opt_state["count"] == 2  # a fresh optimizer, 2 steps
  disc = checkpoints.latest_checkpoint(os.path.join(model_dir, "disc"))
  assert disc is not None and disc.endswith("step_4")
  d4 = checkpoints.restore_checkpoint(disc)

  # Leg 2, the restart: the whole GAN state restored.
  state, trainer = train_vocoder.main(_argv(
      model_dir, "--steps", "6", "--adversarial", "--resume",
      "--waveform_weight", "0"))
  out = capsys.readouterr().out
  assert "restored adversarial state" in out
  assert state.g_opt_state["count"] == 4 and state.d_opt_state["count"] == 4
  disc6 = checkpoints.latest_checkpoint(os.path.join(model_dir, "disc"))
  assert disc6.endswith("step_6")
  d6 = checkpoints.restore_checkpoint(disc6)["params"]
  # The discriminator continued training from its step-4 weights.
  assert any(not torch.equal(d4["params"][k], d6[k]) for k in d6)
  assert set(d6) == set(trainer.disc.state_dict())
  g6 = checkpoints.restore_checkpoint(os.path.join(model_dir, "step_6"))
  assert set(g6["params"]) == set(recon["params"])
  lines = [json.loads(l) for l in open(os.path.join(model_dir,
                                                    "metrics.jsonl"))]
  adversarial = [m for m in lines if "d_loss" in m]
  assert [m["step"] for m in adversarial] == [3, 4, 5, 6]
  for m in adversarial:
    for k in ("g_loss", "d_loss", "adv", "feature_matching"):
      assert np.isfinite(m[k]), (m["step"], k)
  assert isinstance(vocoder.load_trained(model_dir, device="cpu"),
                    vocoder.SoundStreamVocoder)


def test_magnitude_gl_trains_and_serves(tmp_path):
  model_dir = str(tmp_path / "mag")
  state, trainer = train_vocoder.main(_argv(model_dir, "--steps", "2",
                                            "--arch", "magnitude_gl"))
  assert state.step == 2
  step_dir = os.path.join(model_dir, "step_2")
  assert json.load(open(os.path.join(step_dir, "config.json"))) == {
      "arch": "magnitude_gl", "hidden": 512}
  voc = vocoder.load_trained(step_dir, num_iters=2, device="cpu")
  assert isinstance(voc, vocoder.HybridGLVocoder)
  for name, value in voc.net.state_dict().items():
    assert torch.equal(value, trainer.net.state_dict()[name]), name
  audio = voc(torch.full((1, 6, 128), -4.0))
  assert tuple(audio.shape) == (1, 6 * 320) and torch.isfinite(audio).all()


def test_eval_vocoder_scores_a_checkpoint_of_the_cli(tmp_path):
  from music_spectrogram_diffusion_tpu_torch.cli import eval_vocoder
  model_dir = str(tmp_path / "mag")
  train_vocoder.main(_argv(model_dir, "--steps", "1", "--arch",
                           "magnitude_gl"))
  report = eval_vocoder.main(["--checkpoint", model_dir, "--synthetic",
                              "--clips", "2", "--clip_seconds", "1.0",
                              "--griffin_lim_iters", "2", "--device",
                              "cpu"])
  for k, v in report["methods"]["trained"].items():
    assert np.isfinite(v), k


def test_unknown_arch_raises(tmp_path):
  model_dir = str(tmp_path / "odd")
  train_vocoder.main(_argv(model_dir, "--steps", "1"))
  with open(os.path.join(model_dir, "step_1", "config.json"), "w") as f:
    json.dump({"arch": "hifigan"}, f)
  with pytest.raises(ValueError, match="unknown vocoder arch 'hifigan'"):
    vocoder.load_trained(model_dir, device="cpu")


def test_flags_and_refusals(tmp_path):
  with pytest.raises(SystemExit):
    train_vocoder.parse_args(_argv(str(tmp_path), "--arch", "magnitude_gl",
                                   "--adversarial"))
  with pytest.raises(SystemExit):
    train_vocoder.parse_args(["--model_dir", str(tmp_path)])  # no source
  _, args = train_vocoder.parse_args(["--model_dir", str(tmp_path),
                                      "--synthetic"])
  assert {k: getattr(args, k) for k in (
      "steps", "batch", "segment_frames", "base_channels", "arch",
      "adversarial", "learning_rate", "waveform_weight", "log_period",
      "checkpoint_period", "seed", "resume", "device")} == {
          "steps": 1000, "batch": 8, "segment_frames": 64,
          "base_channels": 512, "arch": "soundstream", "adversarial": False,
          "learning_rate": 1e-4, "waveform_weight": None, "log_period": 50,
          "checkpoint_period": 500, "seed": 0, "resume": False,
          "device": "cuda"}


@pytest.fixture(scope="module")
def maestro_records(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("mirror"))
  dataset_records.write_split(root, "maestrov3", "train", [1, 2], 2.0)
  return root


def test_dataset_trains_on_the_port_where_the_jax_cli_raises(
    tmp_path, maestro_records, monkeypatch):
  """JAX's registry.audio_source hands on examples without an 'audio' key
  (data/registry.py:76), so the JAX CLI's ex['audio'] raises KeyError on
  every record; the port's audio_source adds it, so its CLI trains."""
  model_dir = str(tmp_path / "dataset")
  argv = ["--model_dir", model_dir, "--dataset", "maestrov3",
          "--data_root", maestro_records, "--batch", "1",
          "--segment_frames", "8", "--base_channels", "16", "--steps", "2",
          "--log_period", "1"]
  state, _ = train_vocoder.main(argv + ["--device", "cpu"])
  assert state.step == 2
  lines = [json.loads(l) for l in open(os.path.join(model_dir,
                                                    "metrics.jsonl"))]
  assert [m["step"] for m in lines] == [1, 2]
  assert all(np.isfinite(m["loss"]) for m in lines)

  from music_spectrogram_diffusion_tpu.cli import (
      train_vocoder as jax_train_vocoder)
  monkeypatch.setattr(sys, "argv", ["train_vocoder", "--model_dir",
                                    str(tmp_path / "jax")] + argv[2:])
  with pytest.raises(KeyError, match="audio"):
    jax_train_vocoder.main()
