"""cli/distill.py on the CPU: one round from a tiny teacher checkpoint of
cli/train.py, served afterwards by `load_checkpoint` with DDIM at half the
teacher's steps and one decoder forward a step; JAX's flags and defaults;
--mesh refused; a missing teacher raises.
"""

import json
import os

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu_torch.cli import distill as distill_cli
from music_spectrogram_diffusion_tpu_torch.cli import train as train_cli
from music_spectrogram_diffusion_tpu_torch.infer import inference


@pytest.fixture(scope="module")
def tiny_teacher(tmp_path_factory):
  model_dir = str(tmp_path_factory.mktemp("teacher"))
  train_cli.main(["--synthetic", "--preset", "context_tiny", "--model_dir",
                  model_dir, "--batch", "2", "--synthetic_examples", "2",
                  "--steps", "1", "--log_period", "1", "--device", "cpu"])
  return model_dir


def test_cli_distills_a_round_and_the_student_serves_ddim_single_forward(
    tiny_teacher, tmp_path):
  out = str(tmp_path / "distilled")
  summaries = distill_cli.main([
      "--teacher", tiny_teacher, "--model_dir", out, "--rounds", "1",
      "--steps_per_round", "2", "--batch", "2", "--synthetic",
      "--synthetic_examples", "2", "--data_threads", "1", "--log_period",
      "1", "--device", "cpu"])
  assert [s["round"] for s in summaries] == [0]
  assert summaries[0]["teacher_steps"] == 1000
  assert summaries[0]["student_steps"] == 500
  assert summaries[0]["steps"] == 2 and summaries[0]["peak_gib"] is None
  round_dir = os.path.join(out, "round_0")
  lines = [json.loads(l) for l in open(os.path.join(round_dir,
                                                    "metrics.jsonl"))]
  assert [m["step"] for m in lines] == [1, 2]
  assert all(np.isfinite(m["loss"]) for m in lines)

  served = inference.load_checkpoint(round_dir, device="cpu")
  sampler = served.experiment.diffusion.sampler
  assert (sampler.name, sampler.num_steps) == ("ddim", 500)
  assert served.experiment.diffusion.guidance.eval_condition_weight == 1.0
  # One decoder forward of the batch's rows a step, no CFG pair: checked
  # over 10 of its DDIM steps on the CPU (chip_smoke phase 29 renders the
  # next round's student at its full 250).
  served = inference.load_checkpoint(round_dir, device="cpu",
                                     sampler_steps=10)
  module = served.model.module
  rows, decode = [], module.decode
  module.decode = lambda enc, z, *a, **k: (
      rows.append(z.shape[0]) or decode(enc, z, *a, **k))
  tl = served.experiment.task_lengths
  r = np.random.RandomState(2)
  mel = served.predict({
      "encoder_input_tokens": r.randint(1, 200, (1, tl.inputs)),
      "encoder_continuous_inputs": np.zeros((1, tl.targets_context, 128),
                                            np.float32),
      "encoder_continuous_mask": np.zeros((1, tl.targets_context), bool),
      "decoder_target_tokens": np.zeros((1, tl.targets, 128), np.float32)},
      seed=0)
  assert mel.shape == (1, tl.targets, 128) and np.isfinite(mel).all()
  assert rows == [1] * 10


def test_cli_refuses_mesh_and_a_missing_teacher(tmp_path):
  argv = ["--teacher", str(tmp_path), "--model_dir", str(tmp_path / "o"),
          "--synthetic"]
  # --mesh is DATAxMODEL, and a mesh larger than the processes raises.
  with pytest.raises(SystemExit):
    distill_cli.parse_args(argv + ["--device", "cpu", "--mesh", "4"])
  assert distill_cli.parse_args(argv + ["--mesh", "4x2"]).mesh == "4x2"
  with pytest.raises(ValueError, match="mesh 4x2 != 1 devices"):
    distill_cli.main(argv + ["--device", "cpu", "--mesh", "4x2"])
  defaults = vars(distill_cli.parse_args(argv))
  assert {k: defaults[k] for k in (
      "rounds", "steps_per_round", "batch", "synthetic_examples",
      "data_threads", "dataset", "learning_rate", "warmup_steps",
      "guidance_weight", "log_period", "seed", "device", "mesh")} == {
          "rounds": 2, "steps_per_round": 10_000, "batch": None,
          "synthetic_examples": 64, "data_threads": 8,
          "dataset": "maestrov3", "learning_rate": 1e-4,
          "warmup_steps": 100, "guidance_weight": None, "log_period": 100,
          "seed": 0, "device": "cuda", "mesh": None}
  with pytest.raises(FileNotFoundError, match="no teacher"):
    distill_cli.main(["--teacher", str(tmp_path / "none"), "--model_dir",
                      str(tmp_path / "o"), "--synthetic", "--device",
                      "cpu"])
