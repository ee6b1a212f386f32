"""The port's CLIs on the dataset pipeline, on the CPU at context_tiny, on
records in every published schema that the test writes: cli/train.py
--dataset (with its held-out eval set) and --dataset mega after
cli/cache_task.py --dataset all (reading the caches), cli/eval_vocoder.py
--dataset, and cli/dump_task.py with --dataset, --task and --full_song
against the JAX CLI's output."""

import json
import os
import sys
import unittest.mock

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu_torch.cli import cache_task
from music_spectrogram_diffusion_tpu_torch.cli import dump_task
from music_spectrogram_diffusion_tpu_torch.cli import eval_vocoder
from music_spectrogram_diffusion_tpu_torch.cli import train as train_cli
from music_spectrogram_diffusion_tpu_torch.data import cache
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import tasks
# clean_registries and no_gcs_backend are autouse fixtures.
from torch_data_parity import (  # noqa: F401
    clean_registries, no_gcs_backend, write_mirror)


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
  return write_mirror(tmp_path_factory.mktemp("mirror"))


def _train_argv(model_dir, mirror, *extra):
  return ["--preset", "context_tiny", "--model_dir", str(model_dir),
          "--data_root", mirror, "--steps", "2", "--batch", "2",
          "--log_period", "1", "--shuffle_buffer", "4", "--data_threads",
          "2", "--device", "cpu", *extra]


def _metrics(model_dir):
  with open(os.path.join(model_dir, "metrics.jsonl")) as f:
    return [json.loads(line) for line in f]


def test_train_on_a_dataset_with_its_eval_split(tmp_path, mirror, capsys):
  """--dataset maestrov3: the train split's task, and the held-out eval
  set from the validation_subset split at seed 1, as JAX's."""
  evals = []
  real_task = tasks.Task.model_dataset

  def seen(self, lengths, training=True, seed=0, **kw):
    evals.append((self.name, seed))
    return real_task(self, lengths, training=training, seed=seed, **kw)

  with unittest.mock.patch.object(tasks.Task, "model_dataset", seen):
    state, _ = train_cli.main(_train_argv(
        tmp_path, mirror, "--dataset", "maestrov3", "--eval_batches", "1",
        "--eval_period", "2"))
  assert state.step == 2
  assert "(no cache: tokenizing online" in capsys.readouterr().out
  assert evals == [
      ("synthesis_with_context_maestrov3_notes_ties_melgan_vb1_train", 0),
      ("synthesis_with_context_maestrov3_notes_ties_melgan_vb1_"
       "validation_subset", 1)]
  lines = _metrics(tmp_path)
  assert [m["step"] for m in lines if "loss" in m] == [1, 2]
  assert all(np.isfinite(m["loss"]) for m in lines if "loss" in m)
  assert [np.isfinite(m["eval/loss"]) for m in lines
          if "eval/loss" in m] == [True]


def test_cache_all_then_train_on_the_mega_mixture(tmp_path, mirror, capsys,
                                                  monkeypatch):
  """cli/cache_task.py --dataset all caches the six mixture datasets; the
  mega mixture then trains from those caches (no eval set, as JAX)."""
  cache_root = str(tmp_path / "cache")
  built = cache_task.main(["--dataset", "all", "--data_root", mirror,
                           "--cache_root", cache_root,
                           "--examples_per_shard", "1"])
  assert len(built) == 6 and all(m["num_examples"] == 2 for m in built)
  names = sorted(os.listdir(cache_root))
  assert names == sorted(os.path.basename(m["cache_dir"]) for m in built)
  assert all(n.endswith("_notes_ties_melgan_vb1_train") for n in names)
  reads, real_read = [], cache.read_cache

  def counted_read(cache_dir):
    reads.append(os.path.basename(cache_dir))
    return real_read(cache_dir)

  monkeypatch.setattr(cache, "read_cache", counted_read)
  # The raw records are never read once the caches exist.
  monkeypatch.setattr(datasets, "tfrecord_source", None)
  model_dir = tmp_path / "run"
  state, _ = train_cli.main(_train_argv(
      model_dir, mirror, "--dataset", "mega", "--cache_root", cache_root,
      "--eval_batches", "1"))
  out = capsys.readouterr().out
  assert state.step == 2
  assert "mixture: synthesis_with_context_mega over 6 tasks" in out
  assert "no held-out eval for the mega mixture" in out
  assert set(reads) <= set(names) and len(reads) >= 2
  lines = _metrics(model_dir)
  assert [m["step"] for m in lines] == [1, 2]
  assert all(np.isfinite(m["loss"]) for m in lines)
  with pytest.raises(SystemExit):
    cache_task.main(["--dataset", "maestro", "--cache_root", cache_root])


def test_train_without_records_raises(tmp_path):
  """A missing shard raises; no synthetic data stands in."""
  with pytest.raises(FileNotFoundError, match="no files match"):
    train_cli.main(_train_argv(tmp_path / "run", str(tmp_path / "empty"),
                               "--dataset", "guitarset"))


def test_eval_vocoder_on_dataset_audio(tmp_path, mirror):
  """--dataset maestrov3 --split validation_subset: the clips are the first
  clip_seconds of each song (JAX's audio_source examples' frames: JAX's
  CLI reads an 'audio' key they lack), and every metric is finite."""
  from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
  from music_spectrogram_diffusion_tpu.data import registry as jax_registry
  from music_spectrogram_diffusion_tpu_torch.audio import codecs, vocoder
  argv = ["--dataset", "maestrov3", "--split", "validation_subset",
          "--data_root", mirror, "--clips", "2", "--clip_seconds", "1.0",
          "--griffin_lim_iters", "2", "--checkpoint",
          vocoder.TRAINED_MAGNITUDE_GL, "--device", "cpu", "--output",
          str(tmp_path / "report.json")]
  report = eval_vocoder.main(argv)
  assert report["clips"] == 2
  assert list(report["methods"]) == ["griffin_lim", "griffin_lim_zero",
                                     "trained"]
  for metrics in report["methods"].values():
    assert all(np.isfinite(v) for v in metrics.values())
  clips = eval_vocoder.dataset_clips(eval_vocoder.parse_args(argv),
                                     codecs.MelGan(), 16000)
  want = [ex["inputs"].reshape(-1)[:16000]
          for ex in jax_registry.audio_source(
              "maestrov3", "validation_subset", jax_codecs.MelGan(),
              data_root=mirror, is_training=False)]
  np.testing.assert_array_equal(clips, np.stack(want[:2]))


def _jax_dump(argv, monkeypatch, capsys):
  from music_spectrogram_diffusion_tpu.cli import dump_task as jax_dump
  monkeypatch.setattr(sys, "argv", ["dump_task"] + argv)
  jax_dump.main()
  return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--dataset", "urmp", "--split", "train", "--decode_events"],
    ["--dataset", "slakh", "--split", "validation", "--full_song",
     "--decode_events"],
    ["--dataset", "maestrov3", "--split", "validation", "--velocity_bins",
     "127", "--full_song"],
    ["--task", "synthesis_with_context_cerberus4_notes_ties_melgan_vb1_"
               "validation", "--full_song", "--decode_events"],
    ["--synthetic", "--decode_events"],
])
def test_dump_task_prints_what_the_jax_cli_prints(flags, mirror, monkeypatch,
                                                  capsys):
  argv = flags + ["--data_root", mirror, "--n", "2", "--targets_length",
                  "64"]
  dump_task.main(argv)
  got = capsys.readouterr().out
  tasks.TASK_REGISTRY.clear()
  tasks.MIXTURE_REGISTRY.clear()
  want = _jax_dump(argv, monkeypatch, capsys)
  assert got == want
  assert got.count("--- example") == 2
  if "--decode_events" in flags:
    assert "decoded:" in got


def test_dump_task_refuses_unknown_names(mirror):
  for argv in (["--dataset", "maestro"], ["--task", "nope", "--data_root",
                                          mirror], []):
    with pytest.raises(SystemExit):
      dump_task.main(argv)
