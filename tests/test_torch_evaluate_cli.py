"""cli/evaluate.py and cli/merge_eval.py of the port on the CPU at
context_tiny (random weights, 2 sampler steps, 2 synthetic songs).

* each prediction source runs and reports finite mel metrics and the mel
  FAD; `gt_encoded` scores the ground truth against itself (0 exactly);
* `evaluate.score` gives main's per-song results without the aggregate
  and the files;
* two shards, merged by cli/merge_eval.py: exactly the JAX package's
  `merge_shard_outputs` of the same shard files, and the same per-song
  metrics as the unsharded run;
* an unknown dataset and a missing --vggish_weights are JAX's usage
  errors (exit 2, its messages);
* the entry points refuse a missing card instead of moving to the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl

from music_spectrogram_diffusion_tpu_torch.cli import evaluate, merge_eval
from music_spectrogram_diffusion_tpu_torch.infer import (postprocessors,
                                                         transcription)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--synthetic", "--preset", "context_tiny", "--songs", "2",
        "--steps", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_blas_thread():
  """One BLAS thread for scipy's sqrtm on these small matrices: several
  threads per test worker fight the other workers for the cores (the
  committed merge took 22 s with them against 2.5 s without, on 8 cores,
  to the same bits)."""
  with threadpoolctl.threadpool_limits(1, user_api="blas"):
    yield


def _run(argv):
  before = (dict(postprocessors.EMBEDDING_MODELS),
            transcription.get_transcriber())
  out = evaluate.main(BASE + argv)
  # The CLI leaves the scorer registries as it found them.
  assert dict(postprocessors.EMBEDDING_MODELS) == before[0]
  assert transcription.get_transcriber() is before[1]
  return out


@pytest.mark.parametrize("source", ["model", "gt_encoded", "gt_raw"])
def test_prediction_sources(source, tmp_path):
  out = _run(["--prediction_source", source, "--output_dir",
              str(tmp_path)])
  agg = out["aggregate"]
  assert agg["num_songs"] == 2
  for key in ("mel_l1", "mel_l2", "mel_frechet"):
    assert np.isfinite(agg[key]), key
  if source == "gt_encoded":
    assert agg["mel_l1"] == 0.0 and agg["mel_l2"] == 0.0
  if source == "gt_raw":
    assert "frechet_audio_distance/mel" in agg
  assert set(out["stage_seconds_per_song"]) >= {"render", "mel"}
  with open(tmp_path / "metrics.json") as f:
    assert json.load(f)["aggregate"] == agg
  assert len([n for n in os.listdir(tmp_path) if n.endswith("_pred.npy")]) == 2


def test_score_is_main_without_aggregate_or_files(tmp_path):
  """`evaluate.score`: main's per-song results and stage timings, with no
  aggregate and no files written."""
  argv = BASE + ["--prediction_source", "gt_encoded", "--output_dir",
                 str(tmp_path / "main")]
  whole = _run(argv[len(BASE):])
  scored = evaluate.score(evaluate.parse_args(
      argv[:-1] + [str(tmp_path / "score")]))
  assert "aggregate" not in scored
  assert not (tmp_path / "score").exists()
  assert ([(r.song_id, r.metrics) for r in scored["results"]]
          == [(r.song_id, r.metrics) for r in whole["results"]])
  assert set(scored["stage_seconds_per_song"]) == set(
      whole["stage_seconds_per_song"])


def test_shards_merge_as_jax(tmp_path):
  from music_spectrogram_diffusion_tpu.infer import evaluation as jax_eval
  argv = ["--prediction_source", "gt_raw"]
  whole = _run(argv)
  shards = []
  for i in range(2):
    d = str(tmp_path / f"shard{i}")
    _run(argv + ["--num_shards", "2", "--shard", str(i), "--output_dir", d])
    shards.append(d)
  out = str(tmp_path / "merged.json")
  merged = merge_eval.main(["--shards", *shards, "--output", out])
  with open(out) as f:
    assert json.load(f) == merged
  assert merged == jax_eval.merge_shard_outputs(shards)
  assert merged["aggregate"]["num_songs"] == 2
  want = {r.song_id: r.metrics for r in whole["results"]}
  assert merged["per_song"] == json.loads(json.dumps(want))


def test_usage_errors_as_jax(capsys, tmp_path, monkeypatch):
  from music_spectrogram_diffusion_tpu.cli import evaluate as jax_cli
  with pytest.raises(SystemExit) as e:
    evaluate.main(["--dataset", "nope"])
  assert e.value.code == 2
  port_err = capsys.readouterr().err.splitlines()[-1]
  monkeypatch.setattr(sys, "argv", ["evaluate", "--dataset", "nope"])
  with pytest.raises(SystemExit):
    jax_cli.main()
  jax_err = capsys.readouterr().err.splitlines()[-1]
  assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
  assert "unknown dataset 'nope'" in port_err
  missing = str(tmp_path / "vggish.npz")
  monkeypatch.delenv("MSD_VGGISH_WEIGHTS", raising=False)
  with pytest.raises(SystemExit) as e:
    _run(["--prediction_source", "gt_encoded", "--vggish_weights", missing])
  assert e.value.code == 2
  assert (f"error: VGGish weights not found: {missing}"
          in capsys.readouterr().err)


_PROBE = r"""
import tempfile
import numpy as np
import torch
assert not torch.cuda.is_available()
from music_spectrogram_diffusion_tpu_torch.cli import evaluate
from music_spectrogram_diffusion_tpu_torch.cli import train_transcriber
from music_spectrogram_diffusion_tpu_torch.infer import mt3, trill, vggish
d = tempfile.mkdtemp()
np.savez(d + "/v.npz", **vggish.random_weights(0))
for make in (lambda: evaluate.main(["--synthetic", "--preset",
                                    "context_tiny", "--songs", "1"]),
             lambda: train_transcriber.main(["--model_dir", d + "/tr",
                                             "--synthetic_examples", "1",
                                             "--song_seconds", "2.0"]),
             lambda: vggish.VGGishEmbedder(d + "/v.npz"),
             lambda: trill.register(d + "/v.npz"),
             lambda: mt3.build_module(mt3.MT3Config(
                 vocab_size=128, emb_dim=64, num_heads=1,
                 num_encoder_layers=1, num_decoder_layers=1))):
  try:
    make()
  except RuntimeError as e:
    assert "cuda" in str(e), e
  else:
    raise AssertionError("a cuda request ran without a card")
print("refused")
"""


def test_entry_points_refuse_a_missing_card():
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["CUDA_VISIBLE_DEVICES"] = ""
  proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "refused" in proc.stdout
