"""The port's evaluation module against the JAX package's and the
committed round-5 results.

* `aggregate` and `write_outputs` (files, `fad_moments.npz`) on the same
  SongEvals: exactly JAX's (host numpy in both), CIs included;
* `merge_shard_outputs` on the committed sdedpm64_iv18_sharded shards:
  the committed metrics.json, all 73 aggregate keys, exactly;
* `evaluate_songs` with `gt_encoded` and `gt_raw` on the same tiny
  full-song segments (made by each package's own task from the same
  synthetic songs): JAX's per-song metrics exactly where they are host
  numpy (mel metrics, transcription scores); gt_raw's population mel FAD
  (raw audio against itself) is sqrtm's rounding, below 1e-5, in both;
* with `model`: the port's own `render_songs` given `chunk_noise`, chunk
  by chunk, bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import threadpoolctl

from music_spectrogram_diffusion_tpu.infer import evaluation as jax_eval
from music_spectrogram_diffusion_tpu_torch.infer import evaluation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDED = os.path.join(ROOT, "results", "round5", "base_sweep",
                       "sdedpm64_iv18_sharded")


@pytest.fixture(autouse=True)
def one_blas_thread():
  """One BLAS thread for scipy's sqrtm on these small matrices: several
  threads per test worker fight the other workers for the cores (the
  committed merge took 22 s with them against 2.5 s without, on 8 cores,
  to the same bits)."""
  with threadpoolctl.threadpool_limits(1, user_api="blas"):
    yield


def _song_evals(lib, n_songs=6, seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for i in range(n_songs):
    metrics = {"mel_l1": float(rng.rand()), "mel_l2": float(rng.rand()),
               "mel_frechet": float(100 * rng.rand()),
               "timing/prediction_seconds": float(rng.rand())}
    if i != 2:  # a key missing from one song
      metrics["Model Onset + program precision/recall/F1 (flat) F1"] = (
          float(rng.rand()))
    emb_t = {"mel": rng.randn(30, 5), "vggish": rng.randn(7, 3)}
    emb_p = {k: v + 0.3 * rng.randn(*v.shape) for k, v in emb_t.items()}
    if i == 4:  # one song lacking a space
      del emb_p["vggish"]
    out.append(lib.SongEval(song_id=f"synthetic-{i}", metrics=metrics,
                            mel_pred=rng.randn(12, 4).astype(np.float32),
                            mel_target=rng.randn(12, 4).astype(np.float32),
                            embeddings_target=emb_t, embeddings_pred=emb_p))
  return out


@pytest.mark.parametrize("n_songs", [3, 6])
def test_aggregate_equals_jax(n_songs):
  want = jax_eval.aggregate(_song_evals(jax_eval, n_songs))
  got = evaluation.aggregate(_song_evals(evaluation, n_songs))
  assert list(got) == list(want)
  assert got == want
  assert ("mel_l1_ci95_low" in got) == (n_songs >= 4)


def test_bootstrap_zero_has_no_ci():
  """`bootstrap=0` (chip_smoke.py's aggregate of `cli/evaluate.score`'s
  results): JAX's aggregate with bootstrap 0, and no CI keys."""
  got = evaluation.aggregate(_song_evals(evaluation), bootstrap=0)
  assert got == jax_eval.aggregate(_song_evals(jax_eval), bootstrap=0)
  assert not [k for k in got if "_ci95_" in k]


def test_write_outputs_equal_jax(tmp_path):
  jax_eval.write_outputs(_song_evals(jax_eval), str(tmp_path / "jax"))
  evaluation.write_outputs(_song_evals(evaluation), str(tmp_path / "port"))
  names = sorted(os.listdir(tmp_path / "jax"))
  assert names == sorted(os.listdir(tmp_path / "port"))
  assert "fad_moments.npz" in names and "synthetic-0_pred.npy" in names
  for name in names:
    a, b = tmp_path / "jax" / name, tmp_path / "port" / name
    if name.endswith(".npz"):
      with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
          np.testing.assert_array_equal(za[key], zb[key])
    else:
      assert a.read_bytes() == b.read_bytes(), name


def test_merge_equals_committed_sharded_run():
  with open(os.path.join(SHARDED, "metrics.json")) as f:
    committed = json.load(f)
  merged = evaluation.merge_shard_outputs(
      [os.path.join(SHARDED, "shard0"), os.path.join(SHARDED, "shard1")])
  assert len(committed["aggregate"]) == 73
  assert merged["aggregate"] == committed["aggregate"]
  assert merged["per_song"] == committed["per_song"]
  assert merged["num_shards"] == committed["num_shards"] == 2


def _full_song_segments(tasks_lib, synthetic_lib, codecs_lib, vocab_lib):
  task = tasks_lib.Task(
      name="eval", source_fn=lambda: synthetic_lib.synthetic_source(
          3, duration=3.0, seed=11),
      audio_codec=codecs_lib.MelGan(),
      vocab_config=vocab_lib.VocabularyConfig(num_velocity_bins=1),
      note_rep=tasks_lib.NoteRepresentationConfig(), with_context=True)
  lengths = {"inputs": 256, "targets": 64, "targets_context": 64}
  return task.full_song_dataset(lengths)


def _port_songs():
  from music_spectrogram_diffusion_tpu_torch.audio import codecs
  from music_spectrogram_diffusion_tpu_torch.data import synthetic, tasks
  from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
  return evaluation.group_songs(_full_song_segments(tasks, synthetic, codecs,
                                                    vocabularies))


def _jax_songs():
  from music_spectrogram_diffusion_tpu.audio import codecs
  from music_spectrogram_diffusion_tpu.data import synthetic, tasks
  from music_spectrogram_diffusion_tpu.midi import vocabularies
  return jax_eval.group_songs(_full_song_segments(tasks, synthetic, codecs,
                                                  vocabularies))


class _Stub:
  """What evaluate_songs reads of a Synthesizer for the ground-truth
  sources: the vocoder (none) and the model's codec and device."""

  def __init__(self, codec):
    self.vocoder = None
    self.model = type("M", (), {"audio_codec": codec, "device": "cpu"})()


def _onset_transcriber(seq_lib):
  """A deterministic stand-in transcriber: a note at each 0.25 s whose
  audio frame is loud, so that both packages score the same notes."""
  def transcribe(audio):
    ns = seq_lib.NoteSequence()
    hop = 4000
    for i in range(len(audio) // hop):
      if np.abs(audio[i * hop:(i + 1) * hop]).mean() > 0.01:
        ns.add(pitch=60 + i % 12, velocity=100, start_time=i * 0.25,
               end_time=i * 0.25 + 0.2, program=0, is_drum=False)
    return ns
  return transcribe


@pytest.mark.parametrize("source", ["gt_encoded", "gt_raw"])
def test_evaluate_songs_ground_truth_sources_equal_jax(source):
  from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
  from music_spectrogram_diffusion_tpu.infer import (
      transcription as jax_tr)
  from music_spectrogram_diffusion_tpu.midi import sequences as jax_seq
  from music_spectrogram_diffusion_tpu_torch.audio import codecs
  from music_spectrogram_diffusion_tpu_torch.infer import transcription
  from music_spectrogram_diffusion_tpu_torch.midi import sequences
  saved = (jax_tr.get_transcriber(), transcription.get_transcriber())
  jax_tr.register_transcriber(_onset_transcriber(jax_seq))
  transcription.register_transcriber(_onset_transcriber(sequences))
  try:
    want = jax_eval.evaluate_songs(_Stub(jax_codecs.MelGan()), _jax_songs(),
                                   songs_per_batch=2,
                                   prediction_source=source)
    got = evaluation.evaluate_songs(_Stub(codecs.MelGan()), _port_songs(),
                                    songs_per_batch=2,
                                    prediction_source=source)
  finally:
    jax_tr.register_transcriber(saved[0])
    transcription.register_transcriber(saved[1])
  assert [r.song_id for r in got] == [r.song_id for r in want]
  for g, w in zip(got, want):
    assert list(g.metrics) == list(w.metrics)
    assert g.metrics == w.metrics
  if source == "gt_raw":
    assert any("F1" in k for k in got[0].metrics)
    agg_w, agg_g = jax_eval.aggregate(want), evaluation.aggregate(got)
    assert list(agg_g) == list(agg_w)
    # The predicted audio is the raw audio: the population FAD is sqrtm's
    # rounding in both (covariance traces ~1e3), the distance exactly 0.
    fad = "frechet_audio_distance/mel"
    assert abs(agg_g[fad]) < 1e-5 and abs(agg_w[fad]) < 1e-5
    assert agg_g["embedding_distance/mel"] == 0.0
    assert {k: v for k, v in agg_g.items() if k != fad} == {
        k: v for k, v in agg_w.items() if k != fad}


def test_evaluate_songs_model_equals_render_songs():
  """With the model, each chunk renders as render_songs does with
  chunk_noise(seed, start): the same mels bit for bit, chunks of songs
  at the same position drawing different noise."""
  from music_spectrogram_diffusion_tpu_torch import config
  from music_spectrogram_diffusion_tpu_torch.infer import inference
  experiment = inference.with_sampler(
      dataclasses.replace(config.preset("context_tiny"), dropout_rate=0.0),
      sampler_steps=2)
  model = inference.InferenceModel(experiment, seed=0, device="cpu")
  synth = model.synthesizer()
  songs = _port_songs()
  results = evaluation.evaluate_songs(synth, songs, songs_per_batch=2,
                                      seed=3, keep_arrays=True)
  items = list(songs.items())
  for start in (0, 2):
    renders = synth.render_songs(
        [[s["inputs"] for s in segs] for _, segs in items[start:start + 2]],
        noise=evaluation.chunk_noise(3, start, "cpu"), vocode=False)
    for r, render in zip(results[start:start + 2], renders):
      np.testing.assert_array_equal(r.mel_pred,
                                    render.mel[:len(r.mel_pred)])
  assert not np.array_equal(results[0].mel_pred[:64],
                            results[2].mel_pred[:64])
  assert "timing/prediction_seconds" in results[0].metrics
