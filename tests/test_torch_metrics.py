"""The port's evaluation metrics, transcription scores, postprocessors and
summaries against the JAX package's on the same inputs (numpy, made from
a seed), and its mel metrics against the committed round-5 results.

Tolerances: the metric functions are numpy and scipy in both packages, so
their outputs are compared exactly; the mel-frame embedding is computed by
each package's own STFT (float32), compared within 1e-4 absolute on a
log-mel of magnitude ~10.
"""

import json
import os

import numpy as np
import pytest
import threadpoolctl

from music_spectrogram_diffusion_tpu.infer import (
    postprocessors as jax_post, transcription as jax_tr)
from music_spectrogram_diffusion_tpu.midi import sequences as jax_seq
from music_spectrogram_diffusion_tpu.train import (
    metrics as jax_metrics, summaries as jax_summaries)
from music_spectrogram_diffusion_tpu_torch.infer import (
    postprocessors as port_post, transcription as port_tr)
from music_spectrogram_diffusion_tpu_torch.midi import sequences as port_seq
from music_spectrogram_diffusion_tpu_torch.train import (
    metrics as port_metrics, summaries as port_summaries)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(ROOT, "results", "round5", "base_sweep")


@pytest.fixture(autouse=True)
def one_blas_thread():
  """One BLAS thread for scipy's sqrtm on these small matrices: several
  threads per test worker fight the other workers for the cores (the
  committed merge took 22 s with them against 2.5 s without, on 8 cores,
  to the same bits)."""
  with threadpoolctl.threadpool_limits(1, user_api="blas"):
    yield


def _gaussians(rng, n, d):
  a = rng.randn(n, d)
  return a, a @ (0.3 * rng.randn(d, d)) + 0.1 * rng.randn(n, d) + 0.5


@pytest.mark.parametrize("d", [8, 1030])
def test_streaming_gaussian_and_frechet_equal_jax(d):
  rng = np.random.RandomState(d)
  x, y = _gaussians(rng, 40, d)
  gaussians = []
  for lib in (jax_metrics, port_metrics):
    g1 = lib.StreamingMultivariateGaussian()
    g2 = lib.StreamingMultivariateGaussian()
    for lo, hi in ((0, 15), (15, 40)):
      g1.update(x[lo:hi])
      g2.update(y[lo:hi])
    gaussians.append((g1, g2))
  (j1, j2), (p1, p2) = gaussians
  np.testing.assert_array_equal(j1.mu, p1.mu)
  np.testing.assert_array_equal(j1.sigma, p1.sigma)
  assert p1.sigma.ndim == (2 if d <= 1024 else 1)
  assert (port_metrics.frechet_distance(p1.mu, p1.sigma, p2.mu, p2.sigma)
          == jax_metrics.frechet_distance(j1.mu, j1.sigma, j2.mu, j2.sigma))
  if d <= 1024:
    assert (port_metrics._stable_trace_sqrt_product(p1.sigma, p2.sigma)
            == jax_metrics._stable_trace_sqrt_product(j1.sigma, j2.sigma))
    with pytest.raises(ValueError):
      port_metrics._stable_trace_sqrt_product(p1.sigma, -p2.sigma)


def test_distances_rates_and_timings_equal_jax():
  rng = np.random.RandomState(1)
  a, b = rng.randn(30, 16), rng.randn(25, 16)
  assert (port_metrics.embedding_distance(a, b)
          == jax_metrics.embedding_distance(a, b))
  targets = [{"embeddings": {"mel": rng.randn(20, 6), "v": rng.randn(9, 4)}}
             for _ in range(3)]
  preds = [{"embeddings": {k: v + 0.1 * rng.randn(*v.shape)
                           for k, v in t["embeddings"].items()},
            "timings": {"t": float(i), "u": 2.0 * i}}
           for i, t in enumerate(targets)]
  for fn in ("reconstruction_metrics", "count_examples", "model_timing"):
    assert (getattr(port_metrics, fn)(targets, preds)
            == getattr(jax_metrics, fn)(targets, preds)), fn
  assert (port_metrics.throughput_metrics(8, 2048, 1.5, 1, 3)
          == jax_metrics.throughput_metrics(8, 2048, 1.5, 1, 3))


@pytest.mark.parametrize("case", ["random", "constant_frames"])
def test_mel_spectral_metrics_equal_jax(case):
  rng = np.random.RandomState(2)
  t = rng.randn(300, 128).astype(np.float32)
  p = (t + 0.3 * rng.randn(300, 128)).astype(np.float32)
  if case == "constant_frames":  # the diagonal fallback's path
    t[:] = t[0]
  assert (port_metrics.mel_spectral_metrics(t, p[:280])
          == jax_metrics.mel_spectral_metrics(t, p[:280]))


def test_mel_metrics_equal_committed_round5():
  """Every song of sdedpm100_iv18: the port's mel metrics of its committed
  pred/target mels equal the committed per_song entries exactly."""
  run = os.path.join(SWEEP, "sdedpm100_iv18")
  with open(os.path.join(run, "metrics.json")) as f:
    per_song = json.load(f)["per_song"]
  assert len(per_song) == 16
  for song, committed in per_song.items():
    got = port_metrics.mel_spectral_metrics(
        np.load(os.path.join(run, f"{song}_target.npy")),
        np.load(os.path.join(run, f"{song}_pred.npy")))
    for key in ("mel_l1", "mel_l2", "mel_frechet"):
      assert got[key] == committed[key], (song, key)


def _sequence(seq_lib, rng, n, drums=True):
  ns = seq_lib.NoteSequence()
  for _ in range(n):
    start = float(np.round(rng.uniform(0, 8), 3))
    ns.add(pitch=int(rng.randint(40, 80)), velocity=100,
           start_time=start, end_time=start + 0.25,
           program=int(rng.randint(0, 128)),
           is_drum=bool(drums and rng.rand() < 0.1))
  return ns


def _jitter(seq_lib, ns, rng):
  out = seq_lib.NoteSequence()
  for note in ns.notes:
    if rng.rand() < 0.2:
      continue
    start = note.start_time + float(rng.uniform(-0.08, 0.08))
    out.add(pitch=note.pitch, velocity=note.velocity, start_time=start,
            end_time=start + 0.2,
            program=(note.program + (1 if rng.rand() < 0.2 else 0)) % 128,
            is_drum=note.is_drum)
  return out


@pytest.mark.parametrize("granularity", ["flat", "midi_class", "full"])
def test_note_onset_scores_equal_jax(granularity):
  scores = []
  for seq_lib, tr in ((jax_seq, jax_tr), (port_seq, port_tr)):
    rng = np.random.RandomState(3)
    ref = _sequence(seq_lib, rng, 60)
    est = _jitter(seq_lib, ref, rng)
    scores.append(tr.note_onset_scores(ref, est, granularity))
  assert scores[0] == scores[1]
  assert 0.0 < scores[1][
      f"Onset + program precision/recall/F1 ({granularity}) F1"] < 1.0


def test_transcription_metrics_equal_jax():
  out = []
  for seq_lib, tr in ((jax_seq, jax_tr), (port_seq, port_tr)):
    rng = np.random.RandomState(4)
    targets, preds = [], []
    for i in range(3):
      ns = _sequence(seq_lib, rng, 30)
      target = {"sequence": ns}
      if i != 1:  # one song without the ground-truth transcription
        target["transcribed_audio"] = _jitter(seq_lib, ns, rng)
      targets.append(target)
      preds.append({"transcribed_audio": _jitter(seq_lib, ns, rng)})
    preds.append({})  # skipped: nothing transcribed
    targets.append({"sequence": _sequence(seq_lib, rng, 5)})
    out.append(tr.transcription_metrics(targets, preds))
  assert out[0] == out[1]
  assert len(out[1]) == 18


def test_transcriber_slot():
  saved = port_tr.get_transcriber()
  try:
    fn = lambda audio: port_seq.NoteSequence()  # noqa: E731
    port_tr.register_transcriber(fn)
    assert port_tr.get_transcriber() is fn
  finally:
    port_tr.register_transcriber(saved)


def test_mel_frame_embeddings_match_jax():
  audio = np.random.RandomState(5).randn(48000).astype(np.float32) * 0.2
  want = jax_post.mel_frame_embeddings(audio)
  got = port_post.mel_frame_embeddings(audio)
  assert got.shape == want.shape == (150, 128)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
  assert set(port_post.get_embeddings(audio)) >= {"mel"}


def test_make_output_dict():
  from music_spectrogram_diffusion_tpu_torch.audio import codecs, vocoder
  codec = codecs.MelGan()
  rng = np.random.RandomState(6)
  raw = rng.randn(16000).astype(np.float32) * 0.1
  target = port_post.make_output_dict(
      codec, {"raw_targets": raw, "sequence": "ns"}, is_target=True)
  assert target["sequence"] == "ns"
  assert target["embeddings"]["mel"].shape == (50, 128)
  mel = codec.encode_np(raw[None])[0]
  voc = vocoder.GriffinLimVocoder(num_iters=2, device="cpu")
  pred = port_post.make_output_dict(codec, {"timings": {"t": 1.0}}, mel,
                                    vocoder=voc)
  assert pred["audio"].shape == (16000,)
  assert pred["timings"] == {"t": 1.0}
  assert pred["embeddings"]["mel"].shape == (50, 128)


def test_summaries_equal_jax(tmp_path):
  """The same scalars, audio clips and spectrogram images give the same
  index and the same PNG and WAV bytes in both packages."""
  from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
  from music_spectrogram_diffusion_tpu_torch.audio import codecs
  rng = np.random.RandomState(7)
  feats = rng.uniform(-10, 2, (40, 128)).astype(np.float32)
  raw = (0.1 * rng.randn(4000)).astype(np.float32)
  targets = [{"features": feats, "raw_targets": raw}]
  preds = [{"predicted_features": feats[::-1].copy()}]
  dirs = []
  for lib, codec in ((jax_summaries, jax_codecs.MelGan()),
                     (port_summaries, codecs.MelGan())):
    d = str(tmp_path / lib.__name__.split(".")[0])
    writer = lib.SummaryWriter(d, audio_codec=codec)
    writer.add_scalars(3, {"loss": np.float32(0.5), "acc": 1})
    lib.eval_summaries(writer, 3, targets, preds, codec)
    assert writer.add_audio("big", 4, np.zeros(6_000_000)) is None
    dirs.append(d)
  names = sorted(os.listdir(dirs[0]))
  assert names == sorted(os.listdir(dirs[1]))
  assert {"index.json", "target_0_3.png", "prediction_0_3.png",
          "target_0_3.wav"} <= set(names)
  for name in names:
    with open(os.path.join(dirs[0], name), "rb") as a, \
        open(os.path.join(dirs[1], name), "rb") as b:
      assert a.read() == b.read(), name
