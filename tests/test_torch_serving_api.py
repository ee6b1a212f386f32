"""The port's serving API against the JAX package's, on a tiny context
model (params moved by convert.py, JAX's noise replayed): `stream_song`
(the counterpart of tests/test_synthesize.py:41), input bucketing
(`bucket_inputs`, :165), `vocode=` and `always_mask_context=`.

Features are held as tests/test_torch_export.py holds them (2e-3, with at
most 0.1% isolated values up to 2e-2 where a float ulp takes x0 across
the sampler's clip). Within the port, what must be equal is equal bit for
bit: the streamed mel and the batch renderer's, and each streamed audio
chunk and the vocoder on [context | segment] with the warm-up dropped.
Bucketed against padded to the task's length: 1e-5, as the JAX test
(masked keys add exact zeros; only sums' blocking differs).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.audio import vocoder as jax_vocoder
from music_spectrogram_diffusion_tpu.infer import synthesize as jax_synth
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.infer import synthesize

LENGTHS = {"inputs": 512, "targets": 32, "targets_context": 32}
STEPS, INTERVAL = 10, (0.1, 0.8)
FEATURE_ATOL, OUTLIER_ATOL, OUTLIER_SHARE = 2e-3, 2e-2, 1e-3


def assert_features_close(got, want):
  assert got.shape == want.shape
  err = np.abs(np.asarray(got) - np.asarray(want))
  assert err.max() <= OUTLIER_ATOL, err.max()
  assert (err > FEATURE_ATOL).mean() <= OUTLIER_SHARE, (
      (err > FEATURE_ATOL).sum())


def jax_noise(rng) -> synthesize.SegmentNoise:
  """The draws the JAX Synthesizer takes for (song, segment)."""
  def for_segment(segment, n_songs):
    song_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        rng, jnp.arange(n_songs))
    keys = jax.vmap(jax.random.fold_in, (0, None))(song_keys,
                                                   jnp.asarray(segment))

    def draw(i, shape):
      step = None if i is None else jnp.asarray(i, jnp.int32)
      return torch.from_numpy(np.array(jd._normal_from_keys(
          keys, step, tuple(shape), jnp.float32)))
    return draw
  return for_segment


SEGMENTS = [np.arange(1, 20, dtype=np.int32),
            np.arange(5, 200, dtype=np.int32),
            np.arange(1, 10, dtype=np.int32)]


@pytest.fixture(scope="module")
def models():
  """(JAX model, params) and the port's InferenceModel, same weights."""
  jax_cfg = jd.DiffusionConfig(
      guidance=jd.GuidanceConfig(interval=INTERVAL),
      sampler=jd.SamplerConfig(name="sde-dpm++", num_steps=STEPS))
  net = jax_network.ContextTransformer(config=jax_config.network_config(
      "tiny", with_context=True, dropout_rate=0.0))
  model = jax_model.ContextDiffusionModel(net, jax_cfg,
                                          jax_codecs.MelGan())
  shapes = {"encoder_input_tokens": (1, LENGTHS["inputs"]),
            "encoder_continuous_inputs": (1, 32, 128),
            "encoder_continuous_mask": (1, 32),
            "decoder_target_tokens": (1, 32, 128)}
  params = flax.core.unfreeze(
      model.init_variables(jax.random.PRNGKey(0), shapes)["params"])
  out = params["decoder"]["spec_out_dense"]
  out["kernel"] = out["kernel"] * 0.1
  experiment = inference.with_sampler(
      dataclasses.replace(config.preset("context_tiny"),
                          task_lengths=config.TaskLengths(**LENGTHS)),
      sampler_steps=STEPS, sampler_name="sde-dpm++",
      guidance_interval=INTERVAL)
  module = inference.build_model(experiment, device="cpu").module
  port = inference.InferenceModel(
      experiment, state_dict=convert.flax_to_state_dict(params, module),
      device="cpu")
  return model, params, port


def test_stream_song_matches_batch_and_jax(models):
  model, params, port = models
  rng = jax.random.PRNGKey(3)
  theirs = jax_synth.Synthesizer(
      model, params, LENGTHS,
      vocoder=jax_vocoder.GriffinLimVocoder(num_iters=2))
  want = [mel for _, mel, _ in theirs.stream_song(
      SEGMENTS, rng=rng, vocoder_context_frames=4)]
  voc = vocoder.GriffinLimVocoder(num_iters=2, device="cpu")
  ours = port.synthesizer(voc)
  batch = ours.render_song(SEGMENTS, noise=jax_noise(rng), vocode=False)
  streamed = list(ours.stream_song(SEGMENTS, noise=jax_noise(rng),
                                   vocoder_context_frames=4))
  assert [gi for gi, _, _ in streamed] == [0, 1, 2]
  mels = [mel for _, mel, _ in streamed]
  np.testing.assert_array_equal(np.concatenate(mels), batch.mel)
  for got, w in zip(mels, want):
    assert_features_close(got, w)
  hop = port.audio_codec.hop_size
  for gi, mel, audio in streamed:
    assert audio.shape == (LENGTHS["targets"] * hop,)
    if gi == 0:
      chunk = voc(torch.from_numpy(mel)[None])[0]
    else:
      warm = np.concatenate([mels[gi - 1][-4:], mel])
      chunk = voc(torch.from_numpy(warm)[None])[0, 4 * hop:]
    np.testing.assert_array_equal(audio, chunk.numpy())


def test_stream_song_without_vocoder_or_warm_up(models):
  _, _, port = models
  noise = synthesize.seeded_noise(7, "cpu")
  plain = list(port.synthesizer().stream_song(SEGMENTS[:2], noise=noise))
  assert all(audio is None for _, _, audio in plain)
  voc = vocoder.GriffinLimVocoder(num_iters=0, device="cpu")
  cold = list(port.synthesizer(voc).stream_song(
      SEGMENTS[:2], noise=noise, vocoder_context_frames=0))
  for (_, mel, _), (_, mel_v, audio) in zip(plain, cold):
    np.testing.assert_array_equal(mel, mel_v)
    np.testing.assert_array_equal(
        audio, voc(torch.from_numpy(mel)[None])[0].numpy())


def test_input_bucketing_matches_padding_and_jax(models):
  model, params, port = models
  rng = jax.random.PRNGKey(2)
  songs = [SEGMENTS[:1]]  # 19 tokens: the 256 bucket against 512
  bucketed = port.synthesizer()
  padded = port.synthesizer(bucket_inputs=False)
  assert bucketed._input_length(19) == 256
  assert padded._input_length(19) == 512
  got_b = bucketed.render_songs(songs, noise=jax_noise(rng))[0]
  got_p = padded.render_songs(songs, noise=jax_noise(rng))[0]
  np.testing.assert_allclose(got_b.mel, got_p.mel, rtol=1e-5, atol=1e-5)
  want = jax_synth.Synthesizer(model, params, LENGTHS,
                               bucket_inputs=False).render_songs(
                                   songs, rng=rng, vocode=False)[0]
  assert_features_close(got_p.mel, want.mel)


def test_input_bucket_selection(models):
  _, _, port = models
  big = synthesize.Synthesizer(port.model, {"inputs": 2048, "targets": 16,
                                            "targets_context": 16})
  assert [big._input_length(n) for n in (100, 256, 257, 600, 2048)] == [
      256, 256, 512, 1024, 2048]
  assert port.synthesizer()._input_length(10) == 256
  off = synthesize.Synthesizer(port.model, big.lengths, bucket_inputs=False)
  assert off._input_length(100) == 2048


def test_vocode_flag_and_always_mask_context(models):
  model, params, port = models
  rng = jax.random.PRNGKey(4)
  voc = vocoder.GriffinLimVocoder(num_iters=0, device="cpu")
  synth = port.synthesizer(voc)
  songs = [SEGMENTS[:2]]
  silent = synth.render_songs(songs, noise=jax_noise(rng), vocode=False)[0]
  assert silent.audio is None
  assert silent.timings["audio_decode_seconds"] == 0.0
  voiced = synth.render_song(songs[0], noise=jax_noise(rng))
  assert voiced.audio.shape == (64 * 320,)
  np.testing.assert_array_equal(voiced.mel, silent.mel)
  blind = synth.render_songs(songs, noise=jax_noise(rng), vocode=False,
                             always_mask_context=True)[0]
  # Segment 0 never sees a context; segment 1 differs once it is blind.
  np.testing.assert_array_equal(blind.mel[:32], silent.mel[:32])
  assert not np.allclose(blind.mel[32:], silent.mel[32:], atol=1e-3)
  want = jax_synth.Synthesizer(model, params, LENGTHS).render_songs(
      songs, rng=rng, vocode=False, always_mask_context=True)[0]
  assert_features_close(blind.mel, want.mel)
