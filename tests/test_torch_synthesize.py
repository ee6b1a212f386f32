"""The serving path as a whole on the CPU: a tiny context model renders a
song of two chained segments through `Synthesizer.render_song` in the JAX
package and in the port, with the same params (moved by convert.py) and
the same noise (JAX's draws replayed through the port's provider), with
the serving sampler (sde-dpm++, CFG weight 5 in the interval [0.1, 0.8]).
The other two families render as JAX's tests/test_synthesize.py renders
them: a notes-only model a song of 2 independent segments (the limit and
the output scaling below, the sampler at 20 steps: at 10, the untrained
network's gain took 23 of 8192 values of one frame up to 1.7e-2 from
JAX's, measured, where 20 steps give at most 1.4e-3), an autoregressive
model (deterministic head) a
song of 1 segment of 32 frames, within 3e-4 (nothing is random; the limit
tests/test_torch_network.py gives a decoder, float32 sums in other orders
fed back frame by frame). Batched with another song, a song's mel is the
same as alone, within the same limits.

The random init's output projection is scaled by 0.1, the same on both
sides. At Flax's init scale the untrained network's eps is so large that
75% of x0 sits at the clip and the rest answers float noise with a gain
near 1e5 (measured: 0.23 on the features from the decoders' 1e-4
difference, tests/test_torch_network.py); a trained model's eps is O(1).
Tolerance 2e-3 on the features (range log(1e-5)..4; measured 5.2e-4).
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
from music_spectrogram_diffusion_tpu.infer import inference as jax_inference
from music_spectrogram_diffusion_tpu.infer import synthesize as jax_synth
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import vocoder, wav_io
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.infer import synthesize
from music_spectrogram_diffusion_tpu_torch.midi import note_tokens
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

LENGTHS = {"inputs": 64, "targets": 32, "targets_context": 32}
STEPS, INTERVAL = 10, (0.1, 0.8)


def _segments():
  codec = vocabularies.build_codec(vocabularies.VocabularyConfig(
      num_velocity_bins=1))
  return note_tokens.segment_tokens(
      note_tokens.random_notes(3, 1.28, notes_per_second=6),
      num_segments=2, segment_seconds=0.64, max_tokens=LENGTHS["inputs"],
      codec=codec, vocab=vocabularies.vocabulary_from_codec(codec))


def _jax_noise(rng) -> synthesize.SegmentNoise:
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


@pytest.fixture(scope="module")
def renders():
  segments = _segments()
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
  rng = jax.random.PRNGKey(5)
  want = jax_synth.Synthesizer(model, params, LENGTHS).render_song(
      segments, rng=rng, vocode=False)

  experiment = inference.with_sampler(
      dataclasses.replace(config.preset("context_tiny"),
                          task_lengths=config.TaskLengths(**LENGTHS)),
      sampler_steps=STEPS, sampler_name="sde-dpm++",
      guidance_interval=INTERVAL)
  module = inference.build_model(experiment, device="cpu").module
  state = convert.flax_to_state_dict(params, module)
  port = inference.InferenceModel(experiment, state_dict=state,
                                  device="cpu")
  assert port.task_lengths == LENGTHS
  synth = port.synthesizer(vocoder.GriffinLimVocoder(num_iters=2,
                                                     device="cpu"))
  got = synth.render_song(segments, noise=_jax_noise(rng))
  return want, got


def test_two_segment_render_matches_jax(renders):
  want, got = renders
  assert got.mel.shape == want.mel.shape == (64, 128)
  np.testing.assert_allclose(got.mel, want.mel, rtol=0, atol=2e-3)


def test_render_outputs_and_timings(renders):
  _, got = renders
  assert np.all(np.isfinite(got.mel))
  assert got.audio.shape == (64 * 320,)
  assert np.all(np.isfinite(got.audio))
  assert got.timings["audio_seconds"] == pytest.approx(64 / 50)
  assert got.timings["prediction_seconds"] > 0


def test_segment_tokens_layout():
  codec = vocabularies.build_codec(vocabularies.VocabularyConfig(
      num_velocity_bins=1))
  vocab = vocabularies.vocabulary_from_codec(codec)
  notes = np.array([[0.0, 0.9, 60, 0], [0.5, 0.7, 64, 24]])
  segs = note_tokens.segment_tokens(notes, num_segments=2,
                                    segment_seconds=0.64, max_tokens=32,
                                    codec=codec, vocab=vocab)
  ids = [vocab.decode(s[s > 0]) for s in segs]
  types = [[codec.event_types[t] if v >= 0 else "eos"
            for t, v in zip(*codec.decode(i))] for i in ids]
  # Segment 0: an empty tie section, then onset 60 at step 0; segment 1
  # opens with a tie section naming the notes still sounding (60 and 64).
  assert types[0][:4] == ["tie", "program", "velocity", "pitch"]
  assert types[1][:5] == ["program", "pitch", "program", "pitch", "tie"]
  assert all(t[-1] == "eos" for t in types)


def test_experiment_config_json_reads_in_both_packages():
  for name in ("context_base", "context_tiny", "ismir2021_small"):
    ours = inference.with_sampler(config.preset(name), sampler_steps=100,
                                  sampler_name="sde-dpm++",
                                  guidance_interval=(0.1, 0.8))
    theirs = jax_config.ExperimentConfig.from_json(ours.to_json())
    assert config.ExperimentConfig.from_json(theirs.to_json()) == ours
    a, b = ours.network(), theirs.network()
    for field in ("vocab_size", "emb_dim", "num_heads", "head_dim",
                  "num_encoder_layers", "num_decoder_layers", "mlp_dim",
                  "mlp_activations", "cross_attend_style",
                  "position_encoding", "context_positions"):
      assert getattr(a, field) == getattr(b, field), (name, field)


def test_wav_round_trip(renders, tmp_path):
  _, got = renders
  audio = got.audio / np.abs(got.audio).max()
  path = tmp_path / "song.wav"
  wav_io.write_wav(str(path), audio, 16000)
  rate, back = wav_io.decode_wav(path.read_bytes())
  assert rate == 16000 and back.shape == audio.shape
  np.testing.assert_allclose(back, audio, atol=1 / 16384)


NOTES_LENGTHS = {"inputs": 64, "targets": 32}
NOTES_STEPS = 20


def _scaled_init(model, shapes):
  params = flax.core.unfreeze(jax.jit(
      lambda key: model.init_variables(key, shapes))(
          jax.random.PRNGKey(0))["params"])
  out = params["decoder"]["spec_out_dense"]
  out["kernel"] = out["kernel"] * 0.1
  return params


def _port_model(preset, params, steps=None):
  experiment = dataclasses.replace(
      config.preset(preset), dropout_rate=0.0,
      task_lengths=config.TaskLengths(inputs=64, targets=32))
  if steps:
    experiment = inference.with_sampler(
        experiment, sampler_steps=steps, sampler_name="sde-dpm++",
        guidance_interval=INTERVAL)
  module = inference.build_model(experiment, device="cpu").module
  return inference.InferenceModel(
      experiment, state_dict=convert.flax_to_state_dict(params, module),
      device="cpu")


def _other_song():
  return [np.arange(3, 40, 2, dtype=np.int64), np.arange(1, 9)]


def test_notes_only_song_matches_jax_and_the_batch():
  segments = _segments()
  jax_cfg = jd.DiffusionConfig(
      guidance=jd.GuidanceConfig(interval=INTERVAL),
      sampler=jd.SamplerConfig(name="sde-dpm++", num_steps=NOTES_STEPS))
  net = jax_network.Transformer(config=jax_config.network_config(
      "tiny", with_context=False, dropout_rate=0.0))
  model = jax_model.DiffusionModel(net, jax_cfg, jax_codecs.MelGan())
  params = _scaled_init(model, {
      "encoder_input_tokens": (1, 64), "decoder_target_tokens": (1, 32, 128)})
  rng = jax.random.PRNGKey(5)
  want = jax_synth.Synthesizer(model, params, NOTES_LENGTHS).render_song(
      segments, rng=rng, vocode=False)

  port = _port_model("diffusion_tiny", params, NOTES_STEPS)
  assert port.task_lengths == NOTES_LENGTHS
  synth = port.synthesizer()
  assert not synth._uses_context
  got = synth.render_song(segments, noise=_jax_noise(rng), vocode=False)
  assert got.mel.shape == want.mel.shape == (64, 128)
  np.testing.assert_allclose(got.mel, want.mel, rtol=0, atol=2e-3)
  both = synth.render_songs([segments, _other_song()], noise=_jax_noise(rng),
                            vocode=False)
  np.testing.assert_allclose(both[0].mel, got.mel, rtol=0, atol=2e-3)


def test_autoregressive_song_matches_jax_and_the_batch():
  exp = dataclasses.replace(jax_config.preset("ar_tiny"), dropout_rate=0.0)
  model = jax_inference.build_model(exp)
  params = _scaled_init(model, {
      "encoder_input_tokens": (1, 64), "decoder_target_tokens": (1, 32, 128)})
  segment = _segments()[:1]
  want = jax_synth.Synthesizer(model, params, NOTES_LENGTHS).render_song(
      segment, rng=jax.random.PRNGKey(0), vocode=False)

  port = _port_model("ar_tiny", params)
  synth = port.synthesizer()
  assert not synth._uses_context
  got = synth.render_song(segment, vocode=False)
  assert got.mel.shape == want.mel.shape == (32, 128)
  assert np.isfinite(got.mel).all()
  np.testing.assert_allclose(got.mel, want.mel, rtol=3e-4, atol=3e-4)
  both = synth.render_songs([segment, _other_song()], vocode=False)
  np.testing.assert_allclose(both[0].mel, got.mel, rtol=3e-4, atol=3e-4)
  assert both[1].mel.shape == (64, 128)
