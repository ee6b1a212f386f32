"""JAX checkpoints into the port: tools/export_jax_checkpoint.py writes one
`.npz`, `convert.read_export` reads it, `inference.load_export` serves it.

* The committed export of the repo's trained vocoder equals a fresh restore
  of results/round3/vocoder_ckpt/step_4000 bit for bit.
* A tiny JAX `context_tiny` checkpoint (orbax, with its config.json) is
  saved, exported and served by the port: `InferenceModel.predict` and
  `Synthesizer.render_songs` match the JAX package's with JAX's noise
  replayed through the port's providers. The random init's output
  projection is scaled by 0.1 on both sides, and the sampler is
  tests/test_torch_synthesize.py's (sde-dpm++, 10 steps), for the reason
  that file gives: the untrained network's gain. Features agree within
  2e-3 (that file's limit; measured 5.2e-4) but for isolated values: the
  sampler clips x0 to [-1, 1] at every step, and a float ulp that takes a
  value across the clip on one side only leaves one outlier (measured: 1
  of 8192 values, at 9.0e-3 and 9.4e-3). So at most 0.1% of the values
  may pass 2e-3, none 2e-2. With 8 steps, the first segment's 2.6e-4
  differences, fed back as the second one's context, grew to 0.26 at 52
  of 8192 values (measured), while the second segment alone, given the
  same context on both sides, agrees at 1.8e-4.
* The MIDI CLI loads the export (`--checkpoint`) and an exported vocoder
  (`--vocoder_checkpoint`), and prints the checkpoint's step; orbax
  directories are refused with the tool's name.
"""

import dataclasses
import importlib.util
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.infer import inference as jax_inference
from music_spectrogram_diffusion_tpu.midi import midi_io as jax_midi_io
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu.train import checkpoints as jax_ckpt
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import vocoder, wav_io
from music_spectrogram_diffusion_tpu_torch.cli import synthesize_midi
from music_spectrogram_diffusion_tpu_torch.data import synthetic
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.midi import note_tokens
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCODER_CKPT = os.path.join(ROOT, "results", "round3", "vocoder_ckpt",
                            "step_4000")
LENGTHS = {"inputs": 64, "targets": 32, "targets_context": 32}
FEATURE_ATOL = 2e-3
OUTLIER_ATOL, OUTLIER_SHARE = 2e-2, 1e-3


def export_tool():
  spec = importlib.util.spec_from_file_location(
      "export_jax_checkpoint",
      os.path.join(ROOT, "tools", "export_jax_checkpoint.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def jax_noise(rng):
  """The draws the JAX Synthesizer takes for (song, segment)."""
  def for_segment(segment, n_songs):
    song_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        rng, jnp.arange(n_songs))
    keys = jax.vmap(jax.random.fold_in, (0, None))(song_keys,
                                                   jnp.asarray(segment))
    return _replay(keys)
  return for_segment


def _replay(keys):
  def draw(i, shape):
    step = None if i is None else jnp.asarray(i, jnp.int32)
    return torch.from_numpy(np.array(jd._normal_from_keys(
        keys, step, tuple(shape), jnp.float32)))
  return draw


def assert_features_close(got, want):
  assert got.shape == want.shape
  err = np.abs(np.asarray(got) - np.asarray(want))
  assert err.max() <= OUTLIER_ATOL, err.max()
  assert (err > FEATURE_ATOL).mean() <= OUTLIER_SHARE, (err > FEATURE_ATOL).sum()


def test_committed_vocoder_export_equals_a_fresh_restore():
  if not os.path.isdir(VOCODER_CKPT):
    pytest.skip(f"{VOCODER_CKPT} is not in this checkout")
  restored = jax_ckpt.restore_checkpoint(VOCODER_CKPT)
  params, config_json, step = convert.read_export(
      vocoder.TRAINED_MAGNITUDE_GL)
  want = convert.flatten(jax.device_get(restored["params"]))
  got = convert.flatten(params)
  assert sorted(got) == sorted(want)
  for key in want:
    assert got[key].dtype == want[key].dtype == np.float32, key
    np.testing.assert_array_equal(got[key], want[key])
  assert config_json == restored["config_json"]
  assert step == restored["step"] == 4000
  assert sorted(want) == [f"params/{c}/{p}" for c in
                          ("conv_in", "conv_mid", "conv_out")
                          for p in ("bias", "kernel")]


def test_read_export_refuses_what_is_not_an_export(tmp_path):
  other = str(tmp_path / "other.npz")
  np.savez(other, w=np.zeros(3))
  for path in (str(tmp_path), other, str(tmp_path / "x.pt")):
    with pytest.raises(ValueError, match="tools/export_jax_checkpoint.py"):
      convert.read_export(path)


def _experiment():
  return dataclasses.replace(
      jax_config.preset("context_tiny"),
      task_lengths=jax_config.TaskLengths(**LENGTHS),
      diffusion=jd.DiffusionConfig(
          guidance=jd.GuidanceConfig(interval=(0.1, 0.8)),
          sampler=jd.SamplerConfig(name="sde-dpm++", num_steps=10)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
  """A saved and exported tiny JAX checkpoint: (orbax dir, .npz)."""
  root = tmp_path_factory.mktemp("ckpt")
  experiment = _experiment()
  model = jax_inference.build_model(experiment)
  shapes = {"encoder_input_tokens": (1, LENGTHS["inputs"]),
            "encoder_continuous_inputs": (1, 32, 128),
            "encoder_continuous_mask": (1, 32),
            "decoder_target_tokens": (1, 32, 128)}
  params = flax.core.unfreeze(
      model.init_variables(jax.random.PRNGKey(0), shapes)["params"])
  out = params["decoder"]["spec_out_dense"]
  out["kernel"] = out["kernel"] * 0.1
  model_dir = str(root / "model")
  jax_ckpt.save_checkpoint(model_dir, 5, params,
                           config_json=experiment.to_json())
  npz = str(root / "model.npz")
  export_tool().export(model_dir, npz)
  return model_dir, npz


def _segments():
  codec = vocabularies.build_codec(vocabularies.VocabularyConfig(
      num_velocity_bins=1))
  return note_tokens.segment_tokens(
      note_tokens.random_notes(3, 1.28, notes_per_second=6),
      num_segments=2, segment_seconds=0.64, max_tokens=LENGTHS["inputs"],
      codec=codec, vocab=vocabularies.vocabulary_from_codec(codec))


def test_load_export_reads_the_experiment_and_step(exported):
  _, npz = exported
  port = inference.load_export(npz, device="cpu")
  theirs = config.ExperimentConfig.from_json(_experiment().to_json())
  assert port.experiment == theirs and port.step == 5
  assert port.task_lengths == LENGTHS
  over = inference.load_export(npz, device="cpu", sampler_steps=3,
                               sampler_name="ddim",
                               guidance_interval=(0.2, 0.9),
                               compute_dtype="bfloat16")
  sampler = over.experiment.diffusion.sampler
  assert (sampler.num_steps, sampler.name) == (3, "ddim")
  assert over.experiment.diffusion.guidance.interval == (0.2, 0.9)
  assert over.experiment.dtype == "bfloat16"


def test_predict_matches_jax(exported):
  model_dir, npz = exported
  theirs = jax_inference.InferenceModel(model_dir)
  ours = inference.load_export(npz, device="cpu")
  rng = np.random.RandomState(0)
  tokens = np.zeros((2, LENGTHS["inputs"]), np.int32)
  for row, seg in enumerate(_segments()):
    tokens[row, :len(seg)] = seg
  batch = {"encoder_input_tokens": tokens,
           "encoder_continuous_inputs": rng.uniform(
               -11, 4, (2, 32, 128)).astype(np.float32),
           "encoder_continuous_mask": np.array([[1] * 32, [0] * 32], bool),
           "decoder_target_tokens": np.zeros((2, 32, 128), np.float32)}
  want = theirs.predict(batch, seed=3)
  got = ours.predict(batch, noise=_replay(jax.random.PRNGKey(3)))
  assert isinstance(got, np.ndarray) and got.shape == want.shape
  assert_features_close(got, want)
  # The default noise: row i from (seed, i, 0), as a song's first segment.
  again = ours.predict(batch, seed=3)
  np.testing.assert_array_equal(again, ours.predict(batch, seed=3))
  assert not np.array_equal(again, ours.predict(batch, seed=4))


@pytest.mark.parametrize("always_mask_context", [False, True])
def test_render_songs_from_export_matches_jax(exported, always_mask_context):
  model_dir, npz = exported
  theirs = jax_inference.InferenceModel(model_dir).synthesizer()
  ours = inference.load_export(npz, device="cpu").synthesizer()
  songs = [_segments(), _segments()[:1]]
  rng = jax.random.PRNGKey(5)
  want = theirs.render_songs(songs, rng=rng, vocode=False,
                             always_mask_context=always_mask_context)
  got = ours.render_songs(songs, noise=jax_noise(rng), vocode=False,
                          always_mask_context=always_mask_context)
  for w, g in zip(want, got):
    assert g.audio is None and g.mel.shape == w.mel.shape
    assert_features_close(g.mel, w.mel)


def test_midi_cli_serves_exports(exported, tmp_path, capsys):
  _, npz = exported
  ns = synthetic.random_note_sequence(np.random.RandomState(0),
                                      duration=0.5)
  midi = str(tmp_path / "song.mid")
  jax_midi_io.write_midi_file(ns, midi)
  out = str(tmp_path / "song.wav")
  timings = synthesize_midi.main([
      "--midi", midi, "--output", out, "--checkpoint", npz,
      "--vocoder_checkpoint", vocoder.TRAINED_MAGNITUDE_GL, "--device",
      "cpu"])
  printed = capsys.readouterr().out
  assert f"loaded {npz} (step 5)" in printed
  rate, audio = wav_io.decode_wav(open(out, "rb").read())
  assert rate == 16000 and audio.size % (32 * 320) == 0  # whole segments
  assert audio.size == round(timings["audio_seconds"] * 16000)
  assert np.isfinite(audio).all() and np.abs(audio).max() > 0


@pytest.mark.parametrize("flag", ["--checkpoint", "--vocoder_checkpoint"])
def test_midi_cli_refuses_orbax_directories(exported, flag):
  model_dir, _ = exported
  for path in (model_dir, os.path.join(model_dir, "step_5")):
    args = synthesize_midi.parse_args(
        ["--midi", "x.mid", "--output", "y.wav", "--device", "cpu", flag,
         path])
    with pytest.raises(ValueError, match="tools/export_jax_checkpoint.py"):
      if flag == "--checkpoint":
        synthesize_midi.build_model(args)
      else:
        vocoder.load_trained(args.vocoder_checkpoint, device="cpu")


def test_export_tool_writes_params_config_and_step(exported):
  model_dir, npz = exported
  with np.load(npz) as z:
    assert int(z["step"]) == 5
    assert json.loads(str(z["config_json"]))["size"] == "tiny"
    keys = [k for k in z.files if k not in ("step", "config_json")]
  assert keys and all(k.startswith("params/") for k in keys)
  assert "params/decoder/spec_out_dense/kernel" in keys


# ---------------------------------------------------------------------------
# A T5X directory (the published checkpoints' format) through the tool.
# ---------------------------------------------------------------------------

# This repo's module names -> the reference's, the inverse of
# checkpoints.remap_t5x_params for an autoregressive tree.
_TO_REFERENCE = (("pre_attention_norm", "pre_attention_layer_norm"),
                 ("pre_self_attention_norm", "pre_self_attention_layer_norm"),
                 ("pre_cross_attention_norm",
                  "pre_cross_attention_layer_norm"),
                 ("pre_mlp_norm", "pre_mlp_layer_norm"))


def write_t5x(directory: str, params) -> None:
  """A T5X checkpoint directory as T5X writes one: a msgpack `checkpoint`
  index whose optimizer target holds a TensorStore (zarr) spec for each
  leaf, the arrays in zarr directories beside it."""
  import tensorstore as ts
  os.makedirs(directory)
  specs = {}
  for path, leaf in convert.flatten(params).items():
    for ours, theirs in _TO_REFERENCE:
      path = path.replace(ours, theirs)
    arr = np.asarray(leaf)
    rel = "target." + path.replace("/", ".")
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": rel}}
    ts.open(dict(spec, kvstore={"driver": "file",
                                "path": os.path.join(directory, rel)},
                 metadata={"shape": list(arr.shape),
                           "dtype": arr.dtype.str}),
            create=True).result().write(arr).result()
    specs[path] = spec
  index = {"optimizer": {"target": convert.unflatten(specs)}}
  with open(os.path.join(directory, "checkpoint"), "wb") as f:
    f.write(flax.serialization.msgpack_serialize(index))


def test_t5x_directory_exports_and_serves_as_jax(tmp_path):
  experiment = dataclasses.replace(jax_config.preset("ar_tiny"),
                                   dropout_rate=0.0)
  model = jax_inference.build_model(experiment)
  r = np.random.RandomState(0)
  tokens = r.randint(1, 1000, (2, 32)).astype(np.int32)
  tokens[1, 20:] = 0
  frames = r.randn(2, 8, 128).astype(np.float32)
  params = jax.jit(lambda key: model.init_variables(key, {
      "encoder_input_tokens": tokens.shape,
      "decoder_target_tokens": frames.shape}))(
          jax.random.PRNGKey(0))["params"]
  t5x_dir = str(tmp_path / "checkpoint_7")
  write_t5x(t5x_dir, jax.device_get(params))
  loaded = jax_ckpt.load_t5x_checkpoint(t5x_dir)
  want = model.module.apply({"params": loaded}, jnp.asarray(tokens),
                            jnp.asarray(frames), jnp.asarray(frames),
                            enable_dropout=False)

  npz = str(tmp_path / "ar.npz")
  arrays = export_tool().export(t5x_dir, npz, preset="ar_tiny")
  assert int(arrays["step"]) == 7
  assert "params/encoder/layers_0/pre_attention_norm/scale" in arrays
  served = inference.load_export(npz, device="cpu")
  assert served.step == 7
  assert served.experiment.model_family == "autoregressive"
  with torch.no_grad():
    got = served.model.module(torch.from_numpy(tokens),
                              torch.from_numpy(frames))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  with pytest.raises(ValueError, match="--preset is for T5X"):
    export_tool().export(t5x_dir.replace("checkpoint_7", "nothing"),
                         npz, preset="ar_tiny")
