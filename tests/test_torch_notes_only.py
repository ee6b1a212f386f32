"""The port's notes-only diffusion family (`Transformer`, `DiffusionModel`)
against the JAX package's, at tiny size on the CPU, the weights moved by
convert.py.

Tolerances are those of the context model's tests, for their reasons:
* the encoder 1e-5, the decoder 3e-4 (tests/test_torch_network.py: the
  timing embedding's sin/cos of up to 2e4 rad, where XLA's and PyTorch's
  float32 exp differ by an ulp);
* `DiffusionModel.predict` with JAX's noise replayed, 2e-3 on the features
  (tests/test_torch_synthesize.py: the untrained network's gain, with its
  output projection scaled by 0.1 on both sides);
* `loss_fn` 1e-5 relative, each gradient 3e-4 of its leaf's largest entry
  (tests/test_torch_train.py);
* bf16 and int8 forwards at emb 128, 2.5% of the output's max and 2%
  relative RMS (tests/test_torch_quantize.py: JAX's bf16 einsum attention
  rounds scores and softmax to bf16 where the port keeps f32, and JAX's
  int8 path on the CPU rounds the dequantized weight to bf16 where the
  port keeps the integer weight exact).
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
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu.ops import quantize as jax_quantize
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model, network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d

TOL = dict(rtol=1e-5, atol=1e-5)
DECODER_TOL = dict(rtol=3e-4, atol=3e-4)
STYLES = ("fixed", "fixed_permuted_offset", "learnable_permuted_offset",
          "random")


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _configs(style="fixed_permuted_offset", **widths):
  jcfg = dataclasses.replace(jax_config.network_config(
      "tiny", with_context=False, vocab_size=256, dropout_rate=0.0),
      position_encoding=style, **widths)
  tcfg = dataclasses.replace(config.network_config(
      "tiny", with_context=False, vocab_size=256, dropout_rate=0.0),
      position_encoding=style, **widths)
  return jcfg, tcfg


def _inputs():
  r = np.random.RandomState(0)
  tokens = r.randint(1, 200, (2, 24)).astype(np.int32)
  tokens[1, 15:] = 0
  return dict(tokens=tokens, z=r.randn(4, 16, 128).astype(np.float32),
              time=np.array([0.3, 0.9, 0.3, 0.9], np.float32))


def _init(jcfg, m):
  flax_module = jax_network.Transformer(config=jcfg)
  params = jax.jit(lambda key: flax_module.init(
      key, jnp.asarray(m["tokens"]), jnp.zeros((2, 16, 128)),
      jnp.ones((2,)), enable_dropout=False))(jax.random.PRNGKey(0))
  return flax_module, flax.core.unfreeze(params["params"])


@pytest.fixture(scope="module")
def tiny():
  m = _inputs()
  jcfg, tcfg = _configs()
  flax_module, params = _init(jcfg, m)
  module = network.Transformer(tcfg)
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  return dict(m, flax=flax_module, params=params, torch=module.eval())


def _encode_both(t):
  enc_jax = jax.jit(lambda p: t["flax"].apply(
      {"params": p}, jnp.asarray(t["tokens"]), enable_dropout=False,
      method=t["flax"].encode))(t["params"])
  with torch.no_grad():
    enc_t = t["torch"].encode(torch.from_numpy(t["tokens"]))
  return enc_jax, enc_t


@pytest.mark.parametrize("fused_cfg_pair", [False, True])
def test_encode_and_decode_match_jax(tiny, fused_cfg_pair):
  enc_jax, enc_t = _encode_both(tiny)
  assert len(enc_t) == len(enc_jax) == 1
  _close(enc_t[0][0], enc_jax[0][0])
  np.testing.assert_array_equal(enc_t[0][1].numpy(),
                                np.asarray(enc_jax[0][1]))
  z, time = tiny["z"], tiny["time"]
  if not fused_cfg_pair:
    z, time = z[:2], time[:2]
  cond_rows = 2 if fused_cfg_pair else None
  flax_module = tiny["flax"]

  @jax.jit
  def decode(p, enc):
    kv = flax_module.apply({"params": p}, enc,
                           method=flax_module.precompute_cross_kv)
    return flax_module.apply(
        {"params": p}, enc, jnp.asarray(z), jnp.asarray(time),
        enable_dropout=False, cross_kv=kv, cond_rows=cond_rows,
        method=flax_module.decode)
  want = decode(tiny["params"], enc_jax)
  with torch.no_grad():
    kv_t = tiny["torch"].precompute_cross_kv(enc_t)
    got = tiny["torch"].decode(enc_t, torch.from_numpy(z),
                               torch.from_numpy(time), cross_kv=kv_t,
                               cond_rows=cond_rows)
    call = tiny["torch"](torch.from_numpy(tiny["tokens"]),
                         torch.from_numpy(z[:2]), torch.from_numpy(time[:2]))
  _close(got, want, DECODER_TOL)
  if not fused_cfg_pair:  # the training forward is encode, then decode
    _close(call, want, DECODER_TOL)


def _jax_noise(keys) -> d.NoiseFn:
  def draw(i, shape):
    step = None if i is None else jnp.asarray(i, jnp.int32)
    return torch.from_numpy(np.array(jd._normal_from_keys(
        keys, step, tuple(shape), jnp.float32)))
  return draw


def test_predict_matches_jax(tiny):
  steps, interval = 10, (0.1, 0.8)
  jcfg = jd.DiffusionConfig(
      guidance=jd.GuidanceConfig(interval=interval),
      sampler=jd.SamplerConfig(name="sde-dpm++", num_steps=steps))
  tcfg = d.DiffusionConfig(
      guidance=d.GuidanceConfig(interval=interval),
      sampler=d.SamplerConfig(name="sde-dpm++", num_steps=steps))
  params = jax.tree.map(lambda x: x, tiny["params"])
  params["decoder"]["spec_out_dense"]["kernel"] = (
      params["decoder"]["spec_out_dense"]["kernel"] * 0.1)
  jm = jax_model.DiffusionModel(tiny["flax"], jcfg, jax_codecs.MelGan())
  batch = {"encoder_input_tokens": tiny["tokens"],
           "decoder_target_tokens": np.zeros((2, 16, 128), np.float32)}
  keys = jax.random.split(jax.random.PRNGKey(5), 2)
  want, _ = jax.jit(jm.predict)(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, keys)
  module = network.Transformer(tiny["torch"].config)
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  pm = model.DiffusionModel(module.eval(), tcfg, codecs.MelGan())
  assert not pm.USES_CONTEXT
  got = pm.predict({k: torch.from_numpy(v) for k, v in batch.items()},
                   _jax_noise(keys))
  assert got.shape == (2, 16, 128) and torch.isfinite(got).all()
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=2e-3)


def test_loss_fn_and_gradients_match_jax():
  """With trained position tables ('learnable_permuted_offset') and half
  the rows' condition dropped (all-masked cross-attention)."""
  r = np.random.RandomState(1)
  batch = {
      "encoder_input_tokens": r.randint(1, 200, (4, 24)).astype(np.int32),
      "decoder_target_tokens": (r.randn(4, 16, 128) * 3 - 4).astype(
          np.float32),
      "decoder_target_mask": np.ones((4, 16), bool),
  }
  batch["encoder_input_tokens"][1, 10:] = 0
  batch["decoder_target_mask"][3, 12:] = False
  jcfg_net, tcfg_net = _configs("learnable_permuted_offset")
  jcfg = jd.DiffusionConfig(guidance=jd.GuidanceConfig(
      drop_condition_prob=0.5))
  jm = jax_model.DiffusionModel(jax_network.Transformer(config=jcfg_net),
                                jcfg, jax_codecs.MelGan())
  params = jax.jit(lambda key: jm.init_variables(
      key, {k: v.shape for k, v in batch.items()}))(
          jax.random.PRNGKey(0))["params"]
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  (loss, metrics), grads = jax.jit(jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, None), has_aux=True))(params)
  targets = jm.audio_codec.scale_features(
      jb["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  _, eps, time, include = jd.training_input(
      jax.random.split(jax.random.PRNGKey(0))[1], targets, jcfg)
  assert 0 < int(np.sum(include)) < len(include)
  arrays = [torch.from_numpy(np.array(x)) for x in (eps, time, include)]

  module = network.Transformer(tcfg_net)
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  pm = model.DiffusionModel(module, d.DiffusionConfig(
      guidance=d.GuidanceConfig(drop_condition_prob=0.5)), codecs.MelGan())
  got, got_metrics = pm.loss_fn(
      {k: torch.from_numpy(v) for k, v in batch.items()},
      lambda x0, cfg: tuple(arrays))
  got.backward()
  np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
  assert set(got_metrics) == set(metrics)
  for k, v in metrics.items():
    np.testing.assert_allclose(got_metrics[k].item(), float(v), rtol=1e-5,
                               err_msg=k)
  named = dict(module.named_parameters())
  flat = convert.flatten(jax.tree.map(np.asarray, grads))
  assert {convert.torch_name(k) for k in flat} == set(named)
  for path, want in flat.items():
    p = named[convert.torch_name(path)]
    assert p.requires_grad, path  # the learnable tables too
    want = np.asarray(want).reshape(p.shape)
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                               atol=3e-4 * np.abs(want).max() + 1e-8,
                               err_msg=path)


@pytest.mark.parametrize("style", STYLES)
def test_position_encodings(style):
  """Each style: JAX's tables move over and encode alike; the tables are
  trained exactly where JAX's gradient reaches them; a fresh port model
  draws them as JAX's initializer does."""
  m = _inputs()
  jcfg, tcfg = _configs(style)
  flax_module, params = _init(jcfg, m)
  module = network.Transformer(tcfg)
  module.load_state_dict(convert.flax_to_state_dict(params, module))

  def encode_sq(p):
    enc = flax_module.apply({"params": p}, jnp.asarray(m["tokens"]),
                            enable_dropout=False, method=flax_module.encode)
    return jnp.sum(enc[0][0] ** 2), enc[0][0]
  (_, want), grads = jax.jit(jax.value_and_grad(encode_sq, has_aux=True))(
      params)
  with torch.no_grad():
    _close(module.encode(torch.from_numpy(m["tokens"]))[0][0], want)
  jax_grad = grads["encoder"]["position_encoder"]["embedding"]
  trained = style in ("learnable_permuted_offset", "random")
  assert bool(np.any(np.asarray(jax_grad) != 0)) == trained
  tables = [module.encoder.position_encoder, module.decoder.position_encoder]
  assert all(t.embedding.requires_grad == trained for t in tables)

  fresh = network.Transformer(tcfg).init_weights(
      torch.Generator().manual_seed(0))
  table = fresh.encoder.position_encoder.embedding.detach()
  plain = layers.sinusoidal_table(*table.shape)
  if style == "fixed":
    _close(table, plain.numpy(), dict(rtol=0, atol=0))
  elif style == "random":
    assert abs(table.std().item() - tcfg.emb_dim ** -0.5) < 0.01
  else:  # sinusoids with random phases, bands permuted
    assert table.abs().max() <= 1.0 and not torch.equal(table, plain)
    jax_table = np.asarray(params["encoder"]["position_encoder"][
        "embedding"])
    # Each column is a sinusoid of one band, sin(w t + phase), so
    # x[t+1] + x[t-1] = 2 cos(w) x[t]: the same bands as JAX's table.
    def bands(t):
      t = np.asarray(t, np.float64)
      return np.sort(np.sum((t[2:] + t[:-2]) * t[1:-1], axis=0)
                     / (2 * np.sum(t[1:-1] ** 2, axis=0)))
    np.testing.assert_allclose(bands(table), bands(jax_table), atol=1e-4)


WIDTHS = dict(emb_dim=128, num_heads=2, head_dim=64, mlp_dim=256)
NET_MAX_REL, NET_RMS_REL = 2.5e-2, 2e-2


class _Tiny128(config.ExperimentConfig):
  """diffusion_tiny at emb 128 (quantizable with min_dim=128)."""

  def network(self):
    return dataclasses.replace(super().network(), **WIDTHS)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "int8"])
def test_bf16_and_int8_forwards_match_jax(compute_dtype):
  m = _inputs()
  jcfg, tcfg = _configs(**WIDTHS)
  _, params = _init(jcfg, m)
  experiment = _Tiny128(size="tiny", with_context=False, dropout_rate=0.0,
                        vocab_size=256)
  float_module = network.Transformer(experiment.network())
  if compute_dtype == "bfloat16":
    jax_params = jax_inference.cast_params_bf16(params)
    state = convert.flax_to_state_dict(params, float_module)
  else:
    jax_params = jax_quantize.quantize_params(
        jax_inference.cast_params_bf16(params), min_dim=128)
    state = convert.flax_to_state_dict(jax_params, float_module)
  served = inference.InferenceModel(experiment, state_dict=state,
                                    device="cpu", compute_dtype=compute_dtype)
  assert isinstance(served.model, model.DiffusionModel)
  jmod = jax_network.Transformer(config=dataclasses.replace(
      jcfg, dtype=jnp.bfloat16))

  @jax.jit
  def forward(p):
    enc = jmod.apply({"params": p}, jnp.asarray(m["tokens"]),
                     enable_dropout=False, method=jmod.encode)
    kv = jmod.apply({"params": p}, enc, method=jmod.precompute_cross_kv)
    return enc, jmod.apply({"params": p}, enc, jnp.asarray(m["z"]),
                           jnp.asarray(m["time"]), enable_dropout=False,
                           cross_kv=kv, cond_rows=2, method=jmod.decode)
  enc, want = forward(jax_params)
  module = served.model.module
  with torch.no_grad():
    enc_t = module.encode(torch.from_numpy(m["tokens"]))
    got = module.decode(enc_t, torch.from_numpy(m["z"]),
                        torch.from_numpy(m["time"]),
                        cross_kv=module.precompute_cross_kv(enc_t),
                        cond_rows=2)
  assert got.dtype == torch.bfloat16
  if compute_dtype == "int8":
    assert module.decoder.layers[0].mlp.wo.is_int8
  for g, w in ((enc_t[0][0], enc[0][0]), (got, want)):
    g = g.float().numpy()
    w = np.asarray(jnp.asarray(w).astype(jnp.float32))
    assert np.abs(g - w).max() <= NET_MAX_REL * np.abs(w).max()
    assert np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)) <= NET_RMS_REL


def test_ismir2021_at_512_target_frames_raises_as_jax():
  """A finding about the reference, recorded, not repaired: the ismir2021
  presets' task asks for 512 target frames, but their network keeps
  max_target_length 256 (the task's length never reaches network_config),
  so JAX's init_variables at 512 frames raises (network.py:422). The port
  raises the same way."""
  experiment = config.preset("ismir2021_tiny")
  assert experiment.task_lengths.targets == 512
  assert experiment.network().max_target_length == 256
  jm = jax_inference.build_model(jax_config.preset("ismir2021_tiny"))
  with pytest.raises(AssertionError, match="exceeds configured"):
    jax.eval_shape(lambda key: jm.init_variables(key, {
        "encoder_input_tokens": (1, 32),
        "decoder_target_tokens": (1, 512, 128)}), jax.random.PRNGKey(0))
  served = inference.build_model(experiment, device="cpu")
  assert isinstance(served, model.DiffusionModel)
  with pytest.raises(ValueError, match="exceeds max_target_length 256"):
    served.module.decode(
        served.module.encode(torch.ones(1, 32, dtype=torch.int64)),
        torch.zeros(1, 512, 128), torch.ones(1))
