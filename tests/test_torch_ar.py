"""The port's autoregressive family against the JAX package's, at tiny size
on the CPU, the weights moved by convert.py.

* The network against tests/goldens/ar_network.npz (the reference
  implementation's parameters and outputs), the parameters renamed by the
  port's copy of the T5X renaming (`convert.remap_t5x_params`), as
  tests/test_ar_parity.py holds the JAX package: atol = rtol = 1e-5.
* `encode` and the teacher-forced call against JAX on JAX-initialised
  weights, 1e-5; the cached decode, step by step, against the port's own
  teacher-forced call, 1e-5 (the same function: the decode step attends
  over the whole fixed-length cache with its later positions masked out,
  as JAX's does).
* `predict` with the deterministic head against JAX's `predict`: nothing is
  random, so the frames must agree, within 3e-4, the limit
  tests/test_torch_network.py gives a decoder (float32 sums in other
  orders, fed back through 8 generated frames here).
* The heads' losses, 1e-6 relative; the mixture's sampling with injected
  draws against a numpy recomputation; `loss_fn` (1e-5 relative) and every
  gradient of one step without dropout (1e-4 relative RMS) against
  `jax.grad`.

A known deviation, not copied: in bf16 JAX's einsum attention rounds the
scores and the softmax to bf16, the port keeps them in float32
(`layers.dot_product_attention`). Every comparison here is float32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.models.autoregressive import (
    model as jax_model, network as jax_network,
    output_functions as jax_heads)
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.autoregressive import (
    model, network, output_functions as heads)
from music_spectrogram_diffusion_tpu_torch.ops import attention

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "ar_network.npz")
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _configs(out_dim: int, audio_dim: int):
  common = dict(vocab_size=100, emb_dim=32, num_heads=2, head_dim=8,
                num_encoder_layers=2, num_decoder_layers=2, mlp_dim=48,
                mlp_activations=("gelu", "linear"), output_dim=out_dim,
                audio_dim=audio_dim)
  return (jax_network.ARConfig(dropout_rate=0.1, **common),
          network.ARConfig(dropout_rate=0.1, **common))


def _port(cfg, params):
  module = network.ARTransformer(cfg)
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  return module.eval()


def test_matches_reference_goldens_through_the_t5x_renaming():
  g = np.load(GOLDENS)
  flat = {k[len("pAR/"):]: g[k] for k in g.files if k.startswith("pAR/")}
  params = convert.remap_t5x_params(convert.unflatten(flat))
  module = _port(_configs(6, 6)[1], params)
  tokens = torch.from_numpy(g["tokens"])
  with torch.no_grad():
    _close(module.encode(tokens), g["outAR_encoded"])
    _close(module(tokens, torch.from_numpy(g["dec_inputs"])),
           g["outAR_call"])


@pytest.fixture(scope="module")
def tiny():
  """Tiny AR network in both packages with the same JAX-initialised
  weights, the deterministic head's shapes (128 mel dims)."""
  jcfg, tcfg = _configs(0, 128)
  flax_module = jax_network.ARTransformer(config=jcfg)
  r = np.random.RandomState(0)
  tokens = r.randint(1, 100, (2, 16)).astype(np.int32)
  tokens[1, 11:] = 0
  dec_in = r.randn(2, 8, 128).astype(np.float32)
  params = jax.jit(lambda key: flax_module.init(
      key, jnp.asarray(tokens), jnp.asarray(dec_in), jnp.asarray(dec_in),
      enable_dropout=False))(jax.random.PRNGKey(1))["params"]
  return dict(flax=flax_module, params=params, torch=_port(tcfg, params),
              tokens=tokens, dec_in=dec_in)


def test_encode_and_teacher_forced_call_match_jax(tiny):
  m = tiny
  want_enc = m["flax"].apply({"params": m["params"]},
                             jnp.asarray(m["tokens"]), enable_dropout=False,
                             method=m["flax"].encode)
  want = m["flax"].apply({"params": m["params"]}, jnp.asarray(m["tokens"]),
                         jnp.asarray(m["dec_in"]), jnp.asarray(m["dec_in"]),
                         enable_dropout=False)
  tokens = torch.from_numpy(m["tokens"])
  with torch.no_grad():
    _close(m["torch"].encode(tokens), want_enc)
    _close(m["torch"](tokens, torch.from_numpy(m["dec_in"])), want)


def test_cached_decode_equals_the_teacher_forced_call(tiny):
  module = tiny["torch"]
  tokens = torch.from_numpy(tiny["tokens"])
  frames = torch.from_numpy(tiny["dec_in"])
  with torch.no_grad():
    want = module(tokens, frames)
    cache = module.init_cache(module.encode(tokens), tokens, frames.shape[1])
    got = torch.cat([module.decode_step(cache, frames[:, i:i + 1],
                                        torch.tensor([i]))
                     for i in range(frames.shape[1])], dim=1)
  _close(got, want)


def test_decode_step_masks_the_cache_after_its_index(tiny):
  """The fixed-length cache's positions after the step's index take no
  part: whatever they hold, the step's output is the same bit for bit."""
  module = tiny["torch"]
  tokens = torch.from_numpy(tiny["tokens"])
  frame = torch.from_numpy(tiny["dec_in"])[:, :1]
  outs = []
  with torch.no_grad():
    for fill in (0.0, 3.0):
      cache = module.init_cache(module.encode(tokens), tokens, 8)
      for kv in cache.self_kv:
        kv.key[:, :, 3:] = fill
        kv.value[:, :, 3:] = fill
      outs.append(module.decode_step(cache, frame, torch.tensor([2])))
  assert torch.equal(outs[0], outs[1])


def test_predict_draws_every_step_before_the_loop(tiny):
  """A head that draws: predict takes every step's draws before the loop,
  in the steps' order, and equals the per-step loop that drew each step's
  in turn."""
  head = heads.Deterministic(0.3)
  pm = model.AutoregressiveModel(tiny["torch"], head, codecs.MelGan())
  tokens = torch.from_numpy(tiny["tokens"])
  batch = {"encoder_input_tokens": tokens,
           "decoder_target_tokens": torch.zeros(2, 8, 128)}
  calls = []

  def noise(i, shape):
    calls.append((i, shape))
    return torch.randn(shape, generator=torch.Generator().manual_seed(i))

  got = pm.predict(batch, noise)
  assert calls == [(i, (2, 128)) for i in range(8)]
  with torch.no_grad():
    module = tiny["torch"]
    cache = module.init_cache(module.encode(tokens), tokens, 8)
    frame, frames = torch.zeros(2, 1, 128), []
    for i in range(8):
      out = module.decode_step(cache, frame, torch.tensor([i]))
      frame = head.get_sample(out[:, 0], noise(i, (2, 128)))[:, None]
      frames.append(frame)
  assert torch.equal(got, torch.cat(frames, dim=1))


def test_attention_routes(tiny, monkeypatch):
  """The encoder's self-attention and the full-length cross-attention go
  through flash_attention (the kernel on the card), unmasked and masked;
  the causal self-attention and the decode steps do not."""
  calls = []
  real = attention.flash_attention

  def record(q, k, v, *args, kv_mask=None, **kwargs):
    calls.append((q.shape[1], k.shape[1], kv_mask is not None))
    return real(q, k, v, *args, kv_mask=kv_mask, **kwargs)

  monkeypatch.setattr(attention, "flash_attention", record)
  module = tiny["torch"]
  tokens = torch.from_numpy(tiny["tokens"])
  with torch.no_grad():
    module(tokens, torch.from_numpy(tiny["dec_in"]))
    assert calls == [(16, 16, False)] * 2 + [(8, 16, True)] * 2
    calls.clear()
    cache = module.init_cache(module.encode(tokens), tokens, 8)
    module.decode_step(cache, torch.zeros(2, 1, 128), torch.tensor([0]))
  assert calls == [(16, 16, False)] * 2


def test_predict_matches_jax(tiny):
  codec = jax_codecs.MelGan()
  jm = jax_model.AutoregressiveModel(tiny["flax"], jax_heads.Deterministic(),
                                     codec)
  batch = {"encoder_input_tokens": tiny["tokens"],
           "decoder_target_tokens": np.zeros((2, 8, 128), np.float32)}
  want, _ = jax.jit(jm.predict)(tiny["params"],
                                {k: jnp.asarray(v) for k, v in batch.items()})

  def no_draws(i, shape):
    raise AssertionError("the deterministic head draws nothing")

  pm = model.AutoregressiveModel(tiny["torch"], heads.Deterministic(),
                                 codecs.MelGan())
  got = pm.predict({k: torch.from_numpy(v) for k, v in batch.items()},
                   no_draws)
  assert got.shape == (2, 8, 128) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                             atol=3e-4)


def _mixture_outputs(r, lead, n=3, dims=4):
  return r.randn(*lead, n + 2 * n * dims).astype(np.float32)


def test_head_losses_match_jax():
  r = np.random.RandomState(2)
  out = _mixture_outputs(r, (2, 5))
  target = r.randn(2, 5, 4).astype(np.float32)
  want = jax_heads.GaussianMixture(n_components=3, dims_per_component=4
                                   ).get_loss(jnp.asarray(out),
                                              jnp.asarray(target))
  got = heads.GaussianMixture(3, 4).get_loss(torch.from_numpy(out),
                                             torch.from_numpy(target))
  _close(got, want, dict(rtol=1e-6, atol=0))
  det = r.randn(2, 5, 4).astype(np.float32)
  _close(heads.Deterministic().get_loss(torch.from_numpy(det),
                                        torch.from_numpy(target)),
         jax_heads.Deterministic().get_loss(jnp.asarray(det),
                                            jnp.asarray(target)),
         dict(rtol=1e-6, atol=0))
  with pytest.raises(ValueError, match="expects"):
    heads.GaussianMixture(3, 4).get_loss(torch.zeros(2, 7), torch.zeros(2, 4))


def test_mixture_sampling_with_injected_draws():
  r = np.random.RandomState(3)
  n, dims = 3, 4
  out = _mixture_outputs(r, (6,), n, dims)
  out[:, :n] *= 3.0  # spread the component probabilities
  draws = r.randn(6, 1 + dims).astype(np.float32)
  head = heads.GaussianMixture(n, dims)
  assert head.draw_shape(6, out.shape[1]) == (6, 1 + dims)
  got = head.get_sample(torch.from_numpy(out), torch.from_numpy(draws))
  # numpy: the component where the CDF first passes Phi(draw), then
  # mu + sigma x normal of that component.
  logits = out[:, :n].astype(np.float64)
  mu = out[:, n:n + n * dims].reshape(6, n, dims)
  sigma = 0.1 + 0.9 * scipy.special.expit(out[:, n + n * dims:].reshape(
      6, n, dims))
  cdf = np.cumsum(scipy.special.softmax(logits, axis=-1), axis=-1)
  comp = np.minimum((cdf < scipy.special.ndtr(draws[:, 0])[:, None]).sum(-1),
                    n - 1)
  rows = np.arange(6)
  want = mu[rows, comp] + sigma[rows, comp] * draws[:, 1:]
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
  assert len(set(comp.tolist())) > 1  # the draws reach several components


def test_dithered_deterministic_sampling_draws_per_step():
  out = torch.ones(2, 4)
  draws = torch.arange(8.0).reshape(2, 4)
  head = heads.Deterministic(0.5)
  assert head.draw_shape(2, 4) == (2, 4)
  assert heads.Deterministic().draw_shape(2, 4) is None
  got = head.get_sample(out, draws)
  _close(got, (out + 0.5 * draws).numpy(), dict(rtol=0, atol=0))


@pytest.mark.parametrize("head", ["deterministic", "gaussian_mixture"])
def test_loss_fn_and_gradients_match_jax(head):
  n_dims = 128
  jhead = (jax_heads.Deterministic() if head == "deterministic" else
           jax_heads.GaussianMixture(n_components=10,
                                     dims_per_component=n_dims))
  phead = heads.build(head, n_dims)
  out_dim = 0 if head == "deterministic" else phead.expected_num_dims
  jcfg, tcfg = _configs(out_dim, n_dims)
  jm = jax_model.AutoregressiveModel(jax_network.ARTransformer(config=jcfg),
                                     jhead, jax_codecs.MelGan())
  r = np.random.RandomState(4)
  targets = r.randn(3, 8, n_dims).astype(np.float32)
  inputs = np.roll(targets, 1, axis=1)
  inputs[:, 0] = 0
  batch = {"encoder_input_tokens": r.randint(1, 100, (3, 16)).astype(
               np.int32),
           "decoder_input_tokens": inputs, "decoder_target_tokens": targets,
           "decoder_target_mask": np.ones((3, 8), bool)}
  batch["encoder_input_tokens"][2, 9:] = 0
  batch["decoder_target_mask"][1, 5:] = False
  params = jax.jit(lambda key: jm.init_variables(
      key, {k: v.shape for k, v in batch.items()}))(
          jax.random.PRNGKey(0))["params"]
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  (loss, metrics), grads = jax.jit(jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, None), has_aux=True))(params)

  module = network.ARTransformer(tcfg)
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  pm = model.AutoregressiveModel(module, phead, codecs.MelGan())
  got, got_metrics = pm.loss_fn(
      {k: torch.from_numpy(v) for k, v in batch.items()})
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
    g = named[convert.torch_name(path)].grad.numpy()
    want = np.asarray(want).reshape(g.shape)
    rms = np.sqrt(np.mean((g - want) ** 2) / np.mean(want ** 2))
    assert rms <= 1e-4, (path, rms)


def test_build_model_serves_both_heads_in_every_dtype():
  for head in ("deterministic", "gaussian_mixture"):
    experiment = config.ExperimentConfig(
        size="tiny", with_context=False, model_family="autoregressive",
        ar_output=head,
        task_lengths=config.TaskLengths(inputs=32, targets=4))
    for dtype in (None, "float32", "bfloat16", "int8"):
      served = inference.InferenceModel(experiment, device="cpu",
                                        compute_dtype=dtype)
      tokens = np.zeros((2, 32), np.int64)
      tokens[:, :5] = np.arange(1, 6)
      mel = served.predict({"encoder_input_tokens": tokens,
                            "decoder_target_tokens": np.zeros(
                                (2, 4, 128), np.float32)}, seed=3)
      assert mel.shape == (2, 4, 128) and np.isfinite(mel).all(), (head,
                                                                   dtype)
      out = served.model.module.decoder.spec_out_dense
      assert out.kernel.dtype == torch.float32
      assert out.kernel.shape[1] == (128 if head == "deterministic" else
                                     10 + 2 * 10 * 128)


def test_causal_and_decoder_masks_match_jax():
  from music_spectrogram_diffusion_tpu.models import layers as jax_layers
  tgt = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
  _close(layers.make_decoder_mask(torch.from_numpy(tgt), torch.float32),
         jax_layers.make_decoder_mask(jnp.asarray(tgt), jnp.float32))
  _close(layers.make_causal_mask(torch.from_numpy(tgt)),
         jax_layers.make_causal_mask(jnp.asarray(tgt)))
  seg = np.array([[1, 1, 2, 2], [1, 1, 1, 2]], np.int32)
  prefix = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], np.int32)
  _close(layers.make_decoder_mask(torch.from_numpy(tgt), torch.float32,
                                  torch.from_numpy(prefix),
                                  torch.from_numpy(seg)),
         jax_layers.make_decoder_mask(jnp.asarray(tgt), jnp.float32,
                                      jnp.asarray(prefix), jnp.asarray(seg)))
  a, b = np.ones((1, 2, 3, 3), np.float32), np.full((1, 2, 3, 3), 2.0,
                                                   np.float32)
  _close(layers.combine_biases(torch.from_numpy(a), None,
                               torch.from_numpy(b)),
         jax_layers.combine_biases(jnp.asarray(a), None, jnp.asarray(b)))
  assert layers.combine_biases(None) is None
