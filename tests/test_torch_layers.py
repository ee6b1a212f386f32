"""The port's layers against the JAX package's Flax layers, weights moved
by convert.py. Tolerance 1e-5 (rtol and atol): float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.models import layers as jax_layers
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.models import layers

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(module, flax_params):
  module.load_state_dict(convert.flax_to_state_dict(flax_params, module))
  return module.eval()


def _close(got, want):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_multi_head_attention(cached):
  emb, heads, head_dim = 32, 4, 8
  q_in, mem = _rand(0, 2, 6, emb), _rand(1, 2, 11, emb)
  keep = np.random.RandomState(2).rand(2, 11) > 0.4
  keep[1] = False  # all keys dropped in one row
  flax_mha = jax_layers.MultiHeadAttention(
      num_heads=heads, head_dim=head_dim, out_features=emb)
  params = flax_mha.init(jax.random.PRNGKey(0), jnp.asarray(q_in),
                         jnp.asarray(mem), deterministic=True)["params"]
  kv_mask = jnp.asarray(keep)
  if cached:
    kv = flax_mha.apply({"params": params}, jnp.asarray(mem),
                        method=flax_mha.project_kv)
    want = flax_mha.apply({"params": params}, jnp.asarray(q_in), None,
                          cached_kv=kv, kv_mask=kv_mask, deterministic=True)
  else:
    want = flax_mha.apply({"params": params}, jnp.asarray(q_in),
                          jnp.asarray(mem), kv_mask=kv_mask,
                          deterministic=True)
  mha = _port(layers.MultiHeadAttention(emb, heads, head_dim, emb), params)
  q_t, mem_t = torch.from_numpy(q_in), torch.from_numpy(mem)
  keep_t = torch.from_numpy(keep)
  with torch.no_grad():
    if cached:
      k, v = mha.project_kv(mem_t)
      assert k.shape == (2, heads, 11, head_dim)  # cached layout [b,h,l,d]
      got = mha(q_t, cached_kv=(k, v), kv_mask=keep_t)
    else:
      got = mha(q_t, mem_t, kv_mask=keep_t)
  _close(got, want)


@pytest.mark.parametrize("activations", [("gelu", "linear"), ("relu",)])
def test_mlp_block(activations):
  x = _rand(3, 2, 5, 16)
  flax_mlp = jax_layers.MlpBlock(intermediate_dim=24,
                                 activations=activations)
  params = flax_mlp.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         deterministic=True)["params"]
  want = flax_mlp.apply({"params": params}, jnp.asarray(x),
                        deterministic=True)
  mlp = _port(layers.MlpBlock(16, 24, activations), params)
  with torch.no_grad():
    _close(mlp(torch.from_numpy(x)), want)


def test_rms_norm():
  x = _rand(4, 3, 7, 16) * 3.0
  flax_norm = jax_layers.RMSNorm()
  params = {"scale": _rand(5, 16)}
  want = flax_norm.apply({"params": params}, jnp.asarray(x))
  norm = _port(layers.RMSNorm(16), params)
  with torch.no_grad():
    _close(norm(torch.from_numpy(x)), want)


def test_film():
  x, cond = _rand(6, 2, 5, 16), _rand(7, 2, 1, 64)
  flax_film = jax_layers.FiLM()
  params = flax_film.init(jax.random.PRNGKey(2), jnp.asarray(x),
                          jnp.asarray(cond))["params"]
  want = flax_film.apply({"params": params}, jnp.asarray(x),
                         jnp.asarray(cond))
  film = _port(layers.FiLM(64, 16), params)
  with torch.no_grad():
    _close(film(torch.from_numpy(x), torch.from_numpy(cond)), want)


def test_embed_and_mask_helpers():
  table = _rand(8, 10, 4)
  ids = np.array([[0, 3, 9], [2, 2, 1]])
  flax_embed = jax_layers.Embed(num_embeddings=10, features=4, one_hot=True)
  want = flax_embed.apply({"params": {"embedding": table}}, jnp.asarray(ids))
  embed = _port(layers.Embed(10, 4), {"embedding": table})
  _close(embed(torch.from_numpy(ids)), want)

  mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0]], np.float32)
  y = _rand(9, 2, 3, 5)
  _close(layers.zero_if_all_masked(torch.from_numpy(y),
                                   torch.from_numpy(mask)),
         jax_layers.zero_if_all_masked(jnp.asarray(y), jnp.asarray(mask)))
  _close(layers.mask_to_bias(torch.from_numpy(mask)),
         jax_layers.mask_to_bias(jnp.asarray(mask), jnp.float32))
  am = layers.make_attention_mask(torch.from_numpy(mask),
                                  torch.from_numpy(mask))
  _close(am, jax_layers.make_attention_mask(jnp.asarray(mask),
                                            jnp.asarray(mask)))
  _close(layers.combine_masks(am, None, am),
         jax_layers.combine_masks(jnp.asarray(am.numpy()), None,
                                  jnp.asarray(am.numpy())))


def test_fixed_embed_table_matches_flax_sinusoidal():
  want = jax_layers.sinusoidal()(None, (12, 8))
  _close(layers.FixedEmbed(8, 12).embedding, want)


def test_convert_refuses_int8_and_unknown_leaves():
  mlp = layers.MlpBlock(4, 8, ("relu",))
  good = {"wi": {"kernel": np.zeros((4, 8), np.float32)},
          "wo": {"kernel": np.zeros((8, 4), np.float32)}}
  assert set(convert.flax_to_state_dict(good, mlp)) == {"wi.kernel",
                                                         "wo.kernel"}
  # An int8 kernel converts only beside its kernel_scale, exactly; an
  # unpaired int8 kernel or scale is refused.
  q = np.arange(-16, 16, dtype=np.int8).reshape(4, 8)
  int8 = {"wi": {"kernel": q, "kernel_scale": np.full(8, 0.5, np.float32)},
          "wo": good["wo"]}
  state = convert.flax_to_state_dict(int8, mlp)
  assert state["wi.kernel"].dtype == torch.int8
  np.testing.assert_array_equal(state["wi.kernel"].numpy(), q)
  np.testing.assert_array_equal(state["wi.kernel_scale"].numpy(),
                                np.full(8, 0.5, np.float32))
  with pytest.raises(ValueError, match="int8"):
    convert.flax_to_state_dict({"wi": {"kernel": q}, "wo": good["wo"]}, mlp)
  with pytest.raises(ValueError, match="int8"):
    convert.flax_to_state_dict(
        {"wi": {**good["wi"], "kernel_scale": np.ones(8, np.float32)},
         "wo": good["wo"]}, mlp)
  with pytest.raises(KeyError):
    convert.flax_to_state_dict({"wo": good["wo"]}, mlp)
  with pytest.raises(KeyError):
    convert.flax_to_state_dict({**good, "extra": {"kernel": np.zeros(1)}},
                               mlp)
