"""The port's ContextTransformer against the JAX package's, weights moved by
convert.py, and against the reference goldens (tests/goldens/network.npz,
through checkpoints.remap_t5x_params as tests/test_reference_parity.py
does). Tolerance 1e-5 (rtol and atol), float32 on both sides.

The decoder's output, against the JAX decoder and against the goldens that
JAX computed, holds to 3e-4 instead (largest difference measured: 1.5e-4):
its FiLM conditioning evaluates sin/cos of diffusion time x 2e4 x inverse
timescale, arguments up to 2e4 rad, and XLA's and PyTorch's float32 exp
differ by one ulp in some inverse timescales, which moves the timing
embedding by up to 2e-4 (measured)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.models.diffusion import (
    network as jax_network)
from music_spectrogram_diffusion_tpu.train import checkpoints
from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network

TOL = dict(rtol=1e-5, atol=1e-5)
DECODER_TOL = dict(rtol=3e-4, atol=3e-4)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "network.npz")


def _close(got, want, tol=TOL):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def tiny():
  """Tiny context model in both packages with the same weights."""
  jax_cfg = jax_config.network_config("tiny", with_context=True,
                                      vocab_size=256, dropout_rate=0.0)
  flax_module = jax_network.ContextTransformer(config=jax_cfg)
  r = np.random.RandomState(0)
  tokens = r.randint(1, 200, (2, 24)).astype(np.int32)
  tokens[1, 15:] = 0
  context = r.randn(2, 16, 128).astype(np.float32)
  ctx_mask = np.zeros((2, 16), bool)
  ctx_mask[0, :11] = True  # row 1: no context (a song's first segment)
  params = flax_module.init(
      jax.random.PRNGKey(0), encoder_input_tokens=jnp.asarray(tokens),
      encoder_continuous_inputs=jnp.asarray(context),
      encoder_continuous_mask=jnp.asarray(ctx_mask),
      decoder_input_tokens=jnp.zeros((2, 16, 128)),
      decoder_noise_time=jnp.ones((2,)), enable_dropout=False)["params"]
  module = network.ContextTransformer(config.network_config(
      "tiny", with_context=True, vocab_size=256, dropout_rate=0.0))
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  return dict(flax=flax_module, params=params, torch=module.eval(),
              tokens=tokens, context=context, ctx_mask=ctx_mask,
              z=r.randn(4, 16, 128).astype(np.float32),
              time=np.array([0.3, 0.9, 0.3, 0.9], np.float32))


def _encode_both(m):
  enc_jax = m["flax"].apply(
      {"params": m["params"]}, jnp.asarray(m["tokens"]),
      jnp.asarray(m["context"]), jnp.asarray(m["ctx_mask"]),
      enable_dropout=False, method=m["flax"].encode)
  with torch.no_grad():
    enc_t = m["torch"].encode(torch.from_numpy(m["tokens"]),
                              torch.from_numpy(m["context"]),
                              torch.from_numpy(m["ctx_mask"]))
  return enc_jax, enc_t


def test_encode_and_cross_kv(tiny):
  enc_jax, enc_t = _encode_both(tiny)
  for (ej, mj), (et, mt) in zip(enc_jax, enc_t):
    _close(et, ej)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
  kv_jax = tiny["flax"].apply({"params": tiny["params"]}, enc_jax,
                              method=tiny["flax"].precompute_cross_kv)
  with torch.no_grad():
    kv_t = tiny["torch"].precompute_cross_kv(enc_t)
  assert len(kv_t) == len(kv_jax)
  for layer_t, layer_j in zip(kv_t, kv_jax):
    for (kt, vt), (kj, vj) in zip(layer_t, layer_j):
      _close(kt, kj)  # both [b, h, l, d]
      _close(vt, vj)


@pytest.mark.parametrize("fused_cfg_pair", [False, True])
def test_decode(tiny, fused_cfg_pair):
  enc_jax, enc_t = _encode_both(tiny)
  z, time = tiny["z"], tiny["time"]
  if not fused_cfg_pair:
    z, time = z[:2], time[:2]
  kv_jax = tiny["flax"].apply({"params": tiny["params"]}, enc_jax,
                              method=tiny["flax"].precompute_cross_kv)
  cond_rows = 2 if fused_cfg_pair else None
  want = tiny["flax"].apply(
      {"params": tiny["params"]}, enc_jax, jnp.asarray(z), jnp.asarray(time),
      enable_dropout=False, cross_kv=kv_jax, cond_rows=cond_rows,
      method=tiny["flax"].decode)
  with torch.no_grad():
    kv_t = tiny["torch"].precompute_cross_kv(enc_t)
    got = tiny["torch"].decode(enc_t, torch.from_numpy(z),
                               torch.from_numpy(time), cross_kv=kv_t,
                               cond_rows=cond_rows)
    uncached = tiny["torch"].decode(enc_t, torch.from_numpy(z),
                                    torch.from_numpy(time),
                                    cond_rows=cond_rows)
  _close(got, want, DECODER_TOL)
  _close(uncached, want, DECODER_TOL)
  if fused_cfg_pair:
    # The unconditional rows' output does not depend on the encodings.
    blank = [(torch.zeros_like(e), torch.zeros_like(m)) for e, m in enc_t]
    with torch.no_grad():
      uncond = tiny["torch"].decode(blank, torch.from_numpy(z[2:]),
                                    torch.from_numpy(time[2:]))
    _close(got[2:], uncond.numpy())


def _golden_config(style):
  common = dict(vocab_size=100, emb_dim=32, num_heads=2, head_dim=8,
                num_encoder_layers=2, num_decoder_layers=2, mlp_dim=48,
                mlp_activations=("gelu", "linear"), max_input_length=16,
                max_context_length=8, max_target_length=8, output_dim=6)
  if style == "A":
    return network.NetworkConfig(
        cross_attend_style="concat_encodings",
        position_encoding="fixed_permuted_offset",
        context_positions="terminal_relative", **common)
  return network.NetworkConfig(
      cross_attend_style="sum_cross_attends", position_encoding="fixed",
      context_positions="regular", **common)


@pytest.mark.parametrize("style", ["A", "B"])
def test_matches_reference_goldens(style):
  g = np.load(GOLDENS)
  prefix = f"p{style}/"
  flat = {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}
  params = checkpoints.remap_t5x_params(checkpoints._unflatten(flat))
  module = network.ContextTransformer(_golden_config(style))
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  module.eval()
  tokens, context = torch.from_numpy(g["tokens"]), torch.from_numpy(
      g["context"])
  ctx_mask = torch.from_numpy(g["ctx_mask"])
  z, time = torch.from_numpy(g["z"]), torch.from_numpy(g["time"])
  with torch.no_grad():
    _close(module(tokens, context, ctx_mask, z, time), g[f"out{style}_call"],
           DECODER_TOL)
    if style == "A":
      enc = module.encode(tokens, context, ctx_mask)
      # Valid rows only: padded query rows attend the valid keys here
      # (a [b, len] key mask) where the reference averages them evenly.
      tok_mask = g["tokens"] > 0
      _close(enc[0][0][torch.from_numpy(tok_mask)],
             g["outA_tokens_encoded"][tok_mask])
      _close(enc[1][0][ctx_mask], g["outA_context_encoded"][g["ctx_mask"]])
      _close(module.decode(enc, z, time), g["outA_decode"], DECODER_TOL)


def test_terminal_relative_positions():
  mask = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]])
  lengths = network.sequence_length_from_mask(mask)
  assert lengths.tolist() == [2, 5, 0]
  pos = network.terminal_relative_positions(
      torch.arange(5).expand(3, 5), lengths)
  assert pos.tolist() == [[3, 4, 0, 1, 2], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4]]
  for row, n in zip(mask.numpy(), lengths.tolist()):
    assert int(jax_network.sequence_length_from_mask(jnp.asarray(row))) == n
